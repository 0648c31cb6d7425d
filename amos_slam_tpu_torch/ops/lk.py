"""Batched pyramidal Lucas-Kanade optical flow (port of ops/lk.py).

The counterpart of cv::calcOpticalFlowPyrLK in the dynamic stage (reference
src/Tracking.cc:896) and the LK helper (include/LK.h:32). All N tracks
advance together; a fixed number of Gauss-Newton updates per level solves
the 2x2 flow systems of the whole batch at once.

Window sampling. The JAX package samples a window as two products against
the whole level image with per-track one-hot interpolation matrices in
bf16. Each output sample only ever has two taps per axis, so the port
gathers those taps instead and reproduces the same rounding: the level
image and the weights rounded to bf16, each row sample a two-term f32 sum
rounded to bf16, then the column pass the same way. Where the edge clamp
puts both taps of a sample on one texel, the JAX matrix holds their summed
weight ``(1-f)+f`` rounded once, and so does the port. On identical inputs
the samples are bit-equal to the JAX package's. The window sums and the
divisions by constants follow the compiled JAX program (``ops/f32.py``),
so on the CPU the whole flow is bit-equal to ``jax.jit(lk_flow)``; the
bf16 sampling itself moves samples by < 0.004 px against an exact
bilinear interpolant, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .f32 import recip, seq_sum


def _dyadic_pyramid(img: torch.Tensor, levels: int):
    """List of (H/2^l, W/2^l) images, 2x2 average-pool downsampling."""
    out = [img]
    for _ in range(levels - 1):
        p = out[-1]
        h2, w2 = p.shape[0] // 2, p.shape[1] // 2
        p = p[: h2 * 2, : w2 * 2]
        # the four taps added in XLA's reduce order, then the exact /4
        s = ((p[0::2, 0::2] + p[0::2, 1::2]) + p[1::2, 0::2]) + p[1::2, 1::2]
        out.append(s * 0.25)
    return out


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and return as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _taps(pos: torch.Tensor, P: int, size: int):
    """Two-tap bilinear interpolation along one axis for P consecutive
    samples starting at ``pos`` (N,): -> (N, P+1) clamped texel indices
    (sample i reads indices i and i+1) and (N, P) bf16 weights of each tap.
    Where the clamp collapses both taps onto one texel the first tap
    carries the summed weight and the second none, as in the JAX matrix."""
    base = torch.floor(pos)
    f = (pos - base)[:, None]
    idx = torch.clamp(base.to(torch.long)[:, None]
                      + torch.arange(P + 1, device=pos.device)[None], 0, size - 1)
    collapse = idx[:, :-1] == idx[:, 1:]
    one_m = 1.0 - f
    w0 = _bf16(torch.where(collapse, one_m + f, one_m))
    w1 = _bf16(torch.where(collapse, torch.zeros_like(f), f))
    return idx, w0, w1


def _sample_window(img: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
                   half: int, extra: int = 0) -> torch.Tensor:
    """Bilinear samples on the (2*(half+extra)+1)^2 grid centred at the
    float positions (cy, cx): (N, P, P) with the JAX package's bf16
    rounding (see the module docstring)."""
    P = 2 * (half + extra) + 1
    H, W = img.shape
    iy, wy0, wy1 = _taps(cy - (half + extra), P, H)
    ix, wx0, wx1 = _taps(cx - (half + extra), P, W)
    img_b = _bf16(img)
    cols = ix[:, None, :]                                         # (N, 1, P+1)
    top = img_b[iy[:, :-1, None], cols]                           # (N, P, P+1)
    bot = img_b[iy[:, 1:, None], cols]
    rows = _bf16(wy0[:, :, None] * top + wy1[:, :, None] * bot)
    return wx0[:, None, :] * rows[:, :, :-1] + wx1[:, None, :] * rows[:, :, 1:]


class FlowResult(NamedTuple):
    pts1: torch.Tensor     # (N, 2) tracked (x, y) positions in image 2
    valid: torch.Tensor    # (N,) bool: converged, in-bounds, low residual
    err: torch.Tensor      # (N,) mean |I1 - I2| over the window (SAD/px)


def lk_flow(
    img0: torch.Tensor,
    img1: torch.Tensor,
    pts0: torch.Tensor,         # (N, 2) float32 (x, y) in img0
    pts_valid: torch.Tensor,    # (N,) bool
    levels: int = 4,
    win_half: int = 7,
    iters: int = 6,
    max_err: float = 20.0,
    min_eig: float = 1.0,
) -> FlowResult:
    """Track pts0 from img0 to img1; positions in img1.

    The window is (2*win_half+1)^2 (the reference uses 22x22). Images are in
    [0, 255] intensity units: ``min_eig`` (squared intensity) and
    ``max_err`` (intensity) assume them. The validity gate folds in the
    reference's neighbourhood-SAD and border filters
    (src/Tracking.cc:902-924) and cv::calcOpticalFlowPyrLK's
    minEigThreshold texture gate."""
    pyr0 = _dyadic_pyramid(img0, levels)
    pyr1 = _dyadic_pyramid(img1, levels)
    N = pts0.shape[0]
    w = win_half

    g = torch.zeros((N, 2), dtype=torch.float32, device=pts0.device)
    I_last = None
    for lvl in range(levels - 1, -1, -1):
        scale = 0.5 ** lvl
        I0, I1 = pyr0[lvl], pyr1[lvl]
        cy = pts0[:, 1] * scale
        cx = pts0[:, 0] * scale

        # template + central-difference gradients from one padded sample
        Tfull = _sample_window(I0, cy, cx, w, extra=1)            # (N, P+2, P+2)
        T = Tfull[:, 1:-1, 1:-1]
        Tx = 0.5 * (Tfull[:, 1:-1, 2:] - Tfull[:, 1:-1, :-2])
        Ty = 0.5 * (Tfull[:, 2:, 1:-1] - Tfull[:, :-2, 1:-1])
        Gxx = seq_sum(Tx * Tx, 2)
        Gxy = seq_sum(Tx * Ty, 2)
        Gyy = seq_sum(Ty * Ty, 2)
        det = Gxx * Gyy - Gxy * Gxy
        inv_ok = det > 1e-6
        det = torch.where(inv_ok, det, torch.ones_like(det))

        # the JAX fori_loop: a fixed number of GN updates
        for _ in range(iters):
            I_last = _sample_window(I1, cy + g[:, 1] * scale, cx + g[:, 0] * scale, w)
            It = I_last - T
            bx = seq_sum(It * Tx, 2)
            by = seq_sum(It * Ty, 2)
            dxe = (Gyy * bx - Gxy * by) / det
            dye = (Gxx * by - Gxy * bx) / det
            step = torch.stack([-dxe, -dye], dim=-1) / scale
            step = torch.where(inv_ok[:, None], step, torch.zeros_like(step))
            g = g + torch.clamp(step, -32.0, 32.0)

    # Texture gate: the GN system's min eigenvalue at the finest level, per
    # window pixel. A flat or 1-D-textured window slides along its weak
    # direction with a low residual, which the SAD gate cannot catch.
    inv_p2 = recip((2 * w + 1) ** 2)
    d = Gxx - Gyy
    lam_min = 0.5 * ((Gxx + Gyy) - torch.sqrt(d * d + 4.0 * (Gxy * Gxy)))
    texture_ok = lam_min * inv_p2 > min_eig

    # Residual of the last GN sample against the level-0 template, and the
    # bounds check
    H, W = img0.shape
    p1 = pts0 + g
    err = seq_sum(torch.abs(I_last - T), 2) * inv_p2
    inb = ((p1[:, 0] >= w + 1) & (p1[:, 0] < W - w - 1)
           & (p1[:, 1] >= w + 1) & (p1[:, 1] < H - w - 1))
    valid = pts_valid & inb & (err < max_err) & texture_ok
    return FlowResult(pts1=p1, valid=valid, err=err)

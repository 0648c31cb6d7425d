"""Vectorized FAST-9/16 corner detection with spatially balanced selection
(port of ops/fast.py).

* ``fast_margin``: the exact FAST corner margin of every pixel (the largest
  threshold t at which it is still a corner) from 16 shifted copies of the
  image; circle reads wrap around both axes, as ``jnp.roll`` does.
* ``nms3x3``: 3x3 non-max suppression with pixels outside the image at
  -inf, as ``reduce_window(..., "SAME")`` does.
* ``select_from_margin``: one winner per fixed cell, then a global top-k
  over the cell winners. Ties keep the lower index first, as
  ``jax.lax.top_k`` does: ``torch.topk`` gives no such order, a stable
  descending sort does.

These are the plain versions of the CUDA kernel in
``ops/kernels/fast_margin_nms.py``; every function takes any number of
leading batch dims.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, circularly ordered (dy, dx).
CIRCLE16: Tuple[Tuple[int, int], ...] = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def fast_margin(img: torch.Tensor) -> torch.Tensor:
    """Per-pixel FAST-9 corner margin (..., H, W), 0 where not a corner.

    margin = max over the two polarities of
             max over 16 arc starts of
             min over the 9 contiguous circle differences.
    """
    shifted = torch.stack(
        [torch.roll(img, (-dy, -dx), dims=(-2, -1)) for (dy, dx) in CIRCLE16],
        dim=0,
    )  # (16, ..., H, W); shifted[k][..., y, x] = img[..., y+dy, x+dx]
    d = shifted - img[None]

    def arc_margin(diff):
        m = diff
        for i in range(1, 9):
            m = torch.minimum(m, torch.roll(diff, -i, dims=0))
        return torch.amax(m, dim=0)

    bright = arc_margin(d)        # circle brighter than center
    dark = arc_margin(-d)         # circle darker than center
    return torch.clamp(torch.maximum(bright, dark), min=0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only local maxima in a 3x3 window (score elsewhere -> 0)."""
    lead = score.shape[:-2]
    flat = score.reshape((-1, 1) + score.shape[-2:])
    mx = F.max_pool2d(flat, 3, stride=1, padding=1).reshape(score.shape)
    return torch.where(score >= mx, score, torch.zeros((), dtype=score.dtype,
                                                       device=score.device))


class LevelKeypoints(NamedTuple):
    yx: torch.Tensor       # (K, 2) float32 pixel coords at this level
    score: torch.Tensor    # (K,)
    valid: torch.Tensor    # (K,) bool


def detect_level(
    img: torch.Tensor,
    active_hw: Tuple[int, int],
    budget: int,
    min_th: float,
    border: int,
    cell: int = 16,
) -> LevelKeypoints:
    """Detect up to ``budget`` spatially balanced corners on one level.

    ``img`` may be a zero-padded full-size slot; ``active_hw`` is the level's
    true extent.
    """
    return select_from_margin(
        nms3x3(fast_margin(img)), active_hw, budget, min_th, border, cell
    )


def top_k_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values, equal
    values in ascending index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_from_margin(
    margin: torch.Tensor,
    active_hw: Tuple[int, int],
    budget: int,
    min_th: float,
    border: int,
    cell: int = 16,
) -> LevelKeypoints:
    """Spatially balanced top-k selection from an NMS'd margin map (H, W)."""
    H, W = margin.shape
    h, w = active_hw
    dev = margin.device

    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    ok = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    margin = torch.where(ok & (margin > min_th), margin,
                         torch.zeros((), dtype=margin.dtype, device=dev))

    # One winner per (cell x cell) block; argmax keeps the first maximum.
    ch, cw = -(-H // cell), -(-W // cell)
    m = F.pad(margin, (0, cw * cell - W, 0, ch * cell - H))
    blocks = m.reshape(ch, cell, cw, cell).permute(0, 2, 1, 3).reshape(
        ch, cw, cell * cell
    )
    cell_best = torch.amax(blocks, dim=-1)
    cell_arg = torch.argmax(blocks, dim=-1)

    flat_score = cell_best.reshape(-1)
    k = min(budget, flat_score.shape[0])
    top_score, top_idx = top_k_stable(flat_score, k)

    arg = cell_arg.reshape(-1)[top_idx]
    y = (top_idx // cw) * cell + arg // cell
    x = (top_idx % cw) * cell + arg % cell

    valid = top_score > 0.0
    yx = torch.stack([y, x], dim=-1).to(torch.float32)
    if k < budget:  # pad to the static budget
        pad = budget - k
        yx = F.pad(yx, (0, 0, 0, pad))
        top_score = F.pad(top_score, (0, pad))
        valid = F.pad(valid, (0, pad))
    return LevelKeypoints(yx=yx, score=top_score, valid=valid)

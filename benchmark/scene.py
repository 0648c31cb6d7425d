"""Synthetic RGB-D scenes, rendered on the card from a seed.

A PyTorch rewrite of the port's planes-and-texture renderer
(``io/synthetic.py``: ``default_room``, ``room_with_mover``, ``render``):
a room of axis-aligned textured rectangles, raycast from each camera pose
into a grey image and a z-depth map, with the ground truth exact. The
textures are multi-octave value noise drawn from a ``torch.Generator``
on the rendering device, so a seed gives the same scene on every run, and
a whole sequence renders in a few large batched calls.

The camera path is fixed (the same for every seed): a smooth handheld
motion whose mean speeds are set by the traffic file.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FREE_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
TEX_SIZE = 256


@dataclass
class Plane:
    """Axis-aligned textured rectangle at ``axis`` = ``value``; ``bounds``
    (lo_a, hi_a, lo_b, hi_b) over the two free axes in ascending order.
    The texture is sampled at (pa - anchor_a, pb - anchor_b) * tex_scale,
    wrapping. For a moving plane ``bounds`` and ``anchor`` may be (N, 4)
    and (N, 2) tensors, one row per frame."""

    axis: int
    value: float
    bounds: object
    texture: torch.Tensor
    tex_scale: float = 80.0
    anchor: object = (0.0, 0.0)


def block_textures(gen: torch.Generator, n: int, block: int = 8, contrast: float = 180.0,
                   size: int = TEX_SIZE, device=None) -> torch.Tensor:
    """(n, size, size) float32 textures in [30, 210]: value noise at four
    octaves (block / 2, block, 4 block, 16 block pixels), each a grid of
    uniform draws enlarged by linear interpolation through its corners."""
    tex = torch.zeros(n, size, size, device=device)
    for blk, weight in ((block // 2, 0.5), (block, 1.0), (block * 4, 1.5), (block * 16, 2.0)):
        blk = max(blk, 2)
        g = size // blk + 2
        grid = torch.rand(n, 1, g, g, generator=gen, device=device)
        up = F.interpolate(grid, size=(g * blk, g * blk), mode="bilinear", align_corners=True)
        tex += weight * up[:, 0, :size, :size]
    lo = tex.amin(dim=(1, 2), keepdim=True)
    tex = tex - lo
    tex = tex * (contrast / tex.amax(dim=(1, 2), keepdim=True).clamp(min=1e-6))
    return (tex + 30.0).clamp(0, 255)


def room(gen: torch.Generator, device=None) -> List[Plane]:
    """The port's ``default_room`` layout: back wall, floor, ceiling, two
    side walls and a box face, each with its own texture."""
    walls = block_textures(gen, 5, device=device)
    box = block_textures(gen, 1, block=6, device=device)
    return [
        Plane(2, 5.0, (-4.0, 4.0, -3.0, 3.0), walls[0]),
        Plane(1, 1.6, (-4.0, 4.0, 0.0, 5.0), walls[1]),
        Plane(1, -1.6, (-4.0, 4.0, 0.0, 5.0), walls[2]),
        Plane(0, -2.5, (-3.0, 3.0, 0.0, 5.0), walls[3]),
        Plane(0, 2.5, (-3.0, 3.0, 0.0, 5.0), walls[4]),
        Plane(2, 3.0, (-0.8, 0.4, -0.6, 0.6), box[0]),
    ]


def mover(gen: torch.Generator, x0: np.ndarray, size=(0.7, 2.0), depth: float = 2.6,
          y_top: float = -1.1, device=None) -> Plane:
    """``room_with_mover``'s mover: a frontal textured plane of ``size``
    (m) at z = ``depth`` whose left edge is at ``x0[i]`` in frame i; its
    texture rides with it."""
    x = torch.as_tensor(np.asarray(x0, np.float64), device=device)
    w, h = size
    bounds = torch.stack([x, x + w, torch.full_like(x, y_top), torch.full_like(x, y_top + h)], 1)
    anchor = torch.stack([x, torch.zeros_like(x)], 1)
    tex = block_textures(gen, 1, block=6, device=device)[0]
    return Plane(2, depth, bounds, tex, tex_scale=90.0, anchor=anchor)


def _per_frame(v, idx, dtype):
    """A plane's constant tuple as floats, or its rows for frames ``idx``
    as k columns of shape (n, 1, 1)."""
    if isinstance(v, torch.Tensor):
        rows = v[idx].to(dtype)
        return [rows[:, j, None, None] for j in range(rows.shape[1])]
    return [float(x) for x in v]


def _sample(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    T1, T0 = tex.shape[1] - 1, tex.shape[0] - 1
    iu = torch.remainder(u * scale, T1)
    iv = torch.remainder(v * scale, T0)
    # in float32 a remainder can round up to the divisor itself
    x0, y0 = iu.floor().clamp(max=T1 - 1), iv.floor().clamp(max=T0 - 1)
    fx, fy = iu - x0, iv - y0
    x0, y0 = x0.long(), y0.long()
    flat = tex.reshape(-1).to(u.dtype)
    W = tex.shape[1]

    def at(y, x):
        return flat[y * W + x]

    return (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
            + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)


def render(planes: Sequence[Plane], Tcw: np.ndarray, idx: Optional[np.ndarray] = None,
           fx=535.4, fy=539.2, cx=320.1, cy=247.6, width=640, height=480,
           dtype=torch.float32, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raycast ``planes`` from camera poses ``Tcw`` (n, 4, 4) -> grey (n, H,
    W) and z-depth (n, H, W) [m, 0 where nothing is hit], in ``dtype``.
    ``idx``: the frame index of each pose, selecting moving planes' rows
    (default 0..n-1)."""
    Tcw = np.asarray(Tcw, np.float64).reshape(-1, 4, 4)
    n = Tcw.shape[0]
    idx = np.arange(n) if idx is None else np.asarray(idx)
    Twc = torch.as_tensor(np.linalg.inv(Tcw), dtype=dtype, device=device)
    Rwc, twc = Twc[:, :3, :3], Twc[:, :3, 3]
    xs = (torch.arange(width, dtype=dtype, device=device) - cx) / fx
    ys = (torch.arange(height, dtype=dtype, device=device) - cy) / fy
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    dirs_c = torch.stack([gx, gy, torch.ones_like(gx)], -1)            # (H, W, 3)
    dirs = torch.einsum("hwk,njk->nhwj", dirs_c, Rwc)                  # (n, H, W, 3)
    best = torch.full((n, height, width), math.inf, dtype=dtype, device=device)
    gray = torch.zeros((n, height, width), dtype=dtype, device=device)
    sel = torch.as_tensor(idx)
    for pl in planes:
        a = pl.axis
        fa, fb = FREE_AXES[a]
        dz = dirs[..., a]
        safe = torch.where(dz.abs() < 1e-9, torch.full_like(dz, 1e-9), dz)
        t = (pl.value - twc[:, a, None, None]) / safe
        pa = twc[:, fa, None, None] + t * dirs[..., fa]
        pb = twc[:, fb, None, None] + t * dirs[..., fb]
        b = _per_frame(pl.bounds, sel, dtype)
        anc = _per_frame(pl.anchor, sel, dtype)
        hit = ((t > 0.05) & (t < best) & (pa >= b[0]) & (pa <= b[1])
               & (pb >= b[2]) & (pb <= b[3]))
        val = _sample(pl.texture, pa - anc[0], pb - anc[1], pl.tex_scale)
        gray = torch.where(hit, val, gray)
        best = torch.where(hit, t, best)
    depth = torch.where(torch.isfinite(best), best, torch.zeros_like(best))
    return gray, depth


def _rot(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """Rotation yaw about y, then pitch about x, then roll about z."""
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cr, sr = math.cos(roll), math.sin(roll)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return Ry @ Rx @ Rz


# the handheld path's shape: (frequency Hz, phase, relative amplitude) per
# axis of translation (x, y, z) and of rotation (yaw, pitch, roll)
PATH_T = ((0.15, 0.0, 1.0), (0.21, 1.0, 0.5), (0.12, 2.0, 0.7))
PATH_R = ((0.13, 0.5, 1.0), (0.19, 1.5, 0.6), (0.23, 0.0, 0.3))


def _path(n: int, fps: float, a_t: float, a_r: float, base) -> np.ndarray:
    t = np.arange(n) / fps
    pos = np.stack([base[k] + a_t * amp * np.sin(2 * np.pi * f * t + ph)
                    for k, (f, ph, amp) in enumerate(PATH_T)], 1)
    ang = np.stack([a_r * amp * np.sin(2 * np.pi * f * t + ph) for f, ph, amp in PATH_R], 1)
    Twc = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        Twc[i, :3, :3] = _rot(*ang[i])
        Twc[i, :3, 3] = pos[i]
    return Twc


def _speeds(Twc: np.ndarray, fps: float) -> Tuple[float, float]:
    """Mean translational (m/s) and rotational (deg/s) speed."""
    v = np.linalg.norm(np.diff(Twc[:, :3, 3], axis=0), axis=1).mean() * fps
    rel = np.einsum("nji,njk->nik", Twc[:-1, :3, :3], Twc[1:, :3, :3])
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    return float(v), float(np.degrees(np.arccos(cos)).mean() * fps)


def handheld_path(n: int, fps: float, speed: float, turn_deg: float,
                  base=(0.0, 0.0, 0.4)) -> np.ndarray:
    """(n, 4, 4) camera-from-world poses of a smooth handheld motion about
    ``base`` whose mean speeds over the n frames are ``speed`` m/s and
    ``turn_deg`` deg/s (amplitudes found by fixed-point iteration)."""
    a_t, a_r = 0.3, math.radians(10.0)
    for _ in range(20):
        v, w = _speeds(_path(n, fps, a_t, a_r, base), fps)
        a_t *= speed / v
        a_r *= turn_deg / w
    return np.linalg.inv(_path(n, fps, a_t, a_r, base))


def back_and_forth(n: int, fps: float, speed: float, lo: float, hi: float) -> np.ndarray:
    """x of a point that walks from ``lo`` to ``hi`` and back at ``speed``
    m/s, at each of n frames."""
    span = hi - lo
    s = (np.arange(n) / fps * speed) % (2 * span)
    return lo + np.where(s <= span, s, 2 * span - s)


def playback(k, n: int):
    """Frame of an n-frame sequence played forward and back, for step k."""
    period = 2 * n - 2
    i = np.asarray(k) % period
    return np.where(i < n, i, period - i)

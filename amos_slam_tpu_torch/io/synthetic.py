"""Synthetic RGB-D scene renderer (test/bench fixture).

The reference validates end-to-end on TUM sequences it does not vendor
(SURVEY.md section 4); this module provides a self-contained substitute: a
textured axis-aligned "room" raycast at any camera pose, yielding (gray,
depth) pairs with perfect ground truth. Pure NumPy on the host -- it is data
generation, not framework compute.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class Plane:
    """Axis-aligned textured rectangle.

    axis: 0/1/2 -> the fixed coordinate (x/y/z = value).
    bounds: (lo_a, hi_a, lo_b, hi_b) extents in the two free axes
    (free axes in ascending order, e.g. axis=2 -> free (x, y)).
    """

    axis: int
    value: float
    bounds: Tuple[float, float, float, float]
    texture: np.ndarray
    tex_scale: float = 80.0  # texture pixels per world unit
    # chroma tint (r, g, b) weights, luma-normalized at render time so the
    # GRAYSCALE image is identical whatever the tint -- lets tests build
    # luma-matched but chroma-distinct surfaces (the CIELAB SLIC contract)
    chroma: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # texture anchor in the plane's free-axis coordinates: texture is
    # sampled at (pa - anchor_a, pb - anchor_b). Default (0, 0) keeps the
    # texture fixed in WORLD space -- correct for static walls. A moving
    # plane must move its anchor along with its bounds, or the render is a
    # sliding window over static texture (no apparent motion -> no LK
    # signal, which silently defeats any mover test).
    tex_anchor: Tuple[float, float] = (0.0, 0.0)


def _block_texture(rng, size=256, block=8, contrast=180.0):
    """Multi-octave value noise: corner-dense yet locally *unique* texture.

    A single-scale block pattern aliases -- every block corner looks like
    every other, and projection-window matching locks onto the wrong one as
    soon as the motion prediction overshoots. Mixing octaves makes each
    neighborhood distinctive while keeping plenty of FAST corners.
    """
    from scipy.ndimage import zoom

    tex = np.zeros((size, size))
    for blk, weight in ((block // 2, 0.5), (block, 1.0), (block * 4, 1.5), (block * 16, 2.0)):
        blk = max(blk, 2)
        n = size // blk + 2
        octave = zoom(rng.uniform(0, 1, (n, n)), blk, order=1)[:size, :size]
        tex += weight * octave
    tex -= tex.min()
    tex *= contrast / max(tex.max(), 1e-6)
    return np.clip(tex + 30.0, 0, 255).astype(np.float32)


def default_room(seed: int = 0) -> List[Plane]:
    rng = np.random.default_rng(seed)
    return [
        Plane(2, 5.0, (-4.0, 4.0, -3.0, 3.0), _block_texture(rng)),   # back wall
        Plane(1, 1.6, (-4.0, 4.0, 0.0, 5.0), _block_texture(rng)),    # floor
        Plane(1, -1.6, (-4.0, 4.0, 0.0, 5.0), _block_texture(rng)),   # ceiling
        Plane(0, -2.5, (-3.0, 3.0, 0.0, 5.0), _block_texture(rng)),   # left wall
        Plane(0, 2.5, (-3.0, 3.0, 0.0, 5.0), _block_texture(rng)),    # right wall
        Plane(2, 3.0, (-0.8, 0.4, -0.6, 0.6), _block_texture(rng, block=6)),  # box face
    ]


def room_with_mover(seed: int = 0, t: float = 0.0, speed: float = 1.2):
    """The default room plus one *moving* frontal plane (a stand-in for the
    walking person in TUM fr3/walking): at time ``t`` (seconds) the plane
    has translated ``speed * t`` in x. Returns (planes, mover_index)."""
    rng = np.random.default_rng(seed + 77)
    planes = default_room(seed)
    x0 = -1.2 + speed * t
    mover = Plane(
        2, 2.6, (x0, x0 + 0.7, -1.1, 0.9),
        _block_texture(rng, block=6), tex_scale=90.0,
        tex_anchor=(x0, 0.0),   # texture rides with the plane: real motion
    )
    planes.append(mover)
    return planes, len(planes) - 1


def weak_room(seed: int, contrast: float = 70.0) -> List[Plane]:
    """The default room's layout with low-contrast texture: few strong
    corners, so a textured mover owns most of them."""
    rng = np.random.default_rng(seed)

    def tex(**kw):
        return _block_texture(rng, contrast=contrast, **kw)

    return [
        Plane(2, 5.0, (-4.0, 4.0, -3.0, 3.0), tex()),
        Plane(1, 1.6, (-4.0, 4.0, 0.0, 5.0), tex()),
        Plane(1, -1.6, (-4.0, 4.0, 0.0, 5.0), tex()),
        Plane(0, -2.5, (-3.0, 3.0, 0.0, 5.0), tex()),
        Plane(0, 2.5, (-3.0, 3.0, 0.0, 5.0), tex()),
        Plane(2, 3.0, (-0.8, 0.4, -0.6, 0.6), tex(block=6)),
    ]


def _dominant_mover(x0: float) -> Plane:
    """A large high-contrast frontal plane whose texture rides with it."""
    return Plane(2, 1.6, (x0, x0 + 1.2, -1.2, 1.2),
                 _block_texture(np.random.default_rng(99), block=6, contrast=200.0),
                 tex_scale=90.0, tex_anchor=(x0, 0.0))


def dominant_mover_frames(n: int = 24, **render_kw):
    """A textured mover crossing a weakly textured room, present from the
    first frame (a person walking past plain walls). Returns (poses,
    [(gray, depth, mover_mask)])."""
    poses = orbit_trajectory(n, radius=0.1, advance=0.2)
    frames = []
    for i in range(n):
        planes = weak_room(1) + [_dominant_mover(-1.5 + 2.0 * (i / 30.0))]
        g, d, ids = render(planes, poses[i], return_ids=True, **render_kw)
        frames.append((g, d, ids == len(planes) - 1))
    return poses, frames


def entering_mover_frames(n: int = 24, enter_at: int = 6, with_masks: bool = False,
                          **render_kw):
    """The dominant mover entering after the map is initialized (frames
    0..enter_at-1 static). Returns (poses, [(gray, depth, mask)]): the mask
    is the mover's (with_masks, from frame enter_at on) or None."""
    poses = orbit_trajectory(n, radius=0.1, advance=0.2)
    frames = []
    for i in range(n):
        planes = weak_room(1)
        if i >= enter_at:
            planes.append(_dominant_mover(-1.5 + 2.0 * (i / 30.0 - enter_at / 30.0)))
        if with_masks and i >= enter_at:
            g, d, ids = render(planes, poses[i], return_ids=True, **render_kw)
            frames.append((g, d, ids == len(planes) - 1))
        else:
            g, d = render(planes, poses[i], **render_kw)
            frames.append((g, d, None))
    return poses, frames


def luma_matched_mover(t: float):
    """A room plus a mover whose grey texture comes from the walls'
    generator (luma-matched), at near the back wall's depth, with a strong
    chroma tint: only colour separates it. Returns (planes, mover_index)."""
    rng = np.random.default_rng(5)
    planes = [
        Plane(2, 5.0, (-4.0, 4.0, -3.0, 3.0), _block_texture(rng)),
        Plane(1, 1.6, (-4.0, 4.0, 0.0, 5.0), _block_texture(rng)),
        Plane(1, -1.6, (-4.0, 4.0, 0.0, 5.0), _block_texture(rng)),
        Plane(0, -2.5, (-3.0, 3.0, 0.0, 5.0), _block_texture(rng)),
        Plane(0, 2.5, (-3.0, 3.0, 0.0, 5.0), _block_texture(rng)),
    ]
    x0 = -1.0 + 1.8 * t
    planes.append(Plane(2, 4.75, (x0, x0 + 1.1, -1.0, 1.0),
                        _block_texture(np.random.default_rng(99)),
                        chroma=(1.6, 0.85, 0.55), tex_anchor=(x0, 0.0)))
    return planes, len(planes) - 1


def _sample_tex(tex, u, v, scale):
    iu = np.mod(u * scale, tex.shape[1] - 1)
    iv = np.mod(v * scale, tex.shape[0] - 1)
    x0 = np.floor(iu).astype(np.int64)
    y0 = np.floor(iv).astype(np.int64)
    fx = iu - x0
    fy = iv - y0
    t00 = tex[y0, x0]
    t01 = tex[y0, x0 + 1]
    t10 = tex[y0 + 1, x0]
    t11 = tex[y0 + 1, x0 + 1]
    return (
        t00 * (1 - fx) * (1 - fy)
        + t01 * fx * (1 - fy)
        + t10 * (1 - fx) * fy
        + t11 * fx * fy
    )


def render(
    planes: List[Plane],
    Tcw: np.ndarray,
    fx=535.4, fy=539.2, cx=320.1, cy=247.6,
    width=640, height=480,
    return_ids: bool = False,
    return_rgb: bool = False,
):
    """Raycast the scene from camera pose Tcw -> (gray, depth[, plane_ids]
    [, rgb]).

    plane_ids: (H, W) int32, index into ``planes`` of the visible surface
    (-1 = background). Used as a ground-truth instance mask when testing the
    dynamic-rejection / segmentation stack.
    rgb: (H, W, 3) uint8, each plane's texture tinted by its luma-normalized
    ``chroma`` -- gray stays bit-identical to the no-color render."""
    Twc = np.linalg.inv(Tcw)
    Rwc, twc = Twc[:3, :3], Twc[:3, 3]
    xs = (np.arange(width, dtype=np.float64) - cx) / fx
    ys = (np.arange(height, dtype=np.float64) - cy) / fy
    gx, gy = np.meshgrid(xs, ys)
    dirs_c = np.stack([gx, gy, np.ones_like(gx)], axis=-1)      # z=1 rays
    dirs_w = dirs_c @ Rwc.T                                      # (H,W,3)

    best_t = np.full((height, width), np.inf)
    gray = np.zeros((height, width), np.float32)
    ids = np.full((height, width), -1, np.int32)
    rgb = np.zeros((height, width, 3), np.float32) if return_rgb else None
    _LUMA = np.asarray([0.2126, 0.7152, 0.0722])

    free_axes = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
    for pid, pl in enumerate(planes):
        a = pl.axis
        fa, fb = free_axes[a]
        dz = dirs_w[..., a]
        safe = np.where(np.abs(dz) < 1e-9, 1e-9, dz)
        t = (pl.value - twc[a]) / safe
        pa = twc[fa] + t * dirs_w[..., fa]
        pb = twc[fb] + t * dirs_w[..., fb]
        lo_a, hi_a, lo_b, hi_b = pl.bounds
        hit = (
            (t > 0.05)
            & (t < best_t)
            & (pa >= lo_a) & (pa <= hi_a)
            & (pb >= lo_b) & (pb <= hi_b)
        )
        if not hit.any():
            continue
        val = _sample_tex(
            pl.texture,
            pa[hit] - pl.tex_anchor[0],
            pb[hit] - pl.tex_anchor[1],
            pl.tex_scale,
        )
        gray[hit] = val.astype(np.float32)
        best_t[hit] = t[hit]
        ids[hit] = pid
        if return_rgb:
            ch = np.asarray(pl.chroma, np.float64)
            ch = ch / max(float(ch @ _LUMA), 1e-6)   # luma-normalize
            rgb[hit] = np.clip(
                val[:, None] * ch[None, :], 0, 255
            ).astype(np.float32)

    depth = np.where(np.isfinite(best_t), best_t, 0.0).astype(np.float32)
    out = [gray, depth]
    if return_ids:
        out.append(ids)
    if return_rgb:
        out.append(rgb.astype(np.uint8))
    return tuple(out) if len(out) > 2 else (gray, depth)


def orbit_trajectory(n_frames: int, radius=0.25, advance=0.4, yaw_amp=0.06):
    """Smooth test trajectory: gentle lateral sway + slow forward motion.

    Returns a list of (4,4) float64 Tcw ground-truth poses.
    """
    from scipy.spatial.transform import Rotation as _R  # lazy; scipy is baked in

    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        tx = radius * np.sin(2 * np.pi * s)
        ty = 0.08 * np.sin(4 * np.pi * s + 1.0)
        tz = advance * s
        yaw = yaw_amp * np.sin(2 * np.pi * s + 0.5)
        pitch = 0.03 * np.sin(2 * np.pi * s * 2)
        Rwc = _R.from_euler("yxz", [yaw, pitch, 0.0]).as_matrix()
        Twc = np.eye(4)
        Twc[:3, :3] = Rwc
        Twc[:3, 3] = [tx, ty, tz]
        poses.append(np.linalg.inv(Twc))
    return poses


def out_and_back(n_out: int, radius=0.25, advance=0.4, yaw_amp=0.06):
    """Loop-closing fixture: ``orbit_trajectory(n_out, ...)`` forward, then
    reversed, then the start revisited (tests/test_loop_pipeline.py:31-34).
    Returns 2 * n_out + 2 poses."""
    fwd = orbit_trajectory(n_out, radius=radius, advance=advance, yaw_amp=yaw_amp)
    return fwd + fwd[::-1][1:] + [fwd[0], fwd[1], fwd[0]]


def sweep_and_return(n_sweep: int, n_over: int, n_tail: int, yaw=1.4, pitch=1.2,
                     x0=0.0, z0=1.5, sway=0.1):
    """Loop-closing fixture in ``default_room``: from (x0, 0, z0) the camera
    sweeps its yaw from the left wall (-yaw) across the back wall to the
    right wall (+yaw) in ``n_sweep`` frames, comes back to the left wall over
    the ceiling (pitched up by ``pitch`` at mid-way) in ``n_over`` frames,
    then repeats the first ``n_tail`` frames of the sweep; ``sway`` m of
    translation gives parallax. The way back sees only the ceiling, so the
    tracker meets the start's wall with landmarks of its own and the loop
    closer, not the local map, has to join them (an out-and-back re-finds
    the way out's landmarks all the way home). Returns Tcw poses."""
    from scipy.spatial.transform import Rotation as _R

    def tcw(x, z, yw, p):
        Twc = np.eye(4)
        Twc[:3, :3] = _R.from_euler("yxz", [yw, p, 0.0]).as_matrix()
        Twc[:3, 3] = [x, 0.0, z]
        return np.linalg.inv(Twc)

    ease = lambda u: (1.0 - np.cos(np.pi * u)) / 2.0   # noqa: E731
    poses = []
    for i in range(n_sweep):
        u = i / n_sweep
        poses.append(tcw(x0 + sway * np.sin(np.pi * u), z0, yaw * (2 * ease(u) - 1), 0.0))
    for i in range(n_over):
        u = i / n_over
        s = np.sin(np.pi * u)
        poses.append(tcw(x0 + sway * s, z0 - sway * s, yaw * (1 - 2 * ease(u)), pitch * s))
    return poses + poses[:n_tail]


def render_many(planes: List[Plane], poses, workers: int = 1, **kw):
    """(gray, depth) of every pose, rendered by ``workers`` spawned
    processes (the caller may hold CUDA state and threads: no fork)."""
    if workers <= 1:
        return [render(planes, T, **kw) for T in poses]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from functools import partial

    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(partial(render, planes, **kw), poses,
                           chunksize=max(1, len(poses) // (4 * workers))))

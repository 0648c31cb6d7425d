"""Real-imagery RGB-D replay: synthesize a tracked sequence from ONE real
photograph with exactly known geometry (port of io/warp_replay.py; numpy
only).

The repository vendors no full TUM sequence, but the reference ships real
640x480 TUM office frames (``src/python/input/*.png`` of its repository;
:data:`REF_INPUT_DIR` is where a copy of it sits inside this checkout).
This module turns such a frame into a geometrically consistent RGB-D
sequence: the photo becomes the texture of a (slightly tilted) plane in
space, and each output frame renders that plane from a camera pose --
image by homography warp, depth analytically. Ground truth is exact by
construction, so a full System run over the sequence yields a
real-imagery end-to-end ATE (the role of the reference's rgbd_tum main +
offline ATE tooling, Examples/RGB-D/rgbd_tum.cc:58-176).

The texture is real (real gradients, real corner statistics, real
descriptor aliasing); only the scene geometry is synthetic. Any texture
works: the tests use a synthetic one.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np


def plane_replay_frame(
    tex: np.ndarray,          # (H, W) float gray texture, seen from identity
    cam,                      # geometry.camera.Camera (fx, fy, cx, cy)
    Tcw: np.ndarray,          # (4, 4) camera-from-world pose to render from
    plane_n: Tuple[float, float, float] = (0.06, -0.04, 1.0),
    plane_d: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render (gray, depth) of the textured plane ``plane_n . X = plane_d``
    (world frame = the identity base camera that sees ``tex``) from pose
    ``Tcw``. Depth is the analytic ray-plane distance; pixels whose ray
    misses the plane or whose texture lookup leaves the base frame come
    back as 0 (invalid), exactly like a real sensor dropout."""
    h, w = tex.shape
    fx, fy, cx, cy = (float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy))
    n = np.asarray(plane_n, np.float64)
    n = n / np.linalg.norm(n)
    d = float(plane_d)

    R = np.asarray(Tcw, np.float64)[:3, :3]
    t = np.asarray(Tcw, np.float64)[:3, 3]
    Rwc = R.T
    twc = -R.T @ t

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    rx = (xs - cx) / fx
    ry = (ys - cy) / fy
    rays = np.stack([rx, ry, np.ones_like(rx)], -1)          # camera rays
    rw = rays @ Rwc.T                                         # world dirs
    denom = rw @ n
    num = d - twc @ n
    with np.errstate(divide="ignore", invalid="ignore"):
        z = num / denom                                       # ray depth
    valid = (denom != 0) & (z > 0.05) & (z < 50.0)
    z = np.where(valid, z, 0.0)
    Xw = twc[None, None, :] + rw * z[..., None]

    # texture lookup in the base (identity) camera
    with np.errstate(divide="ignore", invalid="ignore"):
        u = fx * Xw[..., 0] / Xw[..., 2] + cx
        v = fy * Xw[..., 1] / Xw[..., 2] + cy
    valid &= (Xw[..., 2] > 0.05) & (u >= 0) & (u <= w - 1.001) & \
        (v >= 0) & (v <= h - 1.001)
    u = np.where(valid, u, 0.0)
    v = np.where(valid, v, 0.0)
    x0 = np.floor(u).astype(int)
    y0 = np.floor(v).astype(int)
    ax, ay = u - x0, v - y0
    g = (
        tex[y0, x0] * (1 - ax) * (1 - ay)
        + tex[y0, np.minimum(x0 + 1, w - 1)] * ax * (1 - ay)
        + tex[np.minimum(y0 + 1, h - 1), x0] * (1 - ax) * ay
        + tex[np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)] * ax * ay
    )
    gray = np.where(valid, g, 0.0).astype(np.float32)
    depth = np.where(valid, z, 0.0).astype(np.float32)
    return gray, depth


def plane_replay_sequence(
    tex: np.ndarray, cam, poses: Sequence[np.ndarray], **kw
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """[(gray, depth)] for each pose (ground truth = ``poses``)."""
    return [plane_replay_frame(tex, cam, T, **kw) for T in poses]


REF_INPUT_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "reference", "src",
    "python", "input")


def load_reference_frame(path: str = None) -> np.ndarray:
    """Load one of the reference's shipped real TUM frames as float gray
    (returns None when the asset is absent -- callers skip)."""
    if path is None:
        path = os.path.join(REF_INPUT_DIR, "1341846313.553992.png")
    if not os.path.exists(path):
        return None
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), np.float32)


def load_reference_frames() -> list:
    """All shipped real frames (possibly empty)."""
    out = []
    if os.path.isdir(REF_INPUT_DIR):
        for f in sorted(os.listdir(REF_INPUT_DIR)):
            if f.endswith(".png"):
                img = load_reference_frame(os.path.join(REF_INPUT_DIR, f))
                if img is not None:
                    out.append(img)
    return out


def _real_crops(n: int, size: int = 256, seed: int = 0):
    """``n`` distinct (size, size) texture crops from the real frames,
    or None when the assets are absent. Crops are contrast-stretched so
    every surface has trackable gradient (some office-frame regions are
    near-uniform wall)."""
    frames = load_reference_frames()
    if not frames:
        return None
    rng = np.random.default_rng(seed)
    crops = []
    tries = 0
    while len(crops) < n and tries < 50 * n:
        tries += 1
        img = frames[rng.integers(len(frames))]
        h, w = img.shape
        y = int(rng.integers(0, h - size)) if h > size else 0
        x = int(rng.integers(0, w - size)) if w > size else 0
        c = img[y : y + size, x : x + size].astype(np.float64)
        if c.std() < 12.0:   # featureless wall region: no corners to track
            continue
        c -= c.min()
        c *= 200.0 / max(c.max(), 1e-6)
        crops.append(np.clip(c + 25.0, 0, 255).astype(np.float32))
    if not crops:
        return None
    n_distinct = len(crops)
    while len(crops) < n:   # fallback: reuse (different planes, same tex)
        crops.append(crops[len(crops) % n_distinct])
    return crops


def real_room(seed: int = 0):
    """Multi-plane room with REAL-photograph textures: the default_room
    geometry (back wall, floor, ceiling, two side walls, plus a frontal
    occluding box that creates genuine depth discontinuities) where every
    surface is textured with a crop of the reference's shipped real TUM
    office frames -- real gradients, corner statistics and descriptor
    aliasing on a scene with occlusion, unlike the single-plane
    plane_replay harness. Returns
    list[synthetic.Plane], or None when the real assets are absent."""
    from .synthetic import Plane

    crops = _real_crops(6, seed=seed)
    if crops is None:
        return None
    return [
        Plane(2, 5.0, (-4.0, 4.0, -3.0, 3.0), crops[0]),   # back wall
        Plane(1, 1.6, (-4.0, 4.0, 0.0, 5.0), crops[1]),    # floor
        Plane(1, -1.6, (-4.0, 4.0, 0.0, 5.0), crops[2]),   # ceiling
        Plane(0, -2.5, (-3.0, 3.0, 0.0, 5.0), crops[3]),   # left wall
        Plane(0, 2.5, (-3.0, 3.0, 0.0, 5.0), crops[4]),    # right wall
        # occluding box face in front of the back wall
        Plane(2, 3.0, (-0.8, 0.4, -0.6, 0.6), crops[5], tex_scale=120.0),
    ]


def real_room_with_mover(seed: int = 0, t: float = 0.0, speed: float = 1.2):
    """real_room plus one REAL-textured moving frontal plane (the walking
    person of TUM fr3/walking with real image statistics): at time ``t``
    the plane has translated ``speed * t`` in x. Returns
    (planes, mover_index), or (None, -1) when the assets are absent."""
    from .synthetic import Plane

    planes = real_room(seed)
    if planes is None:
        return None, -1
    crops = _real_crops(1, size=224, seed=seed + 991)
    x0 = -1.2 + speed * t
    mover = Plane(
        2, 2.6, (x0, x0 + 0.7, -1.1, 0.9), crops[0], tex_scale=110.0,
        tex_anchor=(x0, 0.0),   # texture rides with the plane: real motion
    )
    planes.append(mover)
    return planes, len(planes) - 1

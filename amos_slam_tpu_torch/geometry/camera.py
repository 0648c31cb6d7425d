"""Pinhole camera with OpenCV radial-tangential distortion (port of
geometry/camera.py). Batched over arbitrary leading dims."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    """Camera parameters: 0-d f32 tensors (``dist`` is (5,)) on one device,
    plus the static image size.

    dist = (k1, k2, p1, p2, k3); bf = baseline * fx for stereo/RGB-D.
    """

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # (5,)
    bf: torch.Tensor
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, dist=None, bf=0.0, width=640, height=480,
               device="cpu"):
        f32 = dict(dtype=torch.float32, device=device)
        d = torch.zeros(5, **f32)
        if dist is not None:
            dv = torch.as_tensor(dist, **f32).reshape(-1)
            d[: dv.shape[0]] = dv
        return Camera(
            fx=torch.tensor(fx, **f32), fy=torch.tensor(fy, **f32),
            cx=torch.tensor(cx, **f32), cy=torch.tensor(cy, **f32),
            dist=d, bf=torch.tensor(bf, **f32),
            width=int(width), height=int(height),
        )

    @property
    def K(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack(
            [
                torch.stack([self.fx, z, self.cx], -1),
                torch.stack([z, self.fy, self.cy], -1),
                torch.stack([z, z, o], -1),
            ],
            dim=-2,
        )


def project(cam: Camera, pts_c: torch.Tensor, eps: float = 1e-6):
    """Camera-frame points (...,3) -> pixel coords (...,2) and depth (...,).

    Pure pinhole: matching works on undistorted keypoints."""
    z = pts_c[..., 2]
    inv_z = 1.0 / torch.clamp(z, min=eps)
    u = cam.fx * pts_c[..., 0] * inv_z + cam.cx
    v = cam.fy * pts_c[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1), z


def project_stereo(cam: Camera, pts_c: torch.Tensor, eps: float = 1e-6):
    """Camera-frame points (...,3) -> (u, v, u_right) (...,3) and depth
    (...,), the reference's stereo edges."""
    uv, z = project(cam, pts_c, eps)
    ur = uv[..., 0] - cam.bf / torch.clamp(z, min=eps)
    return torch.cat([uv, ur[..., None]], dim=-1), z


def backproject(cam: Camera, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Undistorted pixels (...,2) + depth (...,) -> camera-frame points (...,3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def distort_normalized(cam: Camera, xy: torch.Tensor) -> torch.Tensor:
    """Apply the 5-coefficient distortion to normalized coords (...,2)."""
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: Camera, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Undistort raw pixel keypoints (...,2) -> undistorted pixels (...,2) by
    the fixed-point iteration of cv::undistortPoints (static trip count)."""
    x0 = (uv[..., 0] - cam.cx) / cam.fx
    y0 = (uv[..., 1] - cam.cy) / cam.fy
    xy0 = torch.stack([x0, y0], dim=-1)
    xy = xy0
    for _ in range(iters):
        d = distort_normalized(cam, xy) - xy
        xy = xy0 - d
    u = xy[..., 0] * cam.fx + cam.cx
    v = xy[..., 1] * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1)


def in_image(cam: Camera, uv: torch.Tensor, border: float = 0.0) -> torch.Tensor:
    """Visibility mask for pixel coords (...,2)."""
    u, v = uv[..., 0], uv[..., 1]
    return (
        (u >= border)
        & (u < cam.width - border)
        & (v >= border)
        & (v < cam.height - border)
    )

"""Structure-only refinement: per-landmark Gauss-Newton with poses fixed
(port of solvers/structure_only.py).

With camera poses held fixed, every landmark's 3-parameter problem is
independent: M simultaneous 3x3 Gauss-Newton solves over padded (M, OBS)
observation tables. Its only user is ``loop.global_ba.run_global_refinement``.
"""

from __future__ import annotations

import torch

from ..geometry.camera import Camera
from .robust import CHI2_MONO, huber_weight, inv3x3


def refine_points(
    cam: Camera,
    points: torch.Tensor,       # (M, 3) initial positions
    point_valid: torch.Tensor,  # (M,)
    poses: torch.Tensor,        # (M, OBS, 4, 4) observing keyframe poses
    uv: torch.Tensor,           # (M, OBS, 2) pixel observations
    obs_valid: torch.Tensor,    # (M, OBS)
    inv_sigma2: torch.Tensor,   # (M, OBS)
    iters: int = 4,
):
    """Returns (refined_points (M, 3), mean chi2 per point (M,))."""
    R = poses[..., :3, :3]
    t = poses[..., :3, 3]
    eye = torch.eye(3, dtype=points.dtype, device=points.device)

    def project(X):
        pc = torch.einsum("moij,mj->moi", R, X) + t
        z = torch.clamp(pc[..., 2], min=1e-6)
        u = cam.fx * pc[..., 0] / z + cam.cx
        v = cam.fy * pc[..., 1] / z + cam.cy
        return pc, z, u, v

    X = points
    for _ in range(iters):
        pc, z, u, v = project(X)
        r = torch.stack([uv[..., 0] - u, uv[..., 1] - v], dim=-1)   # (M, OBS, 2)
        chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
        w = (huber_weight(chi2, CHI2_MONO) * inv_sigma2 * obs_valid
             * (pc[..., 2] > 1e-3))
        zero = torch.zeros_like(z)
        inv_z = 1.0 / z
        du = torch.stack([cam.fx * inv_z, zero, -cam.fx * pc[..., 0] * inv_z ** 2], -1)
        dv = torch.stack([zero, cam.fy * inv_z, -cam.fy * pc[..., 1] * inv_z ** 2], -1)
        dproj = torch.stack([du, dv], dim=-2)                      # (M, OBS, 2, 3)
        J = -torch.einsum("moij,mojk->moik", dproj, R)
        Jw = J * w[..., None, None]
        H = torch.einsum("modi,modj->mij", Jw, J) + eye * 1e-6   # (M, 3, 3)
        g = torch.einsum("modi,mod->mi", Jw, r)
        dx = -torch.einsum("mij,mj->mi", inv3x3(H), g)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        has = torch.sum(w, dim=-1) > 0
        X = torch.where((point_valid & has)[:, None], X + dx, X)
    _, _, u, v = project(X)
    chi2 = ((uv[..., 0] - u) ** 2 + (uv[..., 1] - v) ** 2) * inv_sigma2
    n = torch.clamp(torch.sum(obs_valid, dim=-1), min=1)
    return X, torch.sum(torch.where(obs_valid > 0, chi2, 0.0), dim=-1) / n

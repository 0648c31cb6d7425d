"""Motion-only pose optimization (port of solvers/pose_opt.py).

Optimizer::PoseOptimization (src/Optimizer.cc:363-627): mono and stereo
reprojection edges on one SE3 pose, rounds of LM iterations with chi2
outlier reclassification between rounds (5.991 / 7.815, Huber). Analytic
2x6 / 3x6 Jacobian blocks for all N observations at once; the 6x6 normal
equations are one contraction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.camera import Camera
from .robust import CHI2_MONO, CHI2_STEREO, huber_weight, solve_damped


class PoseObs(NamedTuple):
    """Padded observation set for one pose solve.

    points_w: (N,3) world points; uv: (N,2) undistorted pixel obs;
    u_right: (N,) right-image u for stereo/RGB-D obs (<0 = mono obs);
    inv_sigma2: (N,) information scale of the pyramid level;
    valid: (N,) bool mask of real (non-padding) observations.
    """

    points_w: torch.Tensor
    uv: torch.Tensor
    u_right: torch.Tensor
    inv_sigma2: torch.Tensor
    valid: torch.Tensor


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor          # (4,4) optimized pose
    inlier: torch.Tensor       # (N,) bool final inlier classification
    num_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor         # (N,) final per-obs chi2 (0 where invalid)


def _residual_jacobian(Tcw: torch.Tensor, cam: Camera, obs: PoseObs):
    """Residuals r (N,3), Jacobians J (N,3,6), chi2 per obs.

    Mono observations use the first two residual rows. Perturbation model
    T' = exp(xi) @ T, so d(pc)/d(xi) = [I | -hat(pc)] for xi = [rho, phi].
    """
    pc = se3.transform_points(Tcw, obs.points_w)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    inv_z = 1.0 / torch.clamp(z, min=1e-6)
    inv_z2 = inv_z * inv_z

    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z

    is_stereo = obs.u_right >= 0.0
    zero = torch.zeros_like(z)
    one = torch.ones_like(z)
    r_u = obs.uv[..., 0] - u
    r_v = obs.uv[..., 1] - v
    r_r = torch.where(is_stereo, obs.u_right - ur, zero)
    r = torch.stack([r_u, r_v, r_r], dim=-1)

    du = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], -1)
    dv = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], -1)
    dur = du + torch.stack([zero, zero, cam.bf * inv_z2], -1)
    dproj = torch.stack([du, dv, dur], dim=-2)  # (N,3,3)

    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    dpc = torch.cat([eye, -se3.hat(pc)], dim=-1)
    J = -torch.einsum("...ij,...jk->...ik", dproj, dpc)  # (N,3,6)

    row_mask = torch.stack([one, one, is_stereo.to(z.dtype)], -1)
    depth_ok = (z > 1e-3).to(z.dtype)
    r = r * row_mask
    J = J * row_mask[..., None]

    chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    return r, J, chi2, is_stereo, depth_ok


def _delta2(is_stereo: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.where(
        is_stereo,
        torch.full_like(like, CHI2_STEREO),
        torch.full_like(like, CHI2_MONO),
    )


def optimize_pose(
    Tcw0: torch.Tensor,
    cam: Camera,
    obs: PoseObs,
    rounds: int = 4,
    iters_per_round: int = 10,
    lam0: float = 1e-3,
    unroll: bool = False,
) -> PoseOptResult:
    """Robust pose refinement: ``rounds`` x ``iters_per_round``.

    unroll=False is the reference's LM schedule: each step is accepted only
    if the robust cost drops, with lambda halved or quadrupled. unroll=True
    is the tracking variant: plain Gauss-Newton steps at constant damping
    and no accept/reject re-evaluation."""
    valid_f = obs.valid.to(Tcw0.dtype)

    def lm_iter(Tcw, lam, inlier):
        r, J, chi2, is_stereo, depth_ok = _residual_jacobian(Tcw, cam, obs)
        delta2 = _delta2(is_stereo, chi2)
        w = huber_weight(chi2, delta2) * obs.inv_sigma2 * inlier * valid_f * depth_ok
        Jw = J * w[..., None, None]
        H = torch.einsum("ndp,ndq->pq", Jw, J)
        b = torch.einsum("ndp,nd->p", Jw, r)
        dx = solve_damped(H, -b, lam)
        # r = obs - proj, J = d r/d xi: the GN step solves J^T W J dx = -J^T W r.
        T_new = se3.se3_exp(dx) @ Tcw
        if unroll:
            return T_new, lam
        _, _, chi2_new, _, _ = _residual_jacobian(T_new, cam, obs)
        mask = inlier * valid_f
        cost = torch.sum(torch.minimum(chi2, delta2 * 4.0) * mask)
        cost_new = torch.sum(torch.minimum(chi2_new, delta2 * 4.0) * mask)
        improved = cost_new < cost
        Tcw = torch.where(improved, T_new, Tcw)
        lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-8, 1e4)
        return Tcw, lam

    def classify(Tcw):
        _, _, chi2, is_stereo, depth_ok = _residual_jacobian(Tcw, cam, obs)
        return chi2, (chi2 <= _delta2(is_stereo, chi2)) & (depth_ok > 0)

    # Clean the input: updates only left-multiply orthonormal exp factors,
    # so an input rotation off SO(3) would survive the solve.
    Tcw = se3.orthonormalize(Tcw0)
    inlier = valid_f
    for _ in range(rounds):
        lam = torch.full((), lam0, dtype=Tcw.dtype, device=Tcw.device)
        for _ in range(iters_per_round):
            Tcw, lam = lm_iter(Tcw, lam, inlier)
        # Reclassify like the reference: chi2 > threshold marks the edge
        # outlier for the next round, but it may return.
        inlier = classify(Tcw)[1].to(Tcw.dtype)
    chi2, final_inlier = classify(Tcw)
    final_inlier = final_inlier & obs.valid
    return PoseOptResult(
        Tcw=Tcw,
        inlier=final_inlier,
        num_inliers=torch.sum(final_inlier, dtype=torch.int32),
        chi2=torch.where(obs.valid, chi2, torch.zeros_like(chi2)),
    )

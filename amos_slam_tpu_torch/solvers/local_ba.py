"""Local bundle adjustment with Schur-complement landmark elimination (port
of solvers/local_ba.py).

Contract of Optimizer::LocalBundleAdjustment (src/Optimizer.cc:629):
covisible keyframes free, frontier keyframes fixed, LM iterations, chi2
pruning, more LM iterations (3 + 4 by default, as in the JAX package).

* The problem is a static padded structure: K camera slots (free mask), M
  landmark slots, per-camera observation tables of width O; validity masks
  carry the sparsity.
* Per-observation residuals and Jacobians (3x6 camera, 3x3 point; mono
  rows masked) are built in one pass.
* Per-landmark sums (Hll, bl, the observation count and the per-camera
  coupling Hcl, 31 features per observation) aggregate through an f32
  one-hot product (see ``_aggregate``); the reduced camera system
  S = Hcc - W Hll^-1 W^T is a dense (6K, 6K) matrix from one product.
* Fixed cameras are identity rows of S with a zero right-hand side.
* LM with fixed trip counts; the chi2 prune between phases mirrors the
  reference's prune-and-reoptimize.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.camera import Camera
from .robust import CHI2_MONO, CHI2_STEREO, huber_weight, inv3x3


class BAProblem(NamedTuple):
    """Padded local-BA problem.

    kf_pose: (K, 4, 4) initial Tcw per camera slot.
    kf_free: (K,) bool -- free to optimize (False = fixed frontier / padding).
    kf_valid: (K,) bool -- slot holds a real camera.
    points: (M, 3) initial world points.
    point_valid: (M,) bool.
    obs_point: (K, O) int32 index into points (ignored where obs_valid is
               False).
    obs_uv: (K, O, 2) undistorted pixel observations.
    obs_ur: (K, O) right-image u (<0 = mono observation).
    obs_inv_sigma2: (K, O) information scale.
    obs_valid: (K, O) bool.
    """

    kf_pose: torch.Tensor
    kf_free: torch.Tensor
    kf_valid: torch.Tensor
    points: torch.Tensor
    point_valid: torch.Tensor
    obs_point: torch.Tensor
    obs_uv: torch.Tensor
    obs_ur: torch.Tensor
    obs_inv_sigma2: torch.Tensor
    obs_valid: torch.Tensor


class BAResult(NamedTuple):
    kf_pose: torch.Tensor
    points: torch.Tensor
    obs_inlier: torch.Tensor   # (K, O) bool final chi2 classification
    mean_chi2: torch.Tensor    # () mean inlier chi2 (diagnostic)


def _residuals(cam: Camera, pose: torch.Tensor, points: torch.Tensor, prob: BAProblem):
    """r (K,O,3), Jc (K,O,3,6), Jp (K,O,3,3), chi2 (K,O), stereo mask,
    depth mask."""
    pidx = torch.clamp(prob.obs_point, 0, points.shape[0] - 1).long()
    X = points[pidx]                                   # (K, O, 3)
    R = pose[:, :3, :3]
    pc = torch.einsum("kij,koj->koi", R, X) + pose[:, None, :3, 3]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    inv_z = 1.0 / torch.clamp(z, min=1e-6)
    inv_z2 = inv_z * inv_z

    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    is_stereo = prob.obs_ur >= 0.0
    zero = torch.zeros_like(z)

    r = torch.stack(
        [
            prob.obs_uv[..., 0] - u,
            prob.obs_uv[..., 1] - v,
            torch.where(is_stereo, prob.obs_ur - ur, zero),
        ],
        dim=-1,
    )

    du = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], -1)
    dv = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], -1)
    dur = du + torch.stack([zero, zero, cam.bf * inv_z2], -1)
    dproj = torch.stack([du, dv, dur], dim=-2)         # (K,O,3,3) d(uvr)/d(pc)

    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:2] + (3, 3))
    dpc_dxi = torch.cat([eye, -se3.hat(pc)], dim=-1)   # (K,O,3,6)
    Jc = -torch.einsum("koij,kojl->koil", dproj, dpc_dxi)
    # d(pc)/d(X) = R
    Jp = -torch.einsum("koij,kjl->koil", dproj, R)

    row_mask = torch.stack([torch.ones_like(z), torch.ones_like(z), is_stereo.to(z.dtype)], -1)
    depth_ok = z > 1e-3
    r = r * row_mask
    Jc = Jc * row_mask[..., None]
    Jp = Jp * row_mask[..., None]
    chi2 = torch.sum(r * r, dim=-1) * prob.obs_inv_sigma2
    return r, Jc, Jp, chi2, is_stereo, depth_ok


def _delta2(is_stereo: torch.Tensor) -> torch.Tensor:
    return torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)


def solve_camera_step(S: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the reduced camera system S dx = rhs, or return a zero step.

    ``jax.scipy.linalg.cho_factor`` gives NaNs for an S that is not
    positive definite, and the JAX solver zeroes non-finite entries of the
    step. ``torch.linalg.cholesky`` raises instead, and ``cholesky_ex``
    returns a finite partial factor with ``info > 0``: the step is set to 0
    where ``info != 0`` on the device, with no host read of ``info``."""
    L, info = torch.linalg.cholesky_ex(S)
    dx = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    return torch.where((info == 0) & torch.isfinite(dx), dx, torch.zeros_like(dx))


def solve_local_ba(
    cam: Camera,
    prob: BAProblem,
    iters_phase1: int = 3,
    iters_phase2: int = 4,
    lam0: float = 1e-4,
) -> BAResult:
    K, O = prob.obs_valid.shape
    M = prob.points.shape[0]
    dev, f32 = prob.points.device, prob.points.dtype
    pidx = torch.clamp(prob.obs_point, 0, M - 1).long()

    base_valid = (
        prob.obs_valid
        & prob.kf_valid[:, None]
        & prob.point_valid[pidx]
        & (prob.obs_point >= 0)
    )

    # Observation -> landmark routing, constant across LM iterations. The
    # JAX solver aggregates through a bf16 one-hot split into hi + lo bf16
    # halves (~16 mantissa bits kept); the contract is the per-camera,
    # per-landmark f32 sums. Here the one-hot is f32 and the sums are one
    # batched product (K, M, O) @ (K, O, 31): exact products, and the same
    # order on every run of the card (index_add_ would add with atomics in
    # no fixed order). Its size is K*O*M f32, 50 MB at the largest local-BA
    # shape (12 x 1024 x 1024).
    E_t = (pidx[:, None, :] == torch.arange(M, device=dev)[None, :, None]).to(f32)

    def _aggregate(feat):
        """(K, O, F) f32 -> (K, M, F) f32 per-camera landmark sums."""
        return torch.bmm(E_t, feat)

    kk = torch.arange(K, device=dev)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    free = (prob.kf_free & prob.kf_valid).to(f32)
    freed = free.repeat_interleave(6)

    def lm_iter(pose, points, lam, inlier):
        r, Jc, Jp, chi2, is_stereo, depth_ok = _residuals(cam, pose, points, prob)
        delta2 = _delta2(is_stereo)
        w = huber_weight(chi2, delta2) * prob.obs_inv_sigma2 * inlier * base_valid * depth_ok

        Jcw = Jc * w[..., None, None]
        Jpw = Jp * w[..., None, None]
        Hcc = torch.einsum("kodi,kodj->kij", Jcw, Jc)             # (K,6,6)
        bc = torch.einsum("kodi,kod->ki", Jcw, r)                 # (K,6)
        Hll_blocks = torch.einsum("kodi,kodj->koij", Jpw, Jp)
        bl_blocks = torch.einsum("kodi,kod->koi", Jpw, r)
        Hcl_blocks = torch.einsum("kodi,kodj->koij", Jcw, Jp)
        feat = torch.cat(
            [
                Hll_blocks.reshape(K, O, 9),
                bl_blocks,
                (w > 0).to(f32)[..., None],
                Hcl_blocks.reshape(K, O, 18),
            ],
            dim=-1,
        )                                                         # (K,O,31)
        agg = _aggregate(feat)                                    # (K,M,31)
        flat = torch.sum(agg[..., :13], dim=0)                    # (M,13)
        Hll = flat[:, :9].reshape(M, 3, 3)
        bl = flat[:, 9:12]
        has_obs = flat[:, 12] > 0
        Hcl = agg[..., 13:].reshape(K, M, 6, 3)

        # damp + invert the landmark blocks
        dl = torch.diagonal(Hll, dim1=-2, dim2=-1)
        Hll_d = Hll + eye3 * (lam * torch.clamp(dl, min=1e-9) + 1e-9)[..., None, :]
        Hll_inv = inv3x3(Hll_d)                                   # (M,3,3)

        # Schur complement S = Hcc_diag - W Hll^-1 W^T in dense (6K, 6K)
        # form: S[k*6+i, l*6+o] = -sum_{m,j} W[k,m,i,j] Hcl[l,m,o,j]
        W = torch.einsum("kmij,mjl->kmil", Hcl, Hll_inv)          # (K,M,6,3)
        A = W.permute(0, 2, 1, 3).reshape(6 * K, 3 * M)
        B = Hcl.permute(0, 2, 1, 3).reshape(6 * K, 3 * M)
        S = -(A @ B.T)                                            # (6K,6K)
        dc = torch.diagonal(Hcc, dim1=-2, dim2=-1)
        Hcc_d = Hcc + eye6 * (lam * torch.clamp(dc, min=1e-9) + 1e-9)[..., None, :]
        # Normal equations H dx = -g with g = J^T W r (r = obs - proj,
        # J = dr/dx): reduced rhs = -(bc - W bl).
        rhs_c = torch.einsum("kmij,mj->ki", W, bl) - bc

        # fixed cameras: identity rows/cols, zero rhs; damped Hcc on the
        # 6x6 block diagonal
        S4 = S.view(K, 6, K, 6)
        S4[kk, :, kk, :] += Hcc_d
        S = S * (freed[:, None] * freed[None, :])
        S.view(K, 6, K, 6)[kk, :, kk, :] += eye6 * (1.0 - free)[:, None, None]
        rhs = (rhs_c * free[:, None]).reshape(6 * K)

        dxc = solve_camera_step(S, rhs).reshape(K, 6)

        # back-substitute landmarks: dxl = Hll^-1 (-bl - Hcl^T dxc)
        WTdx = torch.einsum("kmij,ki->mj", Hcl, dxc)
        dxl = -torch.einsum("mij,mj->mi", Hll_inv, bl + WTdx)
        dxl = torch.where(torch.isfinite(dxl), dxl, torch.zeros_like(dxl))
        # points with no observations must not move
        dxl = dxl * (has_obs & prob.point_valid)[:, None]

        pose_new = se3.se3_exp(dxc) @ pose
        pose_new = torch.where(free[:, None, None] > 0, pose_new, pose)
        points_new = points + dxl

        # accept/reject on the total robust cost
        chi2_new = _residuals(cam, pose_new, points_new, prob)[3]
        msk = inlier * base_valid
        cost = torch.sum(torch.minimum(chi2, delta2 * 4) * msk)
        cost_new = torch.sum(torch.minimum(chi2_new, delta2 * 4) * msk)
        improved = cost_new < cost
        pose = torch.where(improved, pose_new, pose)
        points = torch.where(improved, points_new, points)
        lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-8, 1e4)
        return pose, points, lam

    def classify(pose, points):
        _, _, _, chi2, is_stereo, depth_ok = _residuals(cam, pose, points, prob)
        return chi2, (chi2 <= _delta2(is_stereo)) & depth_ok & base_valid

    pose = se3.orthonormalize(prob.kf_pose)
    points = prob.points
    inlier = base_valid.to(f32)
    lam = torch.full((), lam0, dtype=f32, device=dev)
    for _ in range(iters_phase1):
        pose, points, lam = lm_iter(pose, points, lam, inlier)

    # prune: recompute chi2, drop outliers (the reference's Optimizer.cc:629
    # does this between its two phases), and restart the damping
    inlier = classify(pose, points)[1].to(f32)
    lam = torch.full((), lam0, dtype=f32, device=dev)
    for _ in range(iters_phase2):
        pose, points, lam = lm_iter(pose, points, lam, inlier)

    chi2, final_inlier = classify(pose, points)
    mean_chi2 = torch.sum(torch.where(final_inlier, chi2, torch.zeros_like(chi2))) / torch.clamp(
        torch.sum(final_inlier), min=1)
    return BAResult(kf_pose=pose, points=points, obs_inlier=final_inlier, mean_chi2=mean_chi2)

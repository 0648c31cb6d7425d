"""Batched-hypothesis PnP under RANSAC (port of solvers/pnp.py).

The counterpart of the reference's EPnP-in-RANSAC relocalization solver
(PnPsolver, src/PnPsolver.cc:120-366) and the cv::solvePnPRansac call of
the dynamic stage (src/Tracking.cc:1006). Every hypothesis solves at once:

* minimal solver: a 6-point DLT for [R|t] with known intrinsics, its
  leading 3x3 projected onto SO(3) by a determinant-scaled polar iteration;
* scoring: one (hypotheses, N) reprojection pass;
* refinement: the winner's inliers feed the robust pose solver (the
  reference's PnPsolver::Refine).

The draws. ``jax.random.choice(key, N, p=...)`` cannot be reproduced by
torch, so :func:`ransac_pnp` takes the sample indices (``sample_idx``) where
a caller has them (the parity tests feed the JAX package's draws) and
otherwise draws them itself, with replacement and in proportion to
``valid``, by the same inverse-CDF form: a cumulative sum, uniforms from the
caller's generator, a ``searchsorted``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..geometry import se3
from ..geometry.camera import Camera
from ..ops.f32 import recip, seq_sum
from .pose_opt import PoseObs, optimize_pose
from .robust import chol_backsolve_unrolled, chol_factor_unrolled, inv3x3


def _smallest_eigvec(A: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Batched smallest eigenvector of small SPD matrices by inverse
    iteration: (A + eps I)^-1 amplifies the near-null component by
    ~lambda_2 / (eps tr) per step, so two back-solves against one unrolled
    Cholesky factor land at working precision."""
    n = A.shape[-1]
    tr = torch.diagonal(A, dim1=-2, dim2=-1)
    tr = seq_sum(tr)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Ad = A + (1e-9 * tr + 1e-12)[..., None, None] * eye
    L = chol_factor_unrolled(Ad)
    x = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    for _ in range(iters):
        x = chol_backsolve_unrolled(L, x)
        x = x / (torch.sqrt(seq_sum(x * x))[..., None] + 1e-30)
    return x


def _det3(A: torch.Tensor) -> torch.Tensor:
    return (
        A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
        - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
        + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    )


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last dim, keepdim (JAX's sum order)."""
    return torch.sqrt(seq_sum(x * x))[..., None]


def _polar_so3(M: torch.Tensor, iters: int = 8):
    """Batched polar decomposition M ~= R P, elementwise only: the
    determinant-scaled Newton iteration X <- (g X + (g X)^-T) / 2 with
    g = |det X|^(-1/3), which converges for ill-conditioned hypotheses
    (plain Newton stalls when the singular values spread, and a
    non-orthonormal 'R' overfits RANSAC scoring), then a Gram-Schmidt that
    guarantees R in SO(3). Returns (R, mean singular value).

    torch has no ``cbrt``: ``|det| ** (1/3)`` on the clamped (>= 1e-12)
    determinant; it differs from ``jnp.cbrt`` in the last ulps (the parity
    test holds R to 1e-5)."""
    frob = torch.sqrt(seq_sum(M * M, 2))[..., None, None]
    X = M / torch.clamp(frob * recip(math.sqrt(3.0)), min=1e-12)
    for _ in range(iters):
        g = 1.0 / torch.clamp(torch.abs(_det3(X)), min=1e-12) ** (1.0 / 3.0)
        Xg = X * g[..., None, None]
        X = 0.5 * (Xg + inv3x3(Xg).transpose(-1, -2))
    # exact projection: orthonormalize the columns, right-handed
    c0 = X[..., :, 0]
    c0 = c0 / torch.clamp(_norm(c0), min=1e-12)
    c1 = X[..., :, 1]
    c1 = c1 - seq_sum(c1 * c0)[..., None] * c0
    c1 = c1 / torch.clamp(_norm(c1), min=1e-12)
    c2 = torch.linalg.cross(c0, c1, dim=-1)
    R = torch.stack([c0, c1, c2], dim=-1)
    P = torch.einsum("...ji,...jk->...ik", R, M)   # R^T M (symmetric)
    scale = seq_sum(torch.diagonal(P, dim1=-2, dim2=-1)) * recip(3.0)
    return R, scale


def _dlt_pose(X: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Batched 6+-point DLT: (H, S, 3) world points, (H, S, 2) normalized
    image coordinates -> (H, 4, 4) Tcw with R projected onto SO(3).

    Solves P = [R|t] up to scale from x ~ P X, then projects the leading
    3x3 onto a rotation and rescales t accordingly."""
    Hn, S = X.shape[:2]
    zeros = torch.zeros((Hn, S, 4), dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, torch.ones((Hn, S, 1), dtype=X.dtype, device=X.device)], dim=-1)
    u = xn[..., 0:1]
    v = xn[..., 1:2]
    # rows: [X 0 -u X ; 0 X -v X]
    r1 = torch.cat([Xh, zeros, -u * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=1)                     # (H, 2S, 12)
    AtA = torch.einsum("hni,hnj->hij", A, A)
    p = _smallest_eigvec(AtA).reshape(Hn, 3, 4)

    M = p[..., :3]
    # sign: the sample centroid must be in front of the camera
    Xc = seq_sum(X.transpose(1, 2)) * recip(S)
    z = torch.einsum("hj,hj->h", M[:, 2, :], Xc) + p[:, 2, 3]
    sgn = torch.where(z < 0, -1.0, 1.0)
    M = M * sgn[:, None, None]
    t = p[..., 3] * sgn[:, None]

    R, scale = _polar_so3(M)
    t = t / torch.clamp(scale, min=1e-9)[:, None]
    return se3.make_T(R, t)


class PnPResult(NamedTuple):
    Tcw: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor
    ok: torch.Tensor          # () bool: enough inliers to trust


def draw_samples(valid: torch.Tensor, n_hyp: int, sample: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(n_hyp, sample) int64 indices drawn with replacement in proportion
    to ``valid``, by the inverse CDF that ``jax.random.choice(..., p=...)``
    uses: r = cdf[-1] * (1 - u), the first index whose cdf >= r."""
    probs = valid.to(torch.float32)
    probs = probs / torch.clamp(probs.sum(), min=1.0)
    cdf = torch.cumsum(probs, dim=0)
    u = torch.rand((n_hyp, sample), generator=generator, device=valid.device)
    r = cdf[-1] * (1.0 - u)
    idx = torch.searchsorted(cdf, r.reshape(-1)).reshape(n_hyp, sample)
    return torch.clamp(idx, max=valid.shape[0] - 1)


def _project_err(cam: Camera, pc: torch.Tensor, uv: torch.Tensor):
    z = pc[..., 2]
    zc = torch.clamp(z, min=1e-6)
    u = cam.fx * pc[..., 0] / zc + cam.cx
    v = cam.fy * pc[..., 1] / zc + cam.cy
    du = u - uv[..., 0]
    dv = v - uv[..., 1]
    return torch.sqrt(du * du + dv * dv), z


def ransac_pnp(
    cam: Camera,
    points_w: torch.Tensor,     # (N, 3)
    uv: torch.Tensor,           # (N, 2) pixel observations
    valid: torch.Tensor,        # (N,)
    generator: Optional[torch.Generator] = None,
    n_hyp: int = 512,
    sample: int = 6,
    inlier_th_px: float = 2.0,
    min_inliers: int = 12,
    refine: bool = True,
    sample_idx: Optional[torch.Tensor] = None,   # (n_hyp, sample) int64
) -> PnPResult:
    N = points_w.shape[0]
    xn = torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], dim=-1)
    idx = (draw_samples(valid, n_hyp, sample, generator) if sample_idx is None
           else sample_idx.to(points_w.device, torch.long))
    T_h = _dlt_pose(points_w[idx], xn[idx])             # (H, 4, 4)

    # score every hypothesis against every point
    pc = torch.einsum("hij,nj->hni", T_h[:, :3, :3], points_w) + T_h[:, None, :3, 3]
    err, z = _project_err(cam, pc, uv[None])
    inl = (err < inlier_th_px) & (z > 0.05) & valid[None, :]
    scores = torch.sum(inl, dim=-1)
    best = torch.argmax(scores).reshape(1)   # first maximum, as jnp; no host read
    Tcw = T_h.index_select(0, best)[0]
    inliers = inl.index_select(0, best)[0]

    if refine:
        obs = PoseObs(
            points_w=points_w,
            uv=uv,
            u_right=torch.full((N,), -1.0, device=points_w.device),
            inv_sigma2=torch.ones((N,), device=points_w.device),
            valid=inliers,
        )
        opt = optimize_pose(Tcw, cam, obs, rounds=2, iters_per_round=4, unroll=True)
        # re-classify against the refined pose
        e1, z1 = _project_err(cam, se3.transform_points(opt.Tcw, points_w), uv)
        inl1 = (e1 < inlier_th_px) & (z1 > 0.05) & valid
        better = torch.sum(inl1) >= torch.sum(inliers)
        Tcw = torch.where(better, opt.Tcw, Tcw)
        inliers = torch.where(better, inl1, inliers)

    n = torch.sum(inliers, dtype=torch.int32)
    return PnPResult(Tcw=Tcw, inliers=inliers, num_inliers=n, ok=n >= min_inliers)

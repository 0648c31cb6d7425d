"""Batched Horn absolute-orientation Sim3/SE3 solver under RANSAC, plus
mutual-reprojection Sim3 refinement (port of solvers/sim3_solver.py).

The counterparts of the reference's Sim3Solver (src/Sim3Solver.cc:199-547)
and Optimizer::OptimizeSim3 (src/Optimizer.cc:1364). All hypotheses solve at
once: the 4x4 quaternion matrices eigendecompose as one batch; the
refinement is a fixed-trip Gauss-Newton over the 7-dim tangent with exact
forward-mode Jacobians.

The draw. ``jax.random.choice`` cannot be reproduced by torch, so
:func:`ransac_sim3` takes the sample indices (``sample_idx``) where a caller
has them and otherwise draws them with ``solvers.pnp.draw_samples`` (the same
inverse-CDF form) from the caller's generator.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.autograd.forward_ad as fwAD

from ..geometry.camera import Camera
from ..geometry.se3 import quat_to_rotmat
from ..geometry.sim3 import Sim3, sim3_exp
from .pnp import draw_samples


def jacobian_fwd(fn, n: int, x_shape=(), dtype=torch.float32, device=None):
    """(f(0), df/dxi at 0) of ``fn: (..., n) -> (..., m)``, evaluated by
    forward-mode AD with the n basis tangents stacked on a new leading axis
    of a zero input of shape ``(n,) + x_shape + (n,)`` (``fn`` broadcasts
    over it): one pass gives every column, as ``jax.jacfwd`` does.
    Returns (value ``x_shape``-batched (..., m), Jacobian (..., m, n)).

    ``torch.func.jacfwd`` is not used: in some torch builds its tangents of
    ops with Python-number operands come back in float64."""
    x = torch.zeros((n,) + tuple(x_shape) + (n,), dtype=dtype, device=device)
    basis = torch.eye(n, dtype=dtype, device=device).reshape(
        (n,) + (1,) * len(x_shape) + (n,)).expand(x.shape)
    with fwAD.dual_level():
        out = fn(fwAD.make_dual(x, basis))
        val, tan = fwAD.unpack_dual(out)
    return val[0], torch.movedim(tan, 0, -1)


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool = False) -> Sim3:
    """Closed-form alignment p2 ~ s R p1 + t over the last-but-one axis.

    p1, p2: (..., S, 3). Horn 1987: the rotation is the dominant
    eigenvector of the 4x4 N matrix of the cross-covariance
    (Sim3Solver::ComputeSim3, src/Sim3Solver.cc:318-450)."""
    c1 = torch.mean(p1, dim=-2, keepdim=True)
    c2 = torch.mean(p2, dim=-2, keepdim=True)
    q1 = p1 - c1
    q2 = p2 - c2
    M = torch.einsum("...si,...sj->...ij", q1, q2)   # sum q1 q2^T

    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    _, V = torch.linalg.eigh(N)
    q_wxyz = V[..., :, -1]                          # the largest eigenvalue
    q = torch.cat([q_wxyz[..., 1:], q_wxyz[..., :1]], dim=-1)   # xyzw
    R = quat_to_rotmat(q)

    if fix_scale:
        s = torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)
    else:
        # symmetric scale (Horn): sqrt(sum|q2|^2 / sum|q1|^2)
        n1 = torch.sum(q1 * q1, dim=(-2, -1))
        n2 = torch.sum(q2 * q2, dim=(-2, -1))
        s = torch.sqrt(n2 / torch.clamp(n1, min=1e-12))
    t = c2[..., 0, :] - s[..., None] * torch.einsum("...ij,...j->...i", R, c1[..., 0, :])
    return Sim3(R=R, t=t, s=s)


class Sim3RansacResult(NamedTuple):
    sim3: Sim3                 # best p1 -> p2 alignment
    inliers: torch.Tensor      # (N,) bool
    num_inliers: torch.Tensor
    ok: torch.Tensor


def ransac_sim3(
    p1: torch.Tensor,          # (N, 3) 3D points in frame 1
    p2: torch.Tensor,          # (N, 3) corresponding points in frame 2
    valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    n_hyp: int = 128,
    inlier_th=0.06,            # metres in 3D; a float or a 0-d tensor
    min_inliers: int = 12,
    fix_scale: bool = True,
    *,
    sample_idx: Optional[torch.Tensor] = None,   # (n_hyp, 3) int64
) -> Sim3RansacResult:
    """3-point-sample Horn RANSAC; final refit on the winning inlier set
    (3D distance check: with RGB-D both point sets are metric)."""
    idx = (draw_samples(valid, n_hyp, 3, generator) if sample_idx is None
           else sample_idx.to(p1.device, torch.long))
    g = horn_sim3(p1[idx], p2[idx], fix_scale=fix_scale)

    pred = g.apply(p1.expand((idx.shape[0],) + p1.shape))
    d = torch.linalg.vector_norm(pred - p2[None], dim=-1)
    inl = (d < inlier_th) & valid[None]
    scores = torch.sum(inl, dim=-1)
    best = torch.argmax(scores).reshape(1)   # first maximum, as jnp; no host read
    inliers = inl.index_select(0, best)[0]

    # refit on the inliers: outliers are replaced by the inlier centroid so
    # they do not bias the solution
    w = inliers[:, None]
    n_in = torch.clamp(torch.sum(inliers), min=1)
    c1 = torch.sum(torch.where(w, p1, 0.0), dim=0) / n_in
    c2 = torch.sum(torch.where(w, p2, 0.0), dim=0) / n_in
    g_fit = horn_sim3(torch.where(w, p1, c1)[None], torch.where(w, p2, c2)[None],
                      fix_scale=fix_scale)
    g_fit = Sim3(R=g_fit.R[0], t=g_fit.t[0], s=g_fit.s[0])

    d_fit = torch.linalg.vector_norm(g_fit.apply(p1) - p2, dim=-1)
    inl_fit = (d_fit < inlier_th) & valid
    better = torch.sum(inl_fit) >= torch.sum(inliers)
    g_best = Sim3(
        R=torch.where(better, g_fit.R, g.R.index_select(0, best)[0]),
        t=torch.where(better, g_fit.t, g.t.index_select(0, best)[0]),
        s=torch.where(better, g_fit.s, g.s.index_select(0, best)[0]),
    )
    inliers = torch.where(better, inl_fit, inliers)
    n = torch.sum(inliers, dtype=torch.int32)
    return Sim3RansacResult(sim3=g_best, inliers=inliers, num_inliers=n, ok=n >= min_inliers)


class Sim3OptResult(NamedTuple):
    sim3: Sim3
    inlier: torch.Tensor       # (N,) bool final chi2 classification
    num_inliers: torch.Tensor


def optimize_sim3(
    cam: Camera,
    g0: Sim3,                  # initial cam1 -> cam2 similarity
    p1c: torch.Tensor,         # (N, 3) points in camera-1 coords
    uv1: torch.Tensor,         # (N, 2) their pixel observations in image 1
    p2c: torch.Tensor,         # (N, 3) matched points in camera-2 coords
    uv2: torch.Tensor,         # (N, 2) their pixel observations in image 2
    valid: torch.Tensor,       # (N,)
    inv_sigma2_1: torch.Tensor,  # (N,) information scale of uv1 rows
    inv_sigma2_2: torch.Tensor,  # (N,) information scale of uv2 rows
    iters: int = 8,
    fix_scale: bool = False,
    chi2_th: float = 9.210,    # the reference's th2 = 10 on 2-dof residuals
) -> Sim3OptResult:
    """Refine a loop Sim3 by mutual reprojection (OptimizeSim3 contract):
    r2 = proj(g(p1c)) - uv2 and r1 = proj(g^-1(p2c)) - uv1, Huber-weighted
    GN on the 7-dim tangent (continuous IRLS, then a final chi2
    classification)."""
    dev = p1c.device

    def proj(p):
        z = torch.clamp(p[..., 2], min=1e-6)
        return torch.stack([cam.fx * p[..., 0] / z + cam.cx,
                            cam.fy * p[..., 1] / z + cam.cy], dim=-1), p[..., 2]

    def residuals(g: Sim3):
        q2, z2 = proj(g.apply(p1c))
        q1, z1 = proj(g.inverse().apply(p2c))
        r = torch.cat([q1 - uv1, q2 - uv2], dim=-1)     # (..., N, 4)
        ok = valid & (z1 > 1e-3) & (z2 > 1e-3)
        return r, ok

    eye7 = torch.eye(7, dtype=torch.float32, device=dev)
    R, t, s = g0.R, g0.t, g0.s
    for _ in range(iters):
        g = Sim3(R=R, t=t, s=s)
        r, ok = residuals(g)
        _, J = jacobian_fwd(lambda xi: residuals(sim3_exp(xi).compose(g))[0], 7, device=dev)
        chi1 = torch.sum(r[:, :2] ** 2, dim=-1) * inv_sigma2_1
        chi2 = torch.sum(r[:, 2:] ** 2, dim=-1) * inv_sigma2_2
        # Huber IRLS weights per 2-dof residual block
        w1 = torch.where(chi1 > chi2_th, torch.sqrt(chi2_th / torch.clamp(chi1, min=1e-12)), 1.0)
        w2 = torch.where(chi2 > chi2_th, torch.sqrt(chi2_th / torch.clamp(chi2, min=1e-12)), 1.0)
        w = torch.cat([(w1 * inv_sigma2_1 * ok)[:, None].repeat(1, 2),
                       (w2 * inv_sigma2_2 * ok)[:, None].repeat(1, 2)], dim=-1)   # (N, 4)
        H = torch.einsum("nd,ndi,ndj->ij", w, J, J)
        b = torch.einsum("nd,ndi,nd->i", w, J, r)
        if fix_scale:
            H = H.clone()
            H[6, :] = 0.0
            H[:, 6] = 0.0
            H[6, 6] = 1.0
            b = torch.cat([b[:6], torch.zeros_like(b[6:])])
        H = H + 1e-6 * torch.trace(H) * eye7 / 7.0
        dx = -torch.linalg.solve_ex(H, b)[0]
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        gn = sim3_exp(dx).compose(g)
        R, t, s = gn.R, gn.t, gn.s
    g = Sim3(R=R, t=t, s=s)
    r, ok = residuals(g)
    chi1 = torch.sum(r[:, :2] ** 2, dim=-1) * inv_sigma2_1
    chi2 = torch.sum(r[:, 2:] ** 2, dim=-1) * inv_sigma2_2
    inlier = ok & (chi1 < chi2_th) & (chi2 < chi2_th)
    return Sim3OptResult(sim3=g, inlier=inlier, num_inliers=torch.sum(inlier, dtype=torch.int32))

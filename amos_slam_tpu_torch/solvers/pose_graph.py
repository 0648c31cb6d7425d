"""Pose-graph optimization (essential graph) with padded edge lists (port of
solvers/pose_graph.py).

The counterpart of Optimizer::OptimizeEssentialGraph (src/Optimizer.cc:1017:
Sim3 vertices over spanning-tree, covisibility and loop edges). E
relative-pose edges over K pose slots; per-edge residuals and their exact
7x14 Jacobians (forward-mode AD through the Sim3 exp/log chain, all edges at
once) evaluate in parallel; the Gauss-Newton normal system assembles by
accumulating 7x7 blocks into a dense (7K, 7K) matrix (``index_put_`` with
``accumulate=True`` for JAX's duplicate-index ``.at[].add``) and solves with
one Cholesky.

Residual for edge (i, j) with measurement S_ji:
    r(xi_i, xi_j) = sim3_log(S_ji^-1 * (exp(xi_j) S_j) * (exp(xi_i) S_i)^-1)
evaluated at xi = 0; fix_scale=True (RGB-D/stereo) pins the scale tangent.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.sim3 import Sim3, sim3_exp, sim3_log
from .sim3_solver import jacobian_fwd


class PoseGraphProblem(NamedTuple):
    R: torch.Tensor           # (K, 3, 3) world->camera rotations
    t: torch.Tensor           # (K, 3)
    s: torch.Tensor           # (K,) scales (1 for SE3)
    pose_valid: torch.Tensor  # (K,)
    pose_fixed: torch.Tensor  # (K,) bool
    edge_i: torch.Tensor      # (E,) int
    edge_j: torch.Tensor      # (E,) int
    edge_R: torch.Tensor      # (E, 3, 3) measured S_ji = S_j * S_i^-1
    edge_t: torch.Tensor      # (E, 3)
    edge_s: torch.Tensor      # (E,)
    edge_w: torch.Tensor      # (E,) weight (0 = padding)


class PoseGraphResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    final_err: torch.Tensor


def _edge_res_tangent(xi2, Si: Sim3, Sj: Sim3, Sm: Sim3):
    """Residual as a function of the stacked perturbation (..., 14) [xi_i, xi_j]."""
    gi = sim3_exp(xi2[..., :7]).compose(Si)
    gj = sim3_exp(xi2[..., 7:]).compose(Sj)
    rel = gj.compose(gi.inverse())
    return sim3_log(Sm.inverse().compose(rel))


def optimize_pose_graph(
    prob: PoseGraphProblem,
    iters: int = 20,
    fix_scale: bool = True,
    lam: float = 1e-5,
) -> PoseGraphResult:
    K = prob.R.shape[0]
    E = prob.edge_i.shape[0]
    D = 7
    dev = prob.R.device
    f32 = dict(dtype=torch.float32, device=dev)
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    Sm = Sim3(prob.edge_R, prob.edge_t, prob.edge_s.to(torch.float32))
    w = prob.edge_w.to(torch.float32)

    free = (prob.pose_valid & ~prob.pose_fixed).to(torch.float32)
    # clamp fixed/padded variables (and scale rows with fix_scale) through
    # a unit diagonal
    diag_fix = torch.kron(1.0 - free, torch.ones(D, **f32))
    if fix_scale:
        scale_rows = (torch.eye(D, **f32)[6] * free[:, None]).reshape(-1)
        diag_fix = torch.maximum(diag_fix, scale_rows)
    base = torch.diag(diag_fix) + lam * torch.eye(K * D, **f32)
    keep = free[:, None, None, None] * free[None, :, None, None]

    R, t, s = prob.R, prob.t, prob.s.to(torch.float32)
    err = torch.zeros((), **f32)
    for _ in range(iters):
        Si = Sim3(R[ei], t[ei], s[ei])
        Sj = Sim3(R[ej], t[ej], s[ej])
        r, J = jacobian_fwd(lambda xi: _edge_res_tangent(xi, Si, Sj, Sm), 14, (E,),
                            device=dev)                     # (E, 7), (E, 7, 14)
        Ji = J[..., :7]
        Jj = J[..., 7:]
        if fix_scale:
            Ji = torch.cat([Ji[..., :6], torch.zeros_like(Ji[..., 6:])], dim=-1)
            Jj = torch.cat([Jj[..., :6], torch.zeros_like(Jj[..., 6:])], dim=-1)
        Jiw = Ji * w[:, None, None]
        Jjw = Jj * w[:, None, None]
        g = torch.zeros((K, D), **f32)
        g.index_put_((ei,), torch.einsum("edp,ed->ep", Jiw, r), accumulate=True)
        g.index_put_((ej,), torch.einsum("edp,ed->ep", Jjw, r), accumulate=True)
        Hii = torch.einsum("edp,edq->epq", Jiw, Ji)
        Hjj = torch.einsum("edp,edq->epq", Jjw, Jj)
        Hij = torch.einsum("edp,edq->epq", Jiw, Jj)
        H = torch.zeros((K, K, D, D), **f32)
        H.index_put_((ei, ei), Hii, accumulate=True)
        H.index_put_((ej, ej), Hjj, accumulate=True)
        H.index_put_((ei, ej), Hij, accumulate=True)
        H.index_put_((ej, ei), Hij.transpose(-1, -2), accumulate=True)

        H = H * keep
        g = g * free[:, None]
        Hd = H.permute(0, 2, 1, 3).reshape(K * D, K * D) + base
        rhs = (-g).reshape(-1) * (1.0 - diag_fix)
        # cholesky_ex: a failed factorization (info != 0) zeroes the step,
        # where JAX's cho_factor returns NaNs that the finite check zeroes
        L, info = torch.linalg.cholesky_ex(Hd)
        dx = torch.cholesky_solve(rhs[:, None], L)[:, 0].reshape(K, D)
        dx = torch.where(torch.isfinite(dx) & (info == 0), dx, 0.0)

        new = sim3_exp(dx).compose(Sim3(R=R, t=t, s=s))
        Tn = se3.orthonormalize(se3.make_T(new.R, new.t))
        R, t, s = Tn[..., :3, :3], Tn[..., :3, 3], new.s
        err = torch.sum(r * r * w[:, None])
    return PoseGraphResult(R=R, t=t, s=s, final_err=err)

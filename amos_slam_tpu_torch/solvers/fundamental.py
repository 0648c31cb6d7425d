"""Epipolar geometry and the batched fundamental-matrix RANSAC (port of
solvers/fundamental.py).

The counterpart of cv::findFundamentalMat (reference src/Tracking.cc:927,
945) and of the Initializer's F thread (src/Initializer.cc:174-187): every
minimal sample solves at once (a batched 9x9 ``eigh`` for the null vector,
a batched 3x3 SVD for the rank-2 projection), every hypothesis scores
against every point in one (H, N) pass, and the winner's inliers refit it.

The draws. ``jax.random.choice(key, N, p=...)`` cannot be reproduced by
torch, so :func:`ransac_fundamental` takes the sample indices
(``sample_idx``, (n_hyp, 8)) where a caller has them and otherwise draws
them from ``generator`` as ``solvers.pnp.draw_samples`` does.

The null vector's sign is free (``eigh`` may return -f where LAPACK in the
JAX package returns f): F is defined up to sign, and the epipolar distances
and every decision taken on them are the same for both.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.f32 import seq_sum
from .pnp import draw_samples


def _normalize_points(x: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization: zero mean, mean |.| = 1 per axis, over the
    valid points (Initializer::Normalize, src/Initializer.cc:1501).

    x: (N, 2); returns (xn, T) with T (3, 3) the normalizing transform."""
    w = valid.to(x.dtype)
    n = torch.clamp(seq_sum(w), min=1.0)
    mean = seq_sum((x * w[:, None]).T) / n
    d = torch.abs(x - mean) * w[:, None]
    md = torch.clamp(seq_sum(d.T) / n, min=1e-6)
    s = 1.0 / md
    xn = (x - mean) * s
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([
        torch.stack([s[0], z, -mean[0] * s[0]]),
        torch.stack([z, s[1], -mean[1] * s[1]]),
        torch.stack([z, z, o]),
    ])
    return xn, T


def _epipolar_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(..., 9) rows of the 8-point system x2^T F x1 = 0."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    return torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=-1)


def _rank2(f: torch.Tensor) -> torch.Tensor:
    """(..., 9) null vectors -> (..., 3, 3) F with its smallest singular
    value set to 0."""
    F = f.reshape(f.shape[:-1] + (3, 3))
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ (S[..., :, None] * Vt)


def _f_from_8(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Batched 8-point algorithm: (H, 8, 2) x2 -> (H, 3, 3) rank-2 F, the
    null vector by ``eigh`` of A^T A (Initializer::ComputeF21,
    src/Initializer.cc:~770)."""
    A = _epipolar_rows(x1, x2)                                  # (H, 8, 9)
    AtA = torch.einsum("hni,hnj->hij", A, A)
    _, V = torch.linalg.eigh(AtA)
    return _rank2(V[..., :, 0])


def epipolar_distance(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Symmetric epipolar distances: (..., 3, 3) F, (N, 2) points ->
    (..., N) max of point-to-line distances in both images (the quantity the
    reference thresholds at 0.5/1.0 px, src/Tracking.cc:939,1143)."""
    ones = torch.ones(x1.shape[:-1] + (1,), dtype=x1.dtype, device=x1.device)
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)
    l2 = torch.einsum("...ij,nj->...ni", F, p1)        # lines in image 2
    l1 = torch.einsum("...ji,nj->...ni", F, p2)        # lines in image 1
    num = torch.abs(torch.sum(l2 * p2, dim=-1))
    d2 = num / torch.clamp(torch.sqrt(l2[..., 0] ** 2 + l2[..., 1] ** 2), min=1e-9)
    d1 = num / torch.clamp(torch.sqrt(l1[..., 0] ** 2 + l1[..., 1] ** 2), min=1e-9)
    return torch.maximum(d1, d2)


class FundamentalResult(NamedTuple):
    F: torch.Tensor           # (3, 3)
    inliers: torch.Tensor     # (N,) bool
    num_inliers: torch.Tensor
    dist: torch.Tensor        # (N,) epipolar distance under the final F


def ransac_fundamental(
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    n_hyp: int = 256,
    inlier_th: float = 1.0,
    refit: bool = True,
    *,
    sample_idx: Optional[torch.Tensor] = None,   # (n_hyp, 8) int64
) -> FundamentalResult:
    """Batched-hypothesis F-RANSAC with a masked least-squares refit: the
    reference's two passes (findFundamentalMat on all, then on the inliers)
    as the best of ``n_hyp`` hypotheses, then one weighted 8-point solve
    over its inliers, kept only if it loses none."""
    x1n, T1 = _normalize_points(x1, valid)
    x2n, T2 = _normalize_points(x2, valid)
    idx = (draw_samples(valid, n_hyp, 8, generator) if sample_idx is None
           else sample_idx.to(x1.device, torch.long))
    F_h = _f_from_8(x1n[idx], x2n[idx])                         # (H, 3, 3)

    d = epipolar_distance(F_h, x1n, x2n)                        # (H, N)
    # the threshold is in pixels: scale it by the mean normalizing factor
    th_n = inlier_th * (0.5 * (T1[0, 0] + T1[1, 1]))
    inl = (d < th_n) & valid[None, :]
    best = torch.argmax(torch.sum(inl, dim=-1, dtype=torch.int32)).reshape(1)
    F_best = F_h.index_select(0, best)[0]
    inliers = inl.index_select(0, best)[0]

    if refit:
        A = _epipolar_rows(x1n, x2n)
        AtA = torch.einsum("ni,nj->ij", A * inliers.to(x1.dtype)[:, None], A)
        _, V = torch.linalg.eigh(AtA)
        F_ls = _rank2(V[:, 0])
        inl_ls = (epipolar_distance(F_ls, x1n, x2n) < th_n) & valid
        better = torch.sum(inl_ls) >= torch.sum(inliers)
        F_best = torch.where(better, F_ls, F_best)
        inliers = torch.where(better, inl_ls, inliers)

    # denormalize: F = T2^T Fn T1, distances again in pixels
    F_px = T2.T @ F_best @ T1
    F_px = F_px / torch.clamp(torch.abs(F_px[2, 2]), min=1e-12)
    d_px = epipolar_distance(F_px, x1, x2)
    return FundamentalResult(
        F=F_px,
        inliers=inliers,
        num_inliers=torch.sum(inliers, dtype=torch.int32),
        dist=torch.where(valid, d_px, torch.full_like(d_px, float("inf"))),
    )

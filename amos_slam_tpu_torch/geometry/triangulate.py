"""Batched two-view triangulation (port of geometry/triangulate.py).

Replaces the reference's per-point SVD triangulation
(Initializer::Triangulate, src/Initializer.cc:1461; the inline SVD in
LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:313): the DLT system
of a whole padded batch of correspondences is solved at once.
"""

from __future__ import annotations

import torch


def _solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve batched symmetric 3x3 systems by the adjugate (elementwise)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    x0 = (c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]) * inv_det
    x1 = (c01 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]) * inv_det
    x2 = (c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2]) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor):
    """Linear (DLT) triangulation.

    P1, P2: (...,3,4) projection matrices K [R|t]; x1, x2: (...,N,2) pixel
    observations. Returns (...,N,3) world points and (...,N) the residual
    ||A [X;1]||^2 of the row-normalised system (lower = better conditioned).
    """
    def two_rows(P, x):
        P = P[..., None, :, :]  # broadcast over N
        r0 = x[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r1 = x[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return r0, r1

    a0, a1 = two_rows(P1, x1)
    a2, a3 = two_rows(P2, x2)
    A = torch.stack([a0, a1, a2, a3], dim=-2)  # (...,N,4,4)

    # Inhomogeneous DLT: scene points are finite (w = 1), so the 3-unknown
    # least squares A[:, :3] X = -A[:, 3] is solved by 3x3 normal equations
    # instead of the 4x4 null-vector eigenproblem. Points at infinity would
    # be lost; they fail the parallax gate downstream regardless. Rows are
    # normalised so the residual is comparable across points.
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True), min=1e-12)
    Am = A[..., :3]
    b = -A[..., 3]
    AtA = torch.einsum("...ki,...kj->...ij", Am, Am)
    Atb = torch.einsum("...ki,...k->...i", Am, b)
    tr = torch.einsum("...ii->...", AtA)
    ridge = (1e-7 * tr + 1e-12)[..., None, None] * torch.eye(
        3, dtype=A.dtype, device=A.device)
    Xw = _solve3x3(AtA + ridge, Atb)
    r = torch.einsum("...ki,...i->...k", Am, Xw) - b
    w0 = torch.sum(r * r, dim=-1)
    return Xw, w0


def projection_matrix(K: torch.Tensor, Tcw: torch.Tensor) -> torch.Tensor:
    """K (..., 3, 3) and Tcw (..., 4, 4) -> P (..., 3, 4)."""
    return K @ Tcw[..., :3, :4]

"""Robust weights and small SPD solves (port of solvers/robust.py).

g2o's robust kernels in iteratively-reweighted least-squares form: a
per-residual weight w(e) = rho'(e2) applied to the normal equations.
"""

from __future__ import annotations

import torch

# chi2 thresholds at 95% for 2/3 DoF (src/Optimizer.cc:405-447)
CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight of the Huber kernel for squared error ``chi2``:
    1 where chi2 <= delta2, else delta / sqrt(chi2)."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    delta2 = torch.as_tensor(delta2, dtype=chi2.dtype, device=chi2.device)
    delta = torch.sqrt(delta2)
    return torch.where(chi2 <= delta2, torch.ones_like(chi2), delta / e)


def cauchy_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight of the Cauchy kernel: 1 / (1 + chi2 / delta2)."""
    return 1.0 / (1.0 + chi2 / delta2)


def weighted_normal_eq(J: torch.Tensor, r: torch.Tensor, w: torch.Tensor):
    """H = sum w J^T J and b = sum w J^T r over residual blocks.

    J: (..., N, D, P) Jacobian blocks (D residual dims, P parameters);
    r: (..., N, D) residuals; w: (..., N) per-block weights. Returns H
    (..., P, P) and b (..., P), exact f32 on the card (TF32 is off
    package-wide, the JAX package's ``Precision.HIGHEST``)."""
    Jw = J * w[..., None, None]
    H = torch.einsum("...ndp,...ndq->...pq", Jw, J)
    b = torch.einsum("...ndp,...nd->...p", Jw, r)
    return H, b


def chol_factor_unrolled(Hd: torch.Tensor):
    """Unrolled Cholesky factor of a small SPD matrix, as a list of lists of
    (...,) tensors for :func:`chol_backsolve_unrolled`."""
    n = Hd.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = Hd[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-12))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = Hd[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L


def chol_backsolve_unrolled(L, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b given an unrolled factor."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def chol_solve_unrolled(Hd: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SPD solve with a fully unrolled Cholesky (static small n)."""
    return chol_backsolve_unrolled(chol_factor_unrolled(Hd), b)


def inv3x3(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) > eps, det, torch.full_like(det, eps))
    adj = torch.stack([
        torch.stack([A11, A12, A13], -1),
        torch.stack([A21, A22, A23], -1),
        torch.stack([A31, A32, A33], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _solve6_block(Hd: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SPD 6x6 solve by 2x2-block Schur elimination over 3x3 blocks."""
    A = Hd[..., :3, :3]
    B = Hd[..., :3, 3:]
    C = Hd[..., 3:, 3:]
    b1 = b[..., :3]
    b2 = b[..., 3:]
    Ainv = inv3x3(A)
    AinvB = Ainv @ B
    S = C - B.transpose(-1, -2) @ AinvB
    Sinv = inv3x3(S)
    Ainvb1 = torch.einsum("...ij,...j->...i", Ainv, b1)
    rhs2 = b2 - torch.einsum("...ji,...j->...i", AinvB, b1)
    x2 = torch.einsum("...ij,...j->...i", Sinv, rhs2)
    x1 = Ainvb1 - torch.einsum("...ij,...j->...i", AinvB, x2)
    return torch.cat([x1, x2], dim=-1)


def solve_damped(H: torch.Tensor, b: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Solve (H + lam*diag(H)) dx = b (Levenberg-Marquardt diagonal
    damping); non-finite solutions become 0."""
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    damp = lam[..., None] * torch.clamp(diag, min=1e-9)
    n = H.shape[-1]
    Hd = H + torch.eye(n, dtype=H.dtype, device=H.device) * damp[..., None, :]
    if n == 6:
        dx = _solve6_block(Hd, b)
    elif n <= 8:
        dx = chol_solve_unrolled(Hd, b)
    else:
        L = torch.linalg.cholesky(Hd)
        dx = torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))

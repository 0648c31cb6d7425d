"""Sim(3) similarity transforms for loop closure (port of geometry/sim3.py).

A Sim3 element is stored explicitly as ``(R: (...,3,3), t: (...,3), s:
(...,))`` acting as ``x -> s * R x + t`` (g2o's Sim3,
types_seven_dof_expmap.h:48-130). Tangent vectors are 7-dim ``[rho, phi,
sigma]`` with sigma = log(s).

The exp map's small-angle and scale -> 1 series are ``torch.where`` selects
over both branches, as in the JAX package, so each input takes the same
branch and forward-mode derivatives (``torch.func.jacfwd``) follow the
selected one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .se3 import _EPS, hat, so3_exp, so3_log


class Sim3(NamedTuple):
    R: torch.Tensor  # (...,3,3)
    t: torch.Tensor  # (...,3)
    s: torch.Tensor  # (...,)

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        """Apply to points (...,N,3)."""
        return (self.s[..., None, None] * torch.einsum("...ij,...nj->...ni", self.R, pts)
                + self.t[..., None, :])

    def compose(self, other: "Sim3") -> "Sim3":
        """self o other (apply ``other`` first)."""
        return Sim3(
            R=self.R @ other.R,
            t=self.s[..., None] * torch.einsum("...ij,...j->...i", self.R, other.t) + self.t,
            s=self.s * other.s,
        )

    def inverse(self) -> "Sim3":
        Rt = self.R.transpose(-1, -2)
        s_inv = 1.0 / self.s
        return Sim3(R=Rt, t=-s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, self.t),
                    s=s_inv)

    @staticmethod
    def identity(batch=(), dtype=torch.float32, *, device=None) -> "Sim3":
        return Sim3(
            R=torch.eye(3, dtype=dtype, device=device).expand(tuple(batch) + (3, 3)),
            t=torch.zeros(tuple(batch) + (3,), dtype=dtype, device=device),
            s=torch.ones(tuple(batch), dtype=dtype, device=device),
        )

    @staticmethod
    def from_se3(T: torch.Tensor, s=None) -> "Sim3":
        scale = torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device) if s is None else s
        return Sim3(R=T[..., :3, :3], t=T[..., :3, 3], s=scale)


def sim3_exp(xi: torch.Tensor) -> Sim3:
    """Exp map (...,7) [rho, phi, sigma] -> Sim3 (the closed-form W matrix
    of Strasdat's thesis, series-expanded near small angles and scales)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = so3_exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)

    sig2 = sigma * sigma
    small_sig = torch.abs(sigma) < 1e-5
    small_th = theta < 1e-5
    one = torch.ones_like(sigma)

    A = torch.where(small_sig, 1.0 + sigma / 2.0 + sig2 / 6.0,
                    (s - 1.0) / torch.where(small_sig, one, sigma))
    denom = sig2 + theta2
    s_cos = s * torch.cos(theta)
    s_sin = s * torch.sin(theta)
    C1 = torch.where(
        small_th,
        torch.where(small_sig, 0.5 * one, (sigma - 1.0 + s_cos) / torch.where(small_sig, one, denom)),
        (s_sin * sigma + (1.0 - s_cos) * theta) / torch.where(small_th, one, theta * denom),
    )
    C2_big = (
        A - ((s_cos - 1.0) * sigma + s_sin * theta) / torch.where(small_th, one, denom)
    ) / torch.where(small_th, one, theta2)
    C2 = torch.where(
        small_th,
        torch.where(small_sig, one / 6.0,
                    (A - 1.0 - sigma * A + s - 1.0) / torch.where(small_sig, one, denom)),
        C2_big,
    )
    W = A[..., None, None] * eye + C1[..., None, None] * K + C2[..., None, None] * (K @ K)
    t = torch.einsum("...ij,...j->...i", W, rho)
    return Sim3(R=R, t=t, s=s)


def sim3_log(g: Sim3) -> torch.Tensor:
    """Log map: invert the exp's W matrix, W rho = t."""
    phi = so3_log(g.R)
    sigma = torch.log(g.s)
    xi_rot = torch.cat([torch.zeros_like(phi), phi, sigma[..., None]], dim=-1)
    W = _sim3_W(xi_rot)
    rho = torch.linalg.solve(W, g.t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def _sim3_W(xi: torch.Tensor) -> torch.Tensor:
    """The W matrix of sim3_exp for tangent ``xi`` (rho entries ignored),
    column by column: W @ e_i = exp([e_i, phi, sigma]).t."""
    e = torch.eye(3, dtype=xi.dtype, device=xi.device)
    cols = [sim3_exp(torch.cat([e[i].expand(xi.shape[:-1] + (3,)), xi[..., 3:]], dim=-1)).t
            for i in range(3)]
    return torch.stack(cols, dim=-1)

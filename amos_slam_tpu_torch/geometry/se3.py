"""SO(3)/SE(3) Lie-group operations on tensors (port of geometry/se3.py).

Conventions as in the JAX package: rotations are 3x3, rigid transforms are
4x4 camera-from-world T_cw, tangent vectors are ``[rho(3), phi(3)]``
translation-first (g2o's SE3Quat::exp order). Every function broadcasts over
leading batch dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


# ---------------------------------------------------------------------------
# so(3)
# ---------------------------------------------------------------------------

def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric matrices."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(omega: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (...,3,3) -> (...,3)."""
    return torch.stack(
        [omega[..., 2, 1], omega[..., 0, 2], omega[..., 1, 0]], dim=-1
    )


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, (...,3) -> (...,3,3), with small-angle series."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    K = hat(phi)
    return _eye3(phi, K.shape) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map, (...,3,3) -> (...,3), through the quaternion (accurate near
    theta = pi, where trace-based formulas lose the axis)."""
    q = rotmat_to_quat(R)
    qv = q[..., :3]
    qw = q[..., 3]
    nv = torch.linalg.vector_norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(nv, qw)
    small = nv < 1e-8
    scale = torch.where(
        small,
        2.0 / torch.clamp(qw, min=_EPS),
        theta / torch.where(small, torch.ones_like(nv), nv),
    )
    return qv * scale[..., None]


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3), used by se3 exp (V matrix)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2 * theta),
    )
    K = hat(phi)
    return _eye3(phi, K.shape) + b[..., None, None] * K + c[..., None, None] * (K @ K)


def _so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    half = theta * 0.5
    sin_half = torch.where(small, torch.ones_like(half), torch.sin(half) + _EPS)
    cot = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / sin_half) / (theta2 + _EPS),
    )
    K = hat(phi)
    return _eye3(phi, K.shape) - 0.5 * K + cot[..., None, None] * (K @ K)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exp map, (...,6) [rho, phi] -> (...,4,4) homogeneous transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = _so3_left_jacobian(phi)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return make_T(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Log map, (...,4,4) -> (...,6) [rho, phi]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    phi = so3_log(R)
    Vinv = _so3_left_jacobian_inv(phi)
    rho = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([rho, phi], dim=-1)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (...,4,4) from (...,3,3) and (...,3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    # fill_ on the device: item assignment of a Python number copies it
    # from the host, a host sync on the card
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def inv_T(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform (...,4,4), exploiting orthogonality."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_T(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block of (...,4,4) back onto SO(3) by a
    quaternion round trip. Pose chains amplify non-orthonormality
    exponentially in f32, so every solver entry point cleans its input."""
    R = quat_to_rotmat(rotmat_to_quat(T[..., :3, :3]))
    return make_T(R, T[..., :3, 3])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (...,4,4) to points (...,N,3) -> (...,N,3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


# ---------------------------------------------------------------------------
# Quaternions (TUM trajectory convention: qx qy qz qw, Hamilton)
# ---------------------------------------------------------------------------

def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,4) as (qx, qy, qz, qw), qw >= 0.

    Branch-free Shepperd's method: all four candidates, pick the best.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def _safe(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 0.5

    cw = torch.stack(
        [(m21 - m12), (m02 - m20), (m10 - m01), qw2], dim=-1
    ) / (4.0 * _safe(qw2))[..., None]
    cx = torch.stack(
        [qx2, (m01 + m10), (m02 + m20), (m21 - m12)], dim=-1
    ) / (4.0 * _safe(qx2))[..., None]
    cy = torch.stack(
        [(m01 + m10), qy2, (m12 + m21), (m02 - m20)], dim=-1
    ) / (4.0 * _safe(qy2))[..., None]
    cz = torch.stack(
        [(m02 + m20), (m12 + m21), qz2, (m10 - m01)], dim=-1
    ) / (4.0 * _safe(qz2))[..., None]

    cands = torch.stack([cw, cx, cy, cz], dim=-2)  # (...,4,4)
    scores = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(scores, dim=-1)            # first maximum, as jnp
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(...,4) (qx,qy,qz,qw) -> (...,3,3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )

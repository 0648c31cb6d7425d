"""New-landmark triangulation between keyframe pairs (port of
slam_map/triangulation.py).

Replaces LocalMapping::CreateNewMapPoints (src/LocalMapping.cc:313):
epipolar-constrained ORB matching against a covisible keyframe
(SearchForTriangulation; ComputeF12 + CheckDistEpipolarLine,
src/LocalMapping.cc:743) as a masked Hamming matrix, then batched DLT with
cheirality, reprojection and parallax checks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.camera import Camera
from ..geometry.triangulate import triangulate_dlt
from ..ops import hamming


class TriangulationResult(NamedTuple):
    points_w: torch.Tensor   # (N, 3) per new-KF keypoint slot
    match_j: torch.Tensor    # (N,) matched keypoint index in the other KF (-1)
    good: torch.Tensor       # (N,) bool passes all checks


def _fundamental_from_poses(K: torch.Tensor, T1: torch.Tensor, T2: torch.Tensor):
    """F12 such that x2^T F x1 = 0 for pixel coords (ComputeF12)."""
    T21 = T2 @ se3.inv_T(T1)
    R, t = T21[:3, :3], T21[:3, 3]
    E = se3.hat(t) @ R
    Kinv = torch.linalg.inv_ex(K)[0]   # the _ex form checks nothing: no sync
    return Kinv.T @ E @ Kinv


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[:, :1])], dim=-1)


def triangulate_pair(
    cam: Camera,
    # new keyframe (1)
    xy1, desc1, valid1, unmatched1, angle1, T1,
    # neighbour keyframe (2)
    xy2, desc2, valid2, unmatched2, angle2, T2,
    min_parallax_cos: float = 0.9998,
    epi_th: float = 1.5,
    reproj_th2: float = 5.991,
    max_dist: int = 50,
) -> TriangulationResult:
    K = cam.K
    F12 = _fundamental_from_poses(K, T1, T2)

    d = hamming.hamming_matrix(desc1, desc2)
    ok = (valid1 & unmatched1)[:, None] & (valid2 & unmatched2)[None, :]
    # epipolar gate on every candidate pair: distance of xy2[j] to the
    # epipolar line of xy1[i], computed densely then masked
    lines = _homogeneous(xy1) @ F12.T                           # (N,3) in im2
    num = torch.abs(lines @ _homogeneous(xy2).T)
    den = torch.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2)[:, None]
    epi_ok = num / torch.clamp(den, min=1e-9) < epi_th
    res = hamming.match(
        hamming.apply_mask(d, ok & epi_ok),
        max_dist=max_dist, nn_ratio=0.75, mutual=True,
        angle_q=angle1, angle_t=angle2,
    )

    j = torch.clamp(res.idx, min=0)
    P1 = K @ T1[:3]
    P2 = K @ T2[:3]
    X2 = xy2[j]
    X, _ = triangulate_dlt(P1, P2, xy1, X2)

    # checks: cheirality in both views, reprojection, parallax
    pc1 = se3.transform_points(T1, X)
    pc2 = se3.transform_points(T2, X)

    def reproj_err2(P, x):
        y = _homogeneous(X) @ P.T
        uv = y[:, :2] / torch.clamp(y[:, 2:], min=1e-9)
        return torch.sum((uv - x) ** 2, dim=-1)

    e1 = reproj_err2(P1, xy1)
    e2 = reproj_err2(P2, X2)
    r1 = X - se3.inv_T(T1)[:3, 3]
    r2 = X - se3.inv_T(T2)[:3, 3]
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(r1, dim=-1) * torch.linalg.vector_norm(r2, dim=-1),
        min=1e-9)
    good = (
        res.valid
        & (pc1[:, 2] > 0.05) & (pc2[:, 2] > 0.05)
        & (e1 < reproj_th2) & (e2 < reproj_th2)
        & (cosp < min_parallax_cos)
        & torch.isfinite(X).all(dim=-1)
    )
    return TriangulationResult(points_w=X, match_j=res.idx, good=good)

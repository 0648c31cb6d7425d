"""Trajectory evaluation: ATE and RPE (a frozen copy of the port's
``io/evaluate.py``, kept with the benchmark so that the yardstick does not
move with the program).

ATE follows the standard TUM benchmark definition:
Umeyama/Horn alignment of estimated to ground-truth positions, then RMSE of
residual translations. RPE compares relative motions over a fixed frame
delta.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def align_umeyama(x: np.ndarray, y: np.ndarray, with_scale: bool = False):
    """Least-squares similarity aligning x (N,3) onto y (N,3).

    Returns (s, R, t) with y ~ s * R @ x + t. Horn/Umeyama closed form --
    the same mathematics as the reference's Sim3Solver (src/Sim3Solver.cc:199)
    in its ATE-evaluation role.
    """
    mx = x.mean(axis=0)
    my = y.mean(axis=0)
    xc = x - mx
    yc = y - my
    cov = yc.T @ xc / len(x)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_x = (xc ** 2).sum() / len(x)
        s = float(np.trace(np.diag(D) @ S) / var_x)
    else:
        s = 1.0
    t = my - s * R @ mx
    return s, R, t


def ate_rmse(
    est_pos: np.ndarray,
    gt_pos: np.ndarray,
    with_scale: bool = False,
) -> float:
    """Absolute trajectory error RMSE after alignment; positions (N,3)."""
    s, R, t = align_umeyama(est_pos, gt_pos, with_scale)
    aligned = (s * (R @ est_pos.T)).T + t
    err = aligned - gt_pos
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rpe(
    est_cw: np.ndarray, gt_cw: np.ndarray, delta: int = 1
) -> Tuple[float, float]:
    """Relative pose error over frame delta.

    est_cw, gt_cw: (N,4,4) camera-from-world poses.
    Returns (trans_rmse, rot_rmse_rad).
    """
    def rel(T):
        # camera motion between i and i+delta: T_i+d->i = Tcw_{i+d} @ Twc_i
        inv = np.linalg.inv(T)
        return np.matmul(T[delta:], inv[:-delta])

    e = rel(np.asarray(est_cw))
    g = rel(np.asarray(gt_cw))
    d = np.matmul(np.linalg.inv(g), e)
    trans = np.sqrt((d[:, :3, 3] ** 2).sum(axis=1))
    cos = np.clip((np.trace(d[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)
    rot = np.arccos(cos)
    return float(np.sqrt((trans ** 2).mean())), float(np.sqrt((rot ** 2).mean()))


def positions_from_cw(poses_cw: np.ndarray) -> np.ndarray:
    """(N,4,4) Tcw -> (N,3) camera centers in world frame."""
    R = poses_cw[:, :3, :3]
    t = poses_cw[:, :3, 3]
    return -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), t)

"""Trajectory file IO, byte-format-compatible with the reference.

Writers mirror System::SaveTrajectoryTUM / SaveKeyFrameTrajectoryTUM /
SaveTrajectoryKITTI (reference src/System.cc:429,520,567): TUM format is
``timestamp tx ty tz qx qy qz qw`` of the camera-to-world transform Twc;
KITTI format is the 3x4 row-major Twc matrix per line.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


def _twc(Tcw: np.ndarray) -> np.ndarray:
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    Twc = np.eye(4, dtype=np.float64)
    Twc[:3, :3] = R.T
    Twc[:3, 3] = -R.T @ t
    return Twc


def _quat_wxyz_from_R(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qx, qy, qz, qw), qw >= 0 (host-side numpy)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    q = np.array([qx, qy, qz, qw])
    if qw < 0:
        q = -q
    return q


def save_tum(path: str, timestamps: Sequence[float], poses_cw: Sequence[np.ndarray]):
    """Write TUM-format trajectory (Twc), like SaveTrajectoryTUM."""
    with open(path, "w") as f:
        for ts, Tcw in zip(timestamps, poses_cw):
            Twc = _twc(np.asarray(Tcw, np.float64))
            q = _quat_wxyz_from_R(Twc[:3, :3])
            t = Twc[:3, 3]
            f.write(
                f"{ts:.6f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
            )


def save_kitti(path: str, poses_cw: Sequence[np.ndarray]):
    with open(path, "w") as f:
        for Tcw in poses_cw:
            Twc = _twc(np.asarray(Tcw, np.float64))
            row = Twc[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def load_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read TUM format -> (timestamps (N,), Twc poses (N,4,4))."""
    ts: List[float] = []
    poses: List[np.ndarray] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) < 8:
                continue
            t, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
            qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
            R = np.array(
                [
                    [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
                    [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
                    [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
                ]
            )
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = [tx, ty, tz]
            ts.append(t)
            poses.append(T)
    return np.asarray(ts), np.asarray(poses)

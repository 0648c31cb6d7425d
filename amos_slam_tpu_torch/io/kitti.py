"""KITTI odometry stereo dataset loading (the port's copy of io/kitti.py).

The counterpart of Examples/Stereo/stereo_kitti.cc's LoadImages: image_0 /
image_1 grey pairs with times.txt. The calibrations of sequences 00-02, 03
and 04-12 are the reference's KITTI00-02.yaml, KITTI03.yaml and
KITTI04-12.yaml (:func:`kitti_camera_config`).
"""

from __future__ import annotations

import os

import numpy as np

from ..config import CameraConfig
from .tum import _imread


KITTI_CALIB = {
    # fx, fy, cx, cy, bf, width, height (the reference's Examples/Stereo yamls)
    "00-02": (718.856, 718.856, 607.1928, 185.2157, 386.1448, 1241, 376),
    "03": (721.5377, 721.5377, 609.5593, 172.854, 387.5744, 1242, 375),
    "04-12": (707.0912, 707.0912, 601.8873, 183.1104, 379.8145, 1226, 370),
}


def kitti_camera_config(sequence: int) -> CameraConfig:
    if sequence <= 2:
        k = KITTI_CALIB["00-02"]
    elif sequence == 3:
        k = KITTI_CALIB["03"]
    else:
        k = KITTI_CALIB["04-12"]
    fx, fy, cx, cy, bf, w, h = k
    return CameraConfig(
        fx=fx, fy=fy, cx=cx, cy=cy, bf=bf, width=w, height=h,
        fps=10.0, th_depth=35.0, depth_map_factor=1.0,
    )


class KittiStereoDataset:
    """Iterates (left_gray, right_gray, timestamp)."""

    def __init__(self, seq_dir: str):
        self.left_dir = os.path.join(seq_dir, "image_0")
        self.right_dir = os.path.join(seq_dir, "image_1")
        with open(os.path.join(seq_dir, "times.txt")) as f:
            self.times = [float(line) for line in f if line.strip()]
        self.names = sorted(os.listdir(self.left_dir))

    def __len__(self):
        return min(len(self.times), len(self.names))

    def __getitem__(self, i: int):
        left = _imread(os.path.join(self.left_dir, self.names[i]))
        right = _imread(os.path.join(self.right_dir, self.names[i]))
        return left.astype(np.float32), right.astype(np.float32), self.times[i]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

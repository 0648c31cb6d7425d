"""EuRoC MAV dataset loading (the port's copy of io/euroc.py).

The counterpart of the loaders of Examples/Monocular/mono_euroc.cc and
Examples/Stereo/stereo_euroc.cc: cam0 / cam1 image streams with nanosecond
timestamps. The reference rectifies with cv::initUndistortRectifyMap; here
the raw images come with the EuRoC calibration, so the front end's analytic
undistortion handles them (mono), or the caller rectifies them (stereo).
"""

from __future__ import annotations

import csv
import os
from typing import List, Tuple

import numpy as np

from ..config import CameraConfig
from .tum import _imread


def euroc_camera_config() -> CameraConfig:
    """cam0 pinhole + radtan intrinsics (reference Examples/Monocular/EuRoC.yaml)."""
    return CameraConfig(
        fx=458.654, fy=457.296, cx=367.215, cy=248.375,
        k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05,
        width=752, height=480, fps=20.0,
    )


class EurocMonoDataset:
    """Iterates (gray, timestamp_seconds) over mav0/<cam>."""

    def __init__(self, root: str, cam: str = "cam0"):
        data_dir = os.path.join(root, "mav0", cam, "data")
        csv_path = os.path.join(root, "mav0", cam, "data.csv")
        self.items: List[Tuple[float, str]] = []
        if os.path.exists(csv_path):
            with open(csv_path) as f:
                for row in csv.reader(f):
                    if not row or row[0].startswith("#"):
                        continue
                    self.items.append(
                        (int(row[0]) * 1e-9, os.path.join(data_dir, row[1].strip())))
        else:
            for name in sorted(os.listdir(data_dir)):
                ts = int(os.path.splitext(name)[0]) * 1e-9
                self.items.append((ts, os.path.join(data_dir, name)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int):
        t, p = self.items[i]
        return _imread(p).astype(np.float32), t

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

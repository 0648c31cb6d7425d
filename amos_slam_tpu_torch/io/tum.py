"""TUM RGB-D dataset loading (the port's copy of io/tum.py; numpy and PIL
only).

The counterpart of the reference's example-main loaders
(Examples/RGB-D/rgbd_tum.cc:74 LoadImages over an associations file).
Images decode on the host; the grey conversion and the DepthMapFactor
scaling (src/Tracking.cc:329: depth / 5000) happen here, so the tracker
gets float32 (H, W) arrays.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


def _imread(path: str) -> np.ndarray:
    """PNG/PGM reader: PIL if available, else imageio."""
    try:
        from PIL import Image

        return np.asarray(Image.open(path))
    except ImportError:
        pass
    try:
        import imageio.v3 as iio

        return iio.imread(path)
    except ImportError as e:
        raise RuntimeError(f"no image backend available to read {path}") from e


def rgb_to_gray(img: np.ndarray, rgb_order: bool = True) -> np.ndarray:
    """BT.601 luma like cv::cvtColor (src/Tracking.cc:308-321)."""
    if img.ndim == 2:
        return img.astype(np.float32)
    c = img[..., :3].astype(np.float32)
    w = (0.299, 0.587, 0.114) if rgb_order else (0.114, 0.587, 0.299)
    return c[..., 0] * w[0] + c[..., 1] * w[1] + c[..., 2] * w[2]


@dataclass
class TumAssociation:
    timestamp: float
    rgb_path: str
    depth_path: str


def load_associations(assoc_file: str, root: str) -> List[TumAssociation]:
    """Parse an associations file: ``t_rgb rgb/... t_depth depth/...``."""
    out = []
    with open(assoc_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            if len(p) < 4:
                continue
            out.append(TumAssociation(timestamp=float(p[0]),
                                      rgb_path=os.path.join(root, p[1]),
                                      depth_path=os.path.join(root, p[3])))
    return out


def associate(rgb_list, depth_list, max_dt: float = 0.02):
    """Nearest-timestamp association (the TUM associate.py algorithm) for
    sequences without a prebuilt associations file."""
    out = []
    j = 0
    for t, rp in rgb_list:
        while j + 1 < len(depth_list) and abs(depth_list[j + 1][0] - t) <= abs(
            depth_list[j][0] - t
        ):
            j += 1
        if abs(depth_list[j][0] - t) <= max_dt:
            out.append((t, rp, depth_list[j][1]))
    return out


def read_list(path: str):
    """(timestamp, relative path) per line of a TUM ``rgb.txt`` /
    ``depth.txt``."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, p = line.split()[:2]
            out.append((float(t), p))
    return out


class TumRGBDDataset:
    """Iterates (gray, depth, rgb, timestamp) over a TUM sequence directory.

    With ``native`` it uses the C++ prefetching decoder
    (:mod:`.native_loader`, built at first use) -- PNG decode + luma/depth
    conversion happen in a worker thread pool ahead of the tracker -- and
    falls back to PIL when that library cannot be built, as the JAX
    package does."""

    def __init__(
        self,
        root: str,
        assoc_file: Optional[str] = None,
        depth_factor: float = 5000.0,
        native: bool = True,
    ):
        self.root = root
        self.depth_factor = depth_factor
        self._native = None
        if assoc_file is None:
            assoc_file = os.path.join(root, "associations.txt")
        if os.path.exists(assoc_file):
            self.items = load_associations(assoc_file, root)
        else:
            rgbs = read_list(os.path.join(root, "rgb.txt"))
            depths = read_list(os.path.join(root, "depth.txt"))
            self.items = [
                TumAssociation(t, os.path.join(root, r), os.path.join(root, d))
                for t, r, d in associate(rgbs, depths)
            ]
        if native:
            try:
                from . import native_loader

                self._native = native_loader.NativePrefetchLoader(
                    [(a.timestamp, a.rgb_path, a.depth_path) for a in self.items],
                    depth_factor=depth_factor,
                )
            except RuntimeError:
                self._native = None

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int):
        if self._native is not None:
            return self._native[i]
        a = self.items[i]
        rgb = _imread(a.rgb_path)
        gray = rgb_to_gray(rgb)
        depth = _imread(a.depth_path).astype(np.float32) / self.depth_factor
        return gray, depth, rgb, a.timestamp

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

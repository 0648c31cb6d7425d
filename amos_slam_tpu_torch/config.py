"""Configuration system (copy of amos_slam_tpu/config.py).

Typed dataclasses, field for field the same as the JAX package's, so one
configuration drives both packages (a test compares their
``dataclasses.fields``). ``load_yaml`` accepts the reference's OpenCV YAML
key names (``Camera.fx``, ``ORBextractor.nFeatures``, ...).

Shape-determining fields (image size, keypoint budgets, padding sizes,
iteration counts) are Python ints: they fix tensor shapes. Numeric
thresholds are plain floats.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class CameraConfig:
    fx: float = 535.4
    fy: float = 539.2
    cx: float = 320.1
    cy: float = 247.6
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    fps: float = 30.0
    bf: float = 40.0            # baseline * fx
    th_depth: float = 40.0      # close/far split: depth < bf*th_depth/fx
    depth_map_factor: float = 5000.0
    rgb_order: bool = True      # true = RGB, false = BGR (Camera.RGB)


@dataclass(frozen=True)
class ORBConfig:
    """ORB extraction (reference ORBextractor.* YAML keys + static pads)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    cell_size: int = 16          # spatial-balance cell in px (quadtree equivalent)
    border: int = 19             # detection margin (reference EDGE_THRESHOLD)
    max_kpts: int = 1024         # static padded keypoint capacity per frame
    patch_radius: int = 15       # IC_Angle patch (reference HALF_PATCH_SIZE)
    pattern_seed: int = 20240816  # rBRIEF sampling-pattern PRNG seed

    def level_scales(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** i for i in range(self.n_levels))

    def level_sizes(self, width: int, height: int):
        """Static (h, w) per pyramid level."""
        out = []
        for s in self.level_scales():
            out.append((int(round(height / s)), int(round(width / s))))
        return tuple(out)

    def level_budgets(self) -> Tuple[int, ...]:
        """Per-level keypoint budgets, geometric in 1/scale_factor like the
        reference's per-level feature allocation (src/ORBextractor.cc:530-556),
        adjusted so they sum to <= max_kpts with the last level absorbing
        rounding."""
        inv = 1.0 / self.scale_factor
        weights = [inv ** i for i in range(self.n_levels)]
        total_w = sum(weights)
        budgets = [int(round(self.n_features * w / total_w)) for w in weights]
        acc = 0
        out = []
        for b in budgets:
            b = min(b, self.max_kpts - acc)
            out.append(b)
            acc += b
        return tuple(out)


@dataclass(frozen=True)
class DynamicsConfig:
    """Two-stage dynamic rejection (not yet ported; kept so one
    SystemConfig describes both packages)."""

    n_clusters: int = 15              # k-means clusters (src/Frame.cc:525)
    slic_cell: int = 16               # SLIC cell length (reference uses 5)
    slic_compactness: float = 10.0    # SLIC m (src/cluster.cc:12)
    slic_iters: int = 3
    epipolar_inlier_th: float = 0.5   # dd <= 0.5 inlier (src/Tracking.cc:939)
    epipolar_outlier_th: float = 1.0  # dd > 1 -> T_M (src/Tracking.cc:1143)
    flow3d_th: float = 0.04           # |scene flow| cluster gate, meters/frame
    mean_rpe_th: float = 3.0          # cluster mean RPE gate (src/Frame.cc:626)
    mask_dilate_radius: int = 15      # seg-mask dilation (src/ORBextractor.cc:1698)
    slic_downsample: int = 1          # SLIC at 1/ds resolution
    max_flow_tracks: int = 1024       # static budget for LK tracks
    lk_win: int = 7                   # LK window half-size (15x15; ref 22x22)
    lk_levels: int = 4
    lk_iters: int = 6
    lk_downsample: int = 2            # LK on 1/n-res frames
    dyn_stride: int = 1               # run the geometric stage every Nth frame
    pnp_hypotheses: int = 256         # RANSAC pose hypotheses
    person_class_id: int = 0
    seg_score_th: float = 0.15
    seg_top_k: int = 15


@dataclass(frozen=True)
class TrackingConfig:
    min_matches_ref_kf: int = 10       # TrackReferenceKeyFrame gate
    min_matches_motion: int = 20
    min_inliers_local_map: int = 30
    min_inliers_after_reloc: int = 50
    match_radius_motion: float = 15.0  # px search window (th=7 * 2ish)
    match_radius_map: float = 3.0
    nn_ratio: float = 0.9
    th_low: int = 50                   # ORBmatcher TH_LOW
    th_high: int = 100                 # ORBmatcher TH_HIGH
    check_rotation: bool = True
    max_map_points_local: int = 4096   # static pad for local map view
    dispatch_window: int = 2           # max unresolved chunks in flight


@dataclass(frozen=True)
class MapConfig:
    max_keyframes: int = 512
    max_points: int = 32768
    max_obs_per_kf: int = 1024         # == ORBConfig.max_kpts
    covis_weight_th: int = 15
    local_window: int = 8              # KFs in local BA
    fixed_window: int = 4              # frontier KFs held fixed in local BA
    ba_max_points: int = 1024          # landmark slots per local BA solve
    loop_consistency_th: int = 3       # consecutive consistent covisibility
                                       # groups (LoopClosing.cc:48)
    ba_cadence: int = 1                # local BA every Nth keyframe
    maintenance_cadence: int = 3       # fusion/culling every Nth keyframe


@dataclass(frozen=True)
class SystemConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: ORBConfig = field(default_factory=ORBConfig)
    dynamics: DynamicsConfig = field(default_factory=DynamicsConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    map: MapConfig = field(default_factory=MapConfig)
    use_dynamics: bool = True
    use_segmentation: bool = True
    sensor: str = "rgbd"               # rgbd | stereo | mono
    deterministic: bool = False        # resolve each frame's host supervision
                                       # before dispatching the next


# ---------------------------------------------------------------------------
# Reference-compatible YAML loading (cv::FileStorage subset)
# ---------------------------------------------------------------------------

_REF_KEYS = {
    "Camera.fx": ("camera", "fx", float),
    "Camera.fy": ("camera", "fy", float),
    "Camera.cx": ("camera", "cx", float),
    "Camera.cy": ("camera", "cy", float),
    "Camera.k1": ("camera", "k1", float),
    "Camera.k2": ("camera", "k2", float),
    "Camera.p1": ("camera", "p1", float),
    "Camera.p2": ("camera", "p2", float),
    "Camera.k3": ("camera", "k3", float),
    "Camera.width": ("camera", "width", int),
    "Camera.height": ("camera", "height", int),
    "Camera.fps": ("camera", "fps", float),
    "Camera.bf": ("camera", "bf", float),
    "Camera.RGB": ("camera", "rgb_order", lambda v: bool(int(float(v)))),
    "ThDepth": ("camera", "th_depth", float),
    "DepthMapFactor": ("camera", "depth_map_factor", float),
    "ORBextractor.nFeatures": ("orb", "n_features", int),
    "ORBextractor.scaleFactor": ("orb", "scale_factor", float),
    "ORBextractor.nLevels": ("orb", "n_levels", int),
    "ORBextractor.iniThFAST": ("orb", "ini_th_fast", float),
    "ORBextractor.minThFAST": ("orb", "min_th_fast", float),
}


def load_yaml(path: str, base: Optional[SystemConfig] = None) -> SystemConfig:
    """Parse a reference-style OpenCV YAML settings file.

    The reference files are `%YAML:1.0` documents of flat `Key.sub: value`
    pairs (Examples/RGB-D/TUM3.yaml); a tiny regex parser keeps us independent
    of cv2/pyyaml.
    """
    cfg = base or SystemConfig()
    groups: dict = {"camera": {}, "orb": {}}
    pat = re.compile(r"^\s*([A-Za-z0-9_.]+)\s*:\s*([-+0-9.eE]+)\s*(#.*)?$")
    with open(path) as f:
        for line in f:
            m = pat.match(line)
            if not m:
                continue
            key, val = m.group(1), m.group(2)
            if key in _REF_KEYS:
                group, name, conv = _REF_KEYS[key]
                groups[group][name] = conv(val)
    cam = dataclasses.replace(cfg.camera, **groups["camera"])
    orb = dataclasses.replace(cfg.orb, **groups["orb"])
    return dataclasses.replace(cfg, camera=cam, orb=orb)

"""Frame feature extraction: the ORB front end (port of frontend/features.py).

Two stages, as in the JAX package:

  1. :meth:`ORBPipeline.detect_keypoints` -- pyramid, FAST-9 margin + NMS
     (the CUDA kernel, once per frame over the whole stacked pyramid),
     spatially balanced selection, patch gather, intensity-centroid angle.
  2. :meth:`ORBPipeline.describe` -- optional mask suppression, rBRIEF
     descriptors, undistortion, RGB-D stereo synthesis.

Both work on one static (max_kpts,)-padded keypoint set; deletion is a mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import CameraConfig, ORBConfig
from ..device import resolve_device
from ..geometry.camera import Camera, undistort_points
from ..ops import fast as fast_ops
from ..ops import orb_descriptor as orb_ops
from ..ops import pyramid as pyr_ops
from ..ops.kernels.fast_margin_nms import fast_margin_nms
from ..utils.profiling import span


class Keypoints(NamedTuple):
    """Padded keypoint set (capacity = ORBConfig.max_kpts)."""

    xy: torch.Tensor          # (K, 2) float32, level-0 pixel coords (x, y), raw
    level: torch.Tensor       # (K,) int32
    response: torch.Tensor    # (K,) float32 FAST margin
    angle: torch.Tensor       # (K,) float32 radians
    yx_level: torch.Tensor    # (K, 2) float32 coords at native level (y, x)
    valid: torch.Tensor       # (K,) bool


class FrameFeatures(NamedTuple):
    """Everything tracking needs from one image (reference Frame fields)."""

    kp: Keypoints
    xy_un: torch.Tensor       # (K, 2) float32 undistorted level-0 coords
    desc: torch.Tensor        # (K, 256) int8 bitplanes
    depth: torch.Tensor       # (K,) float32 (<=0: none)   [mvDepth]
    u_right: torch.Tensor     # (K,) float32 (<0: mono)    [mvuRight]
    inv_sigma2: torch.Tensor  # (K,) float32 per-level information
    valid: torch.Tensor       # (K,) bool (post mask suppression)


def _camera(cfg: CameraConfig, device) -> Camera:
    return Camera.create(
        cfg.fx, cfg.fy, cfg.cx, cfg.cy,
        dist=[cfg.k1, cfg.k2, cfg.p1, cfg.p2, cfg.k3],
        bf=cfg.bf, width=cfg.width, height=cfg.height, device=device,
    )


class ORBPipeline:
    """Extraction context: sizes, budgets, pattern and the constant tables,
    resident on ``device`` (default: the CUDA card; raises without one)."""

    def __init__(self, orb: ORBConfig, cam_cfg: CameraConfig, device=None):
        self.device = resolve_device(device)
        self.orb = orb
        self.cam_cfg = cam_cfg
        self.cam = _camera(cam_cfg, self.device)
        self.sizes = orb.level_sizes(cam_cfg.width, cam_cfg.height)
        self.budgets = orb.level_budgets()
        self.capacity = orb.max_kpts
        self.scales = torch.tensor(orb.level_scales(), dtype=torch.float32,
                                   device=self.device)
        self.sample_table = orb_ops.bin_sample_table(
            orb_ops.make_brief_pattern(orb.pattern_seed), self.device)
        self.resize_w = pyr_ops.resize_weights(self.sizes, self.device)
        # (h, w) of each level in its (H, W) slot: the FAST kernel computes
        # only the tiles that meet them and writes 0 beyond them.
        self.level_extents = torch.tensor(self.sizes, dtype=torch.int32,
                                          device=self.device)

    # -- stage 1 ----------------------------------------------------------
    def detect_keypoints(self, image: torch.Tensor):
        """image (H, W) [0,255] -> (Keypoints, pyramid, blurred, patches)."""
        with span("slam.orb.detect"):
            image = image.to(self.device, torch.float32)
            pyr = pyr_ops.build_pyramid(image, self.sizes, self.resize_w)
            blurred = pyr_ops.blur_pyramid(pyr)

            # FAST margin + NMS for all levels in one kernel launch. Each level
            # is its own image: circle reads wrap within its zero-padded H x W
            # slot, not within the level, and the margins are kept only inside
            # the level's extent. Both the wrap and the padding reach no further
            # than the detection border, which the selection masks.
            margins = fast_margin_nms(pyr, self.level_extents)

            per_level = []
            for lvl, ((h, w), budget) in enumerate(zip(self.sizes, self.budgets)):
                if budget <= 0:
                    continue
                lk = fast_ops.select_from_margin(
                    margins[lvl], (h, w), budget,
                    min_th=self.orb.min_th_fast,
                    border=self.orb.border,
                    cell=self.orb.cell_size,
                )
                per_level.append((lvl, lk))

            yx = torch.cat([lk.yx for _, lk in per_level])
            score = torch.cat([lk.score for _, lk in per_level])
            valid = torch.cat([lk.valid for _, lk in per_level])
            level = torch.cat([
                torch.full((lk.yx.shape[0],), l, dtype=torch.int32, device=self.device)
                for l, lk in per_level
            ])
            pad = self.capacity - yx.shape[0]
            if pad > 0:
                yx = F.pad(yx, (0, 0, 0, pad))
                score = F.pad(score, (0, pad))
                valid = F.pad(valid, (0, pad))
                level = F.pad(level, (0, pad))

            # One patch per keypoint from the blurred pyramid feeds both the
            # orientation and the descriptor sampler.
            patches = orb_ops.gather_patches(blurred, level, yx)
            angle = orb_ops.orientations_from_patches(patches)
            scale = self.scales[level.long()]
            xy0 = torch.stack([yx[:, 1] * scale, yx[:, 0] * scale], dim=-1)
            kp = Keypoints(
                xy=xy0, level=level, response=score, angle=angle,
                yx_level=yx, valid=valid,
            )
            return kp, pyr, blurred, patches

    # -- stage 2 ----------------------------------------------------------
    def describe(
        self,
        kp: Keypoints,
        patches: torch.Tensor,
        depth_image: Optional[torch.Tensor] = None,
        suppress_mask: Optional[torch.Tensor] = None,
    ) -> FrameFeatures:
        """Descriptors + undistortion + RGB-D stereo for surviving keypoints.

        suppress_mask: optional (H, W) bool/int; keypoints whose level-0
        position lands on a nonzero pixel are dropped (reference
        MovingKeyPoints, src/ORBextractor.cc:1688-1745).
        """
        with span("slam.orb.describe"):
            valid = kp.valid
            H, W = self.cam_cfg.height, self.cam_cfg.width
            xi = torch.clamp(torch.round(kp.xy[:, 0]).long(), 0, W - 1)
            yi = torch.clamp(torch.round(kp.xy[:, 1]).long(), 0, H - 1)
            if suppress_mask is not None:
                hit = suppress_mask.to(self.device, torch.int32)[yi, xi] > 0
                valid = valid & ~hit

            desc = orb_ops.descriptors_from_patches(patches, kp.angle, self.sample_table)
            xy_un = undistort_points(self.cam, kp.xy)

            none = torch.full((self.capacity,), -1.0, dtype=torch.float32,
                              device=self.device)
            if depth_image is not None:
                d = depth_image.to(self.device, torch.float32)[yi, xi]
                has_d = (d > 0.0) & valid
                u_right = torch.where(
                    has_d, xy_un[:, 0] - self.cam.bf / torch.clamp(d, min=1e-6), none
                )
                depth = torch.where(has_d, d, none)
            else:
                depth, u_right = none, none

            inv_sigma2 = 1.0 / (self.scales[kp.level.long()] ** 2)
            return FrameFeatures(
                kp=kp, xy_un=xy_un, desc=desc, depth=depth, u_right=u_right,
                inv_sigma2=inv_sigma2, valid=valid,
            )

    def extract(self, image, depth_image=None, suppress_mask=None) -> FrameFeatures:
        """Full extraction in one call (non-dynamic path)."""
        kp, _, _, patches = self.detect_keypoints(image)
        return self.describe(kp, patches, depth_image, suppress_mask)

"""Frame-to-frame tracking: the motion-model odometry core (port of the
odometry part of frontend/tracking.py).

TrackWithMotionModel (src/Tracking.cc:1908) with UpdateLastFrame's temporal
points (:1802): the last frame's depth-backed keypoints are projected with
the constant-velocity prediction, matched into the current frame inside a
window (a masked Hamming matrix), and the pose is refined by motion-only BA.
The fused per-frame functions of the JAX module (``fused_*``) come with the
map.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..device import resolve_device
from ..geometry import se3
from ..geometry.camera import Camera, backproject, in_image, project
from ..ops import hamming
from ..solvers.pose_opt import PoseObs, optimize_pose
from .features import FrameFeatures, ORBPipeline


class TrackStepResult(NamedTuple):
    Tcw: torch.Tensor
    num_matches: torch.Tensor
    num_inliers: torch.Tensor
    inlier: torch.Tensor          # (K,) over last-frame rows
    match_idx: torch.Tensor       # (K,) current-frame kp index per last-frame row


def track_motion_model(
    cam: Camera,
    cur: FrameFeatures,
    last: FrameFeatures,
    last_Tcw: torch.Tensor,
    T_pred: torch.Tensor,
    radius,
    max_dist: int = 100,
    opt_rounds: int = 2,
    opt_iters: int = 4,
    pts_w: Optional[torch.Tensor] = None,
    has_point: Optional[torch.Tensor] = None,
    two_pass: bool = True,
) -> TrackStepResult:
    """Match last frame's depth-backed keypoints into the current frame by
    projection window, then run motion-only BA.

    The contract of SearchByProjection(CurrentFrame, LastFrame, th)
    (src/ORBmatcher.cc:1569) + PoseOptimization: rows are last-frame points,
    columns are current keypoints; the search radius scales with the
    keypoint's pyramid level.

    pts_w/has_point: optional (N, 3)/(N,) world points per last-frame
    keypoint in place of its backprojected depth (monocular callers).
    """
    radius = torch.as_tensor(radius, dtype=torch.float32, device=last_Tcw.device)
    if pts_w is None:
        has_depth = last.valid & (last.depth > 0.0)
        pc_last = backproject(cam, last.xy_un, torch.clamp(last.depth, min=1e-3))
        pts_w = se3.transform_points(se3.inv_T(last_Tcw), pc_last)
    else:
        has_depth = has_point & last.valid

    level_scale = torch.rsqrt(torch.clamp(last.inv_sigma2, min=1e-9))

    # One Hamming matrix serves both passes; only the window changes.
    dist = hamming.hamming_matrix(last.desc, cur.desc)

    def match_and_optimize(T_center, rad, rounds):
        pc = se3.transform_points(T_center, pts_w)
        uv, z = project(cam, pc)
        vis = has_depth & (z > 0.05) & in_image(cam, uv, border=16.0)
        wmask = hamming.window_mask(uv, cur.xy_un, rad * level_scale, vis, cur.valid)
        res = hamming.match(
            hamming.apply_mask(dist, wmask),
            max_dist=max_dist,
            mutual=True,
            angle_q=last.kp.angle,
            angle_t=cur.kp.angle,
        )
        j = torch.clamp(res.idx, min=0)
        obs = PoseObs(
            points_w=pts_w,
            uv=cur.xy_un[j],
            u_right=torch.where(res.valid, cur.u_right[j], -1.0),
            inv_sigma2=cur.inv_sigma2[j],
            valid=res.valid,
        )
        return res, optimize_pose(
            T_center, cam, obs, rounds=rounds, iters_per_round=opt_iters,
            unroll=True,
        )

    # Pass 1: window around the motion prediction. Pass 2: a tight window
    # around the refined pose and one more chi2 round; it breaks
    # self-consistent aliased match sets when the prediction is off.
    res, opt = match_and_optimize(T_pred, radius, opt_rounds)
    if two_pass:
        res2, opt2 = match_and_optimize(
            opt.Tcw, torch.clamp(radius * 0.5, max=5.0), 1
        )
        # Keep pass 1 if the tight re-match collapsed.
        use2 = opt2.num_inliers >= torch.clamp(opt.num_inliers, max=20)
        res = type(res)(*(torch.where(use2, a, b) for a, b in zip(res2, res)))
        opt = type(opt)(*(torch.where(use2, a, b) for a, b in zip(opt2, opt)))
    return TrackStepResult(
        Tcw=opt.Tcw,
        num_matches=torch.sum(res.valid, dtype=torch.int32),
        num_inliers=opt.num_inliers,
        inlier=opt.inlier,
        match_idx=res.idx,
    )


class RGBDOdometry:
    """Host-side odometry loop (constant-velocity model, no map yet).

    Per frame: one ORB extraction (one FAST kernel launch) and one or two
    motion-model tracks. ``device`` defaults to the CUDA card and raises
    without one; pass ``device="cpu"`` for the plain path.
    """

    def __init__(self, cfg: SystemConfig, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.pipeline = ORBPipeline(cfg.orb, cfg.camera, self.device)
        self.cam = self.pipeline.cam
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        self.last_feats: Optional[FrameFeatures] = None
        self.last_Tcw = eye
        self.velocity = eye
        self.timestamps = []
        self.poses_cw = []
        self.stats = []
        self.lost = False

    def track(self, gray: np.ndarray, depth: np.ndarray, timestamp: float) -> np.ndarray:
        """One (H, W) gray image [0,255] and depth map [m] -> Tcw (4, 4)."""
        feats = self.pipeline.extract(
            torch.as_tensor(np.asarray(gray, np.float32)).to(self.device),
            depth_image=torch.as_tensor(np.asarray(depth, np.float32)).to(self.device),
        )
        if self.last_feats is None:
            Tcw = torch.eye(4, dtype=torch.float32, device=self.device)
            n_match = n_inl = 0
        else:
            T_pred = self.velocity @ self.last_Tcw
            radius = self.cfg.tracking.match_radius_motion
            res = track_motion_model(
                self.cam, feats, self.last_feats, self.last_Tcw, T_pred, radius,
            )
            n_match, n_inl = (int(v) for v in torch.stack(
                [res.num_matches, res.num_inliers]).cpu())
            if n_inl < self.cfg.tracking.min_matches_motion:
                # widen the window and retry (the reference doubles th and
                # re-searches, src/Tracking.cc:1934-1944)
                res = track_motion_model(
                    self.cam, feats, self.last_feats, self.last_Tcw, T_pred,
                    2.0 * radius,
                )
                n_match, n_inl = (int(v) for v in torch.stack(
                    [res.num_matches, res.num_inliers]).cpu())
            if n_inl >= 10:
                Tcw = res.Tcw
                self.velocity = Tcw @ se3.inv_T(self.last_Tcw)
                self.lost = False
            else:
                # LOST: hold the last pose, drop the velocity model (the
                # reference goes to LOST + relocalization, src/Tracking.cc:578).
                Tcw = self.last_Tcw
                self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
                self.lost = True
        self.last_feats = feats
        self.last_Tcw = Tcw
        Tcw_np = Tcw.cpu().numpy()
        self.timestamps.append(timestamp)
        self.poses_cw.append(Tcw_np.astype(np.float64))
        self.stats.append({"matches": n_match, "inliers": n_inl})
        return Tcw_np

"""Frame-to-frame tracking: the motion-model odometry core (port of the
odometry part of frontend/tracking.py).

TrackWithMotionModel (src/Tracking.cc:1908) with UpdateLastFrame's temporal
points (:1802): the last frame's depth-backed keypoints are projected with
the constant-velocity prediction, matched into the current frame inside a
window (a masked Hamming matrix), and the pose is refined by motion-only BA.

The fused frame step (:func:`fused_frame_step`) chains ORB extraction, a
single-pass motion-model track, the local-map track and the pose/velocity
update, and returns everything the host's keyframe decision needs as one
(3,) count vector. :func:`fused_stereo_step` does the same for a stereo
pair (both extractions and the stereo match), :func:`fused_mono_step` for
a monocular frame (the motion model projects the landmarks the last frame
matched). :func:`fused_frame_scan` runs W such steps over a chunk
of frames against one fixed local-map view (the JAX package's ``lax.scan``
is a Python loop here); :func:`make_dyn_chunk_fn` builds the two-stage
chunk, the geometric dynamic stage feeding each frame's step.
``RGBDOdometry`` is the map-free tracker.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import DynamicsConfig, SystemConfig
from ..device import resolve_device
from ..geometry import se3
from ..geometry.camera import Camera, backproject, in_image, project
from ..ops import hamming
from ..ops.slic import dilate_mask
from ..ops.stereo import match_stereo
from ..slam_map.slam_map import LocalMapTrackResult, LocalView, track_local_map
from ..solvers.pose_opt import PoseObs, optimize_pose
from ..utils.profiling import span
from .dynamics import compute_dynamics, config_kwargs
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


class FusedStepResult(NamedTuple):
    feats: FrameFeatures
    lm: LocalMapTrackResult     # for keyframe insertion / stats
    Tcw: torch.Tensor           # selected pose
    velocity: torch.Tensor      # updated constant-velocity model
    counts: torch.Tensor        # (2,) int32 [mm_inliers, lm_inliers]
    sup: torch.Tensor           # (3,) int32 [mm_inliers, lm_inliers, n_close]:
                                # the only per-frame device->host read; the
                                # keyframe decision needs nothing else
    sup_heavy: torch.Tensor     # (3N,) int32 [kp_point_id, kp_valid,
                                # depth>0]: the insertion payload, read only
                                # when the frame becomes a keyframe
    stats_acc: torch.Tensor     # (V, 2) int32 accumulated [visible, found]
                                # per local-view row, carried frame to frame
                                # and applied to the map once per view


def _pack_supervision(counts, lm, feats):
    """-> ((3,) counts, (3N,) heavy payload), both int32."""
    valid = feats.valid
    close = valid & (feats.depth > 0)
    sup = torch.cat([counts.to(torch.int32),
                     torch.sum(close, dtype=torch.int32)[None]])
    heavy = torch.cat([
        lm.kp_point_id.to(torch.int32),
        valid.to(torch.int32),
        (feats.depth > 0).to(torch.int32),
    ])
    return sup, heavy


def _accumulate_stats(stats_acc, lm) -> torch.Tensor:
    """Fold this frame's [visible, found] row booleans into the carried
    accumulator (None = cold start)."""
    delta = torch.stack([lm.visible_ids >= 0, lm.found_ids >= 0], dim=-1).to(torch.int32)
    return delta if stats_acc is None else stats_acc + delta


def _track_tail(pipe, feats, last, last_Tcw, velocity, view, mm_radius,
                map_radius, min_lm, stats_acc, two_pass=True, pts_w=None,
                has_point=None) -> FusedStepResult:
    """Both tracking stages and the state update of one extracted frame,
    shared by every fused step: the motion model (its 3D from the last
    frame's depth, or ``pts_w`` / ``has_point``), the local map from its
    pose (or the last pose, with a wider window, when it failed), the
    pose/velocity update with its own LOST fallback, the packed
    supervision and the stats accumulator."""
    with span("slam.track"):
        T_pred = se3.orthonormalize(velocity @ last_Tcw)
        mm = track_motion_model(
            pipe.cam, feats, last, last_Tcw, T_pred, mm_radius,
            pts_w=pts_w, has_point=has_point, two_pass=two_pass,
        )
        ok_mm = mm.num_inliers >= 10
        T0 = torch.where(ok_mm, mm.Tcw, last_Tcw)
        # widen the map window when the motion model failed (retry ladder)
        lm = track_local_map(
            pipe.cam, feats, view, T0, torch.where(ok_mm, map_radius, map_radius * 3.0)
        )
        ok_lm = lm.num_inliers >= min_lm
        Tcw = torch.where(ok_lm, lm.Tcw, T0)
        tracked = ok_lm | ok_mm
        eye = torch.eye(4, dtype=Tcw.dtype, device=Tcw.device)
        vel_new = torch.where(
            tracked, se3.orthonormalize(Tcw @ se3.inv_T(last_Tcw)), eye)
        Tcw = torch.where(tracked, Tcw, last_Tcw)
        counts = torch.stack([mm.num_inliers, lm.num_inliers])
        sup, sup_heavy = _pack_supervision(counts, lm, feats)
        return FusedStepResult(
            feats=feats, lm=lm, Tcw=Tcw, velocity=vel_new, counts=counts,
            sup=sup, sup_heavy=sup_heavy,
            stats_acc=_accumulate_stats(stats_acc, lm),
        )


def _frame_step_core(
    pipe, image, depth, last, last_Tcw, velocity, view,
    mm_radius, map_radius, min_lm, suppress_mask, stats_acc,
) -> FusedStepResult:
    """Body shared by fused_frame_step, fused_frame_scan and the two-stage
    chunk of make_dyn_chunk_fn: RGB-D extraction, then a single-pass motion
    model (the local-map track that follows re-matches from its pose, the
    reference's TrackLocalMap after TrackWithMotionModel,
    src/Tracking.cc:688)."""
    kp, _, _, patches = pipe.detect_keypoints(image)
    feats = pipe.describe(kp, patches, depth, suppress_mask)
    return _track_tail(pipe, feats, last, last_Tcw, velocity, view, mm_radius,
                       map_radius, min_lm, stats_acc, two_pass=False)


def fused_frame_step(
    pipe: ORBPipeline,
    image: torch.Tensor,
    depth: torch.Tensor,
    last: FrameFeatures,
    last_Tcw: torch.Tensor,
    velocity: torch.Tensor,
    view: LocalView,
    mm_radius: torch.Tensor,
    map_radius: torch.Tensor,
    min_lm: int = 30,
    suppress_mask: Optional[torch.Tensor] = None,
    stats_acc: Optional[torch.Tensor] = None,
) -> FusedStepResult:
    """One frame: ORB extraction + motion-model tracking + local-map
    tracking + the pose/velocity update, with no host read. The device
    state chain (pose, velocity, features) holds its own LOST fallback, so
    the host reads only ``sup`` to supervise.

    suppress_mask: optional (H, W) mask from compute_dynamics (or a dilated
    stage-one mask); keypoints on it are dropped before their descriptors
    (the Amos keypoint deletion)."""
    return _frame_step_core(
        pipe, image, depth, last, last_Tcw, velocity, view,
        mm_radius, map_radius, min_lm, suppress_mask, stats_acc,
    )


def fused_stereo_step(
    pipe: ORBPipeline,
    left: torch.Tensor,
    right: torch.Tensor,
    last: FrameFeatures,
    last_Tcw: torch.Tensor,
    velocity: torch.Tensor,
    view: LocalView,
    mm_radius: torch.Tensor,
    map_radius: torch.Tensor,
    min_z: torch.Tensor,
    min_lm: int = 30,
    stats_acc: Optional[torch.Tensor] = None,
) -> FusedStepResult:
    """One stereo frame with no host read: left and right extraction (two
    FAST launches; the reference's two std::threads, src/Frame.cc:161-170),
    subpixel stereo matching for depth and u_right, then both tracking
    stages (two-pass motion model) and the state update."""
    kp_l, _, bl, pl = pipe.detect_keypoints(left)
    kp_r, _, br, pr = pipe.detect_keypoints(right)
    feats = stereo_features(pipe, kp_l, bl, pl, kp_r, br, pr, min_z)
    return _track_tail(pipe, feats, last, last_Tcw, velocity, view, mm_radius,
                       map_radius, min_lm, stats_acc)


def stereo_features(pipe: ORBPipeline, kp_l, bl, pl, kp_r, br, pr, min_z) -> FrameFeatures:
    """Describe both images' keypoints and give the left ones the depth and
    u_right of :func:`~..ops.stereo.match_stereo` (on the blurred level-0
    images)."""
    fl = pipe.describe(kp_l, pl)
    fr = pipe.describe(kp_r, pr)
    sm = match_stereo(
        fl.desc, kp_l.xy, kp_l.level, fl.valid,
        fr.desc, kp_r.xy, kp_r.level, fr.valid,
        bl[0], br[0], pipe.cam.bf, min_z,
    )
    return fl._replace(depth=sm.depth, u_right=sm.u_right)


def fused_mono_step(
    pipe: ORBPipeline,
    image: torch.Tensor,
    last: FrameFeatures,
    last_pid: torch.Tensor,       # (N,) landmark id per last-frame keypoint (-1)
    pt_pos: torch.Tensor,         # (M, 3) landmark positions
    pt_alive: torch.Tensor,       # (M,) bool
    last_Tcw: torch.Tensor,
    velocity: torch.Tensor,
    view: LocalView,
    mm_radius: torch.Tensor,
    map_radius: torch.Tensor,
    min_lm: int = 30,
    stats_acc: Optional[torch.Tensor] = None,
) -> FusedStepResult:
    """One monocular frame with no host read. Monocular keypoints carry no
    depth, so the motion model's 3D is the landmarks the last frame matched
    (``last_pid``, from its local-map track): the reference's mono
    TrackWithMotionModel, which projects mLastFrame.mvpMapPoints
    (src/Tracking.cc:1908). The rest is the RGB-D step's."""
    kp, _, _, patches = pipe.detect_keypoints(image)
    feats = pipe.describe(kp, patches)
    pid = torch.clamp(last_pid, min=0).long()
    has_pt = (last_pid >= 0) & pt_alive[pid]
    return _track_tail(pipe, feats, last, last_Tcw, velocity, view, mm_radius,
                       map_radius, min_lm, stats_acc, pts_w=pt_pos[pid],
                       has_point=has_pt)


class ChunkYs(NamedTuple):
    """Per-frame outputs of a chunk, stacked along a leading W axis."""
    Tcw: torch.Tensor           # (W, 4, 4)
    sup: torch.Tensor           # (W, 3) per-frame count rows: the chunk's
                                # one host read
    sup_heavy: torch.Tensor     # (W, 3N) insertion payload rows, read per
                                # keyframe
    feats: FrameFeatures        # (W, ...) stacked


class FusedChunkResult(NamedTuple):
    feats: FrameFeatures        # final frame's features
    Tcw: torch.Tensor           # final pose
    velocity: torch.Tensor      # final velocity
    stats_acc: torch.Tensor     # (V, 2) accumulated [visible, found]
    ys: ChunkYs


def stack_tree(trees):
    """Stack a list of (nested) NamedTuples of tensors along a new axis 0."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return type(first)(*(stack_tree(list(xs)) for xs in zip(*trees)))


def index_tree(tree, j: int):
    """Row j of every leaf of a stacked (nested) NamedTuple (views)."""
    if isinstance(tree, torch.Tensor):
        return tree[j]
    return type(tree)(*(index_tree(x, j) for x in tree))


def fused_frame_scan(
    pipe: ORBPipeline,
    images: torch.Tensor,       # (W, H, Wd) chunk of frames
    depths: torch.Tensor,       # (W, H, Wd)
    last: FrameFeatures,
    last_Tcw: torch.Tensor,
    velocity: torch.Tensor,
    view: LocalView,            # fixed across the chunk
    mm_radius: torch.Tensor,
    map_radius: torch.Tensor,
    min_lm: int = 30,
    stats_acc: Optional[torch.Tensor] = None,
) -> FusedChunkResult:
    """W fused frame steps against one local-map view, with no host read:
    the caller resolves the chunk's keyframe decisions from its (W, 3)
    ``ys.sup`` after the chunk (the reference's LocalMapping inserts
    keyframes from its consumer thread with comparable latency,
    src/LocalMapping.cc:73)."""
    V = view.ids.shape[0]
    acc = (torch.zeros((V, 2), dtype=torch.int32, device=last_Tcw.device)
           if stats_acc is None else stats_acc)
    feats, Tcw, vel = last, last_Tcw, velocity
    rows = []
    for w in range(images.shape[0]):
        res = _frame_step_core(
            pipe, images[w], depths[w], feats, Tcw, vel, view, mm_radius,
            map_radius, min_lm, None, acc,
        )
        rows.append(ChunkYs(Tcw=res.Tcw, sup=res.sup,
                            sup_heavy=res.sup_heavy, feats=res.feats))
        feats, Tcw, vel, acc = res.feats, res.Tcw, res.velocity, res.stats_acc
    return FusedChunkResult(
        feats=feats, Tcw=Tcw, velocity=vel, stats_acc=acc, ys=stack_tree(rows)
    )


class DynChunkResult(NamedTuple):
    feats: FrameFeatures        # final frame's features
    Tcw: torch.Tensor
    velocity: torch.Tensor
    stats_acc: torch.Tensor
    gate_state: torch.Tensor    # (3,) EMA dynamic-gate levels (carried out)
    geom_mask: torch.Tensor     # (H, W) geometric cluster mask (carried out:
                                # dyn_stride > 1 reuses it across chunks; the
                                # stage-one mask applies fresh every frame)
    ys: ChunkYs


def make_dyn_chunk_fn(pipe: ORBPipeline, dcfg: DynamicsConfig, min_lm: int,
                      has_seg: bool):
    """The W-frame two-stage chunk: for each frame, the geometric stage
    (compute_dynamics) feeds keypoint suppression into the fused frame
    step, with features, pose, velocity, the EMA gate levels, the
    geometric mask and the stats accumulator carried frame to frame, and
    no host read. Stage-one masks for the whole chunk come in precomputed.

    With ``dyn_stride`` > 1 the geometric stage runs on frames whose index
    is a multiple of the stride (a host ``if`` on host ints), and the other
    frames reuse its cluster mask; the stage-one mask applies fresh every
    frame (a mover crosses ~15 px per frame and would trail a reused one)."""
    kw = dict(config_kwargs(dcfg), has_seg=has_seg)
    stride = dcfg.dyn_stride

    def dyn_chunk(
        images,        # (W, H, Wd)
        depths,        # (W, H, Wd)
        prev_g,        # (*, H, Wd) tail of the previous chunk ([-1] is used)
        prev_d,        # (*, H, Wd)
        segs,          # (W, H, Wd) stage-one masks, or None without them
        rgbs,          # (W, H, Wd, 3) or None
        last: FrameFeatures,
        last_Tcw, velocity, gates, mask_in, view, mm_radius, map_radius,
        fid0: int, stats_acc,
    ) -> DynChunkResult:
        V = view.ids.shape[0]
        acc = (torch.zeros((V, 2), dtype=torch.int32, device=last_Tcw.device)
               if stats_acc is None else stats_acc)
        feats, Tcw, vel, g8, geom = last, last_Tcw, velocity, gates, mask_in
        rows = []
        for i in range(images.shape[0]):
            pg = prev_g[-1] if i == 0 else images[i - 1]
            pd = prev_d[-1] if i == 0 else depths[i - 1]
            if stride <= 1 or (fid0 + i) % stride == 0:
                dyn = compute_dynamics(
                    pipe.cam, pg, pd, images[i], depths[i],
                    segs[i] if has_seg else None, Tcw, vel,
                    feats.kp.xy, feats.kp.valid, fid0 + i,
                    cur_rgb=None if rgbs is None else rgbs[i], gate_state=g8, **kw,
                )
                mask, geom, g8 = dyn.suppress_mask, dyn.geom_mask, dyn.gate_state
            else:
                mask = (dilate_mask(segs[i], dcfg.mask_dilate_radius) | geom
                        if has_seg else geom)
            res = _frame_step_core(
                pipe, images[i], depths[i], feats, Tcw, vel, view,
                mm_radius, map_radius, min_lm, mask, acc,
            )
            rows.append(ChunkYs(Tcw=res.Tcw, sup=res.sup,
                                sup_heavy=res.sup_heavy, feats=res.feats))
            feats, Tcw, vel, acc = res.feats, res.Tcw, res.velocity, res.stats_acc
        return DynChunkResult(
            feats=feats, Tcw=Tcw, velocity=vel, stats_acc=acc,
            gate_state=g8, geom_mask=geom, ys=stack_tree(rows),
        )

    return dyn_chunk


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

"""System facade: the public API (port of system.py): RGB-D, stereo and
monocular tracking.

Mirrors the reference's System class (src/System.cc:38-645: construction,
TrackRGBD, Reset, Shutdown, SaveTrajectoryTUM/KITTI) and the Tracking state
machine (src/Tracking.cc:467). Tracking is the caller's loop of fused frame
steps; local mapping (triangulation, fusion, culling, local BA) runs at
keyframe rate on the same thread.

Host supervision. The fused steps never read the device; the host
supervises them from small count vectors, as the JAX package does:

* ``deterministic=False`` (the default, the mode the package is deployed
  in) pipelines it. Each fast-path frame's (3,) vector, or a chunk's (W, 3)
  rows, goes home through ``_SupervisionReader``; each keyframe-rate table
  (the (3N,) insertion payload, triangulation with the BoW transform,
  fusion with culling) through ``_AsyncFetcher``, whose continuation runs
  that step's host half. On the card a submission is one ``non_blocking``
  copy into pinned host memory and a CUDA event (the copy engine does the
  JAX reader thread's work; no side thread takes the GIL); on the CPU it
  is a ``clone()``. Reads resolve FIFO at the drain points: before and
  after each dispatch. Dispatch runs ahead of supervision by at most 16
  frames per frame (``track_rgbd``, ``track_stereo``,
  ``track_monocular``) or ``dispatch_window`` chunks
  (``track_rgbd_chunk``): a keyframe decided at frame i is inserted
  later, and the frames after it are dispatched against the older
  local-map view. ``_flush_pending`` resolves everything before what
  needs it: the slow path, compaction, the trajectory exports, save /
  load / reset / localization mode / ``global_refine`` / ``shutdown``.
* ``deterministic=True`` resolves each call's reads and their keyframe
  work before the call returns (supervision lag zero), for tests and
  evaluation; ``track_rgbd_chunk`` then tracks frame by frame.

Two-stage dynamic rejection (``use_dynamics=True``, the default): with a
previous frame, each frame runs the geometric stage (compute_dynamics: LK
flow, PnP arbitration, epipolar and reprojection votes over SLIC/k-means
depth clusters) and its suppression mask drops keypoints before their
descriptors; a stage-one mask (``seg_mask`` / ``seg_masks``, any (H, W)
mask: the flagship takes ``models.segmenter.Segmenter.person_mask_batch``
of the chunk, a device tensor used without a copy) is dilated by
``mask_dilate_radius`` and joins it, also with ``use_dynamics=False``.
``rgb`` / ``rgbs`` make SLIC cluster in CIELAB.

Loop closing and relocalization (``loop.loop_closing.LoopCloser``, built
at the first keyframe with the given vocabulary or the package's
``data/default_vocab.npz``): every keyframe's BoW transform comes home in
the same read as its triangulation table; a verified loop corrects the map
(pose graph, landmark re-anchoring, fusion across the loop), rebases the
tracker by the keyframe's correction and starts a global BA that advances
one phase per keyframe; a LOST slow-path frame relocalizes against the
keyframe database.

Stereo (``sensor="stereo"``, ``track_stereo``): each frame's left and
right images are extracted (two FAST launches) and matched along the rows
(``ops.stereo.match_stereo``) for depth; the rest is the RGB-D pipeline,
fused into one step once tracking is OK. Monocular (``sensor="mono"``,
``track_monocular``): a two-view initializer (``solvers.initializer``)
builds the first two keyframes at unit median depth; the fused mono step's
motion model projects the landmarks the last frame matched. Neither runs
the dynamic stage (the JAX package's neither does).

Map checkpoints (``save_map`` / ``load_map``, ``slam_map.checkpoint``)
write the JAX package's npz, so a map saved by either package loads in the
other. ``debug_dir`` writes each frame's keypoint overlay
(``viewer.draw_frame``) there as ``<frame_id>_frame.png`` (``.npy``
without PIL), as the JAX package does.
"""

from __future__ import annotations

import collections
import enum
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import SystemConfig
from .device import resolve_device
from .frontend.dynamics import compute_dynamics, config_kwargs
from .frontend.features import FrameFeatures, ORBPipeline
from .frontend.tracking import (
    fused_frame_scan,
    fused_frame_step,
    fused_mono_step,
    fused_stereo_step,
    index_tree,
    make_dyn_chunk_fn,
    stereo_features,
    track_motion_model,
)
from .geometry import se3
from .io import trajectory
from .loop.global_ba import GlobalBundleAdjustment, run_global_refinement
from .loop.loop_closing import LoopCloser
from .loop.vocab_io import load_npz
from .loop.vocabulary import train_vocabulary
from .ops import hamming
from .ops.slic import dilate_mask
from .slam_map.map_state import add_points_kernel
from .slam_map.slam_map import SlamMap, track_local_map
from .solvers.initializer import initialize_two_view
from .utils.profiling import span


class TrackingState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


class _HostCopy:
    """The host copy of a tensor or a dict of tensors, started when it is
    made. On the card: the leaves' bytes in one device buffer (largest
    element first, so every leaf stays aligned), one ``non_blocking`` copy
    into pinned host memory on the current stream, and an event behind it;
    the copy takes the values the tensors hold in stream order, so a later
    in-place write does not reach it. On the CPU: a ``clone()`` of each
    leaf (a ``.cpu()`` of a CPU tensor would alias it, and the map is
    written in place). The pinned buffer lives as long as this object and
    the arrays :meth:`value` returns."""

    __slots__ = ("_keys", "_leaves", "_host", "_event")

    def __init__(self, dev):
        self._keys = sorted(dev, key=lambda k: -dev[k].element_size()) \
            if isinstance(dev, dict) else None
        leaves = [dev[k] for k in self._keys] if self._keys is not None else [dev]
        leaves = [t.detach() for t in leaves]
        self._leaves = [(t.dtype, t.shape) for t in leaves]
        self._event = None
        if leaves[0].device.type != "cuda":
            self._host = [t.clone() for t in leaves]
            return
        flat = leaves[0] if len(leaves) == 1 else torch.cat(
            [t.reshape(-1).view(torch.uint8) for t in leaves])
        self._host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        self._host.copy_(flat, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(flat.device))

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self) -> bool:
        """Block until the copy has landed; True if that took a wait."""
        if self.ready():
            return False
        with span("slam.supervision.wait"):
            self._event.synchronize()
        return True

    def value(self):
        """The host copy as numpy: an array, or a dict of arrays."""
        if isinstance(self._host, list):
            out = [t.numpy() for t in self._host]
        elif len(self._leaves) == 1:
            out = [self._host.numpy()]
        else:
            out, off = [], 0
            for dtype, shape in self._leaves:
                n = shape.numel() * dtype.itemsize
                out.append(self._host[off: off + n].view(dtype).reshape(shape).numpy())
                off += n
        return dict(zip(self._keys, out)) if self._keys is not None else out[0]


class _SupervisionReader:
    """FIFO reads of the fused steps' small supervision vectors (the JAX
    package's reader thread, same interface). ``submit((sup, payload))``
    starts ``sup``'s copy home; ``drain()`` returns ``(*payload,
    sup_host)`` for every read that has landed, oldest first, and stops at
    the first that has not (FIFO); ``wait_until(n)`` waits for the oldest
    reads until at most n are still in flight, which bounds how far
    dispatch runs ahead of supervision; ``flush()`` waits for all, then
    drains. An error in a copy raises here, on the caller's thread.
    ``waits`` counts the reads that had to be waited for."""

    def __init__(self):
        self._items = collections.deque()   # (_HostCopy, payload)
        self.waits = 0

    def submit(self, item):
        sup, payload = item
        self._items.append((_HostCopy(sup), payload))

    def wait_until(self, max_pending: int):
        unready = [c for c, _ in self._items if not c.ready()]
        for c in unready[: max(len(unready) - max_pending, 0)]:
            self.waits += c.wait()

    def drain(self):
        out = []
        while self._items and self._items[0][0].ready():
            c, payload = self._items.popleft()
            out.append((*payload, c.value()))
        return out

    def flush(self):
        self.wait_until(0)
        return self.drain()

    def stop(self):
        """Wait for every copy in flight (no thread to stop); the results
        stay for a later drain."""
        self.wait_until(0)


class _AsyncFetcher:
    """FIFO device->host reads with host continuations (the JAX package's
    fetcher thread, same interface). ``submit(dev, cont)`` starts the copy
    of ``dev`` (a tensor or a dict of tensors); ``drain()`` runs
    ``cont(host)`` for every copy that has landed, oldest first, stopping
    at the first that has not; ``flush()`` waits and drains until nothing
    is left (a continuation may submit more). Continuations run on the
    caller's thread, so every map mutation stays on it; one that raises
    propagates. ``waits`` counts the copies that had to be waited for."""

    def __init__(self):
        self._items = collections.deque()   # (_HostCopy, cont)
        self.waits = 0

    def submit(self, dev, cont):
        self._items.append((_HostCopy(dev), cont))

    def drain(self):
        while self._items and self._items[0][0].ready():
            c, cont = self._items.popleft()
            cont(c.value())

    def flush(self):
        while self._items:
            for c, _ in list(self._items):
                self.waits += c.wait()
            self.drain()

    def stop(self):
        self.flush()


class _ChunkRow(NamedTuple):
    """Row j of a chunk's stacked outputs (views, no copy)."""
    feats: FrameFeatures
    Tcw: torch.Tensor
    sup_heavy: torch.Tensor


class System:
    """The SLAM system facade for RGB-D, stereo and monocular input.

        slam = System(SystemConfig())
        for gray, depth, t in frames:
            Tcw = slam.track_rgbd(gray, depth, t)   # seg_mask=, rgb= optional
        slam.save_trajectory_tum("CameraTrajectory.txt")

    With ``SystemConfig(sensor="stereo")`` call ``track_stereo(left, right,
    t)``; with ``sensor="mono"``, ``track_monocular(gray, t)``.

    ``vocabulary``: a :class:`~.loop.vocabulary.Vocabulary` for place
    recognition (``loop.vocab_io`` loads .npz and ORBvoc.txt files,
    ``convert.vocabulary_from`` a JAX one); the package's default otherwise.
    ``device`` defaults to the CUDA card and raises without one; pass
    ``device="cpu"`` for the plain path.
    """

    def __init__(self, cfg: Optional[SystemConfig] = None, vocabulary=None,
                 debug_dir: Optional[str] = None, *, device=None):
        self.cfg = cfg or SystemConfig()
        self.device = resolve_device(device)
        # per-frame debug artifact dumping (the reference writes
        # output/<id>_rgb/_seg/_mask.png every frame, src/Tracking.cc:392-396)
        self.debug_dir = debug_dir
        if debug_dir:
            os.makedirs(debug_dir, exist_ok=True)
        self.pipeline = ORBPipeline(self.cfg.orb, self.cfg.camera, self.device)
        self.cam = self.pipeline.cam
        self.map = SlamMap(self.cfg, self.cam, self.device)
        # place recognition: built at the first keyframe (_ensure_loop_closer)
        self._vocabulary = vocabulary
        self.loop: Optional[LoopCloser] = None
        # pipelined host supervision (module docstring): the fast paths'
        # count vectors, and the keyframe-rate tables with their host halves
        self._reader = _SupervisionReader()
        self._fetcher = _AsyncFetcher()
        self._compacting = False

        self.state = TrackingState.NOT_INITIALIZED
        self.last_feats: Optional[FrameFeatures] = None
        self._eye = torch.eye(4, dtype=torch.float32, device=self.device)
        self.last_Tcw = self._eye
        self.velocity = self._eye
        self.ref_kf = 0
        self.last_kf_frame = -999
        self.last_kf_inliers = 0
        self.frame_id = -1

        self.timestamps = []
        self.poses_cw = []      # (4,4) per frame or (W,4,4) per chunk, on device
        # one entry per poses_cw entry: index into self._ref_epochs (the
        # (ref-keyframe uid, ref pose at track time) snapshot the frame was
        # tracked against), or -1 before initialization; corrected_poses_np
        # replays map corrections through it (the reference's mlpReferences
        # + track-time Tcr, src/Tracking.cc:806-815)
        self.frame_refs = []
        self._ref_epochs = []
        self._epoch_key = None
        self.stats = []
        # localization-only mode (reference ActivateLocalizationMode):
        # tracking continues, the map is frozen
        self.localization_only = False

        tc = self.cfg.tracking
        f32 = dict(dtype=torch.float32, device=self.device)
        self._r_mm = torch.tensor(tc.match_radius_motion, **f32)
        self._r_map = torch.tensor(tc.match_radius_map * 2.0, **f32)
        # landmark visible/found counters accumulate inside the fused frame
        # step ((V, 2) per local-view row) and apply to the map in one
        # scatter when the view changes or a keyframe is inserted
        self._stats_acc = None
        self._acc_ids = None
        # auto-reset when tracking is lost soon after initialization with a
        # tiny map (reference src/Tracking.cc:785-793)
        self._pending_reset = False
        self._clear_dynamics()
        self._clear_mono()

    def _clear_mono(self):
        """The monocular state: the held reference frame of the two-view
        initializer, and the last frame's landmark id per keypoint (a
        device (N,) tensor from its local-map track, -1 where unmatched)
        that the fused mono step's motion model projects."""
        self._mono_ref: Optional[FrameFeatures] = None
        self._last_pid: Optional[torch.Tensor] = None

    def _clear_dynamics(self):
        """The dynamic stage's carried state: the previous frame (grey and
        depth, or a chunk's stacks), its flow sources, the EMA gate levels
        ((3,) on the device, None = cold start at the absolute thresholds)
        and the last geometric mask (reused on dyn_stride frames), and the
        cached all-false mask that stands in for a missing one."""
        self._zero_masks = {}   # (H, W) -> all-false device mask
        self.prev_gray = None
        self.prev_depth = None
        self.prev_kp_xy = None
        self.prev_kp_valid = None
        self._dyn_gates = None
        self._dyn_mask = None

    def _upload(self, x, dtype=torch.float32) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype)
        if dtype is torch.bool:
            x = np.asarray(x) != 0
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device, dtype)

    def _zero_mask(self, shape) -> torch.Tensor:
        m = self._zero_masks.get(tuple(shape))
        if m is None:
            m = torch.zeros(tuple(shape), dtype=torch.bool, device=self.device)
            self._zero_masks[tuple(shape)] = m
        return m

    def _dynamic_suppress(self, g, d, seg, rgb, flow_xy, flow_valid) -> torch.Tensor:
        """This frame's suppression mask from the dynamic stage (state OK, a
        previous frame held). On a ``dyn_stride`` frame the last geometric
        mask is reused and the stage-one mask applies fresh (a mover
        trails a reused one); otherwise compute_dynamics runs on the
        previous frame and ``flow_xy`` / ``flow_valid`` (its corners) and
        its gate levels and geometric mask are carried on."""
        dcfg = self.cfg.dynamics
        if (dcfg.dyn_stride > 1 and self.frame_id % dcfg.dyn_stride != 0
                and self._dyn_mask is not None):
            return (self._dyn_mask if seg is None
                    else dilate_mask(seg, dcfg.mask_dilate_radius) | self._dyn_mask)
        dyn = compute_dynamics(
            self.cam, self.prev_gray, self.prev_depth, g, d, seg,
            self.last_Tcw, self.velocity, flow_xy, flow_valid, self.frame_id,
            has_seg=seg is not None, cur_rgb=rgb, gate_state=self._dyn_gates,
            **config_kwargs(dcfg),
        )
        self._dyn_gates = dyn.gate_state
        self._dyn_mask = dyn.geom_mask
        return dyn.suppress_mask

    def _maybe_auto_reset(self):
        if self._pending_reset:
            # the LOST verdict that asked for the reset may be stale: a
            # later frame in flight may have recovered (its resolve clears
            # the flag)
            self._flush_pending()
        if self._pending_reset:
            self._pending_reset = False
            self.reset()

    def _on_lost(self):
        self.state = TrackingState.LOST
        if self.map.n_kfs <= 5 and not self.localization_only:
            self._pending_reset = True

    def _flush_stats(self):
        """Apply the accumulated [visible, found] counters to the map (one
        scatter), then reset the accumulator."""
        if self._stats_acc is not None and self._acc_ids is not None:
            self.map.apply_stats_rows(self._acc_ids, self._stats_acc)
        self._stats_acc = None
        self._acc_ids = None

    def _view(self):
        """The current local-map view; the counters gathered against an
        older view are applied to its ids first."""
        with span("slam.map.view"):
            view = self.map.local_view(self.ref_kf)
            if self._acc_ids is not None and view.ids is not self._acc_ids:
                self._flush_stats()
            return view

    # ------------------------------------------------------------------ api
    def track_rgbd(self, gray, depth, timestamp: float, seg_mask=None, rgb=None):
        """One (H, W) gray image [0, 255] and depth map [m] in, the camera
        pose Tcw (4, 4) on the device out (reference System::TrackRGBD).

        seg_mask: optional (H, W) stage-one mask of dynamic objects (any
        dtype, nonzero = dynamic), dilated by ``mask_dilate_radius``.
        rgb: optional (H, W, 3) colour frame in [0, 255]; the dynamic
        stage's SLIC then clusters in CIELAB."""
        self._maybe_auto_reset()
        self.frame_id += 1
        g, d = self._upload(gray), self._upload(depth)
        c = None if rgb is None else self._upload(rgb)
        if self.prev_gray is not None and self.prev_gray.ndim == 3:
            # chunk -> per-frame: the chunk path keeps the previous stacks
            self.prev_gray = self.prev_gray[-1]
            self.prev_depth = self.prev_depth[-1]
        # keyframes resolved here reach this frame's local-map view
        self._pre_dispatch(16)

        use_dyn_fast = (self.cfg.use_dynamics and self.state is TrackingState.OK
                        and self.prev_gray is not None)
        use_plain_fast = (not self.cfg.use_dynamics and seg_mask is None
                          and self.state is TrackingState.OK)
        if use_dyn_fast or use_plain_fast:
            # fast path: (the dynamic stage, then) one fused frame step, its
            # (3,) vector read home behind it
            view = self._view()
            suppress = None
            if use_dyn_fast:
                # flow sources: the last frame's detected corners
                # (``kp.valid`` is their validity before suppression)
                seg = None if seg_mask is None else self._upload(seg_mask, torch.bool)
                suppress = self._dynamic_suppress(g, d, seg, c, self.last_feats.kp.xy,
                                                  self.last_feats.kp.valid)
            res = fused_frame_step(
                self.pipeline, g, d, self.last_feats, self.last_Tcw,
                self.velocity, view, self._r_mm, self._r_map,
                min_lm=self.cfg.tracking.min_inliers_local_map,
                suppress_mask=suppress, stats_acc=self._stats_acc,
            )
            self._acc_ids = view.ids
            self.prev_gray, self.prev_depth = g, d
            return self._fast_record(res, timestamp, g)

        self._flush_pending()
        seg = None if seg_mask is None else self._upload(seg_mask, torch.bool)
        feats = self._extract_with_dynamics(g, d, seg, rgb=c)
        init = self._initialize if self.state is TrackingState.NOT_INITIALIZED else None
        return self._slow_frame(feats, init, g, d, timestamp)

    def _slow_frame(self, feats, init, gray, depth, timestamp) -> torch.Tensor:
        """The slow path's tail: ``init(feats)`` before initialization, the
        split tracker after it; then the frame is recorded. The host half
        of a keyframe it made resolves as a continuation after the record,
        at the next drain point (before this call returns when
        deterministic)."""
        Tcw = init(feats) if init is not None else self._track(feats)
        Tcw = self._finish_frame(feats, Tcw, gray, depth, timestamp)
        if self.cfg.deterministic:
            self._settle()
        return Tcw

    def _drain(self):
        """Resolve every supervision read that has landed, then run the
        landed continuations (non-blocking)."""
        for done in self._reader.drain():
            self._resolve_done(*done)
        self._fetcher.drain()

    def _pre_dispatch(self, window: int):
        """Before a fast-path dispatch (pipelined): resolve what has landed,
        wait until at most ``window`` reads are in flight, resolve again. A
        bounded window keeps keyframe work interleaved with tracking in
        the device queue."""
        if self.cfg.deterministic:
            return
        with span("slam.supervision"):
            self._drain()
            self._reader.wait_until(window)
            self._drain()

    def _submit_sup(self, sup, res, frame_id: int):
        """Send a fast-path dispatch's supervision home, then resolve what
        has landed (all of it, and its keyframe work, when
        deterministic)."""
        with span("slam.supervision"):
            self._reader.submit((sup, (res, frame_id)))
            if self.cfg.deterministic:
                self._settle()
            else:
                self._drain()

    def _settle(self):
        """Resolve every read in flight and every continuation."""
        with span("slam.supervision"):
            for done in self._reader.flush():
                self._resolve_done(*done)
            self._fetcher.flush()

    def _flush_pending(self):
        """Resolve everything in flight, then apply the landmark counters."""
        with span("slam.supervision"):
            self._settle()
            self._flush_stats()

    def _fast_record(self, res, timestamp, gray) -> torch.Tensor:
        """Advance the device state chain by a fused step's result, record
        the frame (its reference epoch as of dispatch), and send its (3,)
        count vector home for supervision."""
        self._stats_acc = res.stats_acc
        self.last_feats = res.feats
        self.last_Tcw = res.Tcw
        self.velocity = res.velocity
        self.prev_kp_xy = res.feats.kp.xy
        self.prev_kp_valid = res.feats.kp.valid
        self.timestamps.append(timestamp)
        self.poses_cw.append(res.Tcw)
        self.frame_refs.append(self._ref_epoch())
        self._submit_sup(res.sup, res, self.frame_id)
        if self.debug_dir is not None:
            self._dump_debug(res.feats, gray)
        return res.Tcw

    def _extract_with_dynamics(self, g, d, seg, rgb=None) -> FrameFeatures:
        """The Amos split on the slow path: keypoints -> dynamic mask ->
        descriptors (reference GrabImageRGBD, src/Tracking.cc:297-406)."""
        kp, _, _, patches = self.pipeline.detect_keypoints(g)
        suppress = None
        if (self.cfg.use_dynamics and self.state is TrackingState.OK
                and self.prev_gray is not None):
            suppress = self._dynamic_suppress(g, d, seg, rgb, self.prev_kp_xy,
                                              self.prev_kp_valid)
        elif seg is not None:
            suppress = dilate_mask(seg, self.cfg.dynamics.mask_dilate_radius)
        # flow sources of the next frame's stage: all of this frame's
        # corners, before suppression (the JAX slow path's choice)
        self.prev_kp_xy, self.prev_kp_valid = kp.xy, kp.valid
        return self.pipeline.describe(kp, patches, d, suppress)

    def track_rgbd_chunk(self, grays, depths, timestamps, seg_masks=None, rgbs=None):
        """Throughput mode: W frames per call.

        grays/depths: (W, H, Wd) stacked frames; timestamps: length W;
        seg_masks: optional (W, H, Wd) stage-one masks; rgbs: optional
        (W, H, Wd, 3) colour. Returns the (W, 4, 4) poses. The W frame
        steps (each after its dynamic stage, with use_dynamics) run against
        one local-map view and the chunk's (W, 3) supervision rows go home
        in one read: keyframe decisions resolve at chunk granularity, at
        most ``dispatch_window`` chunks behind dispatch (supervision lag
        <= 2W frames at the default). Falls back to the per-frame path
        while not initialized, while LOST, with ``cfg.deterministic``, and,
        with use_dynamics, until a previous frame exists."""
        W = len(grays)
        use_dyn = self.cfg.use_dynamics and self.prev_gray is not None
        if (self.cfg.deterministic or self.state is not TrackingState.OK
                or (self.cfg.use_dynamics and not use_dyn)):
            return torch.stack([
                self.track_rgbd(grays[j], depths[j], timestamps[j],
                                seg_mask=None if seg_masks is None else seg_masks[j],
                                rgb=None if rgbs is None else rgbs[j])
                for j in range(W)
            ])

        self._pre_dispatch(self.cfg.tracking.dispatch_window)
        view = self._view()
        fid0 = self.frame_id + 1
        self.frame_id += W
        g, d = self._upload(grays), self._upload(depths)
        if use_dyn:
            segs = None if seg_masks is None else self._upload(seg_masks, torch.bool)
            res = self._dyn_chunk_call(
                g, d, segs, None if rgbs is None else self._upload(rgbs), view, fid0)
        else:
            # without the dynamic stage the chunk drops its stage-one masks,
            # as the JAX package's does
            res = fused_frame_scan(
                self.pipeline, g, d, self.last_feats, self.last_Tcw,
                self.velocity, view, self._r_mm, self._r_map,
                min_lm=self.cfg.tracking.min_inliers_local_map,
                stats_acc=self._stats_acc,
            )
        self._stats_acc = res.stats_acc
        self._acc_ids = view.ids
        self.last_feats = res.feats
        self.last_Tcw = res.Tcw
        self.velocity = res.velocity
        self.prev_kp_xy = res.feats.kp.xy
        self.prev_kp_valid = res.feats.kp.valid
        self.timestamps.extend(timestamps)
        self.poses_cw.append(res.ys.Tcw)
        self.frame_refs.append(self._ref_epoch())
        self._submit_sup(res.ys.sup, res, fid0)
        return res.ys.Tcw

    def _dyn_chunk_call(self, g, d, segs, rgbs, view, fid0: int):
        """Run the two-stage W-frame chunk."""
        fn = make_dyn_chunk_fn(self.pipeline, self.cfg.dynamics,
                               self.cfg.tracking.min_inliers_local_map, segs is not None)
        # per-frame -> chunk: lift the single previous frame to a stack
        pg, pd = self.prev_gray, self.prev_depth
        if pg.ndim == 2:
            pg, pd = pg[None], pd[None]
        gates = (self._dyn_gates if self._dyn_gates is not None
                 else torch.zeros(3, dtype=torch.float32, device=self.device))
        mask_in = (self._dyn_mask if self._dyn_mask is not None
                   else self._zero_mask(g.shape[1:]))
        res = fn(g, d, pg, pd, segs, rgbs, self.last_feats, self.last_Tcw,
                 self.velocity, gates, mask_in, view, self._r_mm, self._r_map,
                 fid0, self._stats_acc)
        self._dyn_gates = res.gate_state
        self._dyn_mask = res.geom_mask
        # the whole stacks stay: the next chunk reads their last rows
        self.prev_gray, self.prev_depth = g, d
        return res

    def track_stereo(self, left, right, timestamp: float):
        """A rectified (H, W) grey pair [0, 255] in, the pose Tcw (4, 4) on
        the device out (reference System::TrackStereo). Once tracking is
        OK, one fused stereo step, its (3,) vector read home behind it;
        around initialization and LOST, the split path: both extractions, the
        stereo match, then StereoInitialization or the slow tracker. Depth
        is kept from bf / fx (a disparity of at most fx) up."""
        self._maybe_auto_reset()
        self.frame_id += 1
        gl, gr = self._upload(left), self._upload(right)
        min_z = self.cam.bf / self.cam.fx
        # the JAX package only drains here; the window bounds the lag alike
        self._pre_dispatch(16)
        if self.state is TrackingState.OK:
            view = self._view()
            res = fused_stereo_step(
                self.pipeline, gl, gr, self.last_feats, self.last_Tcw,
                self.velocity, view, self._r_mm, self._r_map, min_z,
                min_lm=self.cfg.tracking.min_inliers_local_map,
                stats_acc=self._stats_acc,
            )
            self._acc_ids = view.ids
            return self._fast_record(res, timestamp, gl)

        self._flush_pending()
        kp_l, _, bl, pl = self.pipeline.detect_keypoints(gl)
        kp_r, _, br, pr = self.pipeline.detect_keypoints(gr)
        feats = stereo_features(self.pipeline, kp_l, bl, pl, kp_r, br, pr, min_z)
        self.prev_kp_xy, self.prev_kp_valid = kp_l.xy, kp_l.valid
        init = self._initialize if self.state is TrackingState.NOT_INITIALIZED else None
        return self._slow_frame(feats, init, gl, None, timestamp)

    def track_monocular(self, gray, timestamp: float):
        """One (H, W) grey image [0, 255] in, the pose Tcw (4, 4) on the
        device out (reference System::TrackMonocular). Once tracking is OK
        and the last frame matched landmarks, one fused mono step (its
        motion model projects those landmarks), its (3,) vector read home
        behind it;
        otherwise the split path: the two-view initializer, or the slow
        tracker (local map from the velocity prediction)."""
        self._maybe_auto_reset()
        self.frame_id += 1
        g = self._upload(gray)
        if self.state is TrackingState.OK and self._last_pid is not None:
            self._pre_dispatch(16)   # may resolve a LOST frame: check again
        if self.state is TrackingState.OK and self._last_pid is not None:
            view = self._view()
            a = self.map.arrays
            res = fused_mono_step(
                self.pipeline, g, self.last_feats, self._last_pid, a.pt_pos,
                a.pt_valid, self.last_Tcw, self.velocity, view, self._r_mm,
                self._r_map, min_lm=self.cfg.tracking.min_inliers_local_map,
                stats_acc=self._stats_acc,
            )
            self._acc_ids = view.ids
            self._last_pid = res.lm.kp_point_id
            return self._fast_record(res, timestamp, g)

        self._flush_pending()
        kp, _, _, patches = self.pipeline.detect_keypoints(g)
        feats = self.pipeline.describe(kp, patches)
        self.prev_kp_xy, self.prev_kp_valid = kp.xy, kp.valid
        init = (self._initialize_mono if self.state is TrackingState.NOT_INITIALIZED
                else None)
        return self._slow_frame(feats, init, g, None, timestamp)

    # ---------------------------------------------------- trajectory export
    def _ref_uid(self) -> int:
        """uid of the current reference keyframe (-1 before initialization)."""
        if self.map.n_kfs == 0:
            return -1
        return int(self.map.slot_uid[self.ref_kf])

    def _ref_epoch(self) -> int:
        """Index into self._ref_epochs for the current (ref uid, ref pose)
        pair; -1 before initialization.

        The reference composes each frame's relative pose Tcr against its
        reference keyframe's pose as of the frame's track time
        (src/Tracking.cc:806-815), so each frame records an epoch: a (uid,
        (4,4) pose) snapshot taken the first time a frame is tracked after
        any map mutation or reference change. The snapshot is a clone:
        ``kf_pose[ref_kf]`` alone would be a view, and local BA writes
        ``kf_pose`` in place."""
        if self.map.n_kfs == 0:
            return -1
        key = (id(self.map), self.map.version, self.ref_kf)
        if key != self._epoch_key:
            self._epoch_key = key
            self._ref_epochs.append((
                self._ref_uid(), self.map.arrays.kf_pose[self.ref_kf].clone()))
        return len(self._ref_epochs) - 1

    def _frame_poses_refs(self):
        """(per-frame raw Tcw float64 list, per-frame epoch index list);
        chunk entries ((W, 4, 4) stacks) expand in order. One host read."""
        if not self.poses_cw:
            return [], []
        flat = torch.cat([T.reshape(-1, 4, 4) for T in self.poses_cw])
        flat = flat.cpu().numpy().astype(np.float64)
        out, refs, i = [], [], 0
        for T, u in zip(self.poses_cw, self.frame_refs):
            n = T.reshape(-1, 4, 4).shape[0]
            out.extend(flat[i: i + n])
            refs.extend([u] * n)
            i += n
        return out, refs

    def poses_np(self):
        """All frame poses as recorded at track time (no corrections; see
        corrected_poses_np for the replayed export)."""
        self._flush_pending()
        return self._frame_poses_refs()[0]

    def corrected_poses_np(self):
        """Full-frame trajectory with map corrections applied retroactively:
        each frame is recomposed as ``Tcw = Tcr @ Tcw_ref(current)`` with
        ``Tcr = Tcw(track) @ inv(Tcw_ref(track))`` -- the reference's
        SaveTrajectoryTUM replay (src/System.cc:444-516). A culled reference
        keyframe resolves through its cull-time spanning-tree relative pose
        (KeyFrame::mTcp, src/System.cc:468-476). Frames whose reference
        cannot be resolved (before initialization, or before a reset) keep
        their raw pose. Pending supervision and an in-flight global BA are
        drained first."""
        self._flush_pending()
        if self.loop is not None:
            self.loop.flush_gba()
        raw, refs = self._frame_poses_refs()
        m = self.map
        cull_keys = list(m.uid_cull)
        dev = ([m.arrays.kf_pose] + [T for (_, T) in self._ref_epochs]
               + [m.uid_cull[u][1] for u in cull_keys])
        host = torch.cat([T.reshape(-1, 4, 4).to(self.device) for T in dev])
        host = host.cpu().numpy().astype(np.float64)
        K = m.arrays.kf_pose.shape[0]
        kf_now = host[:K]
        n_ep = len(self._ref_epochs)
        epochs = [(u, host[K + i]) for i, (u, _) in enumerate(self._ref_epochs)]
        cull = {u: (m.uid_cull[u][0], host[K + n_ep + i]) for i, u in enumerate(cull_keys)}
        uid2slot = {
            int(m.slot_uid[s]): s
            for s in range(m.n_kfs)
            if m.kf_alive[s] and m.slot_uid[s] >= 0
        }
        out = []
        for T_raw, e in zip(raw, refs):
            if e < 0:
                out.append(T_raw)
                continue
            u, T_ref = epochs[e]
            Tcr = T_raw @ trajectory._twc(T_ref)   # cam <- ref at track time
            ok = True
            while u not in uid2slot:
                nxt = cull.get(u)
                if nxt is None:   # chain broken (a reset dropped the map)
                    ok = False
                    break
                pu, Tcp = nxt
                Tcr = Tcr @ Tcp
                u = pu
            out.append(Tcr @ kf_now[uid2slot[u]] if ok else T_raw)
        return out

    def save_trajectory_tum(self, path: str):
        """Full-frame TUM export with corrections replayed against current
        keyframe poses (reference SaveTrajectoryTUM, src/System.cc:429)."""
        trajectory.save_tum(path, self.timestamps, self.corrected_poses_np())

    def save_trajectory_kitti(self, path: str):
        trajectory.save_kitti(path, self.corrected_poses_np())

    def save_keyframe_trajectory_tum(self, path: str):
        """Keyframe poses only (SaveKeyFrameTrajectoryTUM, src/System.cc:484),
        after pending supervision and an in-flight global BA are drained."""
        self._flush_pending()
        if self.loop is not None:
            self.loop.flush_gba()
        m = self.map
        kf_poses = m.arrays.kf_pose[: m.n_kfs].cpu().numpy().astype(np.float64)
        poses, stamps = [], []
        for k in range(m.n_kfs):
            if not m.kf_alive[k]:
                continue
            fid = int(m.kf_frame_id[k])
            if 0 <= fid < len(self.timestamps):
                stamps.append(self.timestamps[fid])
                poses.append(kf_poses[k])
        trajectory.save_tum(path, stamps, poses)

    def save_map(self, path: str):
        """Persist the full map (the reference's SaveMap TODO,
        include/System.h:148-151, made trivial by tensor storage). Pending
        supervision and landmark counters are applied first."""
        from .slam_map.checkpoint import save_map

        self._flush_pending()
        save_map(path, self.map)

    def load_map(self, path: str):
        from .slam_map.checkpoint import load_map

        # pending keyframe work holds the old map's slots: resolve it first
        self._settle()
        # counters gathered against the old map's view ids mean nothing now
        self._stats_acc = None
        self._acc_ids = None
        load_map(path, self.map)
        self.ref_kf = max(self.map.n_kfs - 1, 0)
        self._epoch_key = None   # force a fresh track-time ref snapshot

    def global_refine(self):
        """Full-map refinement (the reference's global BA): a pose-graph +
        structure-only pass that carries gross corrections, then the joint
        camera + structure LM over all keyframes."""
        self._flush_pending()
        if self.loop is not None:
            self.loop.flush_gba()
        run_global_refinement(self.map)
        if self.map.n_kfs >= 3:
            GlobalBundleAdjustment(self.map).run()

    def activate_localization_mode(self):
        """Track against the existing map without extending it (reference
        System::ActivateLocalizationMode)."""
        self._flush_pending()
        self.localization_only = True

    def deactivate_localization_mode(self):
        self._flush_pending()
        self.localization_only = False

    def reset(self):
        """Drop the map and tracking state (reference System::Reset)."""
        self._flush_pending()
        uid_next = self.map.kf_uid_next
        self.map = SlamMap(self.cfg, self.cam, self.device)
        # keyframe uids stay unique across resets, so frame_refs recorded
        # before the reset never alias new keyframes (they fall back to raw
        # poses in corrected_poses_np)
        self.map.kf_uid_next = uid_next
        self.loop = None
        self.state = TrackingState.NOT_INITIALIZED
        self.last_feats = None
        self.last_Tcw = self._eye
        self.velocity = self._eye
        self.ref_kf = 0
        self.last_kf_frame = -999
        self.last_kf_inliers = 0
        self._stats_acc = None
        self._acc_ids = None
        self._epoch_key = None
        self._clear_dynamics()
        self._clear_mono()

    def shutdown(self):
        """Resolve pending supervision, apply the counters, drain an
        in-flight global BA and wait for the device."""
        self._flush_pending()
        if self.loop is not None:
            self.loop.flush_gba()
        self._reader.stop()
        self._fetcher.stop()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------------------------------------------- host supervision
    def _resolve_done(self, res, frame_id: int, sup: np.ndarray):
        """Route one landed supervision read: a (3,) row supervises one
        frame; a chunk's (W, 3) block supervises its frames row by row."""
        if sup.ndim == 2:
            ys = res.ys
            for j in range(sup.shape[0]):
                row = _ChunkRow(feats=index_tree(ys.feats, j), Tcw=ys.Tcw[j],
                                sup_heavy=ys.sup_heavy[j])
                self._resolve_step(row, frame_id + j, sup[j])
        else:
            self._resolve_step(res, frame_id, sup)

    def _resolve_step(self, res, frame_id: int, sup: np.ndarray):
        """Host supervision of one fused-path frame: state machine,
        keyframe decision. ``sup`` is the frame's (3,) count vector
        [mm_inliers, lm_inliers, n_close], resolved after the frame (and,
        pipelined, after the frames dispatched since)."""
        tcfg = self.cfg.tracking
        n_mm, n_lm, n_close = int(sup[0]), int(sup[1]), int(sup[2])
        made_kf = False
        if n_lm >= tcfg.min_inliers_local_map:
            self.state = TrackingState.OK
            self._pending_reset = False   # recovery cancels a stale reset
            need_kf = (
                (frame_id - self.last_kf_frame >= 30)
                or (
                    frame_id - self.last_kf_frame >= 3
                    and n_lm < 0.75 * max(self.last_kf_inliers, 1)
                )
                or n_lm < 50
            )
            if need_kf and not self.localization_only:
                self._insert_kf(res, frame_id, n_lm, matched=True)
                made_kf = True
        elif n_mm >= 10:
            self.state = TrackingState.OK   # pure odometry frame
            self._pending_reset = False
            # Close-point-starved: the local map fell behind the camera;
            # re-seed it with a keyframe of this frame's close-depth
            # keypoints (all-new landmarks), the reference's insert-on-few-
            # close-points rule (src/Tracking.cc:2064-2208)
            if (
                not self.localization_only
                and frame_id - self.last_kf_frame >= 3
                and n_close >= 100
            ):
                self._insert_kf(res, frame_id, max(n_mm, 1), matched=False)
                made_kf = True
        else:
            # the device chain already held the pose; the next frame takes
            # the slow path
            self._on_lost()
        self.stats.append({"matches": n_mm, "inliers": n_lm, "kf": made_kf})

    def _insert_kf(self, res, frame_id: int, kf_inliers: int, matched: bool):
        """Insert a keyframe from a fused-path frame: the cadence state
        updates now (later decisions see it); the (3N,) payload goes home
        through the fetcher, and the insertion and its maintenance run as
        its continuation, FIFO with every other map mutation.
        ``matched=False`` is the odometry re-seed path (all landmarks
        new)."""
        N = self.cfg.orb.max_kpts
        self.last_kf_frame = frame_id
        self.last_kf_inliers = kf_inliers

        def insert(heavy):
            with span("slam.kf.insert", frame_id):
                self._maybe_compact()
                self._flush_stats()   # cull decisions see fresh counters
                if matched:
                    kp_point = heavy[:N].astype(np.int64)
                else:
                    kp_point = np.full(N, -1, np.int64)
                valid = heavy[N: 2 * N] > 0
                close = heavy[2 * N:] > 0
                self.ref_kf = self.map.insert_keyframe(
                    res.feats, res.Tcw, kp_point, frame_id, valid_close=(valid, close))
                self._keyframe_maintenance(self.ref_kf, frame_id)

        self._fetcher.submit(res.sup_heavy, insert)

    def _maybe_compact(self):
        """Reclaim culled keyframe slots when the map is near capacity
        (SlamMap.compact_keyframes); grow instead when too few are dead.
        Pending work holds slot ids, so it resolves first; a continuation
        it runs may land back here (the guard)."""
        if self.map.n_kfs < self.map.K - 2 or self._compacting:
            return
        self._compacting = True
        try:
            self._flush_pending()
            if self.map.n_kfs < self.map.K - 2:
                return
            # hysteresis: compacting for a handful of slots would thrash
            dead = self.map.n_kfs - int(self.map.kf_alive[: self.map.n_kfs].sum())
            if dead < max(4, self.map.K // 16):
                self.map.grow_keyframes()
                return
            lut = self.map.compact_keyframes()
            if lut[self.ref_kf] >= 0:
                self.ref_kf = int(lut[self.ref_kf])
            else:
                self.ref_kf = self.map.n_kfs - 1
            if self.loop is not None:
                self.loop.remap_slots(lut)
        finally:
            self._compacting = False

    # ------------------------------------------------- keyframe maintenance
    def _keyframe_maintenance(self, slot: int, frame_id: int):
        """Post-insertion maintenance for keyframe ``slot`` (decided at
        frame ``frame_id``, which its spans carry): triangulation
        and the loop closer's BoW transform (their two tables come home in
        one read), loop detection and correction, then (on a cadence)
        fusion + culling + landmark refresh, then local BA -- the
        reference's LocalMapping order (CreateNewMapPoints ->
        SearchInNeighbors -> local BA -> KeyFrameCulling,
        src/LocalMapping.cc:73) with LoopClosing fed in between. Each
        table's host half is a fetcher continuation."""
        with span("slam.kf.triangulate", frame_id):
            disp = self.map.create_new_points_dispatch(slot)
        fetch = {} if disp is None else {"tri": disp["packed"]}
        bow = None
        if self.loop is not None:
            with span("slam.kf.loop", frame_id):
                bow = self.loop.bow_dispatch(slot)
                fetch["bow"] = bow   # (2, N) f32 [word, weight]
                T_old = self.map.arrays.kf_pose[slot].clone()   # a view would follow
        if not fetch:
            self._post_triangulation(slot, frame_id)
            return

        def resolve(host):
            if disp is not None:
                with span("slam.kf.triangulate", frame_id):
                    self.map.create_new_points_resolve(slot, disp, host["tri"])
            if bow is not None:
                with span("slam.kf.loop", frame_id):
                    if self.loop.on_keyframe_resolve(slot, host["bow"]):
                        # the map was corrected: rebase the tracker by the
                        # keyframe's correction (the relative motion since the
                        # keyframe, and so the velocity, stand)
                        T_new = self.map.arrays.kf_pose[slot]
                        self.last_Tcw = self.last_Tcw @ se3.inv_T(T_old) @ T_new
            self._post_triangulation(slot, frame_id)

        self._fetcher.submit(fetch, resolve)

    def _post_triangulation(self, slot: int, frame_id: int):
        mcfg = self.cfg.map

        def finish():
            # BA last, so it optimizes the post-fusion observation set
            if slot % mcfg.ba_cadence == 0 or slot < 4:
                self.map.run_local_ba(slot)

        if slot % mcfg.maintenance_cadence != 1:
            finish()
            return
        # fusion and culling act on slowly accumulating redundancy: every
        # maintenance_cadence-th keyframe. Their two tables come home in
        # one read.
        with span("slam.kf.maintain", frame_id):
            fdisp = self.map.fuse_neighbors_dispatch(slot)
            fetch = {"cull": self.map.cull_points_dispatch()}
            if fdisp is not None:
                fetch["fuse"] = fdisp["packed"]

        def resolve(host):
            with span("slam.kf.maintain", frame_id):
                if fdisp is not None:
                    self.map.fuse_neighbors_resolve(slot, fdisp, host["fuse"])
                self.map.cull_points_resolve(host["cull"])
                self.map.cull_keyframes(slot)
                self.map.refresh_landmarks(slot)
            finish()

        self._fetcher.submit(fetch, resolve)

    def _dump_debug(self, feats, gray):
        from . import viewer

        overlay = viewer.draw_frame(gray, feats)
        try:
            from PIL import Image

            Image.fromarray(overlay).save(
                f"{self.debug_dir}/{self.frame_id:06d}_frame.png")
        except ImportError:
            np.save(f"{self.debug_dir}/{self.frame_id:06d}_frame.npy", overlay)

    def _finish_frame(self, feats, Tcw, gray, depth, timestamp):
        if self.debug_dir is not None:
            self._dump_debug(feats, gray)
        self.last_feats = feats
        self.last_Tcw = Tcw
        self.prev_gray = gray
        self.prev_depth = depth
        self.timestamps.append(timestamp)
        self.poses_cw.append(Tcw)
        self.frame_refs.append(self._ref_epoch())
        return Tcw

    # ------------------------------------------------------------- internals
    def _initialize(self, feats: FrameFeatures) -> torch.Tensor:
        """StereoInitialization (src/Tracking.cc:1343): the first frame with
        enough depth-valid keypoints becomes KF 0 + the initial landmarks."""
        n_depth = int(torch.sum(feats.valid & (feats.depth > 0)))
        if n_depth < 100:
            self.stats.append({"matches": 0, "inliers": 0, "kf": False})
            return self._eye
        kp_point = np.full(self.cfg.orb.max_kpts, -1, np.int64)
        with span("slam.kf.insert", self.frame_id):
            self.ref_kf = self.map.insert_keyframe(feats, self._eye, kp_point, self.frame_id)
        self.last_kf_frame = self.frame_id
        self.last_kf_inliers = n_depth
        self.state = TrackingState.OK
        self._ensure_loop_closer(feats)
        with span("slam.kf.loop", self.frame_id):
            self.loop.on_keyframe(self.ref_kf)
        self.stats.append({"matches": n_depth, "inliers": n_depth, "kf": True})
        return self._eye

    def _initialize_mono(self, feats: FrameFeatures) -> torch.Tensor:
        """Monocular bootstrapping (MonocularInitialization +
        CreateInitialMapMonocular, src/Tracking.cc:1441/1558): hold a
        reference frame, match it in a 100 px window (ratio 0.9, rotation
        consistency; SearchForInitialization, src/ORBmatcher.cc:515), run
        the two-view H/F initializer (its draws from a generator seeded
        with the frame id), scale the scene to a median depth of 1, insert
        both frames as keyframes with the landmarks they share, and polish
        with a local BA."""
        n_kp = int(torch.sum(feats.valid))
        no_kf = {"matches": 0, "inliers": 0, "kf": False}
        if self._mono_ref is None:
            if n_kp >= 100:
                self._mono_ref = feats
            self.stats.append(no_kf)
            return self._eye
        ref = self._mono_ref
        if n_kp < 100:
            self._mono_ref = None
            self.stats.append(no_kf)
            return self._eye

        dist = hamming.hamming_matrix(ref.desc, feats.desc)
        wmask = hamming.window_mask(ref.xy_un, feats.xy_un, 100.0, ref.valid, feats.valid)
        res = hamming.match(
            hamming.apply_mask(dist, wmask), max_dist=50, nn_ratio=0.9,
            mutual=True, angle_q=ref.kp.angle, angle_t=feats.kp.angle,
        )
        n_match = int(torch.sum(res.valid))
        if n_match < 100:
            self._mono_ref = feats
            self.stats.append({**no_kf, "matches": n_match})
            return self._eye

        j = torch.clamp(res.idx, min=0)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.frame_id)
        init = initialize_two_view(self.cam, ref.xy_un, feats.xy_un[j], res.valid, gen)
        if not bool(init.ok):
            self.stats.append({**no_kf, "matches": n_match})
            return self._eye

        # scale: median scene depth -> 1 (inverse median depth, :1558)
        good = init.point_ok.cpu().numpy()
        pts = init.points.cpu().numpy()
        scale = 1.0 / max(float(np.median(pts[good][:, 2])), 1e-6)
        pts = pts * scale
        T2 = init.Tcw2.cpu().numpy().copy()
        T2[:3, 3] *= scale
        T2 = torch.from_numpy(T2).to(self.device)

        N = self.cfg.orb.max_kpts
        none = np.full(N, -1, np.int64)
        m = self.map
        kf0 = m.insert_keyframe(ref, self._eye, none, self.frame_id - 1)
        kf1 = m.insert_keyframe(feats, T2, none, self.frame_id)

        # landmarks observed by both keyframes
        n_new = min(int(good.sum()), m.M - 1 - m.n_pts)
        sel = np.where(good)[0][:n_new]
        ids = np.full(N, -1, np.int64)
        ids[sel] = m.n_pts + np.arange(n_new)
        m.n_pts += n_new
        d = np.linalg.norm(pts, axis=-1)
        normal = pts / np.maximum(d, 1e-9)[:, None]
        match_np = res.idx.cpu().numpy()
        has = ids >= 0
        m.arrays = add_points_kernel(
            m.arrays, m._t(ids), m._t(pts.astype(np.float32), torch.float32), ref.desc,
            m._t(normal.astype(np.float32), torch.float32),
            m._t((d / 1.2 ** 7).astype(np.float32), torch.float32),
            m._t((d * 1.2).astype(np.float32), torch.float32),
            kf0, kf0, m._t(np.where(has, np.arange(N), -1)),
            kf1, m._t(np.where(has, match_np, -1)),
        )
        cids = ids[has]
        m.pt_alive[cids] = True
        m.pt_birth_kf[cids] = kf0
        m.pt_obs_count[cids] = 2
        m.kf_obs_np[kf0][has] = cids
        m.kf_obs_np[kf1][match_np[has]] = cids
        m._update_covisibility(kf1)
        m.run_local_ba(kf1)

        self.ref_kf = kf1
        self.last_kf_frame = self.frame_id
        self.last_kf_inliers = n_new
        self.state = TrackingState.OK
        self._ensure_loop_closer(feats)
        self.loop.on_keyframe(kf0)
        self.loop.on_keyframe(kf1)
        self._mono_ref = None
        self.stats.append({"matches": n_match, "inliers": n_new, "kf": True})
        return T2

    def _ensure_loop_closer(self, feats: FrameFeatures):
        """Build the loop closer at the first keyframe: with the given
        vocabulary, else the package's default (trained on synthetic
        scenes), else one trained on this frame's descriptors."""
        if self.loop is not None:
            return
        if self._vocabulary is None:
            default = os.path.join(os.path.dirname(__file__), "data", "default_vocab.npz")
            if os.path.exists(default):
                self._vocabulary = load_npz(default, device=self.device)
            else:
                desc = feats.desc[feats.valid].cpu().numpy()
                self._vocabulary = train_vocabulary(desc, k=8, depth=3, iters=5,
                                                    device=self.device)
        self._vocabulary = self._vocabulary.to(self.device)
        self.loop = LoopCloser(self.cfg, self.cam, self._vocabulary, self.map)

    def _track(self, feats: FrameFeatures) -> torch.Tensor:
        """The slow path (after LOST, and a monocular map's first frames):
        two-pass motion model, then the local map from its pose, or from the
        last pose if it failed. Monocular frames carry no depth for the
        motion model's temporal points (the reference builds them from
        depth in UpdateLastFrame): they go to the local map from the
        velocity prediction, in a wider window."""
        with span("slam.track"):
            tcfg = self.cfg.tracking
            T_pred = self.velocity @ self.last_Tcw
            view = self._view()
            if self.cfg.sensor == "mono":
                n_mm = 0
                T0 = T_pred
                map_radius = tcfg.match_radius_map * 4.0
            else:
                mm = track_motion_model(
                    self.cam, feats, self.last_feats, self.last_Tcw, T_pred, self._r_mm)
                n_mm = int(mm.num_inliers)
                # a failed motion model means the constant-velocity prediction
                # is wrong: start from the last pose (TrackReferenceKeyFrame,
                # src/Tracking.cc:1736)
                T0 = mm.Tcw if n_mm >= 10 else self.last_Tcw
                map_radius = tcfg.match_radius_map * (2.0 if n_mm >= 10 else 6.0)
            lm = track_local_map(
                self.cam, feats, view, T0,
                torch.tensor(map_radius, dtype=torch.float32, device=self.device))
            mm_Tcw = T0 if n_mm >= 10 else None
            return self._post_track(feats, n_mm, mm_Tcw, lm, view)

    def _post_track(self, feats, n_mm, mm_Tcw, lm, view) -> torch.Tensor:
        """Decision tail of the slow path."""
        tcfg = self.cfg.tracking
        n_lm = int(lm.num_inliers)
        kp_point = None   # read lazily
        if n_lm >= tcfg.min_inliers_local_map:
            Tcw = lm.Tcw
            self.state = TrackingState.OK
            self._last_pid = lm.kp_point_id
            self.map.bump_stats(lm.visible_ids, lm.found_ids)
        elif n_mm >= 10 and mm_Tcw is not None:
            Tcw = mm_Tcw
            kp_point = np.full(self.cfg.orb.max_kpts, -1, np.int64)
            self.state = TrackingState.OK
            # matches below the gate still seed the next mono motion model
            self._last_pid = lm.kp_point_id
        else:
            # LOST: BoW relocalization (Tracking::Relocalization,
            # src/Tracking.cc:2591), re-anchored to the local map from the
            # relocalized pose; otherwise hold the pose
            reloc = self.loop.relocalize(feats) if self.loop is not None else None
            if reloc is not None and reloc[1] >= 25:
                lm2 = track_local_map(
                    self.cam, feats, view, torch.from_numpy(reloc[0]).to(self.device),
                    torch.tensor(tcfg.match_radius_map * 3.0, dtype=torch.float32,
                                 device=self.device))
                n2 = int(lm2.num_inliers)
                if n2 >= tcfg.min_inliers_local_map:
                    self.state = TrackingState.OK
                    self.velocity = self._eye
                    self._last_pid = lm2.kp_point_id
                    self.stats.append({"matches": n_mm, "inliers": n2, "kf": False,
                                       "reloc": True})
                    return lm2.Tcw
            self._on_lost()
            self.velocity = self._eye
            self._last_pid = None
            self.stats.append({"matches": n_mm, "inliers": 0, "kf": False})
            return self.last_Tcw

        self.velocity = se3.orthonormalize(Tcw @ se3.inv_T(self.last_Tcw))

        # keyframe decision (NeedNewKeyFrame, src/Tracking.cc:2064)
        need_kf = self.state is TrackingState.OK and (
            (self.frame_id - self.last_kf_frame >= 30)
            or (
                self.frame_id - self.last_kf_frame >= 3
                and n_lm < 0.75 * max(self.last_kf_inliers, 1)
            )
            or n_lm < 50
        )
        made_kf = False
        if need_kf and n_lm >= tcfg.min_inliers_local_map and not self.localization_only:
            with span("slam.kf.insert", self.frame_id):
                self._maybe_compact()
                if kp_point is None:
                    kp_point = lm.kp_point_id.cpu().numpy().astype(np.int64)
                self.ref_kf = self.map.insert_keyframe(feats, Tcw, kp_point, self.frame_id)
                self.last_kf_frame = self.frame_id
                self.last_kf_inliers = n_lm
                self._keyframe_maintenance(self.ref_kf, self.frame_id)
            made_kf = True

        self.stats.append({"matches": n_mm, "inliers": n_lm, "kf": made_kf})
        return Tcw

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (amos_slam_tpu_torch).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. build   -- nvcc builds every CUDA kernel of the path from csrc/.
  2. kernels -- each kernel against its plain PyTorch version on the card,
                exact equality, at the shapes and extents the main path gives
                it and at extra shapes (negative values, ragged extents);
                timings (ops/kernels/timing.py): median over 5 runs of N
                back-to-back launches between two CUDA events, divided by
                N, after warm-up, the stream held by a spin kernel while the
                host enqueues; nvidia-smi's SM clock and power sampled
                before, after and under load; the bound from the bytes and
                operations that the extents need.
  3. main    -- RGBDOdometry at 640x480 (8 levels, 1000 features) over the
                30-frame synthetic sequence of tests/test_odometry_e2e.py,
                with the same gates (inliers > 50, ATE < 2 cm, RPE-t < 1 cm)
                and one FAST kernel launch per frame.
  4. profile -- torch.profiler over 5 frames: device time by op.
  5. system  -- System(SystemConfig(use_dynamics=False)) at the defaults
                (640x480, 1000 features, max_keyframes 512, max_points
                32768, 4096-point local map, local BA over 8 + 4 keyframes
                and 1024 landmarks) over the first 64 frames of the bench's
                motion (orbit_trajectory(144, radius=0.1, advance=144/768):
                each frame moves as much as in bench.py's 768-frame run):
                frames 0-31 through track_rgbd, frames 32-63 through
                track_rgbd_chunk in 4 chunks of 8. Gates: ATE of
                corrected_poses_np < 1.5 cm, RPE-t < 1 cm, local-map inliers
                > 50 after frame 0, state OK, >= 3 keyframes, > 300 live
                landmarks, >= 2 local BA solves with finite poses, device
                kf_obs equal to the host mirror, scratch slots dead, one FAST
                launch per frame. Local BA is timed with CUDA events, the
                other keyframe steps between two syncs. Then
                torch.profiler over 1 more chunk.
  6. dynamics -- the geometric dynamic stage on the card. (1) Mask level,
                compute_dynamics at 640x480 with its defaults: the mover pair
                of tests/test_dynamics.py (recall > 0.6, false positives
                < 0.25), its clean pair (< 10% suppressed), the luma-matched
                mover with its colour frame (recall > 0.5, false positives
                < 0.25). (2) Pose level, tests/test_dynamic_slam_e2e.py's
                adversarial suites in its config (MapConfig(32, 8192), 2048
                local points, deterministic), each against the port's own
                use_dynamics=False run: the entering mover, geometric only
                (baseline ATE > 0.2, dynamics < 0.15 and < 0.5x baseline);
                the dominant mover with oracle stage-one masks (< 0.1 and
                < 0.35x baseline). (3) Full width: System(SystemConfig(
                use_dynamics=True, dynamics=DynamicsConfig(dyn_stride=2)))
                at the defaults over 64 frames of room_with_mover(seed=1,
                speed=1.5) on orbit_trajectory(72, radius=0.1,
                advance=72/768), the renderer's mover mask as the stage-one
                mask: frames 0-31 through track_rgbd, 32-63 through
                track_rgbd_chunk in chunks of 8. Gates: ATE of
                corrected_poses_np < 3 cm, RPE-t < 1 cm, inliers > 50 after
                frame 0, state OK, >= 3 keyframes, one FAST launch per frame.
                Then one more chunk under torch.profiler, and lk_flow,
                slic_kmeans, ransac_pnp and compute_dynamics alone at the
                path's shapes: per-call time of 10 back-to-back calls
                between CUDA events, device time and launches of one call.
  7. flagship -- YOLACT stage one at full width (ResNet-50 (3, 4, 6, 3), 81
                classes, bf16, Flax's init from seed 0) feeding the flagship
                path. (1) Segmenter alone: Segmenter(img_size=400) on an
                (8, 480, 640, 3) chunk through person_mask_batch and
                Segmenter() (550) on single frames through person_mask:
                per-call time of 10 back-to-back calls between CUDA events,
                device time and launches of one profiled call, the conv
                FLOPs counted from the layer shapes and their bound at the
                card's dense bf16 peak. (2) Mask content: with
                person_classes=range(80) and score 0.0 (random weights give
                empty masks at 81 classes and score 0.15), on two frames:
                the card's f32 path against the port's CPU f32 path (raw
                outputs within 1e-4 of max |CPU|, masks >= 99.9% equal),
                masks covering 1-99% of the image, the card's bf16 path
                against its f32 path within tests/test_torch_segmenter.py's
                tolerances (8e-2 max, 2e-2 rms). (3) The flagship as
                bench.py phase_two_stage runs it: System(SystemConfig(
                dynamics=DynamicsConfig(dyn_stride=2))) at the defaults over
                64 frames of phase 6's sequence in 8 chunks, each chunk's
                masks from Segmenter(img_size=400).person_mask_batch on the
                grey frames replicated to RGB, the next chunk's masks made
                before the current chunk is tracked. Gates: ATE of
                corrected_poses_np < 3 cm, RPE-t < 1 cm, inliers > 50 after
                frame 0, state OK, >= 3 keyframes, one FAST launch per frame,
                one segmenter call per chunk. Then one more chunk under
                torch.profiler.
  Phases 5-7 also read the loop closer that every System builds at its
  first keyframe (LoopProbe): loops closed, relocalizations, each BoW
  transform between CUDA events, keyframe maintenance with the BoW between
  two syncs, and one BoW transform alone (10 calls between events, one
  profiled for device time and launches). Their sequences close no loop.
  8. loop -- loop closing and relocalization on the flagship, driven by
                tools/loop_search.py (track() with LOOP = its PHASE8): the
                phase-7 segmenter and System(SystemConfig(dynamics=
                DynamicsConfig(dyn_stride=2))) at the defaults
                (loop_consistency_th 3) over synthetic.sweep_and_return(40,
                80, 40, yaw=0.7, pitch=1.1, sway=0.2) in default_room(seed=7),
                160 frames in chunks of 8: the yaw sweeps from the left wall
                across the back wall to the right wall, comes back over the
                ceiling, and sweeps again. An out-and-back would re-find the
                way out's landmarks all the way home, so its start stays
                covisible and no loop is detected; coming home over the
                ceiling, the tracker meets the start's wall with landmarks
                of its own. Of 16 sweeps that tools/loop_search.py ran on the
                card with this phase's config, 12 closed a loop, 2 of those
                ended with the corrected ATE under the raw ATE, and this one
                alone also under 3 cm (ROADMAP queue 3, fault 4). Three
                frames at the start of the first chunk after the map holds 8
                keyframes have zero grey and depth (tests/test_reloc_loop.py:
                31-34); the motion model carries the chunk over them. Then
                the kidnap: a chunk that holds the last pose for 5 frames and
                goes black for 3 (it ends LOST), and two chunks back at the
                sequence's first 16 poses, where the per-frame path's motion
                model and local map fail and the relocalizer must place the
                camera. Gates: >= 1 loop closed, state OK after the sequence
                and at the end, ATE of corrected_poses_np over the sequence
                < 3 cm and <= the raw track-time ATE + 0.1 mm (the blackout
                and two frames after it left out), a kidnapped frame with
                "reloc" in its stats, ATE < 3 cm over the sequence and the
                frames from the first relocalized one on, no live
                observation of a dead landmark, device kf_obs equal to the
                host mirror, one FAST launch per frame. Prints the BoW ms per
                keyframe, each _verify_and_correct in parts (pairs, Sim3
                RANSAC, optimize_sim3, guided search, pose graph, fusion:
                host ms between syncs, launches and device ms under
                torch.profiler), each loop's keyframe ATE before and after
                the pose graph, after its global BA and at the end of the
                sequence, each global-BA phase's ms, the relocalizations' ms
                and the ms per chunk with the loop chunks apart.
  9. stereo -- System(SystemConfig(camera=io.kitti.kitti_camera_config(0),
                orb=ORBConfig(n_features=2000, max_kpts=2048), sensor="stereo",
                use_dynamics=False)), the settings of examples/stereo_kitti.py,
                at KITTI's 1241x376 over 64 frames of orbit_trajectory(64,
                radius=0.1, advance=0.25) in default_room(seed=9) (the motion
                of tests/test_stereo_mono_e2e.py's stereo run), each pair
                rendered at KITTI 00-02's intrinsics with the right camera
                bf / fx = 0.537 m to the right. Gates: state OK, ATE of
                corrected_poses_np < 2 cm, local-map inliers > 50 after frame
                0, >= 3 keyframes, two FAST launches per frame. Prints the
                ms per frame on the fused path and on the split path (one
                frame after the state is set to LOST, a reading only), each
                with launches and device ms under torch.profiler, and
                match_stereo alone at the path's shapes.
 10. mono   -- System(SystemConfig(sensor="mono", use_dynamics=False)) at the
                640x480 defaults (examples/mono_tum.py) over
                orbit_trajectory(60, radius=0.35, advance=0.15) in
                default_room(seed=11) (tests/test_stereo_mono_e2e.py's mono
                scene with twice its frames). Gates: initialized (a keyframe
                frame), state OK, >= 2 keyframes, > 100 landmarks,
                scale-aligned ATE after initialization < 5 cm, one FAST
                launch per frame. Prints the fused and split paths as phase
                9 does (the split frame: one after the last frame's landmark
                ids are dropped), and each _initialize_mono call's host and
                device ms, launches and the model that won (H or F).
 11. multistream -- MultiStreamSLAM(SystemConfig(use_dynamics=False), 8) at
                the 640x480 defaults (bench.py phase_multistream's config)
                over 8 distinct rooms, default_room(seed=20 + s), on one
                camera path (the system phase's bench motion): initialize,
                then 32 steps, each one torch.func.vmap of the fused frame
                step over the 8 streams, each step's (S, 3) rows resolved
                and its keyframes inserted at most 2 steps later (flush()
                after the last). Gates: exactly one FAST
                launch per step and one in initialize, each over (64, 480,
                640); at steps 1, 31 and 32 the vmapped step equals 8
                separate fused_frame_step calls on the same inputs (sup rows
                equal to the step's own resolved rows, poses within 1e-5); every stream >= 2 keyframes and
                ATE < 1 cm; local-map inliers > 50 after frame 1. Prints the
                aggregate FPS (8 x steps / wall), per-step ms, launches and
                device ms (2 more steps under torch.profiler) with the busy
                share, the same step at S = 1, keyframes per stream and the
                peak memory.
 12. train  -- YOLACT training (models/{configs,data,train,eval}.py), which
                runs no kernel of the port's own (torch ops, cuDNN convs,
                f32 with TF32 off). (1) get_config("yolact_resnet50"): the
                flagship Segmenter's ResNet-50 (3, 4, 6, 3) and 81 classes,
                550 px, max_objs 16, batch 8, proto (138, 138), Flax's init
                from seed 0, fed by DataLoader(SyntheticShapes(size=550),
                AugmentConfig(), seed=0): first one step at batch 2 on the
                card against the port's CPU path on the same weights and
                batch (loss parts within 1e-4 relative, every tensor's
                update -lr x momentum within 1e-3 of its max |update|),
                then 3 warm-up and 10 timed steps. Gates: loss and its three
                parts finite at every step, no out-of-memory. Prints step ms
                (median of CUDA-event times and of wall times), images/s,
                launches and device ms of one profiled step, the busy share,
                peak memory, the loader's wait per step and its host ms per
                batch, and the conv FLOPs of forward + backward (3 x the
                forward's, counted by hooks) against the f32 peak. (2) The
                training proof of tests/test_yolact_data.py: yolact_tiny,
                SyntheticShapes(n=64, seed=11), batch 4, AugmentConfig(
                expand=False, crop=False), 60 steps; gate: the mean loss of
                the last 5 steps < 0.6 x the mean of the first 3; then, as a
                reading, detect + assemble_masks + evaluate_detections box
                and mask mAP on 16 held-out shapes.
 13. pipeline -- pipelined host supervision (SystemConfig's default,
                deterministic=False) against deterministic=True, in
                alternating blocks (True, False, False, True) of the same
                sequences, each block a fresh tracker timed from its first
                call to the end of shutdown() / flush(): (1) the flagship as
                phase 7 runs it (Segmenter(img_size=400).person_mask_batch ->
                track_rgbd_chunk, W 8, dispatch_window 2) over the first 40
                frames of phase 6's sequence; deterministic, the chunk call
                tracks frame by frame; (2) track_rgbd over phase 5's first
                40 frames (16 frames of run-ahead); (3) MultiStreamSLAM(
                SystemConfig(use_dynamics=False), 8) over 12 steps of phase
                11's rooms (2 steps of run-ahead; deterministic: flush()
                after every step). The second block of each mode drives one
                more chunk (8 frames; 2 steps) under torch.profiler (CUDA
                activity only) with torch's sync debug mode on. Prints per mode: host ms per frame (step), the blocking
                waits of the reader and fetcher (before the final flush and
                in all), the histogram of supervision lag (frames or steps
                dispatched after a frame's own call when its read
                resolves), launches and device ms per frame, the busy share
                and the host syncs the debug mode reports, by file:line.
                Gates: lag <= 2W = 16 frames on the chunk path, <= 16
                frames per frame, <= 2 steps; in every flagship and
                per-frame block phase 7's gates (ATE < 3 cm, RPE-t < 1 cm,
                inliers > 50, >= 3 keyframes, state OK, one FAST launch per
                frame); multistream ATE < 1 cm per stream and one FAST
                launch per step.
 14. multi-device -- the paths over more than one device, on the card.
                (1) MultiStreamSLAM(SystemConfig(use_dynamics=False), 8,
                mesh) over phase 11's 32 steps, the mesh the first G cards
                on a machine with more than one (G the largest divisor of
                8 that is at most the card count), else two entries on
                cuda:0: G groups of 8 / G streams, each with its own state,
                views, maps and batched FAST launch over (8 / G x 8, 480,
                640); runs in turns with one group (G = 1, G, G, 1), each a
                fresh tracker. Gates: every run makes G FAST launches per
                step and G in initialize, all at its group's shape, and
                the profiler (CUDA activity only) counts G FAST kernels per
                step in 2 more steps of the first mesh run; each group's
                state on its mesh device; sup rows equal to the first
                one-group run's every step, poses within 1e-5, the same
                keyframes (>= 2 per stream: each stream inserts at least
                one after initialize, under the mesh); ATE < 1 cm per
                stream. Prints per-step ms of every run, launches and
                device ms per step, peak memory. (2) make_data_parallel_step
                over a 1-rank NCCL group (tcp://localhost) against
                make_train_step: yolact_resnet50 at 550 px, batch 8, f32,
                3 steps on one batch, Flax's init from seed 0, both steps
                taken from the same state each step (the data-parallel
                chain's); gates at every step: phase 12's one-step f32
                tolerances (loss parts 1e-5 relative, the momentum 3e-2 of
                its max); prints step ms by CUDA events and the card's own
                gap, make_train_step run twice from that state.
                (3) 2 ranks on cuda:0, spawned and joined with a 240 s
                timeout, over gloo with CUDA tensors (NCCL refuses two
                ranks on one card: "Duplicate GPU detected"):
                yolact_tiny at 128 px, batch 8 (4 per rank), float64, 3
                steps, against the single-process step on the full batch;
                gates: loss parts, params (over their change) and momentum
                within 1e-10, params equal across the ranks.
Phases 5-11 build SystemConfig() and so run pipelined too; they sync after
each timed call, so a read resolves at the next call's drain at the latest.
To keep the script's time with phase 13, earlier depth was cut: phase 5
from 96 to 64 gated frames and from 16 to 8 profiled ones, phase 6's
full-width run from 96 to 64 frames (its sequence, which phases 7 and 13
share, from 104 to 72), phases 9 and 10 from 4 to 2 profiled fused
frames, phase 11 from 4 to 2 profiled steps at S = 8 and at S = 1, phase
12 from 20 to 10 timed steps.
The kernels phase also holds the FAST kernel against its plain version at
the stereo path's (8, 376, 1241) with KITTI's level extents, at the
multistream path's (64, 480, 640) (8 streams' pyramids through the op's
vmap rule, the level extents repeated) and at a mesh group's (8 / G x 8,
480, 640), and on a ragged (64, 256, 384) batch with -0.0 and negative
values (1,575 active tiles: the persistent kernel); times it at each, and
measures the host time per call of a direct launch, of the custom op and
of the vmapped call. It also measures the issue rate of each instruction the
kernels reduce with (tools/time_fast_kernel.py's pipe probe), from which
each row gets its issue floor beside its bytes bound, and names the kernel
(tiles or persistent) the wrapper picked for the row's shape. The last
three lines are the kernels JSON (the single route; the batched route at 8
streams, launched in phases 11 and 13 and in phase 14's one-group runs;
the batched route at a mesh group's shape, launched in phase 14's mesh
runs), the card's name and power limit (nvidia-smi), and {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import sys
import time
import warnings

import numpy as np
import torch

from amos_slam_tpu_torch.config import SystemConfig
from amos_slam_tpu_torch.frontend.tracking import RGBDOdometry
from amos_slam_tpu_torch.io import evaluate, synthetic
from amos_slam_tpu_torch.ops import pyramid
from amos_slam_tpu_torch.ops.kernels import build
from amos_slam_tpu_torch.ops.kernels import fast_margin_nms as fmn_mod
from amos_slam_tpu_torch.ops.kernels import timing
from amos_slam_tpu_torch.tools import loop_search
from amos_slam_tpu_torch.tools import time_fast_kernel as tfk

N_FRAMES = 30
SYS_FRAMES = 64         # gated main run of the system phase
SYS_PER_FRAME = 32      # of which the first go through track_rgbd
SYS_W = 8               # chunk width of track_rgbd_chunk, as bench.py
SYS_PROFILED = 8        # one more chunk under torch.profiler
DYN_FRAMES = 64         # gated full-width run of the dynamics phase
DYN_PER_FRAME = 32      # of which the first go through track_rgbd
DYN_W = 8               # chunk width; one more chunk is profiled
SEG_W = 8               # flagship chunk width, as bench.py
SEG_CHUNKS = 8          # gated flagship chunks; one more is profiled
LOOP = loop_search.PHASE8   # phase 8's sequence, blackout and kidnap
STEREO_FRAMES = 64     # gated stereo run (phase 9)
MONO_FRAMES = 60       # gated mono run (phase 10)
PATH_PROFILED = 2      # fused-path frames profiled after each of them
MS_STREAMS = 8         # multistream (phase 11): bench.py phase_multistream's S
MS_STEPS = 32          # gated steps after initialize (the 30-frame rule makes a
                       # keyframe per stream by step 30 at the latest)
MS_CHECK = (1, 31, MS_STEPS)   # steps held against S separate fused steps
MS_ATE = 0.01          # the worst stream measured 3.2 mm on an H100
MS_PROFILED = 2        # steps profiled after the gated run
MS_SOLO_STEPS = 8      # the same step at S = 1, then MS_PROFILED profiled
CARD_VS_CPU_F32 = 1e-4  # card f32 net vs CPU f32 net, max error over max |CPU|
BF16_VS_F32 = (8e-2, 2e-2)   # max and rms error over |f32|: tests/test_torch_segmenter.py
BF16_PEAK_FLOP_S = 989e12    # H100 SXM dense bf16 tensor-core peak (data sheet)
TRAIN_CFG = "yolact_resnet50"   # phase 12: the flagship Segmenter's backbone and classes
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
TRAIN_PARITY_B = 2             # batch of the one-step card-vs-CPU check
# card vs CPU, one step: loss parts (relative), each tensor's update over its max |update|
TRAIN_F32 = (1e-5, 3e-2)       # measured 3.1e-7 and 7.5e-3 on an H100 (see train_card_vs_cpu)
TRAIN_F64 = (1e-12, 1e-10)     # measured <= 2.9e-16 and 1.1e-14 on an H100
F32_PEAK_FLOP_S = 67e12        # H100 SXM f32 outside the tensor cores (data sheet)
PROOF_STEPS, PROOF_RATIO = 60, 0.6   # tests/test_yolact_data.py's training proof
PROOF_HELD_OUT = 16
PIPE_MODES = (True, False, False, True)   # phase 13's blocks: deterministic or not
PIPE_FRAMES = 40       # frames per flagship / per-frame block (>= 3 keyframes)
PIPE_MS_STEPS = 12     # multistream steps per block
MESH_STEPS = MS_STEPS  # phase 14: multistream steps per run over the stream mesh
DP_STEPS = 3           # phase 14: data-parallel steps
DP_JOIN_S = 240        # the spawned ranks' join timeout
DP_F64_TOL = 1e-10     # 2 ranks vs the single-process step, float64


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def device_profile(prof, n_frames: int) -> dict:
    """Device kernel time and launches per frame from a profiler window.
    Device kernels carry device_type CUDA; the aten ops that launched them
    carry the same time again, so each list is summed on its own."""
    kernels, ops = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us <= 0:
            continue
        on_device = getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        (kernels if on_device else ops).append((dev_us, e.key, e.count))
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    return {
        "device_kernel_ms_per_frame": sum(r[0] for r in kernels) / 1e3 / n_frames,
        "kernel_launches_per_frame": sum(r[2] for r in kernels) / n_frames,
        "top_ops_by_device_ms": [
            {"op": k[:48], "ms_per_frame": u / 1e3 / n_frames, "calls_per_frame": c / n_frames}
            for u, k, c in ops[:8]
        ],
        "top_kernels_by_device_ms": [
            {"kernel": k[:48], "ms_per_frame": u / 1e3 / n_frames,
             "calls_per_frame": c / n_frames}
            for u, k, c in kernels[:5]
        ],
    }


class LoopProbe:
    """Times the loop closer's work on the card while a phase runs; its
    wrappers sit on the classes and module functions, so ``remove()``
    restores them. BoW transforms: CUDA events around each dispatch, read
    after the run (no added sync). Keyframe maintenance, relocalization and
    each global-BA phase: host ms between two syncs. With ``parts``, every
    ``_verify_and_correct`` is split into its parts, each between two syncs
    with CUPTI kernel tracing on (torch.profiler, CUDA only) for its
    launches and device time, and the live keyframes' poses are read before
    and after the pose graph and after the global BA finishes; the
    profilers' start and stop and those reads are subtracted from every
    enclosing time (keyframe maintenance, the whole verification, a
    chunk)."""

    PARTS = ("_loop_pairs_kernel", "ransac_sim3", "optimize_sim3", "_guided_search_kernel")
    METHODS = ("_pose_graph_correct", "_fuse_across_loop")

    def __init__(self, parts: bool = False):
        from amos_slam_tpu_torch.loop import global_ba, loop_closing
        from amos_slam_tpu_torch.system import System

        self.bow, self.maint_ms, self.reloc, self.gba_ms, self.loops = [], [], [], [], []
        self._saved = []
        self.overhead_ms = 0.0   # the parts' profilers and the pose reads
        lc = loop_closing.LoopCloser
        self._wrap(lc, "bow_dispatch", self._events(self.bow))
        self._wrap(System, "_keyframe_maintenance", self._synced(self.maint_ms))
        self._wrap(lc, "relocalize", self._synced(self.reloc, result=True))
        self._wrap(global_ba.GlobalBundleAdjustment, "step", self._synced(self.gba_ms))
        if parts:
            for name in self.PARTS:
                self._wrap(loop_closing, name, self._part(name))
            for name in self.METHODS:
                self._wrap(lc, name, self._part(name))
            self._wrap(lc, "_pose_graph_correct", self._around_pose_graph)
            self._wrap(global_ba.GlobalBundleAdjustment, "finish", self._after_global_ba)
            self._wrap(lc, "_verify_and_correct", self._verify)

    def _wrap(self, owner, name, make):
        fn = getattr(owner, name)
        self._saved.append((owner, name, fn))
        setattr(owner, name, make(fn))

    def remove(self):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved = []

    @staticmethod
    def _events(out):
        def make(fn):
            def run(*args, **kwargs):
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                res = fn(*args, **kwargs)
                e1.record()
                out.append((e0, e1))
                return res
            return run
        return make

    def _synced(self, out, result=False):
        def make(fn):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t, p0 = time.perf_counter(), self.overhead_ms
                res = fn(*args, **kwargs)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3 - (self.overhead_ms - p0)
                out.append((ms, None if res is None else res[1]) if result else ms)
                return res
            return run
        return make

    def _part(self, name):
        from torch.profiler import ProfilerActivity, profile

        def make(fn):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t = time.perf_counter()
                    res = fn(*args, **kwargs)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t) * 1e3
                p = device_profile(prof, 1)
                self.overhead_ms += (time.perf_counter() - t0) * 1e3 - ms
                if self.loops:
                    self.loops[-1]["parts"][name] = {
                        "ms": ms, "launches": p["kernel_launches_per_frame"],
                        "device_ms": p["device_kernel_ms_per_frame"]}
                return res
            return run
        return make

    def _verify(self, fn):
        def run(lc, slot, cand):
            self.loops.append({"slot": slot, "cand": cand, "parts": {}})
            torch.cuda.synchronize()
            t, p0 = time.perf_counter(), self.overhead_ms
            ok = fn(lc, slot, cand)
            torch.cuda.synchronize()
            self.loops[-1].update(accepted=bool(ok), ms=(time.perf_counter() - t) * 1e3
                                  - (self.overhead_ms - p0))
            return ok
        return run

    def _snapshot(self, key, m):
        t = time.perf_counter()
        self.loops[-1][key] = loop_search.keyframe_poses(m)
        self.overhead_ms += (time.perf_counter() - t) * 1e3

    def _around_pose_graph(self, fn):
        def run(lc, *args, **kwargs):
            self._snapshot("keyframes_before_pose_graph", lc.map)
            res = fn(lc, *args, **kwargs)
            self._snapshot("keyframes_after_pose_graph", lc.map)
            return res
        return run

    def _after_global_ba(self, fn):
        # a global BA starts only on a verified loop and a newer loop aborts
        # it, so the one that finishes is the latest loop's
        def run(gba, *args, **kwargs):
            res = fn(gba, *args, **kwargs)
            self._snapshot("keyframes_after_global_ba", gba.m)
            return res
        return run

    def keyframe_ates(self, raw, kf_end, gt) -> None:
        """Replace each loop's keyframe snapshots by the ATE of the
        keyframes alive in all of them: their track-time poses, before and
        after the pose graph, after the global BA (when it finished) and at
        the end of the sequence."""
        names = ("raw", "before_pose_graph", "after_pose_graph", "after_global_ba",
                 "end_of_sequence")
        for lp in self.loops:
            if "keyframes_before_pose_graph" not in lp:
                continue
            before = lp.pop("keyframes_before_pose_graph")
            snaps = {"raw": {f: raw[f] for f in before}, "before_pose_graph": before,
                     "after_pose_graph": lp.pop("keyframes_after_pose_graph"),
                     "after_global_ba": lp.pop("keyframes_after_global_ba", None),
                     "end_of_sequence": kf_end}
            present = [k for k in names if snaps[k] is not None]
            k = loop_search.keyframe_ate([snaps[x] for x in present], gt)
            lp["keyframe_ate_m"] = {
                **{x: None for x in names},
                **({} if k["ate_m"] is None else dict(zip(present, k["ate_m"]))),
                "keyframes": len(k["frames"])}

    def summary(self, slam) -> dict:
        """The probe's readings and the run's loop outcomes."""
        bow_ms = [e0.elapsed_time(e1) for e0, e1 in self.bow]
        loop = slam.loop
        return {
            "loops_closed": [] if loop is None else [list(x) for x in loop.loops_closed],
            "relocalizations": sum(1 for st in slam.stats if st.get("reloc")),
            "bow_transforms": len(bow_ms),
            "bow_event_ms_median": statistics.median(bow_ms) if bow_ms else None,
            "bow_event_ms": bow_ms,
            "keyframe_maintenance_ms_with_bow": self.maint_ms,
            "relocalize_ms_and_inliers": self.reloc,
            "global_ba_phase_ms": self.gba_ms,
        }


def bow_alone(slam) -> dict:
    """One BoW transform of the last keyframe alone: per-call time of 10
    back-to-back calls between CUDA events, device time and launches of one
    profiled call."""
    slot = slam.map.n_kfs - 1
    fn = lambda: slam.loop.bow_dispatch(slot)   # noqa: E731
    return {"bow_alone_event_ms": _event_ms(fn), **_profiled_call(fn)}


def system_phase(fmn):
    """Phase 5 (see the module docstring). Returns the FAST launches of the
    gated run, and its staged frames (grey, depth on the card; poses) for
    phase 13."""
    from torch.profiler import ProfilerActivity, profile

    from amos_slam_tpu_torch.system import System, TrackingState

    dev = torch.device("cuda")
    n = SYS_FRAMES + SYS_PROFILED
    planes = synthetic.default_room(seed=1)
    poses_gt = synthetic.orbit_trajectory(144, radius=0.1, advance=144 / 768)[:n]
    gray, depth = [], []
    for g, d in synthetic.render_many(planes, poses_gt, os.cpu_count() or 1):
        # grey as a camera delivers it, as bench.py stages it
        gray.append(np.clip(g, 0, 255).astype(np.uint8).astype(np.float32))
        depth.append(d.astype(np.float32))
    # frames staged on the card before the clock starts, as bench.py does
    g_dev = torch.from_numpy(np.stack(gray)).to(dev)
    d_dev = torch.from_numpy(np.stack(depth)).to(dev)
    stamps = [i / 30.0 for i in range(n)]

    slam = System(SystemConfig(use_dynamics=False))
    ba = []   # (ran, ms) per local BA call, CUDA events around run_local_ba
    run_ba = slam.map.run_local_ba

    def timed_ba(slot):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        ran = run_ba(slot)
        t1.record()
        t1.synchronize()
        ba.append((ran, t0.elapsed_time(t1)))
        return ran

    slam.map.run_local_ba = timed_ba
    # the other keyframe-rate steps, each between two syncs (host clock);
    # they run only at keyframes, so frames without one are not perturbed
    steps = {}

    def timed_step(name):
        fn = getattr(slam.map, name)

        def step(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            steps.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
            return out

        setattr(slam.map, name, step)

    for name in ("insert_keyframe", "create_new_points_dispatch",
                 "create_new_points_resolve", "fuse_neighbors_dispatch",
                 "fuse_neighbors_resolve", "cull_points_resolve",
                 "cull_keyframes", "refresh_landmarks"):
        timed_step(name)
    probe = LoopProbe()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fmn.launches = 0
    frame_ms, kf_frame_ms, chunk_ms, kf_chunk_ms = [], [], [], []
    for i in range(SYS_PER_FRAME):
        t = time.perf_counter()
        slam.track_rgbd(g_dev[i], d_dev[i], stamps[i])
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        if slam.stats[-1]["kf"]:
            kf_frame_ms.append(frame_ms[-1])
    for c in range(SYS_PER_FRAME, SYS_FRAMES, SYS_W):
        t = time.perf_counter()
        slam.track_rgbd_chunk(g_dev[c: c + SYS_W], d_dev[c: c + SYS_W],
                              stamps[c: c + SYS_W])
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t) * 1e3)
        if any(s["kf"] for s in slam.stats[-SYS_W:]):
            kf_chunk_ms.append(chunk_ms[-1])
    launches = fmn.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    probe.remove()

    est = np.asarray(slam.corrected_poses_np())
    gt = np.asarray(poses_gt[:SYS_FRAMES])
    check(bool(np.isfinite(est).all()) and est.shape == (SYS_FRAMES, 4, 4),
          f"system trajectory not finite or of shape {est.shape}")
    ate = evaluate.ate_rmse(evaluate.positions_from_cw(est), evaluate.positions_from_cw(gt))
    rpe_t, rpe_r = evaluate.rpe(est, gt)
    inliers = [s["inliers"] for s in slam.stats[1:]]
    m = slam.map
    alive_pts = int(m.pt_alive.sum())
    ba_ran = [ms for ran, ms in ba if ran]
    kf_obs_dev = m.arrays.kf_obs[: m.n_kfs].cpu().numpy()
    print(json.dumps({
        "system_phase": "System(SystemConfig(use_dynamics=False)) 640x480 defaults",
        "frames": SYS_FRAMES, "per_frame_frames": SYS_PER_FRAME,
        "chunk_frames": SYS_FRAMES - SYS_PER_FRAME, "chunk_w": SYS_W,
        "ate_m": ate, "rpe_t_m": rpe_t, "rpe_r_rad": rpe_r,
        "min_inliers": min(inliers), "state": slam.state.name,
        "keyframes": m.n_kfs, "keyframes_alive": int(m.kf_alive[: m.n_kfs].sum()),
        "keyframe_frames": [int(f) for f in m.kf_frame_id[: m.n_kfs]],
        "landmarks": m.n_pts, "landmarks_alive": alive_pts,
        "frame_ms_median_after_5": statistics.median(frame_ms[5:]),
        "frame_ms_first": frame_ms[0],
        "chunk_ms_per_frame_median": statistics.median(chunk_ms) / SYS_W,
        "chunk_ms": chunk_ms,
        "keyframe_frame_ms": kf_frame_ms, "keyframe_chunk_ms": kf_chunk_ms,
        "local_ba_calls": len(ba), "local_ba_solves": len(ba_ran),
        "local_ba_ms": ba_ran,
        "local_ba_ms_median": statistics.median(ba_ran) if ba_ran else None,
        "keyframe_step_ms": steps,
        "max_memory_allocated_bytes": peak_bytes,
        "fast_kernel_launches": launches,
        "loop_closer": {**probe.summary(slam), **bow_alone(slam)},
    }))
    check(launches == SYS_FRAMES,
          f"{fmn_mod.NAME} launched {launches} times in {SYS_FRAMES} system frames")
    check(ate < 0.015, f"system ATE {ate:.4f} m")
    check(rpe_t < 0.01, f"system RPE-t {rpe_t:.4f} m")
    check(min(inliers) > 50, f"system min inliers {min(inliers)}")
    check(slam.state is TrackingState.OK, f"system state {slam.state.name}")
    check(m.n_kfs >= 3, f"{m.n_kfs} keyframes")
    check(alive_pts > 300, f"{alive_pts} live landmarks")
    check(len(ba_ran) >= 2, f"{len(ba_ran)} local BA solves")
    check(bool(torch.isfinite(m.arrays.kf_pose).all()), "keyframe poses not finite")
    check(np.array_equal(kf_obs_dev, m.kf_obs_np[: m.n_kfs]),
          "device kf_obs differs from the host mirror")
    check(not bool(m.arrays.pt_valid[m.M - 1]) and not bool(m.arrays.kf_valid[m.K - 1]),
          "a scratch slot was allocated")

    # where the device time goes: two more chunks under the profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for c in range(SYS_FRAMES, n, SYS_W):
            slam.track_rgbd_chunk(g_dev[c: c + SYS_W], d_dev[c: c + SYS_W],
                                  stamps[c: c + SYS_W])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    prof_out = device_profile(prof, SYS_PROFILED)
    print(json.dumps({
        "system_profile_frames": SYS_PROFILED,
        "keyframes_in_window": sum(s["kf"] for s in slam.stats[-SYS_PROFILED:]),
        "profiled_wall_ms_per_frame": wall_ms / SYS_PROFILED,
        "device_busy_share_profiled": prof_out["device_kernel_ms_per_frame"]
        / (wall_ms / SYS_PROFILED),
        "device_busy_share_unprofiled": prof_out["device_kernel_ms_per_frame"]
        / (statistics.median(chunk_ms) / SYS_W),
        **prof_out,
    }))
    return launches, (g_dev, d_dev, poses_gt)


def _to_dev(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to("cuda") for a in arrays]


def _recall_fp(sup, mover, trail_from):
    """Mover recall, and the suppressed share of the static scene outside
    the mover's footprint dilated by 24 px (tests/test_dynamics.py)."""
    from amos_slam_tpu_torch.ops.slic import dilate_mask

    trail = dilate_mask(torch.from_numpy(trail_from), 24).numpy()
    sup = sup.cpu().numpy()
    return (float((sup & mover).sum() / max(mover.sum(), 1)),
            float((sup & ~trail).sum() / (~trail).sum()))


def _dyn_pair(pipe, f0, f1, T0, T1, frame_idx, rgb=None):
    """compute_dynamics on the card with its own defaults (the JAX tests'
    setting), flow sources from the card's ORB front end."""
    from amos_slam_tpu_torch.frontend.dynamics import compute_dynamics

    g0, d0, g1, d1 = _to_dev(f0[0], f0[1], f1[0], f1[1])
    kp = pipe.detect_keypoints(g0)[0]
    T0d, vel = _to_dev(T0.astype(np.float32), (T1 @ np.linalg.inv(T0)).astype(np.float32))
    return compute_dynamics(pipe.cam, g0, d0, g1, d1, None, T0d, vel, kp.xy, kp.valid,
                            frame_idx, has_seg=False,
                            cur_rgb=None if rgb is None else _to_dev(rgb)[0].float())


def _suite_ate(frames, poses, use_dynamics, seg=False):
    """One adversarial-suite run in tests/test_dynamic_slam_e2e.py's config;
    the ATE of the tracked poses, as that file measures it."""
    from amos_slam_tpu_torch.config import MapConfig, TrackingConfig
    from amos_slam_tpu_torch.system import System

    slam = System(SystemConfig(map=MapConfig(max_keyframes=32, max_points=8192),
                               tracking=TrackingConfig(max_map_points_local=2048),
                               use_dynamics=use_dynamics, deterministic=True))
    for i, (g, d, m) in enumerate(frames):
        slam.track_rgbd(g, d, i / 30.0, seg_mask=m if seg else None)
    slam.shutdown()
    est = np.asarray(slam.poses_np())
    return evaluate.ate_rmse(evaluate.positions_from_cw(est),
                             evaluate.positions_from_cw(np.asarray(poses)))


def _event_ms(fn, reps: int = 10) -> float:
    """Per-call time of ``reps`` back-to-back calls between CUDA events,
    after one warm-up call (host-bound calls: the host's launch rate)."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def _profiled_call(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    p = device_profile(prof, 1)
    return {"device_kernel_ms": p["device_kernel_ms_per_frame"],
            "launches": p["kernel_launches_per_frame"],
            "top_kernels": p["top_kernels_by_device_ms"][:3]}


def mover_sequence(n: int):
    """room_with_mover(seed=1, speed=1.5) seen from orbit_trajectory(n,
    radius=0.1, advance=n/768): grey (rounded to integers), depth and the
    mover's mask staged on the card, and the poses (phases 6 and 7)."""
    poses = synthetic.orbit_trajectory(n, radius=0.1, advance=n / 768)
    gray, depth, masks = [], [], []
    for i, T in enumerate(poses):
        planes, mover = synthetic.room_with_mover(seed=1, t=i / 30.0, speed=1.5)
        g, d, ids = synthetic.render(planes, T, return_ids=True)
        gray.append(np.clip(g, 0, 255).astype(np.uint8).astype(np.float32))
        depth.append(d)
        masks.append(ids == mover)
    g_dev, d_dev, m_dev = _to_dev(np.stack(gray), np.stack(depth), np.stack(masks))
    return g_dev, d_dev, m_dev, poses


def dynamics_phase(fmn, seq) -> int:
    """Phase 6 (see the module docstring) on ``seq`` (mover_sequence of
    DYN_FRAMES + DYN_W frames). Returns the FAST launches of its runs."""
    from torch.profiler import ProfilerActivity, profile

    from amos_slam_tpu_torch.config import DynamicsConfig
    from amos_slam_tpu_torch.frontend.dynamics import (compute_dynamics, config_kwargs,
                                                       ransac_generator)
    from amos_slam_tpu_torch.frontend.features import ORBPipeline
    from amos_slam_tpu_torch.geometry import se3
    from amos_slam_tpu_torch.geometry.camera import backproject
    from amos_slam_tpu_torch.ops.lk import lk_flow
    from amos_slam_tpu_torch.ops.slic import slic_kmeans
    from amos_slam_tpu_torch.solvers.pnp import ransac_pnp
    from amos_slam_tpu_torch.system import System, TrackingState

    fmn.launches = 0
    cfg = SystemConfig()
    pipe = ORBPipeline(cfg.orb, cfg.camera)

    # 6.1 mask level at 640x480
    poses = synthetic.orbit_trajectory(20, radius=0.05, advance=0.1)
    pair = []
    for i, t in ((3, 0.1), (4, 0.1333)):
        planes, mover = synthetic.room_with_mover(seed=1, t=t, speed=3.0)
        g, d, ids = synthetic.render(planes, poses[i], return_ids=True)
        pair.append((g, d, ids == mover))
    res = _dyn_pair(pipe, pair[0], pair[1], poses[3], poses[4], 0)
    recall, fp = _recall_fp(res.suppress_mask, pair[1][2], pair[0][2] | pair[1][2])
    cposes = synthetic.orbit_trajectory(10, radius=0.05, advance=0.1)
    room = synthetic.default_room(seed=2)
    clean = _dyn_pair(pipe, synthetic.render(room, cposes[3]), synthetic.render(room, cposes[4]),
                      cposes[3], cposes[4], 1)
    clean_share = float(clean.suppress_mask.float().mean())
    lposes = synthetic.orbit_trajectory(16, radius=0.08, advance=0.15)
    luma = []
    for i in (10, 11):
        planes, mid = synthetic.luma_matched_mover(i / 30.0)
        g, d, ids, rgb = synthetic.render(planes, lposes[i], return_ids=True, return_rgb=True)
        luma.append((g, d, ids == mid, rgb))
    lres = _dyn_pair(pipe, luma[0], luma[1], lposes[10], lposes[11], 0, rgb=luma[1][3])
    l_recall, l_fp = _recall_fp(lres.suppress_mask, luma[1][2], luma[1][2])
    print(json.dumps({"dynamics_mask_level": "compute_dynamics 640x480, its defaults",
                      "mover_recall": recall, "mover_false_pos": fp,
                      "clean_suppressed_share": clean_share,
                      "luma_matched_recall": l_recall, "luma_matched_false_pos": l_fp}))
    check(recall > 0.6 and fp < 0.25, f"mover pair recall {recall:.3f} false pos {fp:.3f}")
    check(clean_share < 0.1, f"clean pair suppressed share {clean_share:.3f}")
    check(l_recall > 0.5 and l_fp < 0.25,
          f"luma-matched recall {l_recall:.3f} false pos {l_fp:.3f}")

    # 6.2 pose level: the adversarial suites against the port's own baseline
    e_poses, e_frames = synthetic.entering_mover_frames()
    e_dyn = _suite_ate(e_frames, e_poses, True)
    e_off = _suite_ate(e_frames, e_poses, False)
    d_poses, d_frames = synthetic.dominant_mover_frames()
    d_seg = _suite_ate(d_frames, d_poses, True, seg=True)
    d_off = _suite_ate(d_frames, d_poses, False)
    print(json.dumps({"dynamics_pose_level": "tests/test_dynamic_slam_e2e.py config",
                      "entering_geometric_ate_m": e_dyn, "entering_baseline_ate_m": e_off,
                      "dominant_seg_ate_m": d_seg, "dominant_baseline_ate_m": d_off}))
    check(e_off > 0.2, f"entering-mover baseline ATE {e_off:.4f} (fixture lost its teeth)")
    check(e_dyn < 0.15 and e_dyn < 0.5 * e_off,
          f"entering-mover geometric ATE {e_dyn:.4f} vs baseline {e_off:.4f}")
    check(d_seg < 0.1 and d_seg < 0.35 * d_off,
          f"dominant-mover two-stage+seg ATE {d_seg:.4f} vs baseline {d_off:.4f}")

    # 6.3 the full-width run: the flagship's split without a segmenter
    g_dev, d_dev, m_dev, fposes = seq
    stamps = [i / 30.0 for i in range(len(fposes))]
    slam = System(SystemConfig(use_dynamics=True, dynamics=DynamicsConfig(dyn_stride=2)))
    probe = LoopProbe()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches0 = fmn.launches
    frame_ms, chunk_ms = [], []
    for i in range(DYN_PER_FRAME):
        t = time.perf_counter()
        slam.track_rgbd(g_dev[i], d_dev[i], stamps[i], seg_mask=m_dev[i])
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
    for c in range(DYN_PER_FRAME, DYN_FRAMES, DYN_W):
        t = time.perf_counter()
        slam.track_rgbd_chunk(g_dev[c: c + DYN_W], d_dev[c: c + DYN_W], stamps[c: c + DYN_W],
                              seg_masks=m_dev[c: c + DYN_W])
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t) * 1e3)
    run_launches = fmn.launches - launches0
    phase_launches = fmn.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    probe.remove()
    est = np.asarray(slam.corrected_poses_np())
    gt = np.asarray(fposes[:DYN_FRAMES])
    check(bool(np.isfinite(est).all()) and est.shape == (DYN_FRAMES, 4, 4),
          f"dynamics trajectory not finite or of shape {est.shape}")
    ate = evaluate.ate_rmse(evaluate.positions_from_cw(est), evaluate.positions_from_cw(gt))
    rpe_t, rpe_r = evaluate.rpe(est, gt)
    inliers = [s["inliers"] for s in slam.stats[1:]]

    # one more chunk under the profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        slam.track_rgbd_chunk(g_dev[DYN_FRAMES:], d_dev[DYN_FRAMES:], stamps[DYN_FRAMES:],
                              seg_masks=m_dev[DYN_FRAMES:])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    prof_out = device_profile(prof, DYN_W)

    # the stage's parts alone, at the path's shapes (frames 94 -> 95)
    dc = slam.cfg.dynamics
    pg, pd, cg, cd = g_dev[DYN_FRAMES - 2], d_dev[DYN_FRAMES - 2], g_dev[DYN_FRAMES - 1], \
        d_dev[DYN_FRAMES - 1]
    kp = pipe.detect_keypoints(pg)[0]
    src, src_ok = kp.xy[::2][:512], kp.valid[::2][:512]
    lds = dc.lk_downsample
    lk_args = (pg[::lds, ::lds], cg[::lds, ::lds], src / lds, src_ok)
    lk_kw = dict(levels=dc.lk_levels - 1, win_half=dc.lk_win, iters=dc.lk_iters)
    flow = lk_flow(*lk_args, **lk_kw)
    pts1 = flow.pts1 * lds
    xi = torch.clamp(torch.round(src[:, 0]).long(), 0, cg.shape[1] - 1)
    yi = torch.clamp(torch.round(src[:, 1]).long(), 0, cg.shape[0] - 1)
    d0 = pd[yi, xi]
    T_last = slam.last_Tcw
    pts_w = se3.transform_points(se3.inv_T(T_last), backproject(pipe.cam, src, d0.clamp(min=1e-3)))
    pnp_valid = flow.valid & (d0 > 0)
    slic_kw = dict(cell=dc.slic_cell, slic_iters=dc.slic_iters, k=dc.n_clusters)
    dyn_kw = dict(config_kwargs(dc), has_seg=True)
    parts = {
        "lk_flow": lambda: lk_flow(*lk_args, **lk_kw),
        "slic_kmeans": lambda: slic_kmeans(cg, cd, **slic_kw),
        "ransac_pnp": lambda: ransac_pnp(pipe.cam, pts_w, pts1, pnp_valid,
                                         generator=ransac_generator(95, "cuda"),
                                         n_hyp=dc.pnp_hypotheses),
        "compute_dynamics": lambda: compute_dynamics(
            pipe.cam, pg, pd, cg, cd, m_dev[DYN_FRAMES - 1], T_last, slam.velocity,
            kp.xy, kp.valid, 95, **dyn_kw),
    }
    timed = {name: {"event_ms_per_call": _event_ms(fn), **_profiled_call(fn)}
             for name, fn in parts.items()}
    timed["shapes"] = {"lk_flow": f"{int(src.shape[0])} tracks, {lk_kw['levels']} levels at "
                                  f"{tuple(lk_args[0].shape)}",
                       "slic_kmeans": f"{tuple(cg.shape)}",
                       "ransac_pnp": f"{dc.pnp_hypotheses} x {int(pts_w.shape[0])}"}
    print(json.dumps({"dynamics_parts_alone": timed}))

    print(json.dumps({
        "dynamics_full_width": "System(SystemConfig(use_dynamics=True, "
                               "dynamics=DynamicsConfig(dyn_stride=2))) 640x480 defaults, "
                               "renderer's mover mask as the stage-one mask",
        "frames": DYN_FRAMES, "per_frame_frames": DYN_PER_FRAME,
        "chunk_frames": DYN_FRAMES - DYN_PER_FRAME, "chunk_w": DYN_W,
        "ate_m": ate, "rpe_t_m": rpe_t, "rpe_r_rad": rpe_r,
        "min_inliers": min(inliers), "state": slam.state.name, "keyframes": slam.map.n_kfs,
        "frame_ms_median_after_5": statistics.median(frame_ms[5:]),
        # with dyn_stride=2 the per-frame times are bimodal: even frames run
        # the stage, odd frames reuse its mask; a chunk's time is their mean
        "frame_ms_mean_after_5": statistics.mean(frame_ms[5:]),
        "frame_ms_with_stage_median": statistics.median(frame_ms[6::2]),
        "frame_ms_reusing_mask_median": statistics.median(frame_ms[5::2]),
        "chunk_ms_per_frame_median": statistics.median(chunk_ms) / DYN_W,
        "chunk_ms": chunk_ms,
        "max_memory_allocated_bytes": peak_bytes,
        "fast_kernel_launches": run_launches,
        "profiled_chunk_wall_ms_per_frame": wall_ms / DYN_W,
        "device_busy_share_profiled": prof_out["device_kernel_ms_per_frame"] / (wall_ms / DYN_W),
        "loop_closer": {**probe.summary(slam), **bow_alone(slam)},
        **prof_out,
    }))
    check(run_launches == DYN_FRAMES,
          f"{fmn_mod.NAME} launched {run_launches} times in {DYN_FRAMES} dynamics frames")
    check(ate < 0.03, f"dynamics ATE {ate:.4f} m")
    check(rpe_t < 0.01, f"dynamics RPE-t {rpe_t:.4f} m")
    check(min(inliers) > 50, f"dynamics min inliers {min(inliers)}")
    check(slam.state is TrackingState.OK, f"dynamics state {slam.state.name}")
    check(slam.map.n_kfs >= 3, f"{slam.map.n_kfs} keyframes with dynamics")
    return phase_launches


def _conv_flop_hooks(model, add) -> list:
    """Forward hooks that call ``add(part, n)`` with 2 x the multiply-adds
    of every conv of ``model`` per call, ``part`` its top-level module."""
    def conv_hook(mod, args, out, part):
        add(part, 2 * mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
            * out.numel())

    return [m.register_forward_hook(lambda mod, a, o, part=name.split(".")[0]:
                                    conv_hook(mod, a, o, part))
            for name, m in model.named_modules() if isinstance(m, torch.nn.Conv2d)]


def count_flops(seg, rgbs) -> dict:
    """The operations of one ``person_mask_batch(rgbs)``, counted from the
    shapes by forward hooks: 2 x the multiply-adds of every conv (bf16 on
    the tensor cores), by top-level module, and of the f32 resize products
    (``models.yolact.Resize``: the input, the FPN's upsampling, ProtoNet's
    x2, the output mask)."""
    from amos_slam_tpu_torch.models.yolact import Resize

    flops = {}

    def add(part, n):
        flops[part] = flops.get(part, 0) + n

    def resize_hook(mod, args, out):
        x, (oh, ow) = args
        lead, (h, w) = x.numel() // (x.shape[-2] * x.shape[-1]), x.shape[-2:]
        first, second = (oh * h * w, oh * w * ow) if mod.h_first else (h * w * ow, oh * h * ow)
        add("resize_f32", 2 * lead * (first + second))

    hooks = _conv_flop_hooks(seg.model, add)
    for m in list(seg.model.modules()) + [seg._resize_in, seg._resize_out]:
        if isinstance(m, Resize):
            hooks.append(m.register_forward_hook(resize_hook))
    try:
        seg.person_mask_batch(rgbs)
    finally:
        for h in hooks:
            h.remove()
    return flops


def segmenter_alone(seg, fn, rgbs, label: str) -> dict:
    """Per-call time, device time and launches of ``fn`` (one call of the
    segmenter on ``rgbs``), and its FLOPs and their bound."""
    flops = count_flops(seg, rgbs if rgbs.dim() == 4 else rgbs[None])
    conv = sum(v for k, v in flops.items() if k != "resize_f32")
    return {
        "call": label, "input": list(rgbs.shape), "img_size": seg.img_size,
        "event_ms_per_call": _event_ms(fn), **_profiled_call(fn),
        "gflop_by_part": {k: v / 1e9 for k, v in flops.items()},
        "conv_gflop_per_image": conv / 1e9 / (rgbs.shape[0] if rgbs.dim() == 4 else 1),
        "bound_ms": conv / BF16_PEAK_FLOP_S * 1e3, "bound_by": "operations",
        "bound_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet), convs only",
        "resize_f32_ms_at_67_tflops": flops.get("resize_f32", 0) / 67e12 * 1e3,
    }


def flagship_phase(fmn, seq) -> int:
    """Phase 7 (see the module docstring) on ``seq`` (phase 6's
    mover_sequence). Returns the FAST launches of its runs."""
    from torch.profiler import ProfilerActivity, profile

    from amos_slam_tpu_torch.config import DynamicsConfig
    from amos_slam_tpu_torch.models.segmenter import Segmenter
    from amos_slam_tpu_torch.system import System, TrackingState

    g_dev, d_dev, _, fposes = seq
    rgb = g_dev[..., None].expand(-1, -1, -1, 3)     # grey replicated, as bench.py
    launches0 = fmn.launches

    # 7.2 first: the weights (Flax's init, seed 0, drawn on the host) and
    # the mask content on the card against the CPU
    kw = dict(person_classes=tuple(range(80)), score_th=0.0, img_size=400)
    t = time.perf_counter()
    cpu32 = Segmenter(compute_dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(0), **kw)
    sd = cpu32.model.state_dict()
    init_s = time.perf_counter() - t
    card32 = Segmenter(sd, compute_dtype=torch.float32, **kw)
    card16 = Segmenter(sd, **kw)
    two = rgb[10:12]
    raw_cpu = cpu32.raw(two.cpu())
    raw32, raw16 = card32.raw(two), card16.raw(two)
    names = ("loc", "conf", "coef", "proto")
    f32_err = {n: float((a.cpu() - b).abs().max() / b.abs().max())
               for n, a, b in zip(names, raw32, raw_cpu)}
    bf16_err = {n: (float((a - b).abs().max() / b.abs().max()), float((a - b).norm() / b.norm()))
                for n, a, b in zip(names, raw16, raw32)}
    m_cpu = cpu32.person_mask_batch(two.cpu())
    m32, m16 = card32.person_mask_batch(two).cpu(), card16.person_mask_batch(two).cpu()
    agree32 = [float((a == b).float().mean()) for a, b in zip(m32, m_cpu)]
    agree16 = [float((a == b).float().mean()) for a, b in zip(m16, m32)]
    cover = [float(m.float().mean()) for m in m32]
    print(json.dumps({
        "flagship_mask_content": "person_classes=range(80), score_th=0.0, img_size 400, "
                                 "frames 10-11, grey as RGB",
        "weights_init_s_cpu": init_s,
        "card_f32_vs_cpu_f32_max_err": f32_err, "card_f32_vs_cpu_f32_mask_agreement": agree32,
        "card_f32_mask_coverage": cover,
        "card_bf16_vs_card_f32_max_rms_err": bf16_err,
        "card_bf16_vs_card_f32_mask_agreement": agree16,
        "card_bf16_mask_coverage": [float(m.float().mean()) for m in m16],
    }))
    check(max(f32_err.values()) < CARD_VS_CPU_F32, f"card f32 net vs CPU {f32_err}")
    check(min(agree32) >= 0.999, f"card f32 masks vs CPU agree {agree32}")
    check(all(0.01 < c < 0.99 for c in cover), f"mask coverage {cover}")
    check(all(e[0] < BF16_VS_F32[0] and e[1] < BF16_VS_F32[1] for e in bf16_err.values()),
          f"card bf16 vs f32 {bf16_err}")
    del cpu32, card32, card16

    # 7.1 the segmenter alone, at the flagship's and the default size
    seg = Segmenter(sd, img_size=400)
    seg550 = Segmenter(sd)
    chunk = rgb[:SEG_W]
    alone = [
        segmenter_alone(seg, lambda: seg.person_mask_batch(chunk), chunk,
                        "Segmenter(img_size=400).person_mask_batch"),
        segmenter_alone(seg550, lambda: seg550.person_mask(rgb[0]), rgb[0],
                        "Segmenter().person_mask"),
    ]
    print(json.dumps({"segmenter_alone": alone, "card": timing.smi("name,power.limit")}))
    del seg550

    # 7.3 the flagship end to end, as bench.py phase_two_stage
    calls = [0]
    person_mask_batch = seg.person_mask_batch

    def counted(x):
        calls[0] += 1
        return person_mask_batch(x)

    seg.person_mask_batch = counted
    n = SEG_CHUNKS * SEG_W
    stamps = [i / 30.0 for i in range(n + SEG_W)]
    slam = System(SystemConfig(dynamics=DynamicsConfig(dyn_stride=2)))
    probe = LoopProbe()
    torch.cuda.synchronize()
    launches1 = fmn.launches
    chunk_ms, all_masks = [], []
    t0 = time.perf_counter()
    masks = seg.person_mask_batch(rgb[:SEG_W])
    for c in range(0, n, SEG_W):
        t = time.perf_counter()
        nxt = seg.person_mask_batch(rgb[c + SEG_W: c + 2 * SEG_W]) if c + SEG_W < n else None
        slam.track_rgbd_chunk(g_dev[c: c + SEG_W], d_dev[c: c + SEG_W], stamps[c: c + SEG_W],
                              seg_masks=masks)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t) * 1e3)
        all_masks.append(masks)
        masks = nxt
    run_ms = (time.perf_counter() - t0) * 1e3
    run_launches, run_calls = fmn.launches - launches1, calls[0]
    probe.remove()
    coverage = float(torch.stack(all_masks).float().mean())
    est = np.asarray(slam.corrected_poses_np())
    gt = np.asarray(fposes[:n])
    check(bool(np.isfinite(est).all()) and est.shape == (n, 4, 4),
          f"flagship trajectory not finite or of shape {est.shape}")
    ate = evaluate.ate_rmse(evaluate.positions_from_cw(est), evaluate.positions_from_cw(gt))
    rpe_t, rpe_r = evaluate.rpe(est, gt)
    inliers = [s["inliers"] for s in slam.stats[1:]]

    # one more chunk, segmenter included, under the profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        m = seg.person_mask_batch(rgb[n: n + SEG_W])
        slam.track_rgbd_chunk(g_dev[n: n + SEG_W], d_dev[n: n + SEG_W], stamps[n:], seg_masks=m)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    prof_out = device_profile(prof, SEG_W)
    seg_dev, seg_host = alone[0]["device_kernel_ms"], alone[0]["event_ms_per_call"]
    print(json.dumps({
        "flagship": "Segmenter(img_size=400) bf16 -> System(SystemConfig(dynamics="
                    "DynamicsConfig(dyn_stride=2))).track_rgbd_chunk, 640x480 defaults",
        "frames": n, "chunk_w": SEG_W, "segmenter_calls": run_calls,
        "ate_m": ate, "rpe_t_m": rpe_t, "rpe_r_rad": rpe_r,
        "min_inliers": min(inliers), "state": slam.state.name, "keyframes": slam.map.n_kfs,
        "ms_per_frame": run_ms / n, "chunk_ms": chunk_ms,
        "chunk_ms_per_frame_median": statistics.median(chunk_ms) / SEG_W,
        "mask_coverage": coverage,
        "mask_coverage_note": "random weights, 81 classes, score 0.15: empty masks expected",
        "fast_kernel_launches": run_launches,
        "profiled_chunk_wall_ms_per_frame": wall_ms / SEG_W,
        "device_busy_share_profiled": prof_out["device_kernel_ms_per_frame"] / (wall_ms / SEG_W),
        "segmenter_device_ms_share": seg_dev / SEG_W / prof_out["device_kernel_ms_per_frame"],
        "segmenter_launch_share": alone[0]["launches"] / SEG_W
        / prof_out["kernel_launches_per_frame"],
        "segmenter_host_ms_share": seg_host / SEG_W / (run_ms / n),
        "loop_closer": {**probe.summary(slam), **bow_alone(slam)},
        **prof_out,
    }))
    if coverage == 0.0:
        print("flagship: the masks are empty, as random weights at 81 classes and score "
              "0.15 make them; the cost is that of trained weights, the content is not")
    check(run_calls == SEG_CHUNKS, f"{run_calls} segmenter calls in {SEG_CHUNKS} chunks")
    check(run_launches == n, f"{fmn_mod.NAME} launched {run_launches} times in {n} flagship frames")
    check(ate < 0.03, f"flagship ATE {ate:.4f} m")
    check(rpe_t < 0.01, f"flagship RPE-t {rpe_t:.4f} m")
    check(min(inliers) > 50, f"flagship min inliers {min(inliers)}")
    check(slam.state is TrackingState.OK, f"flagship state {slam.state.name}")
    check(slam.map.n_kfs >= 3, f"{slam.map.n_kfs} flagship keyframes")
    seg.person_mask_batch = person_mask_batch
    return fmn.launches - launches0, seg


def loop_phase(fmn, seg) -> int:
    """Phase 8 (see the module docstring), driven by tools/loop_search.py.
    Returns the FAST launches of its run."""
    from amos_slam_tpu_torch.config import DynamicsConfig
    from amos_slam_tpu_torch.system import System, TrackingState

    g_dev, d_dev, poses, n = loop_search.render(LOOP, os.cpu_count() or 1)
    n_all = len(poses)
    slam = System(SystemConfig(dynamics=DynamicsConfig(dyn_stride=2)))
    probe = LoopProbe(parts=True)
    torch.cuda.synchronize()
    fmn.launches = 0
    slam, res = loop_search.track(LOOP, g_dev, d_dev, poses, n, seg, slam=slam,
                                  overhead_ms=lambda: probe.overhead_ms)
    run_launches = fmn.launches
    probe.remove()

    raw = np.asarray(slam.poses_np())
    est = np.asarray(slam.corrected_poses_np())
    check(bool(np.isfinite(est).all()) and est.shape == (n_all, 4, 4),
          f"loop trajectory not finite or of shape {est.shape}")
    check(bool(res["blackout_frames"]), "the run never reached 8 keyframes: no blackout")
    probe.keyframe_ates(raw, res.pop("keyframe_poses"), poses)
    # the relocalizer on the last frame, called once more: a reading only
    t = time.perf_counter()
    r = slam.loop.relocalize(slam.last_feats)
    reloc_last = {"inliers": None if r is None else r[1], "ms": (time.perf_counter() - t) * 1e3}
    m = slam.map
    obs = m.kf_obs_np[: m.n_kfs]
    dead_obs = int((~m.pt_alive[obs[obs >= 0]]).sum())
    chunk_ms, chunk_loops = res.pop("chunk_ms"), res.pop("chunk_loops")
    seq_chunks = n // SEG_W
    loop_chunks = [i for i, k in enumerate(chunk_loops) if k]
    plain = [ms for ms, k in zip(chunk_ms[:seq_chunks], chunk_loops) if not k]
    print(json.dumps({
        "loop_phase": "Segmenter(img_size=400) bf16 -> System(SystemConfig(dynamics="
                      "DynamicsConfig(dyn_stride=2))).track_rgbd_chunk, 640x480 defaults, "
                      f"tools/loop_search.py {LOOP}",
        **res,
        "relocalize_last_frame": reloc_last,
        "observations_of_dead_landmarks": dead_obs,
        "chunk_ms_per_frame_median_without_loop": statistics.median(plain) / SEG_W,
        "chunk_ms_with_loop": [chunk_ms[i] for i in loop_chunks],
        "loop_chunk_frames": [[i * SEG_W, i * SEG_W + SEG_W - 1] for i in loop_chunks],
        "chunk_ms": chunk_ms,
        "verify_and_correct": probe.loops,
        "fast_kernel_launches": run_launches,
        **probe.summary(slam),
        "card": timing.smi("name,power.limit"),
    }))
    check(len(res["loops_closed"]) >= 1, "no loop closed")
    check(res["state_after_sequence"] == "OK",
          f"loop phase state {res['state_after_sequence']} after the sequence")
    check(res["ate_m"] < 0.03, f"loop phase corrected ATE {res['ate_m']:.4f} m")
    check(res["ate_m"] <= res["ate_raw_m"] + 1e-4,
          f"corrected ATE {res['ate_m']:.5f} above the raw {res['ate_raw_m']:.5f} m")
    check(bool(res["reloc_frames"]),
          f"no frame relocalized after the kidnap to frames {res['kidnap_back_frames']}")
    check(res["ate_with_kidnap_m"] < 0.03, f"ATE with the kidnap {res['ate_with_kidnap_m']:.4f} m")
    check(slam.state is TrackingState.OK, f"loop phase state {slam.state.name} at the end")
    check(dead_obs == 0, f"{dead_obs} observations point at dead landmarks")
    check(np.array_equal(m.arrays.kf_obs[: m.n_kfs].cpu().numpy(), obs),
          "device kf_obs differs from the host mirror")
    check(run_launches == n_all,
          f"{fmn_mod.NAME} launched {run_launches} times in {n_all} loop frames")
    return run_launches

def _path_readings(slam, track, frames, stamps, force_split) -> dict:
    """After a gated run: ``PATH_PROFILED`` more frames on the fused path,
    then one on the split path (``force_split()`` makes the next frame
    take it), each window timed between syncs and then again under
    torch.profiler on the next frames (launches and device ms per frame).
    ``frames[i]`` is the argument tuple of ``track``."""
    from torch.profiler import ProfilerActivity, profile

    out, i = {}, 0

    def window(name, n, before=lambda: None):
        nonlocal i
        for profiled in (False, True):
            # a read still in flight would resolve at the next frame's drain
            # and undo ``before`` (a LOST state turned OK again)
            slam.shutdown()
            before()
            torch.cuda.synchronize()
            ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                   if profiled else contextlib.nullcontext())
            with ctx as prof:
                t = time.perf_counter()
                for _ in range(n):
                    track(*frames[i], stamps[i])
                    i += 1
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3 / n
            if profiled:
                p = device_profile(prof, n)
                out[name].update(profiled_ms_per_frame=ms,
                                 launches_per_frame=p["kernel_launches_per_frame"],
                                 device_ms_per_frame=p["device_kernel_ms_per_frame"],
                                 top_kernels=p["top_kernels_by_device_ms"][:3])
            else:
                out[name] = {"frames": n, "ms_per_frame": ms}

    window("fused", PATH_PROFILED)
    window("split", 1, force_split)
    return out


def stereo_phase(fmn) -> int:
    """Phase 9 (see the module docstring). Returns the FAST launches of its
    gated run."""
    from amos_slam_tpu_torch.config import ORBConfig
    from amos_slam_tpu_torch.frontend.tracking import stereo_features
    from amos_slam_tpu_torch.io.kitti import kitti_camera_config
    from amos_slam_tpu_torch.ops.stereo import match_stereo
    from amos_slam_tpu_torch.system import System, TrackingState

    cam = kitti_camera_config(0)
    cfg = SystemConfig(camera=cam, orb=ORBConfig(n_features=2000, max_kpts=2048),
                       sensor="stereo", use_dynamics=False)
    n = STEREO_FRAMES + 2 * (PATH_PROFILED + 1)
    poses = synthetic.orbit_trajectory(STEREO_FRAMES, radius=0.1, advance=0.25)
    poses = poses + poses[::-1][1: n - STEREO_FRAMES + 1]   # the readings retrace the path
    planes = synthetic.default_room(seed=9)
    shift = np.eye(4)
    shift[0, 3] = -cam.bf / cam.fx
    kw = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width, height=cam.height)
    workers = os.cpu_count() or 1
    t = time.perf_counter()
    left = synthetic.render_many(planes, poses, workers, **kw)
    right = synthetic.render_many(planes, [shift @ T for T in poses], workers, **kw)
    render_s = time.perf_counter() - t
    grey = lambda fr: np.stack([np.clip(g, 0, 255).astype(np.uint8) for g, _ in fr])  # noqa: E731
    gl, gr = _to_dev(grey(left).astype(np.float32), grey(right).astype(np.float32))
    stamps = [i / cam.fps for i in range(n)]

    slam = System(cfg)
    probe = LoopProbe()
    torch.cuda.synchronize()
    fmn.launches = 0
    frame_ms = []
    for i in range(STEREO_FRAMES):
        t = time.perf_counter()
        slam.track_stereo(gl[i], gr[i], stamps[i])
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
    launches = fmn.launches
    probe.remove()
    est = np.asarray(slam.corrected_poses_np())
    gt = np.asarray(poses[:STEREO_FRAMES])
    check(bool(np.isfinite(est).all()) and est.shape == (STEREO_FRAMES, 4, 4),
          f"stereo trajectory not finite or of shape {est.shape}")
    ate = evaluate.ate_rmse(evaluate.positions_from_cw(est), evaluate.positions_from_cw(gt))
    rpe_t, rpe_r = evaluate.rpe(est, gt)
    inliers = [s["inliers"] for s in slam.stats[1:]]
    n_kfs, state = slam.map.n_kfs, slam.state
    frames = list(zip(gl[STEREO_FRAMES:], gr[STEREO_FRAMES:]))
    paths = _path_readings(slam, slam.track_stereo, frames, stamps[STEREO_FRAMES:],
                           lambda: setattr(slam, "state", TrackingState.LOST))

    # match_stereo alone on the last pair
    pipe = slam.pipeline
    kl, _, bl, pl = pipe.detect_keypoints(gl[-1])
    kr, _, br, pr = pipe.detect_keypoints(gr[-1])
    fl, fr = pipe.describe(kl, pl), pipe.describe(kr, pr)
    min_z = pipe.cam.bf / pipe.cam.fx
    args = (fl.desc, kl.xy, kl.level, fl.valid, fr.desc, kr.xy, kr.level, fr.valid,
            bl[0], br[0], pipe.cam.bf, min_z)
    n_match = int(match_stereo(*args).valid.sum())
    alone = {"event_ms_per_call": _event_ms(lambda: match_stereo(*args)),
             **_profiled_call(lambda: match_stereo(*args)),
             "keypoints": [int(fl.valid.sum()), int(fr.valid.sum())], "matched": n_match}
    feats_ms = _event_ms(lambda: stereo_features(pipe, kl, bl, pl, kr, br, pr, min_z))
    print(json.dumps({
        "stereo_phase": "System(SystemConfig(camera=kitti_camera_config(0), orb=ORBConfig("
                        "n_features=2000, max_kpts=2048), sensor='stereo', "
                        "use_dynamics=False)) 1241x376",
        "frames": STEREO_FRAMES, "render_s": render_s,
        "ate_m": ate, "rpe_t_m": rpe_t, "rpe_r_rad": rpe_r,
        "min_inliers": min(inliers), "state": state.name, "keyframes": n_kfs,
        "keyframe_frames": [int(f) for f in slam.map.kf_frame_id[: n_kfs]],
        "landmarks": slam.map.n_pts,
        "frame_ms_first": frame_ms[0],
        "frame_ms_median_after_5": statistics.median(frame_ms[5:]),
        "paths": paths,
        "match_stereo_alone": alone,
        "describe_and_match_event_ms": feats_ms,
        "fast_kernel_launches": launches,
        "loop_closer": probe.summary(slam),
        "card": timing.smi("name,power.limit"),
    }))
    check(launches == 2 * STEREO_FRAMES,
          f"{fmn_mod.NAME} launched {launches} times in {STEREO_FRAMES} stereo frames")
    check(state is TrackingState.OK, f"stereo state {state.name}")
    check(ate < 0.02, f"stereo ATE {ate:.4f} m")
    check(min(inliers) > 50, f"stereo min inliers {min(inliers)}")
    check(n_kfs >= 3, f"{n_kfs} stereo keyframes")
    return launches


def mono_phase(fmn) -> int:
    """Phase 10 (see the module docstring). Returns the FAST launches of its
    gated run."""
    import amos_slam_tpu_torch.system as system_mod
    from torch.profiler import ProfilerActivity, profile

    from amos_slam_tpu_torch.system import System, TrackingState

    cfg = SystemConfig(sensor="mono", use_dynamics=False)
    cam = cfg.camera
    n = MONO_FRAMES + 2 * (PATH_PROFILED + 1)
    poses = synthetic.orbit_trajectory(MONO_FRAMES, radius=0.35, advance=0.15)
    poses = poses + poses[::-1][1: n - MONO_FRAMES + 1]   # the readings retrace the path
    planes = synthetic.default_room(seed=11)
    frames = synthetic.render_many(planes, poses, os.cpu_count() or 1)
    (g_dev,) = _to_dev(np.stack([np.clip(g, 0, 255).astype(np.uint8) for g, _ in frames])
                       .astype(np.float32))
    stamps = [i / cam.fps for i in range(n)]

    slam = System(cfg)
    inits, models = [], []
    init_mono, two_view = slam._initialize_mono, system_mod.initialize_two_view

    def timed_init(feats):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            Tcw = init_mono(feats)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        p = device_profile(prof, 1)
        inits.append({"frame": slam.frame_id, "ms": ms, "kf": bool(slam.stats[-1]["kf"]),
                      "launches": p["kernel_launches_per_frame"],
                      "device_ms": p["device_kernel_ms_per_frame"],
                      "model": models[-1] if slam.stats[-1]["kf"] and models else None})
        return Tcw

    def recording_two_view(*args, **kwargs):
        res = two_view(*args, **kwargs)
        models.append({"model": "H" if bool(res.used_h) else "F",
                       "num_good": int(res.num_good), "ok": bool(res.ok)})
        return res

    slam._initialize_mono = timed_init
    system_mod.initialize_two_view = recording_two_view
    probe = LoopProbe()
    try:
        torch.cuda.synchronize()
        fmn.launches = 0
        frame_ms = []
        for i in range(MONO_FRAMES):
            t = time.perf_counter()
            slam.track_monocular(g_dev[i], stamps[i])
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t) * 1e3)
        launches = fmn.launches
    finally:
        system_mod.initialize_two_view = two_view
        probe.remove()
    est = np.asarray(slam.poses_np())
    check(bool(np.isfinite(est).all()) and est.shape == (MONO_FRAMES, 4, 4),
          f"mono trajectory not finite or of shape {est.shape}")
    init = next((i for i, st in enumerate(slam.stats) if st.get("kf")), None)
    check(init is not None, "the monocular map never initialized")
    ate = evaluate.ate_rmse(evaluate.positions_from_cw(est[init:]),
                            evaluate.positions_from_cw(np.asarray(poses[init:MONO_FRAMES])),
                            with_scale=True)
    m = slam.map
    n_kfs, n_pts, alive, state = m.n_kfs, m.n_pts, int(m.pt_alive.sum()), slam.state
    inliers = [st["inliers"] for st in slam.stats[init + 1:]]
    paths = _path_readings(slam, slam.track_monocular, [(g,) for g in g_dev[MONO_FRAMES:]],
                           stamps[MONO_FRAMES:], lambda: setattr(slam, "_last_pid", None))
    print(json.dumps({
        "mono_phase": "System(SystemConfig(sensor='mono', use_dynamics=False)) 640x480 defaults",
        "frames": MONO_FRAMES, "init_frame": init,
        "ate_scale_aligned_after_init_m": ate, "state": state.name,
        "keyframes": n_kfs, "keyframe_frames": [int(f) for f in m.kf_frame_id[: n_kfs]],
        "landmarks": n_pts, "landmarks_alive": alive,
        "min_inliers_after_init": min(inliers) if inliers else None,
        "frame_ms_median_after_init": statistics.median(frame_ms[init + 2:]),
        "initialize_mono_calls": inits,
        "paths": paths,
        "fast_kernel_launches": launches,
        "loop_closer": probe.summary(slam),
        "card": timing.smi("name,power.limit"),
    }))
    check(launches == MONO_FRAMES,
          f"{fmn_mod.NAME} launched {launches} times in {MONO_FRAMES} mono frames")
    check(state is TrackingState.OK, f"mono state {state.name}")
    check(n_kfs >= 2, f"{n_kfs} mono keyframes")
    check(n_pts > 100, f"{n_pts} mono landmarks")
    check(ate < 0.05, f"mono scale-aligned ATE {ate:.4f}")
    return launches


def ms_frames():
    """Phase 11's sequence: MS_STREAMS distinct rooms (default_room(seed=20
    + s), as tests/test_multistream.py's live-map test) over the bench's
    motion (the system phase's orbit), grey as a camera delivers it.
    Returns (poses, grey (n, S, H, W), depth (n, S, H, W)) on the host."""
    n = 1 + MS_STEPS + MS_PROFILED
    poses = synthetic.orbit_trajectory(144, radius=0.1, advance=144 / 768)[:n]
    rooms = [synthetic.default_room(seed=20 + s) for s in range(MS_STREAMS)]
    frames = synthetic.render_rooms(rooms, poses, os.cpu_count() or 1)
    gray = np.stack([[np.clip(g, 0, 255).astype(np.uint8) for g, _ in row] for row in frames])
    depth = np.stack([[d for _, d in row] for row in frames])
    return poses, gray.astype(np.float32), depth.astype(np.float32)


def _host_us(fn, calls: int = 200) -> float:
    """Host time per call of ``calls`` back-to-back calls (no sync inside),
    after warm-up: what dispatching a call costs the host."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def multistream_phase(fmn, seq) -> int:
    """Phase 11 (see the module docstring) on ``seq`` (ms_frames()).
    Returns the FAST launches of its gated run."""
    from torch.profiler import ProfilerActivity, profile

    from amos_slam_tpu_torch.frontend.tracking import fused_frame_step, index_tree
    from amos_slam_tpu_torch.parallel.multistream import MultiStreamSLAM

    S = MS_STREAMS
    poses, gray, depth = seq
    g_dev, d_dev = _to_dev(gray, depth)
    cfg = SystemConfig(use_dynamics=False)
    L = cfg.orb.n_levels
    slam = MultiStreamSLAM(cfg, S)

    # every launch's shape, recorded where the op launches the kernel
    shapes = []

    def recording(imgs, extents=None):
        shapes.append(tuple(imgs.shape))
        return type(fmn).launch(fmn, imgs, extents)

    # each step's (S, 3) rows as they resolve (up to 2 steps after it)
    sups, est, step_ms, snaps = {}, [], [], {}
    resolve = slam._resolve_step

    def recording_rows(st, heavy, frame, sup):
        sups[frame] = np.array(sup)
        return resolve(st, heavy, frame, sup)

    slam._resolve_step = recording_rows
    fmn.launch = recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fmn.launches = 0
        t = time.perf_counter()
        slam.initialize(g_dev[0], d_dev[0])
        torch.cuda.synchronize()
        init_ms = (time.perf_counter() - t) * 1e3
        est.append(slam.state.Tcw)
        t_run = time.perf_counter()
        for k in range(1, 1 + MS_STEPS):
            if k in MS_CHECK:
                snaps[k] = (slam.state, slam.views)
            t = time.perf_counter()
            T, _ = slam.step(g_dev[k], d_dev[k])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            est.append(T)
        slam.flush()
        run_s = time.perf_counter() - t_run
        launches = fmn.launches
    finally:
        del fmn.launch
    launch_shapes = sorted(set(shapes))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # the vmapped step against S separate fused steps on the same inputs
    vs_separate = {}
    for k, (st0, views) in snaps.items():
        sep = [fused_frame_step(slam.pipeline, g_dev[k, s], d_dev[k, s],
                                index_tree(st0.feats, s), st0.Tcw[s], st0.velocity[s],
                                index_tree(views, s), slam._r_mm, slam._r_map,
                                min_lm=cfg.tracking.min_inliers_local_map)
               for s in range(S)]
        sep_sup = np.stack([r.sup.cpu().numpy() for r in sep])
        sep_T = torch.stack([r.Tcw for r in sep])
        vs_separate[k] = {"sup_equal": bool((sep_sup == sups[k]).all()),
                    "pose_max_abs_err": float((sep_T - est[k]).abs().max()),
                    "view_points": [int((views.ids[s] >= 0).sum()) for s in range(S)]}

    # where the time goes: MS_PROFILED more steps under torch.profiler
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(1 + MS_STEPS, 1 + MS_STEPS + MS_PROFILED):
            slam.step(g_dev[k], d_dev[k])
        torch.cuda.synchronize()
    prof8 = device_profile(prof, MS_PROFILED)

    # the same step at S = 1 (stream 0), timed, then profiled
    solo = MultiStreamSLAM(cfg, 1)
    solo.initialize(g_dev[0, :1], d_dev[0, :1])
    solo_ms = []
    for k in range(1, 1 + MS_SOLO_STEPS):
        t = time.perf_counter()
        solo.step(g_dev[k, :1], d_dev[k, :1])
        torch.cuda.synchronize()
        solo_ms.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(1 + MS_SOLO_STEPS, 1 + MS_SOLO_STEPS + MS_PROFILED):
            solo.step(g_dev[k, :1], d_dev[k, :1])
        torch.cuda.synchronize()
    prof1 = device_profile(prof, MS_PROFILED)

    est_np = torch.stack(est).cpu().numpy().astype(np.float64)     # (1 + steps, S, 4, 4)
    gt_pos = evaluate.positions_from_cw(np.asarray(poses[: 1 + MS_STEPS]))
    ates = [evaluate.ate_rmse(evaluate.positions_from_cw(est_np[:, s]), gt_pos)
            for s in range(S)]
    inliers = np.stack([sups[k] for k in range(1, 1 + MS_STEPS)])[:, :, 1]   # (steps, S)
    kfs = [m.n_kfs for m in slam.maps]
    kf_frames = [[int(f) for f in m.kf_frame_id[: m.n_kfs]] for m in slam.maps]
    med8 = statistics.median(step_ms)
    print(json.dumps({
        "multistream_phase": f"MultiStreamSLAM(SystemConfig(use_dynamics=False), {S}) "
                             "640x480 defaults, default_room(seed=20+s)",
        "steps": MS_STEPS, "init_ms": init_ms, "run_s": run_s,
        "aggregate_fps": S * MS_STEPS / run_s,
        "step_ms_median": med8, "step_ms_max": max(step_ms),
        "step_ms_first": step_ms[0],
        "launches_per_step": prof8["kernel_launches_per_frame"],
        "device_ms_per_step": prof8["device_kernel_ms_per_frame"],
        "device_busy_share": prof8["device_kernel_ms_per_frame"] / med8,
        "top_ops_by_device_ms": prof8["top_ops_by_device_ms"][:5],
        "solo_s1": {"step_ms_median": statistics.median(solo_ms),
                    "fps": 1e3 / statistics.median(solo_ms),
                    "launches_per_step": prof1["kernel_launches_per_frame"],
                    "device_ms_per_step": prof1["device_kernel_ms_per_frame"]},
        "fast_kernel_launches": launches, "fast_launch_shapes": launch_shapes,
        "vmapped_vs_separate": vs_separate,
        "ate_m": ates, "min_inliers_after_frame_1": int(inliers[1:].min()),
        "keyframes": kfs, "keyframe_frames": kf_frames,
        "landmarks": [m.n_pts for m in slam.maps],
        "peak_memory_gib": peak_gib,
        "card": timing.smi("name,power.limit"),
    }))
    batched = (S * L, 480, 640)
    check(launches == MS_STEPS + 1,
          f"{fmn_mod.NAME} launched {launches} times in {MS_STEPS} steps + initialize")
    check(launch_shapes == [batched], f"{fmn_mod.NAME} launch shapes {launch_shapes}")
    for k, c in vs_separate.items():
        check(c["sup_equal"], f"vmapped step {k}: sup rows differ from separate steps")
        check(c["pose_max_abs_err"] < 1e-5,
              f"vmapped step {k}: poses {c['pose_max_abs_err']} from separate steps")
    check(min(kfs) >= 2, f"multistream keyframes per stream {kfs}")
    check(max(ates) < MS_ATE, f"multistream ATE {ates}")
    check(int(inliers[1:].min()) > 50, f"multistream min inliers {int(inliers[1:].min())}")
    return launches


def mesh_devices() -> list:
    """Phase 14's stream mesh: on a machine with more than one card, the
    first G cards, G the largest divisor of MS_STREAMS that is at most the
    card count; on one card, two entries on cuda:0."""
    cards = torch.cuda.device_count()
    if cards == 1:
        return ["cuda:0", "cuda:0"]
    return [f"cuda:{i}" for i in range(max(g for g in range(1, cards + 1)
                                           if MS_STREAMS % g == 0))]


def multistream_kernel(fmn, sizes, pyr, levels, kernel_and_floor):
    """The multistream paths' launches, in the kernels phase: the 8
    streams' pyramids (each room's first frame) through the op's vmap
    rule, one launch over (64, 480, 640) with the level extents repeated 8
    times (phases 11 and 13), and the first 8 / G of them, one launch over
    (8 / G x 8, 480, 640) (a group of phase 14's mesh of G entries), each
    exact against the plain version and timed; and the host time per call
    of a direct launch, of the custom op and of the vmapped call on the
    single path's pyramid ``pyr``. Returns {streams: (max abs error, the
    kernels row's numbers)} for 8 and 8 / G streams; ``kernel_and_floor``
    gives the kernel the wrapper picks for a shape and its issue floor."""
    dev = pyr.device
    ms_poses = synthetic.orbit_trajectory(144, radius=0.1, advance=144 / 768)[:1]
    ms_rooms = [synthetic.default_room(seed=20 + s) for s in range(MS_STREAMS)]
    ms_gray = np.stack([np.clip(g, 0, 255).astype(np.uint8).astype(np.float32) for g, _ in
                        synthetic.render_rooms(ms_rooms, ms_poses, os.cpu_count() or 1)[0]])
    all_pyr = torch.stack([pyramid.build_pyramid(g, sizes)
                           for g in torch.from_numpy(ms_gray).to(dev)])     # (8, 8, 480, 640)
    rows = {}
    for n in (MS_STREAMS, MS_STREAMS // len(mesh_devices())):
        ms_pyr = all_pyr[:n]

        def ms_batched():
            return torch.func.vmap(lambda p: fmn(p, levels))(ms_pyr)

        before = fmn.launches
        b_out = ms_batched()
        check(fmn.launches == before + 1, "the vmapped FAST call did not make one launch")
        ms_flat = ms_pyr.reshape(-1, *ms_pyr.shape[2:])
        ms_ext = fmn_mod.repeated_extents(levels, n)
        b_plain = fmn_mod.fast_margin_nms_plain(ms_flat, ms_ext).reshape(ms_pyr.shape)
        torch.cuda.synchronize()
        b_err = float((b_out - b_plain).abs().max())
        b_exact = bool(torch.equal(b_out, b_plain))
        print(f"kernel {fmn_mod.NAME} vmapped_{n}_streams_level_extents "
              f"{tuple(ms_flat.shape)}: tolerance exact, equal={b_exact} max_abs_err={b_err} "
              f"nonzero={int((b_out > 0).sum())}")
        check(b_exact, f"{fmn_mod.NAME} differs from its plain version at "
                       f"{tuple(ms_flat.shape)}")
        b_ms, b_runs, b_held = timing.loop_ms(ms_batched, launches=200)
        b_plain_ms, _, _ = timing.loop_ms(
            lambda: fmn_mod.fast_margin_nms_plain(ms_flat, ms_ext), launches=5, hold=False)
        b_read = n * sum(h * w for h, w in sizes)
        b_bound, b_by = timing.bound(4 * b_read, 4 * ms_flat.numel(),
                                     fmn_mod.OPS_PER_PIXEL * b_read)
        b_kernel, b_floor = kernel_and_floor(list(sizes) * n, *ms_flat.shape[1:])
        out = {"timing": fmn_mod.NAME + " vmapped", "shape": list(ms_flat.shape),
               "extents": f"level sizes repeated {n} times",
               "ms": b_ms, "runs_ms": b_runs, "runs_queue_held": b_held,
               "plain_ms": b_plain_ms, "bound_ms": b_bound, "bound_by": b_by,
               "kernel": b_kernel, "issue_floor_ms": b_floor,
               "read_px": b_read, "write_px": ms_flat.numel(),
               "card": timing.smi("name,power.limit")}
        if n == MS_STREAMS:
            # what the custom op's dispatch costs the host per call
            out["host_dispatch_per_call"] = {
                "direct_launch_us": _host_us(lambda: fmn.launch(pyr, levels)),
                "custom_op_us": _host_us(lambda: fmn(pyr, levels)),
                "vmapped_8_streams_us": _host_us(ms_batched)}
        print(json.dumps(out))
        rows[n] = (b_err, {"ms": b_ms, "plain_ms": b_plain_ms, "bound_ms": b_bound,
                           "bound_by": b_by, "kernel": b_kernel, "issue_floor_ms": b_floor})
    return rows


def _one_step(model, params, priors, cfg, batch, dev, dtype):
    """One train step of ``params`` on ``batch`` on ``dev`` in ``dtype``:
    ({"loss", "loc", "conf", "mask"}, per tensor the update -lr x momentum
    on the CPU in float64)."""
    from amos_slam_tpu_torch.models.train import GTBatch, make_train_step

    init, step = make_train_step(model.to(dev, dtype), priors.to(dev), cfg.lr, cfg.momentum,
                                 cfg.weight_decay)
    b = GTBatch(batch.images.to(dev, dtype), batch.boxes.to(dev, dtype), batch.labels.to(dev),
                batch.masks.to(dev, dtype))
    state, loss, aux = step(init({k: v.to(dev, dtype) for k, v in params.items()}), b)
    return ({"loss": float(loss), **{k: float(v) for k, v in aux.items()}},
            {k: (-cfg.lr * m).to("cpu", torch.float64) for k, m in state.opt_state.items()})


def _step_gap(a, b) -> dict:
    """Two runs of ``_one_step``, ``b`` the reference: the loss parts'
    relative errors, and per tensor the update's max error over its max
    |update| (the worst tensor and the median)."""
    (pa, ua), (pb, ub) = a, b
    upd = {k: float((ua[k] - u).abs().max()) / max(float(u.abs().max()), 1e-300)
           for k, u in ub.items()}
    worst = max(upd, key=upd.get)
    return {"loss_part_rel_err": {k: abs(pa[k] - v) / abs(v) for k, v in pb.items()},
            "update_err_over_max_worst": upd[worst], "worst_tensor": worst,
            "update_err_over_max_median": statistics.median(upd.values())}


def train_card_vs_cpu(model, params, priors, cfg, batch) -> dict:
    """One step of the same weights on the same batch on the CPU and on
    the card, in f32 (the training dtype) and in float64. In f32 the
    loss parts agree to ~1e-7 but the updates do not: on the H100 at this
    width the card's f32 step departs from its own float64 step by 4.6e-4
    of max |update| per tensor (median; 7.5e-3 worst), the CPU's by 1.3e-6
    (1.0e-3 worst: a ReLU unit whose input lies within rounding of 0 takes
    either side, and its gradient jumps). In float64 the two devices agree
    to ~1e-14: the port computes the same step on both, and the f32 gap is
    the precision of cuDNN's f32 convolution algorithms."""
    dev = "cuda"
    runs = {(d, str(dt)[6:]): _one_step(model, params, priors, cfg, batch, d, dt)
            for d in ("cpu", dev) for dt in (torch.float32, torch.float64)}
    out = {"loss_parts": {f"{d}_{dt}": r[0] for (d, dt), r in runs.items()},
           "finite": all(np.isfinite(v) for r in runs.values() for v in r[0].values()),
           "f32_card_vs_cpu": _step_gap(runs[(dev, "float32")], runs[("cpu", "float32")]),
           "f64_card_vs_cpu": _step_gap(runs[(dev, "float64")], runs[("cpu", "float64")])}
    for d in ("cpu", dev):
        out[f"f32_vs_f64_{d}"] = _step_gap(runs[(d, "float32")], runs[(d, "float64")])
    model.to(torch.float32)
    return out


def train_full_width() -> dict:
    """Phase 12 (1): yolact_resnet50 at its width and batch, Flax's init
    from seed 0, fed by the port's DataLoader over SyntheticShapes at 550
    with the default augmentations."""
    from torch.profiler import ProfilerActivity, profile

    from amos_slam_tpu_torch.models import configs, data
    from amos_slam_tpu_torch.models.train import make_train_step

    cfg = configs.get_config(TRAIN_CFG)
    t = time.perf_counter()
    model, params = _init_weights(cfg)
    init_s = time.perf_counter() - t
    priors = torch.from_numpy(cfg.priors())
    ds = data.SyntheticShapes(size=cfg.img_size)

    # card vs CPU: one step at batch TRAIN_PARITY_B, same weights and batch
    rng = np.random.default_rng(0)
    few = [data.augment_sample(ds[i], rng) for i in range(TRAIN_PARITY_B)]
    t = time.perf_counter()
    parity = train_card_vs_cpu(
        model, params, priors, cfg,
        data.samples_to_gt_batch(few, cfg.img_size, cfg.max_objs, cfg.proto_shape, device="cpu"))
    parity["seconds"] = time.perf_counter() - t
    print(json.dumps({"train_card_vs_cpu": f"{TRAIN_CFG}, batch {TRAIN_PARITY_B}, one step",
                      **parity}))
    check(parity["finite"], f"train step not finite {parity['loss_parts']}")
    for key, (part_tol, upd_tol) in (("f32_card_vs_cpu", TRAIN_F32), ("f64_card_vs_cpu", TRAIN_F64)):
        gap = parity[key]
        check(max(gap["loss_part_rel_err"].values()) < part_tol,
              f"train {key} loss parts {gap['loss_part_rel_err']}")
        check(gap["update_err_over_max_worst"] < upd_tol,
              f"train {key} update {gap['update_err_over_max_worst']} ({gap['worst_tensor']})")

    # the run: TRAIN_WARMUP + TRAIN_STEPS steps at batch cfg.batch_size
    model.cuda()
    priors = priors.cuda()
    init, step = make_train_step(model, priors, cfg.lr, cfg.momentum, cfg.weight_decay)
    state = init({k: v.cuda() for k, v in params.items()})
    dl = data.DataLoader(ds, cfg.batch_size, cfg.img_size, cfg.max_objs, cfg.proto_shape,
                         data.AugmentConfig(), seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    try:
        t_run = None
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            if i == TRAIN_WARMUP:
                t_run = time.perf_counter()
            t0 = time.perf_counter()
            batch = next(dl)
            t1 = time.perf_counter()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            state, loss, aux = step(state, batch)
            e1.record()
            vals = torch.stack([loss, aux["loc"], aux["conf"], aux["mask"]]).tolist()
            t2 = time.perf_counter()
            rows.append({"wait_ms": (t1 - t0) * 1e3, "step_ms": (t2 - t1) * 1e3,
                         "event_ms": e0.elapsed_time(e1), "loss": vals})
            check(all(np.isfinite(v) for v in vals), f"train step {i} not finite: {vals}")
        run_s = time.perf_counter() - t_run
        peak = torch.cuda.max_memory_allocated()
        # one more step under the profiler
        batch = next(dl)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, loss, aux = step(state, batch)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
    finally:
        dl.stop()
    prof_out = device_profile(prof, 1)

    # the loader's host work per batch, alone on the host
    rng = np.random.default_rng(1)
    load_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        samples = [data.augment_sample(ds[int(i)], rng)
                   for i in rng.integers(0, len(ds), cfg.batch_size)]
        data.samples_to_gt_batch(samples, cfg.img_size, cfg.max_objs, cfg.proto_shape)
        torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t0) * 1e3)

    # conv FLOPs of one forward at this batch, x 3 for forward + backward
    flops = {}
    hooks = _conv_flop_hooks(model, lambda part, n: flops.__setitem__(part, flops.get(part, 0) + n))
    try:
        with torch.no_grad():
            torch.func.functional_call(model, state.params, (batch.images,))
    finally:
        for h in hooks:
            h.remove()
    train_flop = 3 * sum(flops.values())
    steady = rows[TRAIN_WARMUP:]
    step_ms = statistics.median(r["step_ms"] for r in steady)
    event_ms = statistics.median(r["event_ms"] for r in steady)
    bound_ms = train_flop / F32_PEAK_FLOP_S * 1e3
    result = {
        "train": f"{TRAIN_CFG}: backbone {cfg.backbone_layers}, {cfg.num_classes} classes, "
                 f"{cfg.img_size} px, batch {cfg.batch_size}, max_objs {cfg.max_objs}, "
                 f"proto {cfg.proto_shape}, f32 (TF32 off), SGD lr {cfg.lr} momentum "
                 f"{cfg.momentum} wd {cfg.weight_decay}; SyntheticShapes({cfg.img_size}) with "
                 "AugmentConfig() through DataLoader(seed=0)",
        "init_s_cpu": init_s, "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_STEPS,
        "step_ms_event_median": event_ms, "step_ms_wall_median": step_ms,
        "images_per_s_step": cfg.batch_size / step_ms * 1e3,
        "images_per_s_run": cfg.batch_size * TRAIN_STEPS / run_s,
        "loader_wait_ms_median": statistics.median(r["wait_ms"] for r in steady),
        "loader_host_ms_per_batch": load_ms,
        "profiled_step_wall_ms": prof_ms, **prof_out,
        "device_busy_share_unprofiled": prof_out["device_kernel_ms_per_frame"] / step_ms,
        "peak_memory_gib": peak / 2 ** 30,
        "conv_gflop_forward_by_part": {k: v / 1e9 for k, v in flops.items()},
        "conv_gflop_train_step": train_flop / 1e9,
        "bound_ms": bound_ms, "bound_by": "operations",
        "bound_peak": "67 TFLOP/s f32 outside the tensor cores (H100 SXM data sheet), convs only",
        "flop_share_of_peak": bound_ms / event_ms,
        "losses_first_last": [rows[0]["loss"], rows[-1]["loss"]],
        "step_ms_wall": [r["step_ms"] for r in rows],
        "card": timing.smi("name,power.limit"),
    }
    print(json.dumps(result))
    del state, model
    torch.cuda.empty_cache()
    return result


def train_proof() -> dict:
    """Phase 12 (2): tests/test_yolact_data.py::test_training_learns_synthetic_shapes's
    settings on the card, then the trained net's mAP on held-out shapes."""
    from amos_slam_tpu_torch.models import configs, data
    from amos_slam_tpu_torch.models.eval import evaluate_detections
    from amos_slam_tpu_torch.models.segmenter import flax_init_
    from amos_slam_tpu_torch.models.train import make_train_step
    from amos_slam_tpu_torch.models.yolact import assemble_masks, detect

    cfg = configs.yolact_tiny
    model = cfg.build(device="cpu")
    flax_init_(model, torch.Generator().manual_seed(0))
    model.cuda()
    priors = torch.from_numpy(cfg.priors()).cuda()
    dl = data.DataLoader(data.SyntheticShapes(n=64, size=cfg.img_size, seed=11), batch_size=4,
                         img_size=cfg.img_size, max_objs=cfg.max_objs, proto_hw=cfg.proto_shape,
                         seed=2, augment=data.AugmentConfig(expand=False, crop=False))
    init, step = make_train_step(model, priors, lr=cfg.lr)
    state = init(model.state_dict())
    losses = []
    t = time.perf_counter()
    try:
        for _ in range(PROOF_STEPS):
            state, loss, _ = step(state, next(dl))
            losses.append(float(loss))
    finally:
        dl.stop()
    run_s = time.perf_counter() - t
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-5:]))

    held = data.SyntheticShapes(n=PROOF_HELD_OUT, size=cfg.img_size, seed=99)
    samples = [held[i] for i in range(PROOF_HELD_OUT)]
    batch = data.samples_to_gt_batch(samples, cfg.img_size, cfg.max_objs, cfg.proto_shape)
    with torch.no_grad():
        loc, conf, coef, proto = torch.func.functional_call(model, state.params, (batch.images,))
    det = detect(loc, conf, coef, priors)
    masks = assemble_masks(proto, det).cpu().numpy()
    det = type(det)(*(x.cpu().numpy() for x in det))
    preds, gts = [], []
    for b in range(PROOF_HELD_OUT):
        v, g = det.valid[b], batch.labels[b].cpu().numpy() >= 0
        preds.append({"boxes": det.boxes[b][v], "scores": det.scores[b][v],
                      "classes": det.classes[b][v], "masks": masks[b][v]})
        gts.append({"boxes": batch.boxes[b].cpu().numpy()[g],
                    "classes": batch.labels[b].cpu().numpy()[g],
                    "masks": batch.masks[b].cpu().numpy()[g] > 0.5})
    result = {
        "train_proof": f"yolact_tiny, SyntheticShapes(n=64, seed=11), batch 4, "
                       f"AugmentConfig(expand=False, crop=False), {PROOF_STEPS} steps",
        "loss_first3_mean": first, "loss_last5_mean": last, "ratio": last / first,
        "losses": losses, "run_s": run_s,
        "held_out": f"SyntheticShapes(n={PROOF_HELD_OUT}, seed=99), a reading",
        "box": evaluate_detections(preds, gts),
        "mask": evaluate_detections(preds, gts, iou_type="mask"),
    }
    print(json.dumps(result))
    check(all(np.isfinite(losses)), "train proof loss not finite")
    check(last < PROOF_RATIO * first, f"train proof: last {last} not < {PROOF_RATIO} x {first}")
    return result


def train_phase() -> None:
    """Phase 12 (see the module docstring)."""
    train_full_width()
    train_proof()


class LagMeter:
    """Supervision lag of one System (in frames) or MultiStreamSLAM (in
    steps): when a read resolves, how many frames (steps) were dispatched
    after the call that dispatched it. Wraps the instance's reader submit
    and its resolve method; ``waits()`` reads the blocking waits of its
    reader and fetcher."""

    def __init__(self, obj, multistream: bool = False):
        self.obj, self.hist, self.last = obj, collections.Counter(), -1
        submit = obj._reader.submit

        def rec_submit(item):
            sup, payload = item
            rows = 1 if multistream or sup.dim() == 1 else sup.shape[0]
            self.last = payload[-1] + rows - 1
            return submit(item)

        obj._reader.submit = rec_submit
        if multistream:
            resolve = obj._resolve_step

            def rec_step(st, heavy, frame, sup):
                self.hist[self.last - frame] += 1
                return resolve(st, heavy, frame, sup)

            obj._resolve_step = rec_step
        else:
            resolve_done = obj._resolve_done

            def rec_done(res, frame_id, sup):
                rows = 1 if sup.ndim == 1 else sup.shape[0]
                self.hist[self.last - (frame_id + rows - 1)] += rows
                return resolve_done(res, frame_id, sup)

            obj._resolve_done = rec_done

    def waits(self) -> int:
        return self.obj._reader.waits + self.obj._fetcher.waits


@contextlib.contextmanager
def host_syncs(out: collections.Counter):
    """Count the host syncs that torch's sync debug mode warns about
    (blocking copies, .item(), nonzero, stream syncs; not CUDA-event
    waits), by the file:line that made them."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    for w in caught:
        if "synchronizing" in str(w.message):
            out[f"{os.path.relpath(w.filename)}:{w.lineno}"] += 1


def _pipeline_blocks(name, fmn, make, run, gate, n, unit, lag_max, profiled):
    """Phase 13's alternating blocks of one path. For each mode of
    PIPE_MODES (deterministic True / False), ``make(det)`` builds a fresh
    tracker and ``run(slam, a, b)`` drives it over frames (steps) a..b-1;
    each block is timed from its first call to the end of ``shutdown()`` /
    ``flush()`` (every read resolved, the device idle), then gated by
    ``gate(slam, block_launches)``. The second block of each mode then
    drives ``profiled`` more frames under torch.profiler with the sync debug
    mode on. Prints one JSON line; returns the FAST launches of the
    blocks."""
    from torch.profiler import ProfilerActivity, profile

    per = "_per_" + unit
    modes = {det: {"host_ms" + per: [], "waits_before_flush": [], "waits": [], "gates": []}
             for det in (True, False)}
    lags = {det: collections.Counter() for det in (True, False)}
    total = 0
    for det in PIPE_MODES:
        slam = make(det)
        meter = LagMeter(slam, multistream=unit == "step")
        done = slam.flush if unit == "step" else slam.shutdown
        torch.cuda.synchronize()
        fmn.launches = 0
        t = time.perf_counter()
        run(slam, 0, n)
        waits_run = meter.waits()
        done()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / n
        launches = fmn.launches
        total += launches
        m = modes[det]
        m["host_ms" + per].append(ms)
        m["waits_before_flush"].append(waits_run)
        m["waits"].append(meter.waits())
        lags[det].update(meter.hist)
        m["gates"].append(gate(slam, launches))
        if len(m["gates"]) == 2:   # the mode's second block: profile more frames
            syncs = collections.Counter()
            fmn.launches = 0
            with profile(activities=[ProfilerActivity.CUDA]) as prof, host_syncs(syncs):
                run(slam, n, n + profiled)
                done()
                torch.cuda.synchronize()
            total += fmn.launches
            p = device_profile(prof, profiled)
            m["launches" + per] = p["kernel_launches_per_frame"]
            m["device_ms" + per] = p["device_kernel_ms_per_frame"]
            m["busy_share"] = m["device_ms" + per] / statistics.mean(m["host_ms" + per])
            m["host_syncs" + per] = sum(syncs.values()) / profiled
            m["host_syncs_top"] = syncs.most_common(6)
        del slam, meter
    out = {}
    for det, m in modes.items():
        lag = lags[det]
        m["lag_hist_" + unit + "s"] = {int(k): lag[k] for k in sorted(lag)}
        m["lag_max"] = max(lag) if lag else None
        out["deterministic" if det else "pipelined"] = m
        check(not lag or max(lag) <= lag_max,
              f"{name}: supervision lag {max(lag)} > {lag_max} {unit}s")
    print(json.dumps({"pipeline_phase": name,
                      "blocks": ["deterministic" if d else "pipelined" for d in PIPE_MODES],
                      unit + "s_per_block": n, "profiled_" + unit + "s": profiled,
                      **out, "card": timing.smi("name,power.limit")}))
    return total


def _gate_system(name, poses):
    """Phase 7's gates on a block of a System path."""
    from amos_slam_tpu_torch.system import TrackingState

    def gate(slam, launches):
        est = np.asarray(slam.corrected_poses_np())
        n = est.shape[0]
        gt = np.asarray(poses[:n])
        check(bool(np.isfinite(est).all()), f"{name}: trajectory not finite")
        ate = evaluate.ate_rmse(evaluate.positions_from_cw(est), evaluate.positions_from_cw(gt))
        rpe_t, _ = evaluate.rpe(est, gt)
        inl = min(s["inliers"] for s in slam.stats[1:])
        kfs = [int(f) for f in slam.map.kf_frame_id[: slam.map.n_kfs]]
        check(ate < 0.03, f"{name}: ATE {ate:.4f} m")
        check(rpe_t < 0.01, f"{name}: RPE-t {rpe_t:.4f} m")
        check(inl > 50, f"{name}: min inliers {inl}")
        check(len(kfs) >= 3, f"{name}: {len(kfs)} keyframes")
        check(slam.state is TrackingState.OK, f"{name}: state {slam.state.name}")
        check(launches == n, f"{name}: {fmn_mod.NAME} launched {launches} times in {n} frames")
        return {"ate_m": ate, "rpe_t_m": rpe_t, "min_inliers": inl, "keyframe_frames": kfs}

    return gate


def pipeline_phase(fmn, seg, flag_seq, sys_seq, ms_seq) -> int:
    """Phase 13 (see the module docstring). Returns the FAST launches of its
    System blocks and of its multistream blocks."""
    from amos_slam_tpu_torch.config import DynamicsConfig
    from amos_slam_tpu_torch.parallel.multistream import MultiStreamSLAM
    from amos_slam_tpu_torch.system import System

    W = SEG_W
    stamps = [i / 30.0 for i in range(PIPE_FRAMES + W)]

    # the flagship: segmenter -> track_rgbd_chunk, dispatch_window 2
    g_f, d_f, _, poses_f = flag_seq
    rgb = g_f[..., None].expand(-1, -1, -1, 3)     # grey replicated, as bench.py

    def run_flagship(slam, a, b):
        masks = seg.person_mask_batch(rgb[a: a + W])
        for c in range(a, b, W):
            nxt = seg.person_mask_batch(rgb[c + W: c + 2 * W]) if c + W < b else None
            slam.track_rgbd_chunk(g_f[c: c + W], d_f[c: c + W], stamps[c: c + W],
                                  seg_masks=masks)
            masks = nxt

    flag = _pipeline_blocks(
        "flagship: Segmenter(img_size=400) -> System(SystemConfig(dynamics=DynamicsConfig("
        "dyn_stride=2))).track_rgbd_chunk, W 8, dispatch_window 2", fmn,
        lambda det: System(SystemConfig(dynamics=DynamicsConfig(dyn_stride=2),
                                        deterministic=det)),
        run_flagship, _gate_system("pipeline flagship", poses_f), PIPE_FRAMES, "frame",
        2 * W, W)

    # the per-frame path on the system cell, 16 frames of run-ahead
    g_s, d_s, poses_s = sys_seq

    def run_frames(slam, a, b):
        for i in range(a, b):
            slam.track_rgbd(g_s[i], d_s[i], stamps[i])

    frame = _pipeline_blocks(
        "per frame: System(SystemConfig(use_dynamics=False)).track_rgbd", fmn,
        lambda det: System(SystemConfig(use_dynamics=False, deterministic=det)),
        run_frames, _gate_system("pipeline per frame", poses_s), PIPE_FRAMES, "frame",
        16, W)

    # multistream, 2 steps of run-ahead; deterministic: flush() after each step
    poses_m, gray, depth = ms_seq
    g_m, d_m = _to_dev(gray[: 1 + PIPE_MS_STEPS + MS_PROFILED],
                       depth[: 1 + PIPE_MS_STEPS + MS_PROFILED])
    cfg = SystemConfig(use_dynamics=False)

    def make_ms(det):
        slam = MultiStreamSLAM(cfg, MS_STREAMS)
        slam.deterministic = det
        slam.est = []
        slam.initialize(g_m[0], d_m[0])
        return slam

    def run_ms(slam, a, b):
        for k in range(a + 1, b + 1):
            T, _ = slam.step(g_m[k], d_m[k])
            if slam.deterministic:
                slam.flush()
            slam.est.append(T)

    def gate_ms(slam, launches):
        est = torch.stack(slam.est).cpu().numpy().astype(np.float64)    # (steps, S, 4, 4)
        gt = evaluate.positions_from_cw(np.asarray(poses_m[1: 1 + est.shape[0]]))
        ates = [evaluate.ate_rmse(evaluate.positions_from_cw(est[:, s]), gt)
                for s in range(MS_STREAMS)]
        check(max(ates) < MS_ATE, f"pipeline multistream ATE {ates}")
        check(launches == est.shape[0],
              f"pipeline multistream: {launches} FAST launches in {est.shape[0]} steps")
        return {"ate_m": ates, "keyframes": [m.n_kfs for m in slam.maps]}

    ms = _pipeline_blocks(
        f"multistream: MultiStreamSLAM(SystemConfig(use_dynamics=False), {MS_STREAMS})", fmn,
        make_ms, run_ms, gate_ms, PIPE_MS_STEPS, "step", 2, MS_PROFILED)
    return flag + frame, ms


def _sync(devices) -> None:
    for d in dict.fromkeys(devices):
        torch.cuda.synchronize(d)


def _fast_kernels(prof) -> int:
    """FAST kernel launches (either route's kernel) that a profiler window
    recorded on the device."""
    return sum(e.count for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
               and any(name in e.key for name in fmn_mod.KERNEL_NAMES))


def mesh_multistream(fmn, seq) -> dict:
    """Phase 14 (1): MultiStreamSLAM over a stream mesh of G entries against
    one group, in turns (G = 1, G, G, G = 1) on phase 11's frames."""
    from torch.profiler import ProfilerActivity, profile

    from amos_slam_tpu_torch.parallel.multistream import MultiStreamSLAM, make_stream_mesh

    S, n = MS_STREAMS, MESH_STEPS
    poses, gray, depth = seq
    g_dev, d_dev = _to_dev(gray[: 1 + n + MS_PROFILED], depth[: 1 + n + MS_PROFILED])
    cfg = SystemConfig(use_dynamics=False)
    cards = torch.cuda.device_count()
    mesh = make_stream_mesh(mesh_devices())
    one = make_stream_mesh(["cuda:0"])
    G = len(mesh.devices)
    print(f"mesh: {G} entries {[str(d) for d in mesh.devices]} on {cards} card(s)")
    shapes = []

    def recording(imgs, extents=None):
        shapes.append(tuple(imgs.shape))
        return type(fmn).launch(fmn, imgs, extents)

    def run(m, profiled: bool) -> dict:
        t_run = time.perf_counter()
        slam = MultiStreamSLAM(cfg, S, m)
        sups, resolve = {}, slam._resolve_step

        def rec(st, heavy, frame, sup):
            sups[frame] = np.array(sup)
            return resolve(st, heavy, frame, sup)

        slam._resolve_step = rec
        _sync(m.devices)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fmn.launches = 0
        shapes.clear()
        fmn.launch = recording
        try:
            slam.initialize(g_dev[0], d_dev[0])
            est, step_ms = [slam.state.Tcw.clone()], []
            for k in range(1, 1 + n):
                t = time.perf_counter()
                T, _ = slam.step(g_dev[k], d_dev[k])
                _sync(m.devices)
                step_ms.append((time.perf_counter() - t) * 1e3)
                est.append(T.clone())
            slam.flush()
        finally:
            del fmn.launch
        out = {"groups": len(m.devices), "est": torch.stack(est), "sups": sups,
               "step_ms": step_ms, "launches": fmn.launches,
               "launch_shapes": sorted(set(shapes)),
               "peak_memory_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
               "state_devices": [str(st.Tcw.device) for st in slam._states],
               "kf_frames": [[int(f) for f in mp.kf_frame_id[: mp.n_kfs]] for mp in slam.maps]}
        if profiled:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for k in range(1 + n, 1 + n + MS_PROFILED):
                    slam.step(g_dev[k], d_dev[k])
                _sync(m.devices)
            out["profile"] = device_profile(prof, MS_PROFILED)
            out["fast_kernels_per_step"] = _fast_kernels(prof) / MS_PROFILED
        out["run_s"] = time.perf_counter() - t_run
        return out

    runs = [run(m, p) for m, p in ((one, False), (mesh, True), (mesh, False), (one, False))]
    ref, grouped = runs[0], runs[1]
    gt_pos = evaluate.positions_from_cw(np.asarray(poses[: 1 + n]))
    est = grouped["est"].cpu().numpy().astype(np.float64)
    ates = [evaluate.ate_rmse(evaluate.positions_from_cw(est[:, s]), gt_pos) for s in range(S)]
    pose_err = float((grouped["est"] - ref["est"]).abs().max())
    sup_equal = all((grouped["sups"][k] == ref["sups"][k]).all() for k in range(1, 1 + n))
    prof = grouped["profile"]
    result = {
        "mesh_multistream": f"MultiStreamSLAM(SystemConfig(use_dynamics=False), {S}, mesh) "
                            f"over {n} steps of phase 11's rooms, runs G = 1, {G}, {G}, 1",
        "mesh_devices": [str(d) for d in mesh.devices], "groups": G, "cards": cards,
        "step_ms_median": [statistics.median(r["step_ms"]) for r in runs],
        "step_ms": [r["step_ms"] for r in runs],
        "run_s": [r["run_s"] for r in runs],
        "fast_launches": [r["launches"] for r in runs],
        "fast_launch_shapes": [r["launch_shapes"] for r in runs],
        "fast_kernels_per_step_profiled": grouped["fast_kernels_per_step"],
        "launches_per_step": prof["kernel_launches_per_frame"],
        "device_ms_per_step": prof["device_kernel_ms_per_frame"],
        "peak_memory_gib": [r["peak_memory_gib"] for r in runs],
        "state_devices": grouped["state_devices"],
        "vs_one_group": {"sup_equal": sup_equal, "pose_max_abs_err": pose_err,
                         "keyframes_equal": grouped["kf_frames"] == ref["kf_frames"]},
        "ate_m": ates, "keyframe_frames": grouped["kf_frames"],
        "keyframes": [len(f) for f in grouped["kf_frames"]],
        "card": timing.smi("name,power.limit"),
    }
    print(json.dumps(result))
    L = cfg.orb.n_levels
    for r in runs:
        check(r["launches"] == r["groups"] * (n + 1),
              f"mesh G={r['groups']}: {r['launches']} FAST launches in {n} steps + initialize")
        check(r["launch_shapes"] == [(S // r["groups"] * L, 480, 640)],
              f"mesh G={r['groups']}: FAST launch shapes {r['launch_shapes']}")
    check(grouped["fast_kernels_per_step"] == G,
          f"mesh: {grouped['fast_kernels_per_step']} FAST kernels per profiled step, not {G}")
    check(grouped["state_devices"] == [str(d) for d in mesh.devices],
          f"mesh: group states on {grouped['state_devices']}")
    check(sup_equal, "mesh: sup rows differ from the one-group run")
    check(pose_err < 1e-5, f"mesh: poses {pose_err} from the one-group run")
    check(result["vs_one_group"]["keyframes_equal"], "mesh: keyframes differ from one group")
    check(min(result["keyframes"]) >= 2, f"mesh: keyframes per stream {result['keyframes']}")
    check(max(ates) < MS_ATE, f"mesh multistream ATE {ates}")
    result["launches_one_group"] = runs[0]["launches"] + runs[3]["launches"]
    result["launches_mesh"] = runs[1]["launches"] + runs[2]["launches"]
    return result


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _train_batch(cfg, seed: int):
    """One batch of ``cfg.batch_size`` augmented SyntheticShapes samples at
    ``cfg.img_size``, on the host."""
    from amos_slam_tpu_torch.models import data

    ds = data.SyntheticShapes(size=cfg.img_size)
    rng = np.random.default_rng(seed)
    samples = [data.augment_sample(ds[i], rng) for i in range(cfg.batch_size)]
    return data.samples_to_gt_batch(samples, cfg.img_size, cfg.max_objs, cfg.proto_shape,
                                    device="cpu")


def _init_weights(cfg):
    from amos_slam_tpu_torch.models.segmenter import flax_init_

    model = cfg.build(device="cpu")
    flax_init_(model, torch.Generator().manual_seed(0))
    return model, {k: v.clone() for k, v in model.state_dict().items()}


def nccl_one_rank() -> dict:
    """Phase 14 (2): make_data_parallel_step over a 1-rank NCCL group
    against make_train_step, yolact_resnet50 at its width and batch, the
    same batch for DP_STEPS steps. On one rank the two steps do the same
    arithmetic, but cuDNN's f32 backward at this width is not
    reproducible run to run, and a chain of steps amplifies that gap (3
    chained steps measured 2e-6 to 1.2e-5 in the loss parts on an H100).
    So each step of both starts from the same state, the data-parallel
    chain's, and is held to phase 12's one-step tolerances; the single
    step is run twice from that state to show the card's own gap."""
    import torch.distributed as dist

    from amos_slam_tpu_torch.models import configs
    from amos_slam_tpu_torch.models.train import make_train_step
    from amos_slam_tpu_torch.parallel.data_parallel import make_data_parallel_step

    def update_gap(a, b):
        """(max over tensors of the momentum's max error over its max
        |momentum|, the worst tensor), ``b`` the reference."""
        gap = {k: float((a.opt_state[k] - m).abs().max()) / max(float(m.abs().max()), 1e-300)
               for k, m in b.opt_state.items()}
        worst = max(gap, key=gap.get)
        return gap[worst], worst

    cfg = configs.get_config(TRAIN_CFG)
    model, params = _init_weights(cfg)
    model.cuda()
    priors = torch.from_numpy(cfg.priors()).cuda()
    b = _train_batch(cfg, 3)
    batch = type(b)(*(x.cuda() for x in b))
    params = {k: v.cuda() for k, v in params.items()}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        hp = (cfg.lr, cfg.momentum, cfg.weight_decay)
        init, step = make_train_step(model, priors, *hp)
        dp_init, dp_step = make_data_parallel_step(model, priors, None, *hp)
        state = dp_init(params)
        check(all(torch.equal(state.params[k], v) for k, v in init(params).params.items()),
              "nccl 1 rank: init changed the params")
        rows = []
        for i in range(DP_STEPS):
            ms, out = {}, {}
            for name, fn in (("single", step), ("data_parallel", dp_step),
                             ("single_again", step)):
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                out[name] = fn(state, batch)
                e1.record()
                torch.cuda.synchronize()
                ms[name] = e0.elapsed_time(e1)
            (ref, r_loss, r_aux), (got, d_loss, d_aux) = out["single"], out["data_parallel"]
            parts = {"loss": (float(d_loss), float(r_loss)),
                     **{k: (float(d_aux[k]), float(v)) for k, v in r_aux.items()}}
            upd, worst = update_gap(got, ref)
            rows.append({"step_ms": ms,
                         "loss_part_rel_err": {k: abs(a - v) / abs(v)
                                               for k, (a, v) in parts.items()},
                         "update_err_over_max_worst": upd, "worst_tensor": worst,
                         "single_vs_single_update_err_over_max":
                             update_gap(out["single_again"][0], ref)[0]})
            state = got
            del out, ref
    finally:
        dist.destroy_process_group()
    result = {"nccl_one_rank": f"{TRAIN_CFG}, {cfg.img_size} px, batch {cfg.batch_size}, f32, "
                               f"{DP_STEPS} steps on one batch, make_data_parallel_step over a "
                               "1-rank NCCL group vs make_train_step, each step from the "
                               "data-parallel chain's state",
              "nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
              "steps": rows, "card": timing.smi("name,power.limit")}
    print(json.dumps(result))
    part_tol, upd_tol = TRAIN_F32
    for i, r in enumerate(rows):
        check(max(r["loss_part_rel_err"].values()) < part_tol,
              f"nccl 1 rank step {i}: loss parts {r['loss_part_rel_err']}")
        check(r["update_err_over_max_worst"] < upd_tol,
              f"nccl 1 rank step {i}: update {r['update_err_over_max_worst']} "
              f"({r['worst_tensor']})")
    del model, state, got, params
    torch.cuda.empty_cache()
    return result


def _dp_rank(rank: int, addr: str, weights: dict, arrays: tuple, out_dir: str) -> None:
    """One rank of phase 14 (3) on cuda:0: DP_STEPS float64 steps of
    make_data_parallel_step on its half of the batch, results to out_dir."""
    import datetime

    import torch.distributed as dist

    from amos_slam_tpu_torch.models import configs
    from amos_slam_tpu_torch.models.train import GTBatch
    from amos_slam_tpu_torch.parallel.data_parallel import make_data_parallel_step

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=addr, world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        cfg = configs.yolact_tiny
        model = cfg.build(device="cpu").to("cuda", torch.float64)
        priors = torch.from_numpy(cfg.priors()).cuda()
        init, step = make_data_parallel_step(model, priors, None, cfg.lr, cfg.momentum,
                                             cfg.weight_decay)
        half = slice(rank * cfg.batch_size // 2, (rank + 1) * cfg.batch_size // 2)
        b = GTBatch(*(torch.from_numpy(a[half]).cuda() for a in arrays))
        b = GTBatch(b.images.double(), b.boxes.double(), b.labels, b.masks.double())
        state = init({k: torch.from_numpy(v).cuda() for k, v in weights.items()})
        losses = []
        for _ in range(DP_STEPS):
            state, loss, aux = step(state, b)
            losses.append([float(loss)] + [float(aux[k]) for k in ("loc", "conf", "mask")])
        torch.save({"losses": losses,
                    "params": {k: v.cpu() for k, v in state.params.items()},
                    "momentum": {k: v.cpu() for k, v in state.opt_state.items()}},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def two_ranks_one_card() -> dict:
    """Phase 14 (3): a 2-rank gloo group with both ranks on cuda:0 (NCCL
    refuses a card shared by two ranks; spawned, joined with a timeout)
    against the single-process float64 step on the full batch: yolact_tiny
    at 128 px, batch 8."""
    import tempfile

    from amos_slam_tpu_torch.models import configs
    from amos_slam_tpu_torch.models.train import GTBatch, make_train_step

    cfg = configs.yolact_tiny
    _, params = _init_weights(cfg)
    weights = {k: v.double().numpy() for k, v in params.items()}
    b = _train_batch(cfg, 4)
    arrays = tuple(x.numpy() for x in b)
    os.makedirs("build", exist_ok=True)
    out_dir = tempfile.mkdtemp(dir="build")
    ctx = torch.multiprocessing.get_context("spawn")
    addr = f"tcp://localhost:{_free_port()}"
    t = time.perf_counter()
    procs = [ctx.Process(target=_dp_rank, args=(r, addr, weights, arrays, out_dir))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(DP_JOIN_S)
    stuck = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    wall_s = time.perf_counter() - t
    check(not stuck, f"2 ranks on one card: ranks {stuck} still running after "
                     f"{DP_JOIN_S} s")
    check([p.exitcode for p in procs] == [0, 0],
          f"2 ranks on one card: exit codes {[p.exitcode for p in procs]}")
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(2)]

    model = cfg.build(device="cpu").to("cuda", torch.float64)
    init, step = make_train_step(model, torch.from_numpy(cfg.priors()).cuda(), cfg.lr,
                                 cfg.momentum, cfg.weight_decay)
    full = GTBatch(b.images.cuda().double(), b.boxes.cuda().double(), b.labels.cuda(),
                   b.masks.cuda().double())
    state = init({k: torch.from_numpy(v).cuda() for k, v in weights.items()})
    p0 = {k: v.clone() for k, v in state.params.items()}
    losses = []
    for _ in range(DP_STEPS):
        state, loss, aux = step(state, full)
        losses.append([float(loss)] + [float(aux[k]) for k in ("loc", "conf", "mask")])
    loss_err = max(abs(a - r) / abs(r) for a, r in zip(sum(ranks[0]["losses"], []),
                                                       sum(losses, [])))
    param_err = max(float((ranks[0]["params"][k] - p.cpu()).abs().max())
                    / max(float((p - p0[k]).abs().max()), 1e-300)
                    for k, p in state.params.items())
    mom_err = max(float((ranks[0]["momentum"][k] - m.cpu()).abs().max())
                  / max(float(m.abs().max()), 1e-300) for k, m in state.opt_state.items())
    replicated = all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
                     for k in ranks[0]["params"])
    result = {"two_ranks_one_card": f"yolact_tiny, {cfg.img_size} px, batch {cfg.batch_size} "
                                    f"(4 per rank), float64, {DP_STEPS} steps, gloo, "
                                    "both ranks on cuda:0",
              "wall_s_spawn_to_join": wall_s,
              "loss_part_rel_err_max": loss_err, "param_err_over_change_max": param_err,
              "momentum_err_over_max": mom_err, "params_equal_across_ranks": replicated,
              "losses": losses, "card": timing.smi("name,power.limit")}
    print(json.dumps(result))
    check(replicated, "2 ranks on one card: params differ between the ranks")
    for name, err in (("loss parts", loss_err), ("params", param_err), ("momentum", mom_err)):
        check(err < DP_F64_TOL, f"2 ranks on one card: {name} {err} from the single step")
    return result


def multidevice_phase(fmn, ms_seq) -> tuple:
    """Phase 14 (see the module docstring). Returns the FAST launches of
    its one-group runs and of its runs over the mesh."""
    mesh = mesh_multistream(fmn, ms_seq)
    nccl_one_rank()
    two_ranks_one_card()
    return mesh["launches_one_group"], mesh["launches_mesh"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    fmn = fmn_mod.fast_margin_nms

    # 1. build
    t0 = time.perf_counter()
    build.build([fmn_mod.NAME, tfk.PROBE])   # the kernels and the issue-rate probe, in parallel
    print(f"build: {fmn_mod.NAME}, {tfk.PROBE} in {time.perf_counter() - t0:.2f} s")
    print(build.log_path(fmn_mod.NAME).read_text().strip())

    cfg = SystemConfig()
    cam = cfg.camera
    planes = synthetic.default_room(seed=1)
    poses_gt = synthetic.orbit_trajectory(N_FRAMES, radius=0.15, advance=0.3)
    frames = [synthetic.render(planes, T) for T in poses_gt]

    # 2. kernels against their plain versions, on the card
    sizes = cfg.orb.level_sizes(cam.width, cam.height)
    gray0 = torch.from_numpy(frames[0][0]).to(dev)
    pyr = pyramid.build_pyramid(gray0, sizes)                  # (8, 480, 640)
    levels = torch.tensor(sizes, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(0)
    rand = torch.from_numpy(
        np.round(rng.uniform(-50, 255, (3, 70, 128))).astype(np.float32)).to(dev)
    ragged = torch.tensor([[70, 128], [37, 65], [1, 1]], dtype=torch.int32, device=dev)
    # 1,575 active tiles, more than two waves (the persistent kernel),
    # ragged, with regions of -0.0 beside +0.0 and negative values
    wide = torch.from_numpy(
        np.round(rng.uniform(-50, 255, (64, 256, 384))).astype(np.float32)).to(dev)
    wide[0, 10:40, 10:90] = -0.0
    wide[1, 20:60, 30:99] = 0.0
    wide_ext = torch.tensor([[256 - 3 * i, 384 - 5 * i] for i in range(64)],
                            dtype=torch.int32, device=dev)
    cases = {
        "pyramid_level_extents": (pyr, levels),
        "pyramid_whole_canvas": (pyr, None),
        "random_3x70x128_ragged_extents": (rand, ragged),
        "single_1x480x640": (gray0[None].contiguous(), None),
        "random_64x256x384_ragged_negative_zero": (wide, wide_ext),
    }
    max_err = 0.0
    for name, (x, ext) in cases.items():
        out_k = fmn(x, ext)
        out_p = fmn_mod.fast_margin_nms_plain(x, ext)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        exact = bool(torch.equal(out_k, out_p))
        n_active = fmn_mod.tile_table(
            [(x.shape[1], x.shape[2])] * x.shape[0] if ext is None else ext.tolist(),
            x.shape[1], x.shape[2])[1]
        print(f"kernel {fmn_mod.NAME} {name} {tuple(x.shape)}: tolerance exact, equal={exact} "
              f"max_abs_err={err} nonzero={int((out_k > 0).sum())} "
              f"kernel={fmn.route_of(n_active, dev)}")
        check(exact, f"{fmn_mod.NAME} differs from its plain version on {name}")
        max_err = max(max_err, err)

    # timing on the main path's input, warm in L2 as in the pipeline
    smi_query = "clocks.sm,power.draw,power.limit"
    smi_before = timing.smi(smi_query)
    ms, runs_ms, held = timing.loop_ms(lambda: fmn(pyr, levels), launches=200)
    smi_after = timing.smi(smi_query)
    smi_load = timing.smi_under_load(smi_query, lambda: fmn(pyr, levels))
    plain_ms, _, _ = timing.loop_ms(
        lambda: fmn_mod.fast_margin_nms_plain(pyr, levels), launches=10, hold=False)
    read_px = sum(h * w for h, w in sizes)
    ops = fmn_mod.OPS_PER_PIXEL * read_px
    bound_ms, bound_by = timing.bound(4 * read_px, 4 * pyr.numel(), ops)
    mhz = timing.sm_mhz(smi_load + [smi_after])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    # issue rates of the reductions' instructions, for each row's issue floor
    probe = tfk.pipe_rates(mhz)
    print(json.dumps({"pipe_probe": probe, "card": timing.smi("name,power.limit")}))
    rates = probe["lanes_per_clock_per_sm"]

    def kernel_and_floor(hw, H, W):
        """The kernel the wrapper picks for these extents, and its issue floor."""
        kernel = fmn.route_of(fmn_mod.tile_table(hw, H, W)[1], dev)
        return kernel, tfk.issue_floor_ms(kernel, fmn_mod.margins_computed(hw, H, W),
                                          rates, mhz, n_sm)

    kernel, floor_ms = kernel_and_floor(sizes, *pyr.shape[1:])
    print(json.dumps({
        "timing": fmn_mod.NAME, "shape": list(pyr.shape), "extents": "level sizes",
        "method": "median of 5 runs x 200 launches between CUDA events / 200, "
                  "stream held by a spin kernel while the host enqueues",
        "ms": ms, "runs_ms": runs_ms, "runs_queue_held": held, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "kernel": kernel,
        "issue_floor_ms": floor_ms,
        "read_px": read_px, "write_px": pyr.numel(), "ops": ops,
        "ops_ms_one_per_lane_per_clock":
            None if mhz is None else timing.lane_ms(ops, mhz, n_sm),
        "sm_mhz_max_sampled": mhz, "sms": n_sm,
        "smi_clocks_sm_power_draw_limit_before": smi_before,
        "smi_clocks_sm_power_draw_limit_after": smi_after,
        "smi_under_load": smi_load,
    }))

    # the stereo path's canvas: KITTI 00-02, 1241 wide (not a multiple of 4)
    from amos_slam_tpu_torch.io.kitti import kitti_camera_config

    kcam = kitti_camera_config(0)
    ksizes = cfg.orb.level_sizes(kcam.width, kcam.height)
    kgray = synthetic.render(planes, poses_gt[0], fx=kcam.fx, fy=kcam.fy, cx=kcam.cx,
                             cy=kcam.cy, width=kcam.width, height=kcam.height)[0]
    kpyr = pyramid.build_pyramid(torch.from_numpy(kgray).to(dev), ksizes)   # (8, 376, 1241)
    klevels = torch.tensor(ksizes, dtype=torch.int32, device=dev)
    k_out, k_plain = fmn(kpyr, klevels), fmn_mod.fast_margin_nms_plain(kpyr, klevels)
    torch.cuda.synchronize()
    k_err = float((k_out - k_plain).abs().max())
    k_exact = bool(torch.equal(k_out, k_plain))
    print(f"kernel {fmn_mod.NAME} kitti_stereo_level_extents {tuple(kpyr.shape)}: tolerance "
          f"exact, equal={k_exact} max_abs_err={k_err} nonzero={int((k_out > 0).sum())}")
    check(k_exact, f"{fmn_mod.NAME} differs from its plain version at the KITTI shape")
    max_err = max(max_err, k_err)
    k_ms, k_runs, k_held = timing.loop_ms(lambda: fmn(kpyr, klevels), launches=200)
    k_plain_ms, _, _ = timing.loop_ms(
        lambda: fmn_mod.fast_margin_nms_plain(kpyr, klevels), launches=10, hold=False)
    k_read = sum(h * w for h, w in ksizes)
    k_bound, k_by = timing.bound(4 * k_read, 4 * kpyr.numel(), fmn_mod.OPS_PER_PIXEL * k_read)
    k_kernel, k_floor = kernel_and_floor(ksizes, *kpyr.shape[1:])
    print(json.dumps({
        "timing": fmn_mod.NAME, "shape": list(kpyr.shape), "extents": "KITTI level sizes",
        "ms": k_ms, "runs_ms": k_runs, "runs_queue_held": k_held, "plain_ms": k_plain_ms,
        "bound_ms": k_bound, "bound_by": k_by, "kernel": k_kernel, "issue_floor_ms": k_floor,
        "read_px": k_read, "write_px": kpyr.numel(),
        "card": timing.smi("name,power.limit"),
    }))

    # the multistream paths' launches: 8 streams, and a group of phase 14's mesh
    ms_rows = multistream_kernel(fmn, sizes, pyr, levels, kernel_and_floor)
    max_err = max([max_err] + [err for err, _ in ms_rows.values()])

    # 3. the main path
    odo = RGBDOdometry(cfg)
    fmn.launches = 0
    frame_ms = []
    for i in range(N_FRAMES):
        gray, depth = frames[i]
        t1 = time.perf_counter()
        odo.track(gray, depth, timestamp=i / 30.0)
        frame_ms.append((time.perf_counter() - t1) * 1e3)
    launches = fmn.launches
    check(launches == N_FRAMES, f"{fmn_mod.NAME} launched {launches} times in "
          f"{N_FRAMES} frames")

    est = np.asarray(odo.poses_cw)
    gt = np.asarray(poses_gt)
    check(bool(np.isfinite(est).all()) and est.shape == (N_FRAMES, 4, 4),
          f"trajectory not finite or of shape {est.shape}")
    ate = evaluate.ate_rmse(evaluate.positions_from_cw(est),
                            evaluate.positions_from_cw(gt))
    rpe_t, rpe_r = evaluate.rpe(est, gt)
    inliers = [s["inliers"] for s in odo.stats[1:]]
    print(json.dumps({
        "main_path": "RGBDOdometry 640x480", "frames": N_FRAMES,
        "ate_m": ate, "rpe_t_m": rpe_t, "rpe_r_rad": rpe_r,
        "min_inliers": min(inliers),
        "frame_ms_median_after_5": statistics.median(frame_ms[5:]),
        "frame_ms_first": frame_ms[0], "kernel_launches": launches,
    }))
    check(min(inliers) > 50, f"min inliers {min(inliers)}")
    check(ate < 0.02, f"ATE {ate:.4f} m")
    check(rpe_t < 0.01, f"RPE-t {rpe_t:.4f} m")

    # 4. where the device time goes: a fresh odometry, frames 3-7 profiled
    from torch.profiler import ProfilerActivity, profile

    odo = RGBDOdometry(cfg)
    for i in range(3):
        odo.track(*frames[i], timestamp=i / 30.0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t2 = time.perf_counter()
        for i in range(3, 8):
            odo.track(*frames[i], timestamp=i / 30.0)
        wall_ms = (time.perf_counter() - t2) * 1e3
    prof_out = device_profile(prof, 5)
    frame_med = statistics.median(frame_ms[5:])
    print(json.dumps({
        "profile_frames": 5, "profiled_wall_ms_per_frame": wall_ms / 5,
        "device_busy_share_unprofiled": prof_out["device_kernel_ms_per_frame"] / frame_med,
        **prof_out,
    }))

    phase_s = {"1-4": time.perf_counter() - t0}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    # 5. the system path
    sys_launches, sys_seq = timed("5 system", system_phase, fmn)
    # 6. the system path with the geometric dynamic stage
    seq = timed("6 render", mover_sequence, DYN_FRAMES + DYN_W)
    dyn_launches = timed("6 dynamics", dynamics_phase, fmn, seq)
    # 7. the flagship: the segmenter feeding the system with dynamics
    flag_launches, seg = timed("7 flagship", flagship_phase, fmn, seq)
    # 8. loop closing and relocalization on the flagship
    loop_launches = timed("8 loop", loop_phase, fmn, seg)
    # 9. stereo at KITTI's canvas; 10. monocular at 640x480
    stereo_launches = timed("9 stereo", stereo_phase, fmn)
    mono_launches = timed("10 mono", mono_phase, fmn)
    # 11. multistream: 8 streams in one vmapped step
    ms_seq = timed("11 render", ms_frames)
    ms_launches = timed("11 multistream", multistream_phase, fmn, ms_seq)
    # 12. YOLACT training at yolact_resnet50's width, and the tiny proof
    timed("12 train", train_phase)
    # 13. pipelined host supervision against deterministic, in alternating blocks
    pipe_launches, pipe_ms_launches = timed("13 pipeline", pipeline_phase, fmn, seg, seq,
                                            sys_seq, ms_seq)
    # 14. the multi-device paths: a stream mesh, a 1-rank NCCL group, 2 ranks on one card
    mesh_one, mesh_groups = timed("14 multi-device", multidevice_phase, fmn, ms_seq)
    del seq, seg, sys_seq, ms_seq
    print(json.dumps({"phase_wall_s": phase_s, "total_s": time.perf_counter() - t0}))
    print(json.dumps({"fast_kernel_launches": {"odometry": launches, "system": sys_launches,
                                               "dynamics": dyn_launches,
                                               "flagship": flag_launches,
                                               "loop": loop_launches,
                                               "stereo": stereo_launches,
                                               "mono": mono_launches,
                                               "multistream": ms_launches,
                                               "pipeline": pipe_launches,
                                               "pipeline_multistream": pipe_ms_launches,
                                               "mesh_one_group": mesh_one,
                                               "mesh_groups": mesh_groups}}))

    group = MS_STREAMS // len(mesh_devices())
    print(json.dumps({"kernels": [{
        "name": fmn_mod.NAME, "route": "cuda",
        "source": "amos_slam_tpu_torch/csrc/fast_margin_nms.cu",
        "replaces": "amos_slam_tpu/ops/pallas/fast_pallas.py:110",
        "launches": (launches + sys_launches + dyn_launches + flag_launches + loop_launches
                     + stereo_launches + mono_launches + pipe_launches),
        "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "kernel": kernel, "issue_floor_ms": floor_ms,
        "library_ms": None,
    }, {
        "name": fmn_mod.NAME + "_batched", "route": "cuda",
        "source": "amos_slam_tpu_torch/csrc/fast_margin_nms.cu",
        "replaces": "amos_slam_tpu/ops/pallas/fast_pallas.py:128",
        "launches": ms_launches + pipe_ms_launches + mesh_one,
        "max_abs_err": ms_rows[MS_STREAMS][0], **ms_rows[MS_STREAMS][1],
        "library_ms": None,
    }, {
        "name": fmn_mod.NAME + "_batched_mesh_group", "route": "cuda",
        "source": "amos_slam_tpu_torch/csrc/fast_margin_nms.cu",
        "replaces": "amos_slam_tpu/ops/pallas/fast_pallas.py:128",
        "launches": mesh_groups,
        "max_abs_err": ms_rows[group][0], **ms_rows[group][1],
        "library_ms": None,
    }]}))
    print(timing.smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

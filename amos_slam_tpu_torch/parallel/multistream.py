"""Multi-stream batched SLAM on one card (port of parallel/multistream.py).

The reference's concurrency is 4-5 pthreads in one address space; the
analogue for scale-out is a leading stream axis: S independent camera
streams batched with ``torch.func.vmap``. Per-stream SLAM is embarrassingly
parallel, so one batched program serves every stream: each step is
``vmap`` of the fused frame program (extraction + motion-model + local-map
tracking + pose/velocity update, frontend/tracking.py) over the streams,
with the FAST kernel launched once for all S pyramids (its vmap rule,
ops/kernels/fast_margin_nms.py). Per-stream map views are batched
``LocalView`` tuples (use :func:`empty_views` for pure-odometry streams).

The JAX package shards the stream axis over a device mesh; the port targets
one card, where the stream axis is a batch dimension: a "mesh" here is the
one device the streams live on, and more than one device raises.

Supervision is pipelined, as the JAX class's: each step's (S, 3) count
rows go home through ``System``'s ``_SupervisionReader`` (a non_blocking
copy and an event on the card), and :meth:`MultiStreamSLAM.step` resolves
the reads that have landed, waiting only while more than 2 steps are in
flight: its keyframe decisions trail dispatch by at most 2 steps, and it
returns the (S, 3) rows of the newest resolved step.
:meth:`~MultiStreamSLAM.flush` resolves them all.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..frontend.features import FrameFeatures, ORBPipeline
from ..frontend.tracking import fused_frame_step, index_tree, stack_tree
from ..slam_map.slam_map import LocalView, SlamMap


class StreamState(NamedTuple):
    """Per-stream tracker state, batch-first (S, ...)."""

    feats: FrameFeatures
    Tcw: torch.Tensor        # (S, 4, 4)
    velocity: torch.Tensor   # (S, 4, 4)


class StreamMesh(NamedTuple):
    """The devices the stream axis lies on, and the axis' name."""

    devices: tuple
    axis: str


def make_stream_mesh(devices=None, axis: str = "stream") -> StreamMesh:
    """A stream mesh over ``devices`` (default: every CUDA card)."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return StreamMesh(tuple(torch.device(d) for d in devices), axis)


def _one_device(mesh: StreamMesh) -> torch.device:
    if len(mesh.devices) != 1:
        raise ValueError(
            f"amos_slam_tpu_torch: the multistream port targets one card; a mesh "
            f"of {len(mesh.devices)} devices is not supported (batch the streams "
            f"on one device instead)")
    return resolve_device(mesh.devices[0])


def empty_views(S: int, V: int, *, device=None) -> LocalView:
    """Batched empty local views (odometry-only streams)."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return LocalView(
        ids=torch.full((S, V), -1, dtype=torch.int32, device=dev),
        pos=torch.zeros((S, V, 3), **f32),
        desc=torch.zeros((S, V, 256), dtype=torch.int8, device=dev),
        normal=torch.zeros((S, V, 3), **f32),
        min_dist=torch.zeros((S, V), **f32),
        max_dist=torch.full((S, V), 1e9, **f32),
        valid=torch.zeros((S, V), dtype=torch.bool, device=dev),
    )


def init_state(pipeline: ORBPipeline, images, depths) -> StreamState:
    """Bootstrap all S streams from their first frames: the vmapped
    extraction, one FAST launch for every stream.

    Tcw and velocity are distinct storage: the JAX package's step donates
    its state, and one buffer behind two leaves broke that on its chip; a
    caller here may likewise update either in place."""
    feats = torch.func.vmap(lambda im, d: pipeline.extract(im, depth_image=d))(
        images, depths
    )
    S = images.shape[0]
    eye = torch.eye(4, dtype=torch.float32, device=pipeline.device)
    return StreamState(
        feats=feats, Tcw=eye.repeat(S, 1, 1), velocity=eye.repeat(S, 1, 1)
    )


def multistream_step(
    pipeline: ORBPipeline,
    state: StreamState,
    images: torch.Tensor,   # (S, H, W)
    depths: torch.Tensor,   # (S, H, W)
    views: LocalView,       # batched (S, ...) local views
    mm_radius: torch.Tensor,
    map_radius: torch.Tensor,
    min_lm: int = 30,
):
    """One fused tracking step for every stream: ``torch.func.vmap`` of
    :func:`~..frontend.tracking.fused_frame_step`, with no host read.

    Returns (new_state, sup (S, 3) int32 count rows, sup_heavy (S, 3N)
    keyframe-insertion payload rows). Only `sup` needs a host read per
    step; heavy rows are read only for the streams that insert a keyframe
    (see MultiStreamSLAM)."""
    res = torch.func.vmap(
        lambda im, d, last, T, vel, vw: fused_frame_step(
            pipeline, im, d, last, T, vel, vw, mm_radius, map_radius,
            min_lm=min_lm,
        )
    )(images, depths, state.feats, state.Tcw, state.velocity, views)
    new_state = StreamState(
        feats=res.feats, Tcw=res.Tcw, velocity=res.velocity
    )
    return new_state, res.sup, res.sup_heavy


def shard_step(pipeline: ORBPipeline, mesh: Optional[StreamMesh] = None,
               axis: str = "stream", min_lm: int = 30):
    """The multistream step over the mesh's stream axis. On one card the
    stream axis is a batch dimension, so this is the batched step itself;
    a mesh of more than one device raises (the port targets one card)."""
    if mesh is not None:
        _one_device(mesh)

    def step(state, images, depths, views, mm_radius, map_radius):
        return multistream_step(
            pipeline, state, images, depths, views, mm_radius, map_radius,
            min_lm=min_lm,
        )

    return step


class MultiStreamSLAM:
    """S concurrent RGB-D SLAM streams with LIVE per-stream maps.

    The device half is ONE batched program per step (all S fused frame
    steps vmapped over the stream axis). The host half mirrors System's
    keyframe supervision per stream, pipelined 1-2 steps behind dispatch as
    System's reader is: when a step's (S, 3) count rows land, the streams
    that trigger insertion have the (3N,) payload rows of THAT step (its
    state is kept until then) read in one transfer through the fetcher,
    the stream's own SlamMap inserts the keyframe (landmark creation from
    close depth, covisibility, spanning tree -- SlamMap.insert_keyframe), new points
    triangulate, local BA runs, and the stacked LocalViews refresh -- the
    reference's LocalMapping cycle (src/LocalMapping.cc:73-175) per stream;
    the triangulation tables of every inserting stream come home in one
    wait. Streams therefore track against growing maps: S-stream SLAM, not
    S-stream odometry. As in the JAX package, there is no loop closer.

    ``device`` defaults to the CUDA card (or the mesh's one device) and
    raises without one; pass ``device="cpu"`` for the plain path.
    """

    def __init__(self, cfg, S: int, mesh: Optional[StreamMesh] = None,
                 run_ba: bool = True, *, device=None):
        from ..system import _AsyncFetcher, _SupervisionReader

        self.cfg = cfg
        self.S = S
        self.run_ba = run_ba
        if mesh is None:
            self.device = resolve_device(device)
            mesh = make_stream_mesh([self.device])
        else:
            self.device = _one_device(mesh)
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device {device} is not the mesh's {self.device}")
        self.mesh = mesh
        self.pipeline = ORBPipeline(cfg.orb, cfg.camera, self.device)
        self.maps = [SlamMap(cfg, self.pipeline.cam, self.device) for _ in range(S)]
        self.ref_kf = [0] * S
        self.last_kf_frame = [-999] * S
        self.last_kf_inliers = [0] * S
        self.frame = -1
        self.state: Optional[StreamState] = None
        self.views: Optional[LocalView] = None
        tc = cfg.tracking
        f32 = dict(dtype=torch.float32, device=self.device)
        self._r_mm = torch.tensor(tc.match_radius_motion, **f32)
        self._r_map = torch.tensor(tc.match_radius_map * 2.0, **f32)
        self._step = shard_step(
            self.pipeline, self.mesh, min_lm=tc.min_inliers_local_map
        )
        # pipelined supervision (System's reader and fetcher)
        self._reader = _SupervisionReader()
        self._fetcher = _AsyncFetcher()
        self.last_sup = np.zeros((S, 3), np.int64)

    def _upload(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device, torch.float32)

    # -- lifecycle -----------------------------------------------------
    def initialize(self, images, depths):
        """Bootstrap every stream: first frame becomes its keyframe 0 with
        landmarks from valid close depth (StereoInitialization semantics,
        src/Tracking.cc:1343, per stream)."""
        self.state = init_state(self.pipeline, self._upload(images), self._upload(depths))
        N = self.cfg.orb.max_kpts
        none = np.full(N, -1, np.int64)
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        for s in range(self.S):
            feats_s = index_tree(self.state.feats, s)
            self.ref_kf[s] = self.maps[s].insert_keyframe(feats_s, eye, none, 0)
            self.last_kf_frame[s] = 0
            self.last_kf_inliers[s] = 1
        self.frame = 0
        self._refresh_views()

    def _refresh_views(self):
        self.views = stack_tree([
            self.maps[s].local_view(self.ref_kf[s]) for s in range(self.S)
        ])

    # -- per-frame step ------------------------------------------------
    def step(self, images, depths):
        """Track one frame on every stream; returns ((S, 4, 4) poses on the
        device, (S, 3) count rows of the most recently RESOLVED step --
        supervision trails dispatch by at most 2 steps, see the class
        docstring)."""
        self.frame += 1
        st, sup, heavy = self._step(
            self.state, self._upload(images), self._upload(depths),
            self.views, self._r_mm, self._r_map,
        )
        self.state = st
        self._reader.submit((sup, (st, heavy, self.frame)))
        self._reader.wait_until(2)
        for done in self._reader.drain():
            self._resolve_step(*done)
        return self.state.Tcw, self.last_sup

    def flush(self):
        """Resolve every supervision read in flight (call before reading
        the maps or trajectories at the end of a run)."""
        for done in self._reader.flush():
            self._resolve_step(*done)
        self._fetcher.flush()

    def _resolve_step(self, st, heavy, frame, sup_np):
        self.last_sup = sup_np
        tc = self.cfg.tracking
        need = []
        for s in range(self.S):
            n_mm, n_lm, n_close = (int(v) for v in sup_np[s])
            gap = frame - self.last_kf_frame[s]
            if n_lm >= tc.min_inliers_local_map:
                if (
                    gap >= 30
                    or (gap >= 3
                        and n_lm < 0.75 * max(self.last_kf_inliers[s], 1))
                    or n_lm < 50
                ):
                    need.append((s, n_lm, True))
            elif n_mm >= 10 and gap >= 3 and n_close >= 100:
                need.append((s, max(n_mm, 1), False))
        if need:
            self._insert_keyframes(need, heavy, st, frame)

    def _insert_keyframes(self, need, heavy, st, frame):
        """Insert the keyframes of one resolved step (``need``: (stream,
        inliers, matched) rows) and run their maintenance; the views
        refresh after every stream's. The payload rows come home in one
        read and each stream's triangulation table through the fetcher,
        flushed here: the next step tracks against the new views, as the
        JAX class's does (it reads both synchronously)."""
        rows = torch.stack([heavy[s] for (s, _, _) in need])
        self._fetcher.submit(rows, lambda host: self._insert_rows(need, host, st, frame))
        self._fetcher.flush()
        self._refresh_views()

    def _insert_rows(self, need, rows, st, frame):
        N = self.cfg.orb.max_kpts
        for (s, inl, matched), hv in zip(need, rows):
            feats_s = index_tree(st.feats, s)
            kp = hv[:N].astype(np.int64) if matched else np.full(
                N, -1, np.int64
            )
            valid = hv[N: 2 * N] > 0
            close = hv[2 * N:] > 0
            m = self.maps[s]
            if m.n_kfs >= m.K - 2:
                if m.kf_alive[: m.n_kfs].all():
                    m.grow_keyframes()
                else:
                    lut = m.compact_keyframes()
                    if lut is not None:
                        self.ref_kf[s] = (
                            int(lut[self.ref_kf[s]])
                            if lut[self.ref_kf[s]] >= 0 else m.n_kfs - 1
                        )
            self.ref_kf[s] = m.insert_keyframe(
                feats_s, st.Tcw[s], kp, frame,
                valid_close=(valid, close),
            )
            self.last_kf_frame[s] = frame
            self.last_kf_inliers[s] = inl
            # keyframe-rate maintenance for this stream: triangulate new
            # landmarks with covisible neighbours, then local BA
            slot = self.ref_kf[s]
            disp = m.create_new_points_dispatch(slot)
            if disp is None:
                self._local_ba(m, slot)
            else:
                self._fetcher.submit(disp["packed"], self._triangulated(m, slot, disp))

    def _triangulated(self, m: SlamMap, slot: int, disp: dict):
        """The continuation of one stream's triangulation table."""
        def resolve(packed):
            m.create_new_points_resolve(slot, disp, packed)
            self._local_ba(m, slot)
        return resolve

    def _local_ba(self, m: SlamMap, slot: int):
        if self.run_ba:
            m.run_local_ba(slot)


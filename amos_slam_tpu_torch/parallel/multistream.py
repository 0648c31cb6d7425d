"""Multi-stream batched SLAM over a stream mesh (port of parallel/multistream.py).

The reference's concurrency is 4-5 pthreads in one address space; the
analogue for scale-out is a leading stream axis: S independent camera
streams batched with ``torch.func.vmap``. Per-stream SLAM is embarrassingly
parallel, so one batched program serves every stream: each step is
``vmap`` of the fused frame program (extraction + motion-model + local-map
tracking + pose/velocity update, frontend/tracking.py) over the streams,
with the FAST kernel launched once for all their pyramids (its vmap rule,
ops/kernels/fast_margin_nms.py). Per-stream map views are batched
``LocalView`` tuples (use :func:`empty_views` for pure-odometry streams).

The JAX package shards the stream axis over a device mesh with
``shard_map`` and no collectives. Here a :class:`StreamMesh` of G entries
cuts the S streams into G contiguous groups in mesh order (stream s in
group ``s // (S / G)``; S % G != 0 raises, as ``shard_map`` does). Each
group keeps its state, views, pipeline constants and its streams' maps on
its entry's device and runs its own batched step: G programs, G FAST
launches per step, dispatched in turn by the one host thread. The entries
need not be distinct devices (two groups on one card, or on the CPU).

Supervision is pipelined, as the JAX class's: each step's (S, 3) count
rows, the groups' rows gathered in stream order on the mesh's first
device, go home through ``System``'s ``_SupervisionReader`` (a non_blocking
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
from ..utils.profiling import span


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
    """A stream mesh over ``devices`` (default: every CUDA card); an entry
    that names CUDA without a card raises."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return StreamMesh(tuple(resolve_device(d) for d in devices), axis)


def stream_groups(S: int, mesh: StreamMesh) -> list:
    """The contiguous slice of streams that each mesh entry holds, in mesh
    order."""
    G = len(mesh.devices)
    if S % G:
        raise ValueError(f"amos_slam_tpu_torch: {S} streams do not split evenly over the "
                         f"{G} entries of the stream mesh")
    n = S // G
    return [slice(g * n, (g + 1) * n) for g in range(G)]


def _map_tree(fn, *trees):
    first = trees[0]
    if isinstance(first, (torch.Tensor, np.ndarray)):
        return fn(*trees)
    return type(first)(*(_map_tree(fn, *xs) for xs in zip(*trees)))


def split_streams(tree, mesh: StreamMesh) -> tuple:
    """The per-group form of ``tree`` (a tensor or numpy array with the
    streams on axis 0, or a NamedTuple of them): one entry per mesh entry,
    its streams' rows on its device."""
    leaf = tree
    while not isinstance(leaf, (torch.Tensor, np.ndarray)):
        leaf = leaf[0]
    return tuple(_map_tree(lambda x: torch.as_tensor(x[sl]).to(dev), tree)
                 for sl, dev in zip(stream_groups(leaf.shape[0], mesh), mesh.devices))


def gather_streams(parts, device) -> object:
    """The inverse of :func:`split_streams`: the groups' rows in stream
    order on ``device`` (a single group on that device is returned as it
    is)."""
    dev = torch.device(device)
    if len(parts) == 1:
        return _map_tree(lambda x: x.to(dev), parts[0])
    return _map_tree(lambda *xs: torch.cat([x.to(dev) for x in xs]), *parts)


def group_pipelines(pipeline: ORBPipeline, mesh: StreamMesh) -> list:
    """One pipeline per mesh entry: ``pipeline`` on its own device, else
    one copy of its configuration per other device."""
    by_dev = {pipeline.device: pipeline}
    for d in mesh.devices:
        if d not in by_dev:
            by_dev[d] = ORBPipeline(pipeline.orb, pipeline.cam_cfg, d)
    return [by_dev[d] for d in mesh.devices]


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


def _group_step(pipelines, min_lm: int):
    """The batched step of each group on its pipeline's device, in turn:
    state, images, depths and views in per-group form; returns the new
    states, the sup rows and the heavy rows in per-group form."""

    def step(states, images, depths, views, mm_radius, map_radius):
        outs = [multistream_step(p, st, im, d, vw, mm_radius.to(p.device),
                                 map_radius.to(p.device), min_lm=min_lm)
                for p, st, im, d, vw in zip(pipelines, states, images, depths, views)]
        return tuple(tuple(x) for x in zip(*outs))

    return step


def shard_step(pipeline: ORBPipeline, mesh: Optional[StreamMesh] = None,
               axis: str = "stream", min_lm: int = 30):
    """The multistream step over the mesh's stream axis (no collectives).

    One entry (or no mesh): the batched step itself, with (S, ...) state,
    inputs and outputs. G > 1 entries: ``step(states, images, depths,
    views, mm_radius, map_radius)`` takes the state, images, depths and
    views in per-group form (tuples of G, :func:`split_streams`), the
    radii anywhere, and returns (states, sups, heavies) in per-group form
    (:func:`gather_streams` joins them); each group runs
    :func:`multistream_step` on its entry's device."""
    mesh = mesh or make_stream_mesh([pipeline.device], axis)
    grouped = _group_step(group_pipelines(pipeline, mesh), min_lm)
    if len(mesh.devices) > 1:
        return grouped

    def step(state, images, depths, views, mm_radius, map_radius):
        (st,), (sup,), (heavy,) = grouped((state,), (images,), (depths,), (views,),
                                          mm_radius, map_radius)
        return st, sup, heavy

    return step


class MultiStreamSLAM:
    """S concurrent RGB-D SLAM streams with LIVE per-stream maps.

    The device half is one batched program per mesh entry and step (the
    entry's fused frame steps vmapped over its streams). The host half
    mirrors System's keyframe supervision per stream, pipelined 1-2 steps
    behind dispatch as System's reader is: when a step's (S, 3) count rows
    land, the streams that trigger insertion have the (3N,) payload rows of
    THAT step (its state is kept until then) read in one transfer through
    the fetcher, the stream's own SlamMap inserts the keyframe (landmark
    creation from close depth, covisibility, spanning tree --
    SlamMap.insert_keyframe), new points triangulate, local BA runs, and
    the stacked LocalViews refresh -- the reference's LocalMapping cycle
    (src/LocalMapping.cc:73-175) per stream, on the stream's device; the
    triangulation tables of every inserting stream come home in one wait.
    Streams therefore track against growing maps: S-stream SLAM, not
    S-stream odometry. As in the JAX package, there is no loop closer.

    ``mesh`` (:func:`make_stream_mesh`) places the stream groups; without
    it the streams lie on ``device``, which defaults to the CUDA card and
    raises without one; pass ``device="cpu"`` for the plain path. Poses,
    count rows and :attr:`state` / :attr:`views` are gathered in stream
    order on the mesh's first device (:attr:`device`).
    """

    def __init__(self, cfg, S: int, mesh: Optional[StreamMesh] = None,
                 run_ba: bool = True, *, device=None):
        from ..system import _AsyncFetcher, _SupervisionReader

        self.cfg = cfg
        self.S = S
        self.run_ba = run_ba
        if mesh is None:
            mesh = make_stream_mesh([resolve_device(device)])
        elif device is not None and resolve_device(device) != mesh.devices[0]:
            raise ValueError(f"device {device} is not the mesh's first device "
                             f"{mesh.devices[0]}")
        self.mesh = mesh
        self.device = resolve_device(mesh.devices[0])
        self.groups = stream_groups(S, mesh)
        self.pipelines = group_pipelines(ORBPipeline(cfg.orb, cfg.camera, self.device), mesh)
        self.pipeline = self.pipelines[0]
        # stream s -> (its group, its row in the group)
        self._where = [(g, s - sl.start) for g, sl in enumerate(self.groups)
                       for s in range(sl.start, sl.stop)]
        self.maps = [SlamMap(cfg, self.pipelines[g].cam, self.pipelines[g].device)
                     for g, _ in self._where]
        self.ref_kf = [0] * S
        self.last_kf_frame = [-999] * S
        self.last_kf_inliers = [0] * S
        self.frame = -1
        self._states: Optional[tuple] = None   # per group: StreamState
        self._views: Optional[tuple] = None    # per group: batched LocalView
        tc = cfg.tracking
        f32 = dict(dtype=torch.float32, device=self.device)
        self._r_mm = torch.tensor(tc.match_radius_motion, **f32)
        self._r_map = torch.tensor(tc.match_radius_map * 2.0, **f32)
        self._step = _group_step(self.pipelines, tc.min_inliers_local_map)
        # pipelined supervision (System's reader and fetcher)
        self._reader = _SupervisionReader()
        self._fetcher = _AsyncFetcher()
        self.last_sup = np.zeros((S, 3), np.int64)

    @property
    def state(self) -> Optional[StreamState]:
        """Every stream's tracker state, (S, ...) in stream order (with
        more than one group, a gathered copy)."""
        return None if self._states is None else gather_streams(self._states, self.device)

    @property
    def views(self) -> Optional[LocalView]:
        """Every stream's local view, (S, ...) in stream order (with more
        than one group, a gathered copy)."""
        return None if self._views is None else gather_streams(self._views, self.device)

    def _upload(self, x) -> tuple:
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, np.float32)
        return tuple(t.to(torch.float32) for t in split_streams(x, self.mesh))

    # -- lifecycle -----------------------------------------------------
    def initialize(self, images, depths):
        """Bootstrap every stream: first frame becomes its keyframe 0 with
        landmarks from valid close depth (StereoInitialization semantics,
        src/Tracking.cc:1343, per stream)."""
        self._states = tuple(init_state(p, im, d) for p, im, d in
                             zip(self.pipelines, self._upload(images), self._upload(depths)))
        N = self.cfg.orb.max_kpts
        none = np.full(N, -1, np.int64)
        for s, (g, i) in enumerate(self._where):
            feats_s = index_tree(self._states[g].feats, i)
            eye = torch.eye(4, dtype=torch.float32, device=self.pipelines[g].device)
            self.ref_kf[s] = self.maps[s].insert_keyframe(feats_s, eye, none, 0)
            self.last_kf_frame[s] = 0
            self.last_kf_inliers[s] = 1
        self.frame = 0
        self._refresh_views()

    def _refresh_views(self):
        with span("slam.map.view"):
            self._views = tuple(
                stack_tree([self.maps[s].local_view(self.ref_kf[s])
                            for s in range(sl.start, sl.stop)])
                for sl in self.groups)

    # -- per-frame step ------------------------------------------------
    def step(self, images, depths):
        """Track one frame on every stream; returns ((S, 4, 4) poses on
        :attr:`device`, (S, 3) count rows of the most recently RESOLVED step
        -- supervision trails dispatch by at most 2 steps, see the class
        docstring)."""
        self.frame += 1
        st, sups, heavy = self._step(
            self._states, self._upload(images), self._upload(depths),
            self._views, self._r_mm, self._r_map,
        )
        self._states = st
        self._reader.submit((gather_streams(sups, self.device), (st, heavy, self.frame)))
        with span("slam.supervision"):
            self._reader.wait_until(2)
            for done in self._reader.drain():
                self._resolve_step(*done)
        return gather_streams([x.Tcw for x in st], self.device), self.last_sup

    def flush(self):
        """Resolve every supervision read in flight (call before reading
        the maps or trajectories at the end of a run)."""
        with span("slam.supervision"):
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
        inliers, matched) rows; ``heavy`` and ``st`` in per-group form) and
        run their maintenance; the views refresh after every stream's. The
        payload rows come home in one read and each stream's triangulation
        table through the fetcher, flushed here: the next step tracks
        against the new views, as the JAX class's does (it reads both
        synchronously)."""
        rows = torch.stack([heavy[g][i].to(self.device)
                            for g, i in (self._where[s] for s, _, _ in need)])
        self._fetcher.submit(rows, lambda host: self._insert_rows(need, host, st, frame))
        self._fetcher.flush()
        self._refresh_views()

    def _insert_rows(self, need, rows, st, frame):
        N = self.cfg.orb.max_kpts
        for (s, inl, matched), hv in zip(need, rows):
            with span("slam.kf.insert", frame):
                g, i = self._where[s]
                feats_s = index_tree(st[g].feats, i)
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
                    feats_s, st[g].Tcw[i], kp, frame,
                    valid_close=(valid, close),
                )
                self.last_kf_frame[s] = frame
                self.last_kf_inliers[s] = inl
                # keyframe-rate maintenance for this stream: triangulate new
                # landmarks with covisible neighbours, then local BA
                slot = self.ref_kf[s]
                with span("slam.kf.triangulate", frame):
                    disp = m.create_new_points_dispatch(slot)
                if disp is None:
                    self._local_ba(m, slot)
                else:
                    self._fetcher.submit(disp["packed"], self._triangulated(m, slot, disp, frame))

    def _triangulated(self, m: SlamMap, slot: int, disp: dict, frame: int):
        """The continuation of one stream's triangulation table."""
        def resolve(packed):
            with span("slam.kf.triangulate", frame):
                m.create_new_points_resolve(slot, disp, packed)
            self._local_ba(m, slot)
        return resolve

    def _local_ba(self, m: SlamMap, slot: int):
        if self.run_ba:
            m.run_local_ba(slot)

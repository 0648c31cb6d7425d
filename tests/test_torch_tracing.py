"""The port's layer spans (``utils.profiling.span``, names in ``SPANS``) on
the CPU, over one synthetic orbit, at the small configurations of
tests/test_torch_system_dynamics_port.py (``System``: 320x240, 4 levels,
max_kpts 512) and tests/test_torch_multistream.py (``MultiStreamSLAM``:
128x96, 3 levels, max_kpts 128):

* ``chunk``: ``System.track_rgbd_chunk`` with the geometric stage (the
  first call tracks frame by frame, the next ones run the two-stage chunk);
  ``live``: ``System.track_rgbd`` frame by frame; ``streams``: a
  ``MultiStreamSLAM`` of 2 streams, its frame step vmapped. Each path runs
  once under ``torch.profiler.profile`` and once with no profiler;
* under the profiler every span the path reaches is recorded, inside the
  profiled window, nested in the span that calls it (``PARENTS``); the
  vmapped step records its ORB and tracking spans, the host side its
  supervision and keyframe spans; keyframe spans carry the id of the frame
  that decided them as their ``args``;
* with no profiler, ``record_function`` is never entered, and the poses
  are the same to the bit as under the profiler.

The training spans (``train.*``) over two steps of ``make_train_step`` at
``yolact_tiny``'s net and size, fed by a ``DataLoader`` whose dataset is
slowed so that the first batch is waited for: under the profiler the
loader's wait, the gradient (with the loss inside it) and the SGD update
are recorded, nested so; with no profiler no region is entered; the
``TrainState`` is the same to the bit either way, and the loader counts
its batches and waits.

The ``cuda`` case (skips without a card) holds the shared clock: a kernel
launched inside a span has its launch call inside the span and starts on
the card after the span starts, less than 1 s later.

    python -m pytest -q tests/test_torch_tracing.py
    python -m pytest --noconftest -q tests/test_torch_tracing.py -m cuda   # on the card
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from amos_slam_tpu_torch.config import (CameraConfig, MapConfig, ORBConfig, SystemConfig,
                                        TrackingConfig)
from amos_slam_tpu_torch.io import synthetic
from amos_slam_tpu_torch.models import configs, data, train
from amos_slam_tpu_torch.models.segmenter import flax_init_
from amos_slam_tpu_torch.parallel.multistream import MultiStreamSLAM
from amos_slam_tpu_torch.system import System
from amos_slam_tpu_torch.utils import profiling

CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2, width=320, height=240)
CAM_MS = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, width=128, height=96)
N_FRAMES = 14
WINDOW = "test.window"

# the innermost slam.* span each span may sit in (None: none)
PARENTS = {
    "slam.dynamics": {None},
    "slam.dynamics.flow": {"slam.dynamics"},
    "slam.dynamics.pnp": {"slam.dynamics"},
    "slam.dynamics.clusters": {"slam.dynamics"},
    "slam.dynamics.vote": {"slam.dynamics"},
    "slam.orb.detect": {None},
    "slam.orb.describe": {None},
    "slam.track": {None},
    "slam.map.view": {None, "slam.track", "slam.supervision"},
    "slam.supervision": {None, "slam.supervision", "slam.kf.insert"},
    "slam.supervision.wait": {"slam.supervision"},
    "slam.kf.insert": {None, "slam.supervision", "slam.track"},
    "slam.kf.triangulate": {"slam.kf.insert", "slam.supervision"},
    "slam.kf.loop": {None, "slam.kf.insert", "slam.supervision"},
    "slam.kf.maintain": {"slam.kf.insert", "slam.supervision"},
    "slam.kf.local_ba": {"slam.kf.insert", "slam.supervision"},
}
COMMON = {"slam.orb.detect", "slam.orb.describe", "slam.track", "slam.map.view",
          "slam.supervision", "slam.kf.insert", "slam.kf.triangulate", "slam.kf.local_ba"}
DYNAMICS = {"slam.dynamics", "slam.dynamics.flow", "slam.dynamics.pnp",
            "slam.dynamics.clusters", "slam.dynamics.vote"}
EXPECTED = {"chunk": COMMON | DYNAMICS | {"slam.kf.loop"},
            "live": COMMON | DYNAMICS | {"slam.kf.loop", "slam.kf.maintain"},
            "streams": COMMON}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these eager runs launch many small ops, and
    tier-1 runs several test files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def system_cfg():
    return SystemConfig(camera=CameraConfig(**CAM),
                        orb=ORBConfig(n_features=500, n_levels=4, max_kpts=512),
                        map=MapConfig(max_keyframes=32, max_points=8192),
                        tracking=TrackingConfig(max_map_points_local=2048))


def streams_cfg():
    return SystemConfig(camera=CameraConfig(**CAM_MS, bf=10.0),
                        orb=ORBConfig(n_features=96, max_kpts=128, n_levels=3, border=8,
                                      cell_size=8),
                        map=MapConfig(max_keyframes=16, max_points=4096),
                        tracking=TrackingConfig(max_map_points_local=512,
                                                min_inliers_local_map=15),
                        use_dynamics=False)


def render(S, cam):
    """N_FRAMES batches of S streams: distinct rooms, one orbit."""
    gt = synthetic.orbit_trajectory(N_FRAMES, radius=0.08, advance=0.22)
    rooms = [synthetic.default_room(seed=20 + s) for s in range(S)]
    return [(np.stack([g for g, _ in row]).astype(np.float32),
             np.stack([d for _, d in row]).astype(np.float32))
            for row in synthetic.render_rooms(rooms, gt, **cam)]


@pytest.fixture(scope="module")
def frames():
    return {"system": render(1, CAM), "streams": render(2, CAM_MS)}


def run_chunk(frames):
    frames = frames["system"]
    slam = System(system_cfg(), device="cpu")
    for s in range(0, N_FRAMES, 4):
        rows = frames[s: s + 4]
        slam.track_rgbd_chunk(np.stack([g[0] for g, _ in rows]),
                              np.stack([d[0] for _, d in rows]),
                              [(s + j) / 30.0 for j in range(len(rows))])
    poses = np.stack(slam.poses_np())
    slam.shutdown()
    return poses, kf_frames([slam.map])


def run_live(frames):
    frames = frames["system"]
    slam = System(system_cfg(), device="cpu")
    for k, (g, d) in enumerate(frames):
        slam.track_rgbd(g[0], d[0], k / 30.0)
    poses = np.stack(slam.poses_np())
    slam.shutdown()
    return poses, kf_frames([slam.map])


def run_streams(frames):
    frames = frames["streams"]
    slam = MultiStreamSLAM(streams_cfg(), 2, device="cpu")
    slam.initialize(*frames[0])
    poses = [slam.state.Tcw.clone()]
    for g, d in frames[1:]:
        poses.append(slam.step(g, d)[0].clone())
    slam.flush()
    return torch.stack(poses).numpy(), kf_frames(slam.maps)


def kf_frames(maps):
    """The frames at which the maps' keyframes were inserted."""
    return {int(f) for m in maps for f in m.kf_frame_id[: m.n_kfs]}


RUNS = {"chunk": run_chunk, "live": run_live, "streams": run_streams}


class Recorder:
    """Stands in for ``record_function`` in ``utils.profiling``: counts the
    regions entered and keeps each one's (name, args)."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, args=None):
        self.calls.append((name, args))
        return torch.profiler.record_function(name, args)


@pytest.fixture(scope="module", params=sorted(RUNS))
def path(request, frames):
    """One path run twice: under the profiler and with none. Returns its
    name, the profiled run's slam.* events and window, both runs' poses and
    regions entered, and the profiled run's keyframe frames."""
    name = request.param
    out = {"name": name}
    with pytest.MonkeyPatch.context() as mp:
        for traced in (True, False):
            rec = Recorder()
            mp.setattr(profiling, "record_function", rec)
            ctx = profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext()
            with ctx as prof:
                with torch.profiler.record_function(WINDOW):
                    poses, kfs = RUNS[name](frames)
            out["traced" if traced else "plain"] = (poses, rec.calls)
            if traced:
                out["kf_frames"] = kfs
                evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in prof.profiler.kineto_results.events()]
                out["window"] = next((s, e) for n, s, e in evs if n == WINDOW)
                out["spans"] = sorted((ev for ev in evs if ev[0].startswith("slam.")),
                                      key=lambda ev: (ev[1], -ev[2]))
    return out


def innermost_parents(spans):
    """(span, the innermost slam.* span that encloses it, or None), for
    spans sorted by start (outer first at equal starts)."""
    stack, out = [], []
    for ev in spans:
        while stack and stack[-1][2] < ev[2]:
            stack.pop()
        out.append((ev, stack[-1][0] if stack else None))
        stack.append(ev)
    return out


def test_spans_are_recorded_nested_and_inside_the_window(path):
    names = {n for n, _, _ in path["spans"]}
    assert names <= set(profiling.SPANS), names - set(profiling.SPANS)
    assert EXPECTED[path["name"]] <= names, EXPECTED[path["name"]] - names
    w0, w1 = path["window"]
    assert all(w0 <= s <= e <= w1 for _, s, e in path["spans"])
    for ev, parent in innermost_parents(path["spans"]):
        assert parent in PARENTS[ev[0]], (ev, parent)


def test_no_profiler_enters_no_region_and_changes_no_pose(path):
    poses_t, calls_t = path["traced"]
    poses_p, calls_p = path["plain"]
    assert calls_p == [] and len(calls_t) == len(path["spans"])
    assert poses_t.shape == poses_p.shape and poses_t.dtype == poses_p.dtype
    assert np.array_equal(poses_t, poses_p)


def test_keyframe_spans_carry_their_deciding_frame(path):
    calls = path["traced"][1]
    kf = [(n, a) for n, a in calls if n.startswith("slam.kf.")]
    assert kf and all(a is not None and a.startswith("frame=") for _, a in kf)
    assert all(a is None for n, a in calls if not n.startswith("slam.kf."))
    inserted = {int(a.split("=")[1]) for n, a in kf if n == "slam.kf.insert"}
    assert inserted and inserted <= path["kf_frames"]
    assert {int(a.split("=")[1]) for _, a in kf} <= path["kf_frames"]


def test_profiler_off_is_one_flag_read(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(profiling, "record_function", rec)
    for name in profiling.SPANS:
        with profiling.span(name, 3):
            pass
    assert rec.calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("slam.kf.insert", 7), profiling.span("slam.track"):
            pass
    assert rec.calls == [("slam.kf.insert", "frame=7"), ("slam.track", None)]


TRAIN_PARENTS = {"train.loader.wait": {None}, "train.grads": {None},
                 "train.loss": {"train.grads"}, "train.sgd": {None}}


class SlowShapes(data.SyntheticShapes):
    """SyntheticShapes whose samples take 20 ms each to make."""

    def __getitem__(self, idx):
        import time

        time.sleep(0.02)
        return super().__getitem__(idx)


def run_train():
    """Two steps of yolact_tiny from Flax's init (seed 0) on batches of 2."""
    cfg = configs.get_config("yolact_tiny")
    model = cfg.build(device="cpu")
    flax_init_(model, torch.Generator().manual_seed(0))
    init, step = train.make_train_step(model, torch.from_numpy(cfg.priors()), cfg.lr)
    state = init({k: v.clone() for k, v in model.state_dict().items()})
    loader = data.DataLoader(SlowShapes(n=16, size=cfg.img_size, seed=3), 2, cfg.img_size,
                             cfg.max_objs, cfg.proto_shape, seed=5, device="cpu")
    try:
        for _ in range(2):
            state = step(state, next(loader))[0]
    finally:
        loader.stop()
    return state, (loader.batches, loader.waits)


@pytest.fixture(scope="module")
def trained():
    """run_train under the profiler and with none: each run's state,
    loader counts and regions entered, and the profiled run's train.*
    events and window."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for traced in (True, False):
            rec = Recorder()
            mp.setattr(profiling, "record_function", rec)
            ctx = profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext()
            with ctx as prof:
                with torch.profiler.record_function(WINDOW):
                    state, counts = run_train()
            out["traced" if traced else "plain"] = (state, counts, rec.calls)
            if traced:
                evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in prof.profiler.kineto_results.events()]
                out["window"] = next((s, e) for n, s, e in evs if n == WINDOW)
                out["spans"] = sorted((ev for ev in evs if ev[0].startswith("train.")),
                                      key=lambda ev: (ev[1], -ev[2]))
    return out


def test_train_spans_are_recorded_nested_and_inside_the_window(trained):
    names = [n for n, _, _ in trained["spans"]]
    assert set(names) == set(TRAIN_PARENTS) and set(names) <= set(profiling.SPANS)
    assert names.count("train.grads") == names.count("train.sgd") == names.count("train.loss") == 2
    w0, w1 = trained["window"]
    assert all(w0 <= s <= e <= w1 for _, s, e in trained["spans"])
    for ev, parent in innermost_parents(trained["spans"]):
        assert parent in TRAIN_PARENTS[ev[0]], (ev, parent)


def test_train_without_profiler_enters_no_region_and_changes_no_bit(trained):
    state_t, counts_t, calls_t = trained["traced"]
    state_p, counts_p, calls_p = trained["plain"]
    assert calls_p == [] and len(calls_t) == len(trained["spans"])
    assert counts_t[0] == counts_p[0] == 2 and counts_t[1] >= 1 and counts_p[1] >= 1
    assert int(state_t.step) == int(state_p.step) == 2
    for part in ("params", "opt_state"):
        a, b = getattr(state_t, part), getattr(state_p, part)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (part, k)


@pytest.mark.cuda
def test_span_and_kernel_share_the_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with profiling.span("slam.track"):
            y = x * 3.0
        torch.cuda.synchronize()
    assert float(y[0]) == 3.0
    cuda = torch.autograd.DeviceType.CUDA
    evs = list(prof.profiler.kineto_results.events())
    s0, s1 = next((e.start_ns(), e.start_ns() + e.duration_ns()) for e in evs
                  if e.name() == "slam.track" and e.device_type() != cuda)
    launches = [e for e in evs if e.name() in ("cudaLaunchKernel", "cuLaunchKernel")
                and s0 <= e.start_ns() <= s1]
    assert launches
    kernels = [e for e in evs if e.device_type() == cuda and "elementwise" in e.name()]
    assert kernels
    k0 = min(e.start_ns() for e in kernels)
    assert s0 < k0 < s0 + 1_000_000_000

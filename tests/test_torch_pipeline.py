"""Pipelined host supervision (``deterministic=False``): the port's
``_SupervisionReader`` / ``_AsyncFetcher`` and their wiring in ``System``
and ``MultiStreamSLAM``, against the JAX package on the CPU at 320x240.

The JAX package reads on side threads whose timing varies run to run, and
the port's copies land when the card is done; neither schedule repeats.
So both packages' reader and fetcher are replaced (monkeypatch; neither
package changes) by one fixed-lag stand-in: a clock ticks on every reader
submission, and a submitted item becomes ready L ticks later, or earlier
when ``wait_until`` or ``flush`` demands it. The reads stay each
package's own (``jax.device_get``; ``clone()`` then ``.numpy()``), made at
submission. Under the same lag both packages must then drain, resolve,
insert keyframes and run their maintenance at the same points: what is
held is that they call the reader and fetcher alike and do the same work
at each point.

Cases, each ``deterministic=False``: per-frame ``track_rgbd`` with the
dynamic stage off and on, L in {0, 1, 3} (with it on, JAX's PnP draws are
fed to the port as in tests/test_torch_system_dynamics.py); the chunk
path, W = 8, L in {1, 3} chunks with ``dispatch_window`` 2, so that
``wait_until`` forces reads (the scene of
tests/test_torch_system_chunk_parity.py: two keyframes in one chunk);
stereo and mono per frame, L = 2 (the setups and fed inputs of
tests/test_torch_system_stereo_mono.py); ``MultiStreamSLAM``, S = 3,
L = 1 (the scene of tests/test_torch_multistream.py).

Held: the same keyframe frames, equal ``stats`` rows, equal landmark
counts, every frame's pose within 1e-4 (the local-BA tolerance of
tests/test_torch_local_ba.py), and for multistream ``last_sup`` equal
after every step. Three cases are held as the existing tests hold their
paths, for the reasons given there:

* mono, as tests/test_torch_system_stereo_mono.py (its first local BA
  has a free scale): match and inlier counts within 2, poses within
  3e-4, except frame 6, whose pose solve is weakly constrained (101
  inliers after a keyframe): 1.11e-4 there without lag (the gap that test
  documents), 7.10e-4 with L = 2 (measured), every other frame within
  1.2e-5; it is held to 1e-3;
* the dynamic stage, as tests/test_torch_system_dynamics.py: the same
  keyframe frames and PnP wins, poses within 5 mm / 0.2 deg;
* multistream's tracked poses: keyframes on nearly every step of its tiny
  config put 11 local BAs behind step 12, and the BA's bf16 hi/lo gap
  (tests/test_torch_local_ba.py) carries into the tracked poses: 3.6e-5
  without lag, 1.09e-4 at step 5 with L = 1 (measured); held to 2e-4, the
  keyframe poses to 1e-4.

Unit cases of the two classes use a copy whose landing the test controls:
FIFO order, the ``wait_until`` bound, continuations chained inside
``flush``, an error that propagates; and on the CPU, a snapshot that keeps
its value after its source is written in place. A ``cuda`` case checks
the card's copies (pinned buffer, event, the byte layout of a dict).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amos_slam_tpu.frontend.tracking as jtrack
import amos_slam_tpu.solvers.initializer as jinit
import amos_slam_tpu.system as jsys
import amos_slam_tpu_torch.system as tsys
from amos_slam_tpu.config import (CameraConfig as JCam, MapConfig as JMap,
                                  ORBConfig as JORB, SystemConfig as JSys,
                                  TrackingConfig as JTrk)
from amos_slam_tpu.frontend import dynamics as jdyn
from amos_slam_tpu.parallel import multistream as jms
from amos_slam_tpu_torch.config import (CameraConfig as TCam, MapConfig as TMap,
                                        ORBConfig as TORB, SystemConfig as TSys,
                                        TrackingConfig as TTrk)
from amos_slam_tpu_torch.io import synthetic
from amos_slam_tpu_torch.parallel import multistream as tms

CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2, width=320, height=240)
ORB = dict(n_features=500, n_levels=4, max_kpts=512)
MAP = dict(max_keyframes=32, max_points=8192)
JMODS = (JSys, JCam, JORB, JMap, JTrk)
TMODS = (TSys, TCam, TORB, TMap, TTrk)
POSE_TOL = 1e-4
MONO_WORST = 1e-3   # mono's one weakly constrained frame (module docstring)
MS_POSE_TOL = 2e-4  # multistream's tracked poses (module docstring)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these eager runs launch many small ops, and
    tier-1 runs several test files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the stand-in
def _read_jax(x):
    return jax.device_get(x)


def _read_port(x):
    if isinstance(x, dict):
        return {k: _read_port(v) for k, v in x.items()}
    return x.detach().clone().numpy()


class Lag:
    """A fixed-lag reader and fetcher (``Reader``, ``Fetcher``) for one
    package's run, sharing this clock; ``seen`` records the most reads
    ever in flight."""

    def __init__(self, L: int, read):
        self.L, self.read, self.t, self.seen = L, read, 0, 0
        lag = self

        class Item:
            __slots__ = ("tick", "host", "rest")

            def __init__(self, dev, rest):
                self.tick, self.host, self.rest = lag.t, lag.read(dev), rest

            def ready(self):
                return self.tick is None or lag.t - self.tick >= lag.L

            def force(self):
                self.tick = None

        class Reader:
            def __init__(self):
                self._q = collections.deque()

            def submit(self, item):
                lag.t += 1
                sup, payload = item
                self._q.append(Item(sup, payload))
                lag.seen = max(lag.seen, sum(not it.ready() for it in self._q))

            def wait_until(self, max_pending):
                unready = [it for it in self._q if not it.ready()]
                for it in unready[: max(len(unready) - max_pending, 0)]:
                    it.force()

            def drain(self):
                out = []
                while self._q and self._q[0].ready():
                    it = self._q.popleft()
                    out.append((*it.rest, it.host))
                return out

            def flush(self):
                self.wait_until(0)
                return self.drain()

            def stop(self):
                pass

        class Fetcher:
            def __init__(self):
                self._q = collections.deque()

            def submit(self, dev, cont):
                self._q.append(Item(dev, cont))

            def drain(self):
                while self._q and self._q[0].ready():
                    it = self._q.popleft()
                    it.rest(it.host)

            def flush(self):
                while self._q:
                    for it in self._q:
                        it.force()
                    self.drain()

            def stop(self):
                self.flush()

        self.Reader, self.Fetcher = Reader, Fetcher


@pytest.fixture
def lagged(monkeypatch):
    """lagged(L) -> (jax Lag, port Lag), both installed."""
    def install(L):
        jl, tl = Lag(L, _read_jax), Lag(L, _read_port)
        monkeypatch.setattr(jsys, "_SupervisionReader", jl.Reader)
        monkeypatch.setattr(jsys, "_AsyncFetcher", jl.Fetcher)
        monkeypatch.setattr(tsys, "_SupervisionReader", tl.Reader)
        monkeypatch.setattr(tsys, "_AsyncFetcher", tl.Fetcher)
        return jl, tl
    return install


def cfgs(**kw):
    """(JAX config, port config): 320x240, 4 levels, 500 features,
    MapConfig(32, 8192), 2048 local points, pipelined."""
    trk = kw.pop("tracking", {})
    cam = dict(CAM, bf=20.0) if kw.get("sensor") in ("stereo", "mono") else CAM
    out = []
    for Sys, Cam, Orb, Map, Trk in (JMODS, TMODS):
        out.append(Sys(camera=Cam(**cam), orb=Orb(**ORB), map=Map(**MAP),
                       tracking=Trk(max_map_points_local=2048, **trk),
                       deterministic=False, **kw))
    return out


def render(planes, poses, T_shift=None):
    r = dict(fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"], cy=CAM["cy"], width=320, height=240)
    if T_shift is None:
        return [synthetic.render(planes, T, **r) for T in poses]
    return [(synthetic.render(planes, T, **r)[0],
             synthetic.render(planes, T_shift @ T, **r)[0]) for T in poses]


def check_parity(js, ts, n, tol=POSE_TOL, counts_within=0, min_kfs=3):
    js.shutdown()   # resolves what is still in flight
    ts.shutdown()
    mj, mt = js.map, ts.map
    np.testing.assert_array_equal(mt.kf_frame_id[: mt.n_kfs], mj.kf_frame_id[: mj.n_kfs])
    assert mt.n_kfs >= min_kfs
    assert mt.n_pts == mj.n_pts and int(mt.pt_alive.sum()) == int(mj.pt_alive.sum())
    assert len(ts.stats) == len(js.stats) == n
    if counts_within:
        for a, b in zip(ts.stats, js.stats):
            assert a["kf"] == b["kf"], (a, b)
            assert abs(a["matches"] - b["matches"]) <= counts_within, (a, b)
            assert abs(a["inliers"] - b["inliers"]) <= counts_within, (a, b)
    else:
        assert ts.stats == js.stats
    pj, pt = np.asarray(js.poses_np()), np.asarray(ts.poses_np())
    assert pt.shape == pj.shape == (n, 4, 4)
    gap = np.abs(pt - pj).max(axis=(1, 2))
    assert gap.max() < tol, gap
    assert ts.state.name == js.state.name == "OK"
    return gap


# ----------------------------------------------------- per frame, RGB-D
@pytest.fixture(scope="module")
def orbit():
    """tests/test_torch_system_chunk_parity.py's scene (keyframes at
    frames 0, 3, 19 and 22 when supervision is not lagged)."""
    poses = synthetic.orbit_trajectory(40, radius=0.15, advance=0.6, yaw_amp=0.4)
    frames = render(synthetic.default_room(seed=1), poses)
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


@pytest.mark.parametrize("L", [0, 1, 3])
def test_track_rgbd_lagged(lagged, orbit, L):
    jl, tl = lagged(L)
    g, d = orbit
    jc, tc = cfgs(use_dynamics=False)
    js, ts = jsys.System(jc), tsys.System(tc, device="cpu")
    n = 26
    for i in range(n):
        js.track_rgbd(g[i], d[i], i / 30.0)
        ts.track_rgbd(g[i], d[i], i / 30.0)
    check_parity(js, ts, n)
    assert tl.seen == jl.seen >= L


@pytest.fixture(scope="module")
def mover():
    """tests/test_torch_system_dynamics.py's mover sequence."""
    poses = synthetic.orbit_trajectory(24, radius=0.1, advance=0.2)
    frames = []
    for i in range(16):
        planes, m = synthetic.room_with_mover(seed=1, t=i / 30.0, speed=1.5)
        planes[m].chroma = (1.6, 0.85, 0.55)
        g, d = render(planes, [poses[i]])[0]
        frames.append((g, d))
    return frames


STATIC = ("n_clusters", "slic_cell", "slic_iters", "dilate_radius", "has_seg",
          "slic_downsample", "lk_levels", "lk_win", "lk_iters", "pnp_hypotheses",
          "lk_downsample")
_DRAWS = []                         # JAX's PnP draws, in call order
_JAX_DYN = {}                       # the traced-once JAX compute_dynamics


def _jax_dynamics():
    """JAX's compute_dynamics traced once with ransac_pnp wrapped to
    report its draw (a new function object, so no cached trace skips the
    wrapper)."""
    if "fn" not in _JAX_DYN:
        orig_pnp, orig = jdyn.ransac_pnp, jsys.compute_dynamics

        def recording_pnp(cam, pts_w, uv, valid, key, n_hyp=512, **kw):
            probs = valid.astype(jnp.float32)
            probs = probs / jnp.maximum(probs.sum(), 1.0)
            idx = jax.random.choice(key, pts_w.shape[0], shape=(n_hyp, 6), p=probs)
            jax.debug.callback(lambda i: _DRAWS.append(np.asarray(i)), idx)
            return orig_pnp(cam, pts_w, uv, valid, key, n_hyp=n_hyp, **kw)

        jitted = jax.jit(lambda *a, **k: orig.__wrapped__(*a, **k), static_argnames=STATIC)
        _JAX_DYN["fn"] = (jitted, recording_pnp)
    return _JAX_DYN["fn"]


@pytest.mark.parametrize("L", [0, 1, 3])
def test_track_rgbd_dynamics_lagged(lagged, mover, monkeypatch, L):
    jl, tl = lagged(L)
    jitted, recording_pnp = _jax_dynamics()
    orig_t = tsys.compute_dynamics
    used = {"jax": [], "port": []}
    _DRAWS.clear()

    def jax_dyn(*args, **kwargs):
        res = jitted(*args, **kwargs)
        used["jax"].append(bool(np.asarray(res.used_pnp)))
        return res

    def port_dyn(*args, **kwargs):
        jax.effects_barrier()
        assert len(_DRAWS) == len(used["port"]) + 1
        res = orig_t(*args, pnp_sample_idx=torch.from_numpy(np.array(_DRAWS[-1])).long(),
                     **kwargs)
        used["port"].append(bool(res.used_pnp))
        return res

    monkeypatch.setattr(jdyn, "ransac_pnp", recording_pnp)
    monkeypatch.setattr(jsys, "compute_dynamics", jax_dyn)
    monkeypatch.setattr(tsys, "compute_dynamics", port_dyn)
    jc, tc = cfgs(use_dynamics=True)
    js, ts = jsys.System(jc), tsys.System(tc, device="cpu")
    for i, (g, d) in enumerate(mover):
        js.track_rgbd(g, d, i / 30.0)
        ts.track_rgbd(g, d, i / 30.0)
    n = len(mover)
    js.shutdown()
    ts.shutdown()
    assert used["port"] == used["jax"] and len(used["jax"]) == n - 1
    mj, mt = js.map, ts.map
    np.testing.assert_array_equal(mt.kf_frame_id[: mt.n_kfs], mj.kf_frame_id[: mj.n_kfs])
    assert mt.n_kfs >= 2 and [s["kf"] for s in ts.stats] == [s["kf"] for s in js.stats]
    pj, pt = np.asarray(js.poses_np()), np.asarray(ts.poses_np())
    assert pt.shape == pj.shape == (n, 4, 4)
    dpos = np.linalg.norm(pj[:, :3, 3] - pt[:, :3, 3], axis=1)
    assert dpos.max() < 5e-3, dpos
    rel = np.einsum("nij,nkj->nik", pj[:, :3, :3], pt[:, :3, :3])
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    assert np.degrees(np.arccos(cos)).max() < 0.2
    assert tl.seen == jl.seen >= L


# --------------------------------------------------------------- chunks
@pytest.mark.parametrize("L", [1, 3])
def test_track_rgbd_chunk_lagged(lagged, orbit, L):
    jl, tl = lagged(L)
    g, d = orbit
    W, n = 8, 40
    jc, tc = cfgs(use_dynamics=False, tracking=dict(dispatch_window=2))
    js, ts = jsys.System(jc), tsys.System(tc, device="cpu")
    stamps = [i / 30.0 for i in range(n)]
    for c in range(0, n, W):
        js.track_rgbd_chunk(g[c: c + W], d[c: c + W], stamps[c: c + W])
        ts.track_rgbd_chunk(g[c: c + W], d[c: c + W], stamps[c: c + W])
    assert any(T.ndim == 3 for T in ts.poses_cw)        # chunks were tracked
    check_parity(js, ts, n)
    assert tl.seen == jl.seen >= min(L, 3)


# ---------------------------------------------------------- stereo, mono
def test_track_stereo_lagged(lagged, monkeypatch):
    jl, tl = lagged(2)
    # JAX's fused stereo step op by op (tests/test_torch_system_stereo_mono.py)
    monkeypatch.setattr(jtrack, "fused_stereo_step", jtrack.fused_stereo_step.__wrapped__)
    T_shift = np.eye(4)
    T_shift[0, 3] = -20.0 / CAM["fx"]
    poses = synthetic.orbit_trajectory(24, radius=0.1, advance=0.25)[:16]
    frames = render(synthetic.default_room(seed=9), poses, T_shift)
    jc, tc = cfgs(use_dynamics=False, sensor="stereo")
    js, ts = jsys.System(jc), tsys.System(tc, device="cpu")
    for i, (gl, gr) in enumerate(frames):
        js.track_stereo(gl, gr, i / 30.0)
        ts.track_stereo(gl, gr, i / 30.0)
    check_parity(js, ts, len(frames), min_kfs=2)
    assert tl.seen == jl.seen >= 2


def test_track_monocular_lagged(lagged, monkeypatch):
    jl, tl = lagged(2)
    draws = []
    orig_j, orig_t = jinit.initialize_two_view, tsys.initialize_two_view

    def recording(cam, x1, x2, valid, key, n_hyp=256, **kw):
        k1, k2 = jax.random.split(key)
        probs = valid.astype(jnp.float32)
        probs = probs / jnp.maximum(probs.sum(), 1.0)
        draws.append([np.array(jax.random.choice(k, x1.shape[0], shape=(n_hyp, s), p=probs))
                      for k, s in ((k1, 8), (k2, 4))])
        return orig_j(cam, x1, x2, valid, key, n_hyp=n_hyp, **kw)

    def fed(cam, x1, x2, valid, generator=None, **kw):
        idx_f, idx_h = draws[-1]
        return orig_t(cam, x1, x2, valid, generator, sample_idx_f=torch.from_numpy(idx_f),
                      sample_idx_h=torch.from_numpy(idx_h), **kw)

    monkeypatch.setattr(jinit, "initialize_two_view", recording)
    monkeypatch.setattr(tsys, "initialize_two_view", fed)
    poses = synthetic.orbit_trajectory(30, radius=0.35, advance=0.15)[:24]
    frames = [g for g, _ in render(synthetic.default_room(seed=11), poses)]
    jc, tc = cfgs(use_dynamics=False, sensor="mono")
    js, ts = jsys.System(jc), tsys.System(tc, device="cpu")
    # The JAX mono fast path reads map.arrays before it applies the landmark
    # counters of an older view, and that update donates the arrays: under
    # lag its pt_pos / pt_valid arguments arrive deleted (with
    # deterministic=True the counters are applied at the frame's start).
    # The counters do not touch either, so the map's current ones stand in.
    mono_step = jtrack.fused_mono_step

    def current_map(pipe, image, last, pid, pt_pos, pt_valid, *rest, **kw):
        if pt_pos.is_deleted() or pt_valid.is_deleted():
            pt_pos, pt_valid = js.map.arrays.pt_pos, js.map.arrays.pt_valid
        return mono_step(pipe, image, last, pid, pt_pos, pt_valid, *rest, **kw)

    monkeypatch.setattr(jtrack, "fused_mono_step", current_map)
    for i, g in enumerate(frames):
        js.track_monocular(g, i / 30.0)
        ts.track_monocular(g, i / 30.0)
    assert draws
    gap = check_parity(js, ts, len(frames), tol=MONO_WORST, counts_within=2)
    assert np.sort(gap)[-2] < 3e-4, gap
    assert tl.seen == jl.seen >= 2


# ---------------------------------------------------------- multistream
MS_CAM = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, width=128, height=96)


def ms_cfg(mods):
    Sys, Cam, Orb, Map, Trk = mods
    return Sys(camera=Cam(**MS_CAM, bf=10.0),
               orb=Orb(n_features=96, max_kpts=128, n_levels=3, border=8, cell_size=8),
               map=Map(max_keyframes=16, max_points=4096),
               tracking=Trk(max_map_points_local=512, min_inliers_local_map=15),
               use_dynamics=False)


def test_multistream_lagged(lagged):
    jl, tl = lagged(1)
    S, n = 3, 13
    gt = synthetic.orbit_trajectory(n, radius=0.08, advance=0.22)
    rooms = [synthetic.default_room(seed=20 + s) for s in range(S)]
    frames = [(np.stack([g for g, _ in row]).astype(np.float32),
               np.stack([d for _, d in row]).astype(np.float32))
              for row in synthetic.render_rooms(rooms, gt, **MS_CAM)]
    jslam = jms.MultiStreamSLAM(ms_cfg(JMODS), S)
    tslam = tms.MultiStreamSLAM(ms_cfg(TMODS), S, device="cpu")
    jslam.initialize(*frames[0])
    tslam.initialize(*frames[0])
    for k in range(1, n):
        jT, jsup = jslam.step(*frames[k])
        tT, tsup = tslam.step(*frames[k])
        np.testing.assert_array_equal(tsup, np.asarray(jsup), err_msg=f"step {k}")
        np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=MS_POSE_TOL,
                                   err_msg=f"step {k}")
    jslam.flush()
    tslam.flush()
    np.testing.assert_array_equal(tslam.last_sup, np.asarray(jslam.last_sup))
    for s, (jm, tm) in enumerate(zip(jslam.maps, tslam.maps)):
        assert (tm.n_kfs, tm.n_pts) == (jm.n_kfs, jm.n_pts), s
        assert tm.n_kfs >= 2, s
        np.testing.assert_array_equal(tm.kf_frame_id[: tm.n_kfs], jm.kf_frame_id[: jm.n_kfs])
        np.testing.assert_array_equal(tm.pt_alive, jm.pt_alive)
        np.testing.assert_allclose(tm.arrays.kf_pose[: tm.n_kfs].numpy(),
                                   np.asarray(jm.arrays.kf_pose)[: jm.n_kfs], atol=POSE_TOL)
    assert tl.seen == jl.seen == 1


# -------------------------------------------------- the classes themselves
class FakeCopy:
    """A copy whose landing the test decides: ``landed`` holds the values
    that have landed; ``wait`` lands its own (and counts)."""
    landed, waited = set(), []

    def __init__(self, dev):
        self.v = dev if isinstance(dev, str) else _read_port(dev)

    def ready(self):
        return self.v in FakeCopy.landed

    def wait(self):
        if self.ready():
            return False
        if self.v == "bad":
            raise RuntimeError("copy failed")
        FakeCopy.waited.append(self.v)
        FakeCopy.landed.add(self.v)
        return True

    def value(self):
        return self.v


@pytest.fixture
def fake(monkeypatch):
    FakeCopy.landed, FakeCopy.waited = set(), []
    monkeypatch.setattr(tsys, "_HostCopy", FakeCopy)
    return FakeCopy


def test_reader_fifo_and_bound(fake):
    r = tsys._SupervisionReader()
    for v in "abcd":
        r.submit((v, (v.upper(),)))
    fake.landed |= {"b", "c"}
    assert r.drain() == []                         # b and c wait behind a
    fake.landed.add("a")
    assert r.drain() == [("A", "a"), ("B", "b"), ("C", "c")]
    for v in "efg":
        r.submit((v, (v.upper(),)))
    r.wait_until(2)                                # d, e, f, g in flight: 2 waited for
    assert fake.waited == ["d", "e"] and r.waits == 2
    assert [x[-1] for x in r.drain()] == ["d", "e"]
    r.wait_until(2)                                # f, g: within the bound
    assert r.waits == 2
    assert [x[-1] for x in r.flush()] == ["f", "g"] and r.waits == 4


def test_fetcher_chains_inside_flush(fake):
    f, ran = tsys._AsyncFetcher(), []

    def cont(v):
        ran.append(v)
        if v == "a":                               # a continuation submits more
            f.submit("c", cont)

    f.submit("a", cont)
    f.submit("b", cont)
    f.drain()
    assert ran == []
    f.flush()
    assert ran == ["a", "b", "c"] and f.waits == 3


def test_errors_propagate(fake):
    f = tsys._AsyncFetcher()

    def boom(v):
        raise ValueError(v)

    f.submit("x", boom)
    with pytest.raises(ValueError, match="x"):
        f.flush()
    r = tsys._SupervisionReader()
    r.submit(("bad", ()))
    with pytest.raises(RuntimeError, match="copy failed"):
        r.wait_until(0)


def test_cpu_snapshot_survives_in_place_writes():
    r, f, got = tsys._SupervisionReader(), tsys._AsyncFetcher(), []
    t = torch.arange(6, dtype=torch.int32)
    x = torch.ones(2, 3)
    r.submit((t, ("row",)))
    f.submit({"i": t, "x": x, "b": t > 2}, got.append)
    t.add_(100)                                    # written in place before the drain
    x.mul_(0)
    (tag, host), = r.drain()
    f.drain()
    assert tag == "row" and host.tolist() == list(range(6))
    assert got[0]["i"].tolist() == list(range(6)) and got[0]["x"].tolist() == [[1.0] * 3] * 2
    assert got[0]["b"].tolist() == [False] * 3 + [True] * 3


@pytest.mark.cuda
def test_card_copies_are_snapshots():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    r, f, got = tsys._SupervisionReader(), tsys._AsyncFetcher(), []
    t = torch.arange(7, dtype=torch.int32, device=dev)
    tree = {"b": t > 2, "x": torch.linspace(0, 1, 5, device=dev),
            "i": torch.arange(12, dtype=torch.int64, device=dev).reshape(3, 4), "t": t}
    want = {k: v.cpu().numpy().copy() for k, v in tree.items()}
    torch.cuda._sleep(10_000_000)                  # the copies queue behind this
    r.submit((t, ("row",)))
    f.submit(tree, got.append)
    t.add_(100)
    (tag, host), = r.flush()
    f.flush()
    assert tag == "row" and host.tolist() == list(range(7))
    for k, v in want.items():
        assert got[0][k].dtype == v.dtype and np.array_equal(got[0][k], v), k

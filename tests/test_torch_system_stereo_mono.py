"""Port parity: System with the stereo and the monocular sensor against the
JAX package's System(deterministic=True), at 320x240.

Setup: tests/test_stereo_mono_e2e.py's configs with the camera halved (4
levels, 500 features, max_kpts 512, MapConfig(max_keyframes=32,
max_points=8192), max_map_points_local 2048, use_dynamics=False): stereo
over 16 frames of orbit_trajectory(24, radius=0.1, advance=0.25) in
default_room(seed=9), the right camera bf / fx = 0.0747 m to the right;
mono over 20 frames of orbit_trajectory(30, radius=0.35, advance=0.15) in
default_room(seed=11). Held: the same initialization frame and keyframe
frames, the same landmark counts, per-frame match and inlier counts within
2, every frame's pose within 1e-4 for stereo (the local-BA tolerance of
tests/test_torch_local_ba.py; 3.5e-6 measured) and 3e-4 for mono (the
map's unit is its initial median depth). The mono map's first local BA
runs on two keyframes, one of them fixed, so its scale is free: it leaves
the landmarks up to 2.7e-4 (median 3.9e-5) from JAX's, whose BA sums
landmark blocks in bf16 hi/lo (a gap tests/test_torch_local_ba.py holds
at 1e-3 on points), and the frames tracked against them follow within
1.1e-4 with one torch thread and 7e-5 with two (measured).

Two inputs are fed so that both packages take the same path:

* mono: ``jax.random.choice`` cannot be reproduced, so the JAX
  initializer's draws (from the key it splits) are recorded and given to
  the port's initializer as ``sample_idx_f`` / ``sample_idx_h``;
* stereo: the JAX package's fused stereo step runs as its Python body
  (``fused_stereo_step.__wrapped__``, op by op, its inner jitted parts
  jitted). Compiled whole, XLA fuses the keypoint coordinates' products
  into the band and disparity tests and contracts them into FMAs: a right
  keypoint exactly 2 * 1.2^level rows off, or at zero disparity, then
  falls on the other side of the test (131 of 245,760 band entries and 83
  disparity entries on frame 1, measured), and the match it makes moves
  that frame's pose by up to 9 mm. Op by op, the JAX matcher agrees with
  the port bit for bit (tests/test_torch_stereo.py holds match_stereo,
  eager and jitted alone, exactly).

The port's own draw also initializes the mono map at the same frame and
tracks it to the JAX e2e test's gate (scale-aligned ATE < 5 cm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amos_slam_tpu.frontend.tracking as jtrack
import amos_slam_tpu.solvers.initializer as jinit
import amos_slam_tpu_torch.system as tsys
from amos_slam_tpu.config import (CameraConfig as JCam, MapConfig as JMap,
                                  ORBConfig as JORB, SystemConfig as JSys,
                                  TrackingConfig as JTrk)
from amos_slam_tpu.system import System as JSystem
from amos_slam_tpu_torch.config import (CameraConfig as TCam, MapConfig as TMap,
                                        ORBConfig as TORB, SystemConfig as TSys,
                                        TrackingConfig as TTrk)
from amos_slam_tpu_torch.io import evaluate, synthetic
from amos_slam_tpu_torch.system import TrackingState

BF = 20.0
CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2,
           width=320, height=240, bf=BF)
ORB = dict(n_features=500, n_levels=4, max_kpts=512)
MAP = dict(max_keyframes=32, max_points=8192)
RENDER = dict(fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"], cy=CAM["cy"], width=320, height=240)
N_STEREO, N_MONO = 16, 20
TOL = {"stereo": 1e-4, "mono": 3e-4}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these eager runs launch many small ops, and
    tier-1 runs several test files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jcfg(sensor):
    return JSys(camera=JCam(**CAM), orb=JORB(**ORB), map=JMap(**MAP),
                tracking=JTrk(max_map_points_local=2048), use_dynamics=False,
                sensor=sensor, deterministic=True)


def tcfg(sensor):
    return TSys(camera=TCam(**CAM), orb=TORB(**ORB), map=TMap(**MAP),
                tracking=TTrk(max_map_points_local=2048), use_dynamics=False,
                sensor=sensor, deterministic=True)


@pytest.fixture(scope="module")
def stereo_runs():
    planes = synthetic.default_room(seed=9)
    poses = synthetic.orbit_trajectory(24, radius=0.1, advance=0.25)[:N_STEREO]
    T_shift = np.eye(4)
    T_shift[0, 3] = -BF / CAM["fx"]
    frames = [(synthetic.render(planes, T, **RENDER)[0],
               synthetic.render(planes, T_shift @ T, **RENDER)[0]) for T in poses]
    fused = jtrack.fused_stereo_step
    jtrack.fused_stereo_step = fused.__wrapped__
    try:
        js, ts = JSystem(jcfg("stereo")), tsys.System(tcfg("stereo"), device="cpu")
        for i, (gl, gr) in enumerate(frames):
            js.track_stereo(gl, gr, i / 30.0)
            ts.track_stereo(gl, gr, i / 30.0)
        js.shutdown()
        ts.shutdown()
    finally:
        jtrack.fused_stereo_step = fused
    return js, ts, poses


def mono_frames():
    planes = synthetic.default_room(seed=11)
    poses = synthetic.orbit_trajectory(30, radius=0.35, advance=0.15)[:N_MONO]
    return [synthetic.render(planes, T, **RENDER)[0] for T in poses], poses


@pytest.fixture(scope="module")
def mono_runs():
    frames, poses = mono_frames()
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

    jinit.initialize_two_view, tsys.initialize_two_view = recording, fed
    try:
        js, ts = JSystem(jcfg("mono")), tsys.System(tcfg("mono"), device="cpu")
        for i, g in enumerate(frames):
            js.track_monocular(g, i / 30.0)
            ts.track_monocular(g, i / 30.0)
        js.shutdown()
        ts.shutdown()
    finally:
        jinit.initialize_two_view, tsys.initialize_two_view = orig_j, orig_t
    assert len(draws) >= 1
    return js, ts, poses


def check_parity(js, ts, n, sensor):
    mj, mt = js.map, ts.map
    np.testing.assert_array_equal(mt.kf_frame_id[: mt.n_kfs], mj.kf_frame_id[: mj.n_kfs])
    assert mt.n_kfs >= 2
    pj, pt = np.asarray(js.poses_np()), np.asarray(ts.poses_np())
    assert pt.shape == pj.shape == (n, 4, 4)
    gap = np.abs(pt - pj).max(axis=(1, 2))
    assert gap.max() < TOL[sensor], gap
    assert mt.n_pts == mj.n_pts and int(mt.pt_alive.sum()) == int(mj.pt_alive.sum())
    assert len(ts.stats) == len(js.stats) == n
    for a, b in zip(ts.stats, js.stats):
        assert a["kf"] == b["kf"], (a, b)
        assert abs(a["matches"] - b["matches"]) <= 2 and abs(a["inliers"] - b["inliers"]) <= 2
    assert ts.state.name == js.state.name == "OK"


def test_stereo_system_matches_jax(stereo_runs):
    js, ts, poses = stereo_runs
    check_parity(js, ts, N_STEREO, "stereo")
    assert ts.stats[0]["kf"]                                  # initialized at frame 0
    ate = evaluate.ate_rmse(evaluate.positions_from_cw(np.asarray(ts.poses_np())),
                            evaluate.positions_from_cw(np.asarray(poses)))
    assert ate < 0.02, ate                                    # tests/test_stereo_mono_e2e.py
    assert min(s["inliers"] for s in ts.stats[1:]) > 50


def mono_ate(slam, poses):
    init = next(i for i, s in enumerate(slam.stats) if s.get("kf"))
    est = np.asarray(slam.poses_np())[init:]
    return init, evaluate.ate_rmse(evaluate.positions_from_cw(est),
                                   evaluate.positions_from_cw(np.asarray(poses)[init:]),
                                   with_scale=True)


def test_mono_system_matches_jax(mono_runs):
    js, ts, poses = mono_runs
    check_parity(js, ts, N_MONO, "mono")
    init_j, _ = mono_ate(js, poses)
    init_t, ate = mono_ate(ts, poses)
    assert init_t == init_j
    assert ate < 0.05, ate
    assert ts.map.n_pts > 100
    assert ts._last_pid is not None and ts._last_pid.shape == (ORB["max_kpts"],)


def test_mono_system_own_draw(mono_runs):
    js, _, poses = mono_runs
    frames, _ = mono_frames()
    ts = tsys.System(tcfg("mono"), device="cpu")
    for i, g in enumerate(frames):
        ts.track_monocular(g, i / 30.0)
    init_t, ate = mono_ate(ts, poses)
    assert init_t == mono_ate(js, poses)[0]
    assert ts.state is TrackingState.OK and ts.map.n_kfs >= 2 and ts.map.n_pts > 100
    assert ate < 0.05, ate
    # a reset clears the monocular state, and the map starts over
    ts.reset()
    assert ts._mono_ref is None and ts._last_pid is None
    ts.track_monocular(frames[0], 1.0)
    assert ts.state is TrackingState.NOT_INITIALIZED and ts._mono_ref is not None

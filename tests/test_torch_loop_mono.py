"""The port's LoopCloser on a monocular map, against the JAX package's, on
the CPU at 320x240.

The map: JAX System(sensor="mono", deterministic=True) over an out-and-back
in default_room(seed=11) (orbit_trajectory(20, radius=0.35, advance=0.15)
forward, then reversed: tests/test_stereo_mono_e2e.py's mono motion), with
loop_consistency_th=99 so that the run closes no loop itself. Its scale is
the initializer's (median depth 1). The port gets the same map through
convert.slam_map_from, and both loop closers the same BoW database
(tests/test_torch_loop_closing.py's harness; the Sim3 RANSAC's draw is
recorded from JAX's jitted program and fed to the port).

What the monocular branches change, and what is held: the Sim3 RANSAC
solves for a free scale with an inlier threshold of 4% of the slot side's
median depth (``nanquantile(z, 0.5)``, the mean of the two middle values as
``jnp.nanmedian``), optimize_sim3 keeps the scale free, and the pose graph
solves with fix_scale=False. On the revisit pair (the last keyframe, back
at the start, with keyframe 0): the same accept, the loop edge's T_rel
within 1e-4 and its scale within 1e-4, keyframe poses within 1e-4 and
landmarks within 1e-3 after the correction and after the global BA drains
(the port's BA sums are f32 where JAX's are bf16 hi/lo); the threshold
itself equal to 1e-6.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.config import (CameraConfig as JCam, MapConfig as JMap, ORBConfig as JORB,
                                  SystemConfig as JSys, TrackingConfig as JTrk)
from amos_slam_tpu.loop import loop_closing as jlc
from amos_slam_tpu.system import System as JSystem
from amos_slam_tpu_torch import convert
from amos_slam_tpu_torch.config import (CameraConfig as TCam, MapConfig as TMap,
                                        ORBConfig as TORB, SystemConfig as TSys,
                                        TrackingConfig as TTrk)
from amos_slam_tpu_torch.io import synthetic
from amos_slam_tpu_torch.loop import loop_closing as tlc
from test_torch_loop_closing import Draws, same_map

CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2, width=320, height=240)
ORB = dict(n_features=500, n_levels=4, max_kpts=512)
MAP = dict(max_keyframes=32, max_points=8192, loop_consistency_th=99)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tcfg():
    return TSys(camera=TCam(**CAM), orb=TORB(**ORB), map=TMap(**MAP),
                tracking=TTrk(max_map_points_local=2048), use_dynamics=False,
                deterministic=True, sensor="mono")


@pytest.fixture(scope="module")
def run():
    planes = synthetic.default_room(seed=11)
    fwd = synthetic.orbit_trajectory(20, radius=0.35, advance=0.15)
    poses = fwd + fwd[::-1][1:]
    js = JSystem(JSys(camera=JCam(**CAM), orb=JORB(**ORB), map=JMap(**MAP),
                      tracking=JTrk(max_map_points_local=2048), use_dynamics=False,
                      deterministic=True, sensor="mono"))
    for i, T in enumerate(poses):
        js.track_monocular(synthetic.render(planes, T, **CAM)[0], i / 30.0)
    js.shutdown()
    assert js.state.name == "OK" and js.loop.loops_closed == []
    assert js.map.n_kfs >= 4
    return js


def pair(js):
    jm = copy.deepcopy(js.map)
    tm = convert.slam_map_from(jm, tcfg(), convert.camera_from_numpy(js.cam, "cpu"), "cpu")
    jl = jlc.LoopCloser(js.cfg, js.cam, js.loop.voc, jm)
    tl = tlc.LoopCloser(tcfg(), tm.cam, convert.vocabulary_from(js.loop.voc, device="cpu"), tm)
    for k in np.where(jm.kf_alive[: jm.n_kfs])[0]:
        wj = np.asarray(jl.bow_dispatch(int(k)))
        jl.db.add(int(k), wj[0].astype(np.int64), wj[1])
        tl.db.add(int(k), wj[0].astype(np.int64), wj[1])
    return jl, tl


def test_mono_threshold_is_the_median_depth_share(run):
    jl, tl = pair(run)
    slot = run.map.n_kfs - 1
    oj = jlc._loop_pairs_kernel(jl.map.arrays, jl.cam, jnp.asarray(slot, jnp.int32),
                                jnp.asarray(0, jnp.int32))
    ok, z = np.asarray(oj[1]), np.asarray(oj[2])[:, 2]
    assert ok.sum() >= 20
    zt = torch.where(torch.from_numpy(ok), torch.from_numpy(z), torch.nan)
    th_t = float(torch.clamp(0.04 * torch.nanquantile(zt, 0.5), min=1e-4))
    th_j = float(jnp.maximum(0.04 * jnp.nanmedian(jnp.where(ok, z, jnp.nan)), 1e-4))
    assert abs(th_t - th_j) < 1e-6


def test_mono_verify_and_correct(run, monkeypatch):
    draws = Draws(monkeypatch)
    jl, tl = pair(run)
    slot = run.map.n_kfs - 1
    okj = jl._verify_and_correct(slot, 0)
    okt = tl._verify_and_correct(slot, 0)
    assert okj and okt
    assert not draws.sim3
    (si, ci, Tj, sj), (st, ct, Tt, s_t) = jl.map.loop_edges[-1], tl.map.loop_edges[-1]
    assert (st, ct) == (si, ci) == (slot, 0)
    np.testing.assert_allclose(Tt, np.asarray(Tj), rtol=0, atol=1e-4)
    assert abs(s_t - sj) < 1e-4
    assert tl.fused_last_loop == jl.fused_last_loop
    same_map(jl.map, tl.map, 1e-4, 1e-3)
    jl.flush_gba()
    tl.flush_gba()
    same_map(jl.map, tl.map, 1e-4, 1e-3)

"""The port's System with its loop closer against the JAX package's, on the
CPU at 320x240 (use_dynamics=False; JAX runs System(deterministic=True)),
frame by frame on the same rendered frames: a run in which a loop closes
(here) and a relocalization run (test_torch_system_reloc.py, which uses
this file's helpers).

The loop run: the first 90 frames of OUT_AND_BACK below
(orbit_trajectory(60, radius=0.3, advance=3.5, yaw_amp=0.3) forward, then
reversed, in default_room(seed=7)), in which JAX's loop closer closes a loop
(loop_consistency_th=2, as tests/test_loop_pipeline.py:20-28 allows). The
way out runs 3.5 m toward the back wall, through the box face at z = 3 m,
where tracking at 320x240 drifts by decimetres (JAX: raw ATE 0.199 m), so
the way back builds landmarks of its own and the loop closer has a real
correction to make. Gates: the same
loops_closed, the same keyframes (frame ids), the corrected trajectories
within 5 mm of each other frame by frame, the port's corrected ATE no worse
than its raw track-time ATE + 1e-4 m, and every live observation on a live
landmark.

The draws: the JAX loop closer's Sim3 RANSAC runs in a jitted program that
also returns its draw and its relocalizer's PnP draws eagerly from the same
key; the port's are fed those draws (``sample_idx``) in the order JAX made
them. JAX resolves a keyframe's maintenance at the start of the next frame,
so its pending work is flushed after each frame, before the port's frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.config import (CameraConfig as JCam, MapConfig as JMap, ORBConfig as JORB,
                                  SystemConfig as JSys, TrackingConfig as JTrk)
from amos_slam_tpu.loop import loop_closing as jlc
from amos_slam_tpu.solvers import sim3_solver as jsol
from amos_slam_tpu.system import System as JSystem
from amos_slam_tpu_torch.config import (CameraConfig as TCam, MapConfig as TMap,
                                        ORBConfig as TORB, SystemConfig as TSys,
                                        TrackingConfig as TTrk)
from amos_slam_tpu_torch.io import evaluate, synthetic
from amos_slam_tpu_torch.loop import loop_closing as tlc
from amos_slam_tpu_torch.system import System, TrackingState

CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2, width=320, height=240)
ORB = dict(n_features=500, n_levels=4, max_kpts=512)
OUT_AND_BACK = dict(n=60, radius=0.3, advance=3.5, yaw_amp=0.3, seed=7)
FRAMES = 90    # of its 122: the loop closes at frame 89; shutdown drains its global BA


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**map_kw):
    kw = {"max_keyframes": 64, "max_points": 8192, **map_kw}
    j = JSys(camera=JCam(**CAM), orb=JORB(**ORB), map=JMap(**kw),
             tracking=JTrk(max_map_points_local=2048), use_dynamics=False, deterministic=True)
    t = TSys(camera=TCam(**CAM), orb=TORB(**ORB), map=TMap(**kw),
             tracking=TTrk(max_map_points_local=2048), use_dynamics=False, deterministic=True)
    return j, t


def run_pair(frames, jcfg, tcfg, monkeypatch, localize_from=None, chunk=0):
    """Both Systems frame by frame, JAX's draws fed to the port; from frame
    ``localize_from`` on, both in localization mode. With ``chunk`` = W,
    both run track_rgbd_chunk in chunks of W instead: JAX's pending work
    is flushed after every call, and a chunk that JAX would track frame by
    frame (before initialization, or not OK) is fed to it frame by frame,
    each frame flushed (tests/test_torch_system_chunk_parity.py)."""
    sim3, pnp = [], []
    orig_pnp, orig_tsim3, orig_tpnp = jlc.ransac_pnp, tlc.ransac_sim3, tlc.ransac_pnp

    def jax_sim3(p1, p2, valid, key, n_hyp=128, inlier_th=0.06, min_inliers=12,
                 fix_scale=True):
        def run(p1, p2, valid, key, th):
            probs = valid.astype(jnp.float32)
            probs = probs / jnp.maximum(probs.sum(), 1.0)
            idx = jax.random.choice(key, p1.shape[0], shape=(n_hyp, 3), p=probs)
            return jsol.ransac_sim3.__wrapped__(
                p1, p2, valid, key, n_hyp=n_hyp, inlier_th=th, min_inliers=min_inliers,
                fix_scale=fix_scale), idx
        res, idx = jax.jit(run)(p1, p2, valid, key, jnp.asarray(inlier_th))
        sim3.append(np.asarray(idx))
        return res

    def jax_pnp(cam, pts_w, uv, valid, key, n_hyp=512, sample=6, **kw):
        probs = valid.astype(jnp.float32)
        probs = probs / jnp.maximum(probs.sum(), 1.0)
        pnp.append(np.asarray(jax.random.choice(key, pts_w.shape[0], shape=(n_hyp, sample),
                                                p=probs)))
        return orig_pnp(cam, pts_w, uv, valid, key, n_hyp=n_hyp, sample=sample, **kw)

    def port_sim3(*args, **kw):
        return orig_tsim3(*args, sample_idx=torch.from_numpy(sim3.pop(0)), **kw)

    def port_pnp(*args, **kw):
        return orig_tpnp(*args, sample_idx=torch.from_numpy(pnp.pop(0)), **kw)

    monkeypatch.setattr(jlc, "ransac_sim3", jax_sim3)
    monkeypatch.setattr(jlc, "ransac_pnp", jax_pnp)
    monkeypatch.setattr(tlc, "ransac_sim3", port_sim3)
    monkeypatch.setattr(tlc, "ransac_pnp", port_pnp)
    js, ts = JSystem(jcfg), System(tcfg, device="cpu")
    if chunk:
        g = np.stack([f[0] for f in frames])
        d = np.stack([f[1] for f in frames])
        for c in range(0, len(frames), chunk):
            stamps = [i / 30.0 for i in range(c, min(c + chunk, len(frames)))]
            if js.state.name != "OK":
                for i, t in enumerate(stamps):
                    js.track_rgbd(g[c + i], d[c + i], t)
                    js._flush_pending()
            else:
                js.track_rgbd_chunk(g[c: c + chunk], d[c: c + chunk], stamps)
                js._flush_pending()
            ts.track_rgbd_chunk(g[c: c + chunk], d[c: c + chunk], stamps)
            assert not sim3 and not pnp, f"chunk {c}: the port made fewer draws than JAX"
    for i, (g, d) in enumerate([] if chunk else frames):
        if i == localize_from:
            js.activate_localization_mode()
            ts.activate_localization_mode()
        js.track_rgbd(g, d, i / 30.0)
        js._flush_pending()
        ts.track_rgbd(g, d, i / 30.0)
        assert not sim3 and not pnp, f"frame {i}: the port made fewer draws than JAX"
    js.shutdown()
    ts.shutdown()
    monkeypatch.undo()   # later calls draw with their own keys / generators
    return js, ts


def ate(est, poses, keep=None):
    keep = range(len(poses)) if keep is None else keep
    return evaluate.ate_rmse(evaluate.positions_from_cw(np.asarray(est)[keep]),
                             evaluate.positions_from_cw(np.asarray(poses)[keep]))


def test_loop_closes_as_in_jax(monkeypatch):
    spec = dict(OUT_AND_BACK)
    planes = synthetic.default_room(seed=spec.pop("seed"))
    poses = synthetic.out_and_back(spec.pop("n"), **spec)[:FRAMES]
    frames = [synthetic.render(planes, T, **CAM) for T in poses]
    js, ts = run_pair(frames, *configs(loop_consistency_th=2), monkeypatch)
    assert js.loop.loops_closed, "the fixture lost its loop"
    assert ts.loop.loops_closed == js.loop.loops_closed
    mj, mt = js.map, ts.map
    np.testing.assert_array_equal(mt.kf_frame_id[: mt.n_kfs], mj.kf_frame_id[: mj.n_kfs])
    cj, ct = np.asarray(js.corrected_poses_np()), np.asarray(ts.corrected_poses_np())
    dpos = np.linalg.norm(evaluate.positions_from_cw(cj) - evaluate.positions_from_cw(ct), axis=1)
    assert dpos.max() < 5e-3, dpos.max()
    assert ate(ct, poses) <= ate(ts.poses_np(), poses) + 1e-4
    obs = mt.kf_obs_np[: mt.n_kfs]
    assert mt.pt_alive[obs[obs >= 0]].all()
    assert ts.state is TrackingState.OK


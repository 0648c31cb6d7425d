"""Port parity: the fused frame step / chunk scan and the whole System
(RGB-D, no dynamics) against the JAX package.

Setup: 320x240 synthetic room, 4 levels, 500 features, max_kpts 512,
MapConfig(max_keyframes=32, max_points=8192), max_map_points_local 2048,
the 18 frames of orbit_trajectory(18, radius=0.15, advance=0.3) plus 4 more
for the step tests. JAX runs System(deterministic=True, use_dynamics=False):
each frame's supervision resolves before the next, as the port's per-frame
path always does. Tolerances:

* fused_frame_step and fused_frame_scan (W=3) on identical converted state
  (map, view, last features, pose, velocity): Tcw within 1e-4, the sup
  counts exact. The images go through each package's own ORB front end.
* System: the JAX run closes no loop (so its map is the one the port
  builds); the same keyframe frames; map sizes within 2%; poses within
  5 mm / 0.2 deg frame by frame; corrected_poses_np ATE < 1.5 cm for each
  package and within 2 mm of each other.
"""

import numpy as np
import pytest
import torch

from amos_slam_tpu.config import (CameraConfig as JCam, MapConfig as JMap,
                                  ORBConfig as JORB, SystemConfig as JSys,
                                  TrackingConfig as JTrk)
from amos_slam_tpu.frontend import tracking as jtrack
from amos_slam_tpu.system import System as JSystem
from amos_slam_tpu_torch import convert
from amos_slam_tpu_torch.config import (CameraConfig as TCam, MapConfig as TMap,
                                        ORBConfig as TORB, SystemConfig as TSys,
                                        TrackingConfig as TTrk)
from amos_slam_tpu_torch.frontend import tracking as ttrack
from amos_slam_tpu_torch.frontend.features import FrameFeatures
from amos_slam_tpu_torch.io import evaluate, synthetic
from amos_slam_tpu_torch.slam_map.slam_map import LocalView
from amos_slam_tpu_torch.system import System as TSystem

CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2,
           width=320, height=240)
ORB = dict(n_features=500, n_levels=4, max_kpts=512)
MAP = dict(max_keyframes=32, max_points=8192)
N_RUN = 18


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these eager runs launch many small ops, and
    tier-1 runs several test files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jcfg(**kw):
    return JSys(camera=JCam(**CAM), orb=JORB(**ORB), map=JMap(**MAP),
                tracking=JTrk(max_map_points_local=2048), use_dynamics=False, **kw)


def tcfg(**kw):
    return TSys(camera=TCam(**CAM), orb=TORB(**ORB), map=TMap(**MAP),
                tracking=TTrk(max_map_points_local=2048), use_dynamics=False, **kw)


@pytest.fixture(scope="module")
def sequence():
    planes = synthetic.default_room(seed=1)
    poses = synthetic.orbit_trajectory(N_RUN + 4, radius=0.15, advance=0.3)
    frames = [synthetic.render(planes, T, fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"],
                               cy=CAM["cy"], width=320, height=240) for T in poses]
    return poses, frames


@pytest.fixture(scope="module")
def runs(sequence):
    _, frames = sequence
    js = JSystem(jcfg(deterministic=True))
    ts = TSystem(tcfg(deterministic=True), device="cpu")
    for i, (g, d) in enumerate(frames[:N_RUN]):
        js.track_rgbd(g, d, i / 30.0)
        ts.track_rgbd(g, d, i / 30.0)
    js.shutdown()
    ts.shutdown()
    return js, ts


def ate(est, poses):
    return evaluate.ate_rmse(evaluate.positions_from_cw(np.asarray(est)),
                             evaluate.positions_from_cw(np.asarray(poses[: len(est)])))


def test_system_matches_jax(runs, sequence):
    poses, _ = sequence
    js, ts = runs
    assert js.loop.loops_closed == []
    mj, mt = js.map, ts.map
    # keyframe decisions: no decision of this run sits at a threshold, so
    # the keyframe frames are identical
    np.testing.assert_array_equal(mt.kf_frame_id[: mt.n_kfs], mj.kf_frame_id[: mj.n_kfs])
    assert mt.n_kfs >= 2
    assert abs(mt.n_pts - mj.n_pts) <= 0.02 * mj.n_pts, (mt.n_pts, mj.n_pts)
    alive_j, alive_t = int(mj.pt_alive.sum()), int(mt.pt_alive.sum())
    assert abs(alive_t - alive_j) <= 0.02 * alive_j, (alive_t, alive_j)

    pj, pt = np.asarray(js.poses_np()), np.asarray(ts.poses_np())
    assert pt.shape == pj.shape == (N_RUN, 4, 4)
    dpos = np.linalg.norm(evaluate.positions_from_cw(pj) - evaluate.positions_from_cw(pt), axis=1)
    assert dpos.max() < 5e-3, dpos
    rel = np.einsum("nij,nkj->nik", pj[:, :3, :3], pt[:, :3, :3])
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    assert np.degrees(np.arccos(cos)).max() < 0.2

    aj, at = ate(js.corrected_poses_np(), poses), ate(ts.corrected_poses_np(), poses)
    assert aj < 0.015 and at < 0.015, (aj, at)
    assert abs(aj - at) < 2e-3, (aj, at)
    assert min(s["inliers"] for s in ts.stats[1:]) > 50


def _converted_state(js):
    """The JAX System's tracking state, as the port's tensors."""
    view = js.map.local_view(js.ref_kf)
    return (view, convert.tree_from_numpy(LocalView, view, "cpu"),
            convert.tree_from_numpy(FrameFeatures, js.last_feats, "cpu"),
            torch.from_numpy(np.array(js.last_Tcw, np.float32)),
            torch.from_numpy(np.array(js.velocity, np.float32)))


def test_fused_frame_step_and_scan(runs, sequence):
    _, frames = sequence
    js, ts = runs
    view_j, view, last, T, vel = _converted_state(js)
    r_mm, r_map = torch.tensor(15.0), torch.tensor(6.0)
    g, d = frames[N_RUN]
    rj = jtrack.fused_frame_step(js.pipeline, g, d, js.last_feats, js.last_Tcw,
                                 js.velocity, view_j, js._r_mm, js._r_map, min_lm=30)
    rt = ttrack.fused_frame_step(ts.pipeline, torch.from_numpy(g), torch.from_numpy(d),
                                 last, T, vel, view, r_mm, r_map, min_lm=30)
    np.testing.assert_array_equal(rt.sup.numpy(), np.asarray(rj.sup))
    assert int(rt.sup[1]) > 100
    np.testing.assert_allclose(rt.Tcw.numpy(), np.asarray(rj.Tcw), atol=1e-4)
    np.testing.assert_allclose(rt.velocity.numpy(), np.asarray(rj.velocity), atol=1e-4)

    gs = np.stack([f[0] for f in frames[N_RUN + 1:]])
    ds = np.stack([f[1] for f in frames[N_RUN + 1:]])
    cj = jtrack.fused_frame_scan(js.pipeline, gs, ds, rj.feats, rj.Tcw, rj.velocity,
                                 view_j, js._r_mm, js._r_map, min_lm=30,
                                 stats_acc=rj.stats_acc)
    ct = ttrack.fused_frame_scan(
        ts.pipeline, torch.from_numpy(gs), torch.from_numpy(ds),
        convert.tree_from_numpy(FrameFeatures, rj.feats, "cpu"),
        torch.from_numpy(np.array(rj.Tcw)), torch.from_numpy(np.array(rj.velocity)),
        view, r_mm, r_map, min_lm=30, stats_acc=torch.from_numpy(np.array(rj.stats_acc)))
    np.testing.assert_array_equal(ct.ys.sup.numpy(), np.asarray(cj.ys.sup))
    np.testing.assert_allclose(ct.ys.Tcw.numpy(), np.asarray(cj.ys.Tcw), atol=1e-4)
    assert ct.ys.Tcw.shape == (3, 4, 4) and ct.ys.sup_heavy.shape == (3, 3 * ORB["max_kpts"])
    # the stats accumulator: the same per-row counts where the packages
    # saw the same visibility (exact here)
    np.testing.assert_array_equal(ct.stats_acc.numpy(), np.asarray(cj.stats_acc))

"""The port's System with the geometric dynamic stage (use_dynamics=True)
against the JAX package, on the CPU at 320x240.

Setup: 4 levels, 500 features, max_kpts 512, MapConfig(max_keyframes=32,
max_points=8192), max_map_points_local 2048, the DynamicsConfig defaults;
the first 16 frames of the room_with_mover(seed=1, speed=1.5) sequence of
tests/test_dynamic_slam_e2e.py (orbit_trajectory(24, radius=0.1,
advance=0.2)), rendered with the camera halved. JAX runs
System(deterministic=True): each frame's supervision resolves before the
next, as the port's per-frame path always does.

The port cannot reproduce jax.random, and PnP wins the arbitration on
frames 1 and 6 of this run (frame 1 predicts with the identity velocity),
where the draw decides T_used. So the JAX System's compute_dynamics is
traced with ransac_pnp wrapped to report its draw, and the port's
compute_dynamics gets that draw as ``pnp_sample_idx`` (nothing in either
package changes); both record ``used_pnp`` per frame. The JAX run closes no
loop. Gates: used_pnp equal frame by frame; the same keyframe frames; poses
within 5 mm / 0.2 deg frame by frame; corrected ATE < 3 cm for each package
and within 2 mm of each other; the carried gate levels within 2% (measured
0.85% after 15 frames: the EMA integrates cluster medians of residuals
under poses that differ by microns to a millimetre; on identical inputs
tests/test_torch_dynamics.py holds them to 1e-4) and the geometric mask
equal on >= 99.5%.

The slice end to end: each package's Segmenter (the full-depth 128-px net
of tests/test_torch_segmenter.py, f32, identical weights) makes stage-one
masks from the first 8 grey frames as RGB, and each package's System takes
its own masks, per frame, with the JAX draws fed as above. Gates: masks
>= 99.9% equal per frame and non-trivial, used_pnp equal,
the same keyframes, poses within 5 mm / 0.2 deg.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amos_slam_tpu.system as jsys_mod
import amos_slam_tpu_torch.system as tsys_mod
from amos_slam_tpu.config import (CameraConfig as JCam, MapConfig as JMap,
                                  ORBConfig as JORB, SystemConfig as JSys,
                                  TrackingConfig as JTrk)
from amos_slam_tpu.frontend import dynamics as jdyn
from amos_slam_tpu.models.port_torch import port_state_dict
from amos_slam_tpu.models.segmenter import Segmenter as JSegmenter
from amos_slam_tpu_torch.config import (CameraConfig as TCam, MapConfig as TMap,
                                        ORBConfig as TORB, SystemConfig as TSys,
                                        TrackingConfig as TTrk)
from amos_slam_tpu_torch.io import evaluate, synthetic
from amos_slam_tpu_torch.models.segmenter import Segmenter
from amos_slam_tpu_torch.system import System

CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2, width=320, height=240)
ORB = dict(n_features=500, n_levels=4, max_kpts=512)
MAP = dict(max_keyframes=32, max_points=8192)
N_PARITY = 16


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
                tracking=JTrk(max_map_points_local=2048), **kw)


def tcfg(**kw):
    kw.setdefault("use_dynamics", True)
    return TSys(camera=TCam(**CAM), orb=TORB(**ORB), map=TMap(**MAP),
                tracking=TTrk(max_map_points_local=2048), **kw)


@pytest.fixture(scope="module")
def sequence():
    n = 24
    poses = synthetic.orbit_trajectory(n, radius=0.1, advance=0.2)
    frames = []
    for i in range(n):
        planes, mover = synthetic.room_with_mover(seed=1, t=i / 30.0, speed=1.5)
        planes[mover].chroma = (1.6, 0.85, 0.55)
        g, d, ids, rgb = synthetic.render(planes, poses[i], return_ids=True, return_rgb=True,
                                          **CAM)
        frames.append((g, d, ids == mover, rgb))
    return poses, frames


STATIC = ("n_clusters", "slic_cell", "slic_iters", "dilate_radius", "has_seg",
          "slic_downsample", "lk_levels", "lk_win", "lk_iters", "pnp_hypotheses",
          "lk_downsample")


def run_pair(frames, n, masks=(None, None)):
    """Both Systems over frames[:n], per frame, each with its own stage-one
    masks (JAX's, the port's) if given. The JAX System's compute_dynamics
    is traced afresh with ransac_pnp wrapped to report its draw; the port's
    compute_dynamics is wrapped to take that draw as ``pnp_sample_idx``.
    Both record ``used_pnp`` per call."""
    draws, used = [], {"jax": [], "port": []}
    orig_pnp, orig_j, orig_t = jdyn.ransac_pnp, jsys_mod.compute_dynamics, tsys_mod.compute_dynamics

    def recording_pnp(cam, pts_w, uv, valid, key, n_hyp=512, **kw):
        probs = valid.astype(jnp.float32)
        probs = probs / jnp.maximum(probs.sum(), 1.0)
        idx = jax.random.choice(key, pts_w.shape[0], shape=(n_hyp, 6), p=probs)
        jax.debug.callback(lambda i: draws.append(np.asarray(i)), idx)
        return orig_pnp(cam, pts_w, uv, valid, key, n_hyp=n_hyp, **kw)

    def fresh(*args, **kwargs):   # a new function: no cached trace applies
        return orig_j.__wrapped__(*args, **kwargs)

    jit_fresh = jax.jit(fresh, static_argnames=STATIC)

    def jax_dyn(*args, **kwargs):
        res = jit_fresh(*args, **kwargs)
        used["jax"].append(res.used_pnp)
        return res

    def port_dyn(*args, **kwargs):
        jax.effects_barrier()
        assert len(draws) == len(used["port"]) + 1
        res = orig_t(*args, pnp_sample_idx=torch.from_numpy(np.array(draws[-1])).long(), **kwargs)
        used["port"].append(res.used_pnp)
        return res

    jdyn.ransac_pnp, jsys_mod.compute_dynamics, tsys_mod.compute_dynamics = (
        recording_pnp, jax_dyn, port_dyn)
    jm, tm = masks
    try:
        js = jsys_mod.System(jcfg(use_dynamics=True, deterministic=True))
        ts = System(tcfg(deterministic=True), device="cpu")
        for i, (g, d, _, _) in enumerate(frames[:n]):
            js.track_rgbd(g, d, i / 30.0, seg_mask=None if jm is None else jm[i])
            ts.track_rgbd(g, d, i / 30.0, seg_mask=None if tm is None else tm[i])
        js.shutdown()
        ts.shutdown()
    finally:
        jdyn.ransac_pnp, jsys_mod.compute_dynamics, tsys_mod.compute_dynamics = (
            orig_pnp, orig_j, orig_t)
    return js, ts, {k: [bool(np.asarray(u)) for u in v] for k, v in used.items()}


@pytest.fixture(scope="module")
def runs(sequence):
    _, frames = sequence
    return run_pair(frames, N_PARITY)


def ate(est, poses):
    return evaluate.ate_rmse(evaluate.positions_from_cw(np.asarray(est)),
                             evaluate.positions_from_cw(np.asarray(poses[: len(est)])))


def test_system_with_dynamics_matches_jax(runs, sequence):
    poses, _ = sequence
    js, ts, used = runs
    assert js.loop.loops_closed == []
    # the stage ran on every frame after the first in both packages, and
    # PnP won the arbitration on the same frames: frame 1 (the first
    # prediction is the identity velocity) and frame 6
    assert len(used["jax"]) == N_PARITY - 1
    assert used["port"] == used["jax"]
    assert [i + 1 for i, u in enumerate(used["jax"]) if u] == [1, 6], used
    mj, mt = js.map, ts.map
    np.testing.assert_array_equal(mt.kf_frame_id[: mt.n_kfs], mj.kf_frame_id[: mj.n_kfs])
    assert mt.n_kfs >= 2
    pj, pt = np.asarray(js.poses_np()), np.asarray(ts.poses_np())
    assert pt.shape == pj.shape == (N_PARITY, 4, 4)
    dpos = np.linalg.norm(evaluate.positions_from_cw(pj) - evaluate.positions_from_cw(pt), axis=1)
    assert dpos.max() < 5e-3, dpos
    rel = np.einsum("nij,nkj->nik", pj[:, :3, :3], pt[:, :3, :3])
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    assert np.degrees(np.arccos(cos)).max() < 0.2
    aj, at = ate(js.corrected_poses_np(), poses), ate(ts.corrected_poses_np(), poses)
    assert aj < 0.03 and at < 0.03, (aj, at)
    assert abs(aj - at) < 2e-3, (aj, at)
    # the carried state: the EMA gate levels and the last geometric mask
    np.testing.assert_allclose(ts._dyn_gates.numpy(), np.asarray(js._dyn_gates), rtol=2e-2,
                               atol=1e-4)
    assert (ts._dyn_mask.numpy() == np.asarray(js._dyn_mask)).mean() >= 0.995


N_SEG = 8


@pytest.fixture(scope="module")
def seg_runs(sequence):
    """The slice end to end: each package's Segmenter (the full-depth 128-px
    net of tests/test_torch_segmenter.py, f32, the port's seeded random
    weights carried to JAX) turns the grey frames, replicated to RGB, into
    stage-one masks that its own System takes, per frame."""
    _, frames = sequence
    kw = dict(num_classes=5, person_classes=(0, 1, 2, 3), score_th=0.0, img_size=128)
    ts = Segmenter(compute_dtype=torch.float32, device="cpu", **kw)
    js = JSegmenter(port_state_dict(ts.model.state_dict()), compute_dtype=jnp.float32, **kw)
    rgbs = np.stack([np.repeat(np.clip(g, 0, 255).astype(np.uint8)[..., None], 3, axis=-1)
                     for g, _, _, _ in frames[:N_SEG]])
    masks = (np.asarray(js.person_mask_batch(rgbs)), ts.person_mask_batch(rgbs))
    return masks, run_pair(frames, N_SEG, masks)


def test_segmenter_fed_system_matches_jax(seg_runs):
    (jm, tm), (js, ts, used) = seg_runs
    tm = tm.numpy()
    assert tm.shape == jm.shape == (N_SEG, 240, 320) and tm.dtype == bool
    for j, t in zip(jm, tm):
        assert (j == t).mean() >= 0.999
    assert 0.01 < tm.mean() < 0.99
    assert used["port"] == used["jax"]
    mj, mt = js.map, ts.map
    np.testing.assert_array_equal(mt.kf_frame_id[: mt.n_kfs], mj.kf_frame_id[: mj.n_kfs])
    pj, pt = np.asarray(js.poses_np()), np.asarray(ts.poses_np())
    assert pt.shape == pj.shape == (N_SEG, 4, 4)
    dpos = np.linalg.norm(evaluate.positions_from_cw(pj) - evaluate.positions_from_cw(pt), axis=1)
    assert dpos.max() < 5e-3, dpos
    rel = np.einsum("nij,nkj->nik", pj[:, :3, :3], pt[:, :3, :3])
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    assert np.degrees(np.arccos(cos)).max() < 0.2

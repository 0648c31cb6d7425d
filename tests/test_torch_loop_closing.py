"""The port's LoopCloser and global BA against the JAX package's on one map,
on the CPU at 320x240.

The map: JAX System(deterministic=True, use_dynamics=False) over an
out-and-back sweep in default_room(seed=29) (orbit_trajectory(30,
radius=0.5, advance=1.6, yaw_amp=0.25) forward, then reversed), with
loop_consistency_th=99 so that the run itself closes no loop; the port's
map is the same state, carried across by convert.slam_map_from. Each test
works on fresh copies. Both loop closers get the same BoW database.

The draws: the JAX Sim3 RANSAC runs in a jitted program that also returns
its draw, and the relocalizer's PnP draws eagerly from the same key; the
port's ransac_sim3 / ransac_pnp are fed those draws as ``sample_idx``.

Gates: the pairs equal (3D within 1e-5); _verify_and_correct on the true
revisit pair (the last keyframe, back at the start, and keyframe 0): the
same accept, T_rel / s_rel within 1e-4, the same loop edge, keyframe poses
after the pose graph within 1e-4, landmarks within 1e-3 (the port's BA sums
are f32 where JAX's are bf16 hi/lo), the same fused count and observation
tables, and after the global BA drains, poses 1e-4 and landmarks 1e-3; a
wrong candidate is rejected with the map untouched; relocalize gives the
same (Tcw within 1e-4, inliers); the global BA's step / abort / finish and
the merge of keyframes inserted during the solve; remap_slots.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.config import (CameraConfig as JCam, MapConfig as JMap, ORBConfig as JORB,
                                  SystemConfig as JSys, TrackingConfig as JTrk)
from amos_slam_tpu.loop import global_ba as jgba
from amos_slam_tpu.loop import loop_closing as jlc
from amos_slam_tpu.solvers import sim3_solver as jsol
from amos_slam_tpu.system import System as JSystem
from amos_slam_tpu_torch import convert
from amos_slam_tpu_torch.config import (CameraConfig as TCam, MapConfig as TMap,
                                        ORBConfig as TORB, SystemConfig as TSys,
                                        TrackingConfig as TTrk)
from amos_slam_tpu_torch.frontend.features import FrameFeatures
from amos_slam_tpu_torch.io import synthetic
from amos_slam_tpu_torch.loop import global_ba as tgba
from amos_slam_tpu_torch.loop import loop_closing as tlc

CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2, width=320, height=240)
ORB = dict(n_features=500, n_levels=4, max_kpts=512)
MAP = dict(max_keyframes=32, max_points=8192, loop_consistency_th=99)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jcfg():
    return JSys(camera=JCam(**CAM), orb=JORB(**ORB), map=JMap(**MAP),
                tracking=JTrk(max_map_points_local=2048), use_dynamics=False,
                deterministic=True)


def tcfg():
    return TSys(camera=TCam(**CAM), orb=TORB(**ORB), map=TMap(**MAP),
                tracking=TTrk(max_map_points_local=2048), use_dynamics=False,
                deterministic=True)


def out_and_back(n=30):
    fwd = synthetic.orbit_trajectory(n, radius=0.5, advance=1.6, yaw_amp=0.25)
    return fwd + fwd[::-1][1:]


def render(planes, T):
    return synthetic.render(planes, T, **CAM)


# -- the draws ---------------------------------------------------------------

class Draws:
    """JAX's Sim3-RANSAC and PnP draws, recorded as they are made and fed to
    the port's in the same order."""

    def __init__(self, monkeypatch):
        self.sim3, self.pnp = [], []
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
            self.sim3.append(np.asarray(idx))
            return res

        def jax_pnp(cam, pts_w, uv, valid, key, n_hyp=512, sample=6, **kw):
            probs = valid.astype(jnp.float32)
            probs = probs / jnp.maximum(probs.sum(), 1.0)
            self.pnp.append(np.asarray(jax.random.choice(
                key, pts_w.shape[0], shape=(n_hyp, sample), p=probs)))
            return orig_pnp(cam, pts_w, uv, valid, key, n_hyp=n_hyp, sample=sample, **kw)

        def port_sim3(*args, **kw):
            return orig_tsim3(*args, sample_idx=torch.from_numpy(self.sim3.pop(0)), **kw)

        def port_pnp(*args, **kw):
            return orig_tpnp(*args, sample_idx=torch.from_numpy(self.pnp.pop(0)), **kw)

        monkeypatch.setattr(jlc, "ransac_sim3", jax_sim3)
        monkeypatch.setattr(jlc, "ransac_pnp", jax_pnp)
        monkeypatch.setattr(tlc, "ransac_sim3", port_sim3)
        monkeypatch.setattr(tlc, "ransac_pnp", port_pnp)


# -- the shared map ----------------------------------------------------------

@pytest.fixture(scope="module")
def run():
    planes = synthetic.default_room(seed=29)
    poses = out_and_back()
    js = JSystem(jcfg())
    for i, T in enumerate(poses):
        js.track_rgbd(*render(planes, T), i / 30.0)
    js.shutdown()
    assert js.loop.loops_closed == []
    assert js.map.n_kfs >= 5
    return planes, poses, js


def pair(run):
    """Fresh (JAX, port) loop closers over copies of the run's map, with the
    same BoW database."""
    _, _, js = run
    jm = copy.deepcopy(js.map)
    tm = convert.slam_map_from(jm, tcfg(), convert.camera_from_numpy(js.cam, "cpu"), "cpu")
    jl = jlc.LoopCloser(js.cfg, js.cam, js.loop.voc, jm)
    tl = tlc.LoopCloser(tcfg(), tm.cam, convert.vocabulary_from(js.loop.voc, device="cpu"), tm)
    for k in np.where(jm.kf_alive[: jm.n_kfs])[0]:
        wj = np.asarray(jl.bow_dispatch(int(k)))
        wt = tl.bow_dispatch(int(k)).numpy()
        np.testing.assert_array_equal(wt, wj)
        jl.db.add(int(k), wj[0].astype(np.int64), wj[1])
        tl.db.add(int(k), wt[0].astype(np.int64), wt[1])
    return jl, tl


def same_map(jm, tm, pose_tol, pt_tol):
    K = jm.n_kfs
    assert tm.n_kfs == K and tm.n_pts == jm.n_pts and tm.version == jm.version
    np.testing.assert_allclose(tm.arrays.kf_pose[:K].numpy(), np.asarray(jm.arrays.kf_pose[:K]),
                               rtol=0, atol=pose_tol)
    alive = np.where(jm.pt_alive)[0]
    np.testing.assert_allclose(tm.arrays.pt_pos.numpy()[alive],
                               np.asarray(jm.arrays.pt_pos)[alive], rtol=0, atol=pt_tol)
    np.testing.assert_array_equal(tm.kf_obs_np[:K], jm.kf_obs_np[:K])
    np.testing.assert_array_equal(tm.arrays.kf_obs[:K].numpy(), np.asarray(jm.arrays.kf_obs[:K]))
    np.testing.assert_array_equal(tm.pt_alive, jm.pt_alive)
    np.testing.assert_array_equal(tm.pt_obs_count, jm.pt_obs_count)
    np.testing.assert_array_equal(tm.covis, jm.covis)


def revisit(run):
    _, _, js = run
    return js.map.n_kfs - 1, 0


def test_loop_pairs_equal(run):
    jl, tl = pair(run)
    slot, cand = revisit(run)
    oj = jlc._loop_pairs_kernel(jl.map.arrays, jl.cam, jnp.asarray(slot, jnp.int32),
                                jnp.asarray(cand, jnp.int32))
    ot = tlc._loop_pairs_kernel(tl.map.arrays, tl.cam, slot, cand)
    np.testing.assert_array_equal(ot[0].numpy(), np.asarray(oj[0]))
    np.testing.assert_array_equal(ot[1].numpy(), np.asarray(oj[1]))
    assert int(ot[1].sum()) >= 40
    ok = np.asarray(oj[1])
    for a, b in zip(oj[2:], ot[2:]):
        np.testing.assert_allclose(b.numpy()[ok], np.asarray(a)[ok], rtol=0, atol=1e-5)


def test_verify_and_correct_true_revisit(run, monkeypatch):
    draws = Draws(monkeypatch)
    jl, tl = pair(run)
    slot, cand = revisit(run)
    okj = jl._verify_and_correct(slot, cand)
    okt = tl._verify_and_correct(slot, cand)
    assert okj and okt
    assert not draws.sim3
    (si, ci, Tj, sj), (st, ct, Tt, s_t) = jl.map.loop_edges[-1], tl.map.loop_edges[-1]
    assert (st, ct) == (si, ci) == (slot, cand)
    np.testing.assert_allclose(Tt, np.asarray(Tj), rtol=0, atol=1e-4)
    assert abs(s_t - sj) < 1e-4
    assert tl.fused_last_loop == jl.fused_last_loop
    assert tl.rejected_by_gate == jl.rejected_by_gate == 0
    # the state right after the correction (the global BA's first phase
    # has run but not been applied)
    same_map(jl.map, tl.map, 1e-4, 1e-3)
    assert jl.gba is not None and tl.gba is not None
    jl.flush_gba()
    tl.flush_gba()
    same_map(jl.map, tl.map, 1e-4, 1e-3)


def test_wrong_candidate_rejected(run, monkeypatch):
    """A keyframe facing the opposite way offered keyframe 0 as its loop:
    some stage of the cascade rejects it in both, and the map is as it was."""
    Draws(monkeypatch)
    planes, poses, js = run
    jl, tl = pair(run)
    yaw180 = np.diag([-1.0, 1.0, -1.0, 1.0])
    T_back = np.asarray(poses[len(poses) // 2]) @ yaw180
    g, d = render(planes, T_back)
    fj = js.pipeline.extract(jnp.asarray(g), depth_image=jnp.asarray(d))
    ft = convert.tree_from_numpy(FrameFeatures, fj, "cpu")
    none = np.full(ORB["max_kpts"], -1, np.int64)
    wj = jl.map.insert_keyframe(fj, jnp.asarray(T_back.astype(np.float32)), none, 999)
    wt = tl.map.insert_keyframe(ft, torch.from_numpy(T_back.astype(np.float32)), none, 999)
    assert wj == wt
    before = tl.map.arrays.kf_pose.clone(), tl.map.arrays.pt_pos.clone(), tl.map.version
    assert not jl._verify_and_correct(wj, 0)
    assert not tl._verify_and_correct(wt, 0)
    assert torch.equal(tl.map.arrays.kf_pose, before[0])
    assert torch.equal(tl.map.arrays.pt_pos, before[1]) and tl.map.version == before[2]
    assert tl.map.loop_edges == [] and tl.gba is None
    assert tl.rejected_by_gate == jl.rejected_by_gate


def test_relocalize(run, monkeypatch):
    """A frame between two keyframes of the return leg: the same candidate
    wins with the same inliers and pose."""
    draws = Draws(monkeypatch)
    planes, poses, js = run
    jl, tl = pair(run)
    T = poses[len(poses) - 6]
    g, d = render(planes, T)
    fj = js.pipeline.extract(jnp.asarray(g), depth_image=jnp.asarray(d))
    ft = convert.tree_from_numpy(FrameFeatures, fj, "cpu")
    rj = jl.relocalize(fj)
    n_draws = len(draws.pnp)
    rt = tl.relocalize(ft)
    assert rj is not None and rt is not None and n_draws >= 1 and not draws.pnp
    assert rt[1] == rj[1] >= 25
    np.testing.assert_allclose(rt[0], np.asarray(rj[0]), rtol=0, atol=1e-4)
    # near the pose the run tracked for that frame (the map's own frame)
    T_run = np.asarray(js.poses_np()[len(poses) - 6])
    err = np.linalg.norm(np.linalg.inv(rt[0])[:3, 3] - np.linalg.inv(T_run)[:3, 3])
    assert err < 0.05, err


def perturb(jm, tm, seed):
    """The same perturbation of every keyframe pose but keyframe 0 in both."""
    K = jm.n_kfs
    clean = np.array(jm.arrays.kf_pose[:K])
    rng = np.random.default_rng(seed)
    pert = clean.copy()
    for k in range(1, K):
        w = rng.normal(0, 0.01, 3)
        th = np.linalg.norm(w)
        ax = w / max(th, 1e-12)
        Kx = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
        pert[k, :3, :3] = (np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx) \
            @ clean[k, :3, :3]
        pert[k, :3, 3] = clean[k, :3, 3] + rng.normal(0, 0.02, 3)
    pert = pert.astype(np.float32)
    jm.version += 1
    jm.arrays = jm.arrays._replace(kf_pose=jm.arrays.kf_pose.at[jnp.arange(K)].set(pert))
    tm.version += 1
    tm.arrays.kf_pose[:K] = torch.from_numpy(pert)
    return clean


def test_global_ba_abort_and_merge(run):
    """tests/test_global_ba.py's contracts on both packages: an aborted
    solve changes nothing; a finished one lands where JAX's does, and a
    keyframe inserted during the solve keeps its relative pose to its
    spanning-tree parent."""
    planes, poses, js = run
    jl, tl = pair(run)
    jm, tm = jl.map, tl.map
    perturb(jm, tm, 5)
    same_map(jm, tm, 0, 0)
    before = tm.arrays.kf_pose.clone(), tm.arrays.pt_pos.clone(), tm.version
    gj, gt = jgba.GlobalBundleAdjustment(jm), tgba.GlobalBundleAdjustment(tm)
    gj.step()
    gt.step()
    for g in (gj, gt):
        g.abort()
        g.finish()
        assert g.aborted and not g.finished
    assert torch.equal(tm.arrays.kf_pose, before[0]) and torch.equal(tm.arrays.pt_pos, before[1])
    assert tm.version == before[2]

    perturb(jm, tm, 7)
    k0 = jm.n_kfs
    gj, gt = jgba.GlobalBundleAdjustment(jm), tgba.GlobalBundleAdjustment(tm)
    assert gt.step() and gj.step()
    np.testing.assert_allclose(gt.prob.kf_pose.numpy(), np.asarray(gj.prob.kf_pose), rtol=0,
                               atol=1e-4)
    # a keyframe arrives while the solve is in flight (the last frame's
    # features again, at a pose 1 cm off the last keyframe's)
    g, d = render(planes, poses[-2])
    fj = js.pipeline.extract(jnp.asarray(g), depth_image=jnp.asarray(d))
    ft = convert.tree_from_numpy(FrameFeatures, fj, "cpu")
    T = np.array(jm.arrays.kf_pose[k0 - 1])
    T[0, 3] += 0.01
    kp = np.full(ORB["max_kpts"], -1, np.int64)
    assert jm.insert_keyframe(fj, jnp.asarray(T), kp, 998) == \
        tm.insert_keyframe(ft, torch.from_numpy(T), kp, 998) == k0
    parent = int(tm.kf_parent[k0])
    assert parent == int(jm.kf_parent[k0]) and 0 <= parent < k0
    rel = T.astype(np.float64) @ np.linalg.inv(np.array(tm.arrays.kf_pose[parent], np.float64))
    for g in (gj, gt):
        while g.step():
            pass
        g.finish()
    same_map(jm, tm, 1e-4, 1e-3)
    P = tm.arrays.kf_pose.numpy().astype(np.float64)
    np.testing.assert_allclose(P[k0] @ np.linalg.inv(P[parent]), rel, atol=1e-4)



def test_run_global_refinement(run):
    """Pose graph then structure-only refits. A landmark seen by one
    keyframe is unconstrained along its ray (both packages move it
    arbitrarily far), so landmarks are compared where two or more
    keyframes observe them."""
    jl, tl = pair(run)
    perturb(jl.map, tl.map, 11)
    jgba.run_global_refinement(jl.map)
    tgba.run_global_refinement(tl.map)
    jm, tm = jl.map, tl.map
    K = jm.n_kfs
    np.testing.assert_allclose(tm.arrays.kf_pose[:K].numpy(), np.asarray(jm.arrays.kf_pose[:K]),
                               rtol=0, atol=1e-4)
    ids = np.where(jm.pt_alive)[0]
    _, _, cnt = tgba.harvest_observations(tm, ids)
    np.testing.assert_array_equal(cnt, jgba.harvest_observations(jm, ids)[2])
    two = ids[cnt >= 2]
    assert len(two) >= 100
    np.testing.assert_allclose(tm.arrays.pt_pos.numpy()[two], np.asarray(jm.arrays.pt_pos)[two],
                               rtol=0, atol=1e-3)


def test_remap_slots(run):
    jl, tl = pair(run)
    K = jl.map.n_kfs
    for lc in (jl, tl):
        lc.consistent_groups = [(frozenset({0, 1, 2}), 2), (frozenset({K - 1}), 1)]
        lc.last_loop_kf = K - 1
        lc.loops_closed = [(K - 1, 0), (K - 2, 1)]
    lut = np.arange(jl.map.K)
    lut[1] = -1
    lut[2:] -= 1
    jl.remap_slots(lut)
    tl.remap_slots(lut)
    assert tl.consistent_groups == jl.consistent_groups
    assert tl.last_loop_kf == jl.last_loop_kf == K - 2
    assert tl.loops_closed == jl.loops_closed == [(K - 2, 0), (K - 3, -1)]
    assert tl.db.kf_bow.keys() == jl.db.kf_bow.keys() and tl.db.inverted == jl.db.inverted

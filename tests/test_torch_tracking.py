"""Port parity: Hamming matching, robust solvers, pose optimization, the
motion-model tracker and RGBDOdometry.

Tolerances: hamming_matrix, window_mask and match are EXACT (integer
distances, ties resolved in the JAX order). optimize_pose and the small
solves agree to 1e-5 (f32 evaluation order). track_motion_model on
identical converted state gives the same matches and a pose within 1e-4.
A short RGBDOdometry run at 320x240 in both packages: poses within 5 mm /
0.2 deg frame by frame, and ATE < 2 cm for each.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.config import (CameraConfig as JCam, ORBConfig as JORB,
                                  SystemConfig as JSys)
from amos_slam_tpu.frontend.features import ORBPipeline as JPipe
from amos_slam_tpu.frontend.tracking import RGBDOdometry as JOdo
from amos_slam_tpu.frontend.tracking import track_motion_model as j_track
from amos_slam_tpu.geometry import se3 as jse3
from amos_slam_tpu.geometry.camera import Camera as JCamera
from amos_slam_tpu.ops import hamming as jham
from amos_slam_tpu.solvers import pose_opt as jpo
from amos_slam_tpu.solvers import robust as jrob
from amos_slam_tpu_torch import convert
from amos_slam_tpu_torch.config import (CameraConfig as TCam, ORBConfig as TORB,
                                        SystemConfig as TSys)
from amos_slam_tpu_torch.frontend.features import FrameFeatures
from amos_slam_tpu_torch.frontend.tracking import RGBDOdometry as TOdo
from amos_slam_tpu_torch.frontend.tracking import track_motion_model as t_track
from amos_slam_tpu_torch.io import evaluate, synthetic
from amos_slam_tpu_torch.ops import hamming as tham
from amos_slam_tpu_torch.solvers import pose_opt as tpo
from amos_slam_tpu_torch.solvers import robust as trob

CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2,
           width=320, height=240)
ORB = dict(n_features=500, n_levels=4, max_kpts=512)
N_FRAMES = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these eager runs launch many small ops, and
    tier-1 runs several test files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(rng, n):
    return (rng.random((n, 256)) < 0.5).astype(np.int8)


def test_hamming_matrix_exact(rng):
    a, b = _bits(rng, 200), _bits(rng, 150)
    ref = np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    out = tham.hamming_matrix(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        out, (a[:, None, :] != b[None, :, :]).sum(-1))


@pytest.mark.parametrize("max_dist,nn_ratio,mutual,angles", [
    (100, 1.0, True, True),     # the tracker's settings
    (50, 0.9, True, True),
    (80, 0.8, False, False),
])
def test_window_and_match_exact(rng, max_dist, nn_ratio, mutual, angles):
    n, m = 300, 280
    # each query is a noisy copy of a target near its own position and at a
    # common rotation: real matches, and many integer distance ties
    base = _bits(rng, m)
    partner = rng.integers(0, m, n)
    qd = base[partner].copy()
    flip = rng.random(qd.shape) < 0.15
    qd[flip] ^= 1
    t_uv = rng.uniform(0, 320, (m, 2)).astype(np.float32)
    q_uv = (t_uv[partner] + rng.normal(0, 8, (n, 2))).astype(np.float32)
    rad = rng.uniform(10, 40, n).astype(np.float32)
    qv, tv = rng.random(n) < 0.9, rng.random(m) < 0.9
    wj = jham.window_mask(jnp.asarray(q_uv), jnp.asarray(t_uv), jnp.asarray(rad),
                          jnp.asarray(qv), jnp.asarray(tv))
    wt = tham.window_mask(_t(q_uv), _t(t_uv), _t(rad), _t(qv), _t(tv))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    dj = jham.apply_mask(jham.hamming_matrix(jnp.asarray(qd), jnp.asarray(base)), wj)
    dt = tham.apply_mask(tham.hamming_matrix(_t(qd), _t(base)), wt)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    kw = dict(max_dist=max_dist, nn_ratio=nn_ratio, mutual=mutual)
    at = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    aq = (at[partner] + 0.3 + rng.normal(0, 0.2, n)).astype(np.float32)
    rj = jham.match(dj, **kw, **(dict(angle_q=jnp.asarray(aq), angle_t=jnp.asarray(at))
                                 if angles else {}))
    rt = tham.match(dt, **kw, **(dict(angle_q=_t(aq), angle_t=_t(at)) if angles else {}))
    for name in ("idx", "dist", "valid"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)), err_msg=name)
    assert int(rt.valid.sum()) > 10


def test_robust_solvers(rng):
    A = rng.normal(size=(16, 6, 6)).astype(np.float32)
    H = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=(16, 6)).astype(np.float32)
    lam = np.full(16, 1e-3, np.float32)
    ref = np.asarray(jrob.solve_damped(jnp.asarray(H), jnp.asarray(b), jnp.asarray(lam)))
    out = trob.solve_damped(_t(H), _t(b), _t(lam)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    H4, b4 = H[:, :4, :4], b[:, :4]
    np.testing.assert_allclose(
        trob.chol_solve_unrolled(_t(H4), _t(b4)).numpy(),
        np.asarray(jrob.chol_solve_unrolled(jnp.asarray(H4), jnp.asarray(b4))),
        rtol=1e-4, atol=1e-5)
    chi2 = rng.uniform(0, 20, 100).astype(np.float32)
    np.testing.assert_allclose(
        trob.huber_weight(_t(chi2), jrob.CHI2_MONO).numpy(),
        np.asarray(jrob.huber_weight(jnp.asarray(chi2), jrob.CHI2_MONO)), atol=1e-6)


def _pose_problem(rng, n=300):
    cam = dict(fx=535.4, fy=539.2, cx=320.1, cy=247.6, bf=40.0)
    T = np.asarray(jse3.se3_exp(jnp.asarray([0.05, -0.02, 0.1, 0.02, -0.03, 0.01])))
    pc = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(1, 6, (n, 1))], 1)
    pw = (np.linalg.inv(T) @ np.c_[pc, np.ones(n)].T).T[:, :3]
    u = cam["fx"] * pc[:, 0] / pc[:, 2] + cam["cx"]
    v = cam["fy"] * pc[:, 1] / pc[:, 2] + cam["cy"]
    uv = np.stack([u, v], 1) + rng.normal(0, 0.5, (n, 2))
    out = rng.random(n) < 0.1
    uv[out] += rng.uniform(-40, 40, (out.sum(), 2))
    ur = np.where(rng.random(n) < 0.5, u - cam["bf"] / pc[:, 2], -1.0)
    obs = dict(points_w=pw, uv=uv, u_right=ur,
               inv_sigma2=1.0 / 1.2 ** (2 * rng.integers(0, 4, n)),
               valid=rng.random(n) < 0.95)
    obs = {k: np.asarray(v, np.float32 if k != "valid" else bool) for k, v in obs.items()}
    T0 = np.asarray(jse3.se3_exp(jnp.asarray([0.03, 0.01, -0.05, -0.01, 0.02, 0.0]))
                    @ jnp.asarray(T, jnp.float32))
    return cam, obs, T0


@pytest.mark.parametrize("unroll,rounds,iters", [(True, 3, 4), (False, 4, 10)])
def test_optimize_pose(rng, unroll, rounds, iters):
    c, obs, T0 = _pose_problem(rng)
    cj = JCamera.create(c["fx"], c["fy"], c["cx"], c["cy"], bf=c["bf"])
    ct = convert.camera_from_numpy(cj, device="cpu")
    rj = jpo.optimize_pose(jnp.asarray(T0), cj, jpo.PoseObs(**{
        k: jnp.asarray(v) for k, v in obs.items()}), rounds, iters, unroll=unroll)
    rt = tpo.optimize_pose(_t(T0), ct, convert.tree_from_numpy(tpo.PoseObs, obs, "cpu"),
                           rounds, iters, unroll=unroll)
    np.testing.assert_allclose(rt.Tcw.numpy(), np.asarray(rj.Tcw), atol=1e-5)
    np.testing.assert_array_equal(rt.inlier.numpy(), np.asarray(rj.inlier))
    assert int(rt.num_inliers) == int(rj.num_inliers) > 200


@pytest.fixture(scope="module")
def sequence():
    planes = synthetic.default_room(seed=1)
    poses = synthetic.orbit_trajectory(N_FRAMES, radius=0.05, advance=0.1)
    frames = [synthetic.render(planes, T, fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"],
                               cy=CAM["cy"], width=320, height=240) for T in poses]
    return poses, frames


def test_track_motion_model_on_identical_state(sequence):
    _, frames = sequence
    pipe = JPipe(JORB(**ORB), JCam(**CAM))
    f0 = pipe.extract(jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1]))
    f1 = pipe.extract(jnp.asarray(frames[1][0]), jnp.asarray(frames[1][1]))
    eye = jnp.eye(4)
    rj = j_track(pipe.cam, f1, f0, eye, eye, jnp.asarray(15.0))
    ct = convert.camera_from_numpy(pipe.cam, device="cpu")
    t0 = convert.tree_from_numpy(FrameFeatures, f0, "cpu")
    t1 = convert.tree_from_numpy(FrameFeatures, f1, "cpu")
    teye = torch.eye(4)
    rt = t_track(ct, t1, t0, teye, teye, 15.0)
    np.testing.assert_array_equal(rt.match_idx.numpy(), np.asarray(rj.match_idx))
    assert int(rt.num_matches) == int(rj.num_matches) > 100
    assert int(rt.num_inliers) == int(rj.num_inliers)
    np.testing.assert_array_equal(rt.inlier.numpy(), np.asarray(rj.inlier))
    np.testing.assert_allclose(rt.Tcw.numpy(), np.asarray(rj.Tcw), atol=1e-4)

    # explicit world points (the monocular callers' source; here the
    # backprojection the default computes, last pose = I) and one pass
    d = np.maximum(np.asarray(f0.depth), 1e-3)
    uv = np.asarray(f0.xy_un)
    pts = np.stack([(uv[:, 0] - CAM["cx"]) / CAM["fx"] * d,
                    (uv[:, 1] - CAM["cy"]) / CAM["fy"] * d, d], 1).astype(np.float32)
    has = np.asarray(f0.depth) > 0
    rj = j_track(pipe.cam, f1, f0, eye, eye, jnp.asarray(15.0),
                 pts_w=jnp.asarray(pts), has_point=jnp.asarray(has), two_pass=False)
    rt = t_track(ct, t1, t0, teye, teye, 15.0, pts_w=_t(pts), has_point=_t(has),
                 two_pass=False)
    np.testing.assert_array_equal(rt.match_idx.numpy(), np.asarray(rj.match_idx))
    assert int(rt.num_inliers) == int(rj.num_inliers) > 100
    np.testing.assert_allclose(rt.Tcw.numpy(), np.asarray(rj.Tcw), atol=1e-4)


def test_rgbd_odometry_matches_jax(sequence):
    poses, frames = sequence
    jodo = JOdo(JSys(camera=JCam(**CAM), orb=JORB(**ORB)))
    todo = TOdo(TSys(camera=TCam(**CAM), orb=TORB(**ORB)), device="cpu")
    for i, (g, d) in enumerate(frames):
        jodo.track(g, d, i / 30.0)
        todo.track(g, d, i / 30.0)
    gt = np.asarray(poses)
    for odo in (jodo, todo):
        est = np.asarray(odo.poses_cw)
        ate = evaluate.ate_rmse(evaluate.positions_from_cw(est),
                                evaluate.positions_from_cw(gt))
        assert ate < 0.02, ate
        assert min(s["inliers"] for s in odo.stats[1:]) > 50
    ej, et = np.asarray(jodo.poses_cw), np.asarray(todo.poses_cw)
    dpos = np.linalg.norm(
        evaluate.positions_from_cw(ej) - evaluate.positions_from_cw(et), axis=1)
    assert dpos.max() < 5e-3, dpos
    rel = np.einsum("nij,nkj->nik", ej[:, :3, :3], et[:, :3, :3])
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    assert np.degrees(np.arccos(cos)).max() < 0.2
    assert [s["matches"] for s in todo.stats] == [s["matches"] for s in jodo.stats]


def test_entry_points_default_to_cuda():
    cfg = TSys(camera=TCam(**CAM), orb=TORB(**ORB))
    if torch.cuda.is_available():
        assert TOdo(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TOdo(cfg)
        from amos_slam_tpu_torch.frontend.features import ORBPipeline
        with pytest.raises(RuntimeError, match="CUDA"):
            ORBPipeline(cfg.orb, cfg.camera)

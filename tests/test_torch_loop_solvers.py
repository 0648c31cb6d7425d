"""The loop closer's solvers in the port against the JAX package, on the CPU:
Sim3 exp/log/compose/inverse, the Horn alignment, the Sim3 RANSAC with
JAX's draw fed, the mutual-reprojection Sim3 refinement, the pose graph on
tests/test_sim3_pose_graph.py's drift problem (fixed and free scale) and the
structure-only landmark refinement.

Tolerances: one evaluation within 1e-5 (absolute, f32); after Gauss-Newton
iterations within 1e-4. The Horn alignment is compared as R, t and s, not
as the quaternion (q and -q are the same rotation). The RANSAC's draw is
recorded inside the same jitted program as JAX's own RANSAC
(``ransac_sim3.__wrapped__``) and fed to the port as ``sample_idx``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.geometry import se3 as jse3
from amos_slam_tpu.geometry import sim3 as jsim3
from amos_slam_tpu.geometry.camera import Camera as JCamera
from amos_slam_tpu.solvers import pose_graph as jpg
from amos_slam_tpu.solvers import sim3_solver as jsol
from amos_slam_tpu.solvers.structure_only import refine_points as j_refine
from amos_slam_tpu_torch.geometry import sim3 as tsim3
from amos_slam_tpu_torch.geometry.camera import Camera
from amos_slam_tpu_torch.solvers import pose_graph as tpg
from amos_slam_tpu_torch.solvers import sim3_solver as tsol
from amos_slam_tpu_torch.solvers.structure_only import refine_points as t_refine

CAM = dict(fx=267.7, fy=269.6, cx=160.05, cy=123.8, width=320, height=240)


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy() if torch.is_tensor(b) else b,
                               rtol=0, atol=tol)


def sim3_pair(xi):
    return jsim3.sim3_exp(jnp.asarray(xi)), tsim3.sim3_exp(t(xi))


@pytest.mark.parametrize("scale", [1e-7, 1e-3, 0.3, 1.0])
def test_sim3_exp_log_compose_inverse(scale):
    """Both series branches (|sigma| and theta below 1e-5) and the closed form."""
    rng = np.random.default_rng(0)
    xi = (rng.standard_normal((16, 7)) * scale).astype(np.float32)
    xi[:4, 6] = 0.0          # scale 1
    xi[4:8, 3:6] = 0.0       # no rotation
    gj, gt = sim3_pair(xi)
    for a, b in zip(gj, gt):
        close(a, b, 1e-5)
    close(jsim3.sim3_log(gj), tsim3.sim3_log(gt), 1e-5)
    hj, ht = sim3_pair(xi[::-1].copy())
    for a, b in zip(gj.compose(hj), gt.compose(ht)):
        close(a, b, 1e-5)
    for a, b in zip(gj.inverse(), gt.inverse()):
        close(a, b, 1e-5)
    pts = rng.standard_normal((16, 5, 3)).astype(np.float32)
    close(gj.apply(jnp.asarray(pts)), gt.apply(t(pts)), 1e-5)
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi[:, :6])))
    for a, b in zip(jsim3.Sim3.from_se3(jnp.asarray(T)), tsim3.Sim3.from_se3(t(T))):
        close(a, b, 0)


def test_horn_exact_noise_free():
    rng = np.random.default_rng(0)
    p1 = rng.standard_normal((20, 3)).astype(np.float32)
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.3, -0.2, 0.5])))
    s, tr = 1.7, np.array([0.5, -1.0, 2.0], np.float32)
    p2 = (s * (R @ p1.T).T + tr).astype(np.float32)
    for fix in (True, False):
        gj = jsol.horn_sim3(jnp.asarray(p1), jnp.asarray(p2), fix_scale=fix)
        gt = tsol.horn_sim3(t(p1), t(p2), fix_scale=fix)
        for a, b in zip(gj, gt):
            close(a, b, 1e-5)
    # the free-scale fit recovers the similarity exactly
    np.testing.assert_allclose(gt.R.numpy(), R, atol=1e-5)
    np.testing.assert_allclose(gt.t.numpy(), tr, atol=1e-4)
    np.testing.assert_allclose(float(gt.s), s, rtol=1e-5)


def jax_ransac_sim3(p1, p2, valid, key, n_hyp=128, **kw):
    """JAX's ransac_sim3 and its draw, from one jitted program."""
    def run(p1, p2, valid, key):
        probs = valid.astype(jnp.float32)
        probs = probs / jnp.maximum(probs.sum(), 1.0)
        idx = jax.random.choice(key, p1.shape[0], shape=(n_hyp, 3), p=probs)
        return jsol.ransac_sim3.__wrapped__(p1, p2, valid, key, n_hyp=n_hyp, **kw), idx
    res, idx = jax.jit(run)(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), key)
    return res, torch.from_numpy(np.asarray(idx)).long()


@pytest.mark.parametrize("fix_scale", [True, False])
def test_ransac_sim3_with_jax_draw(fix_scale):
    rng = np.random.default_rng(1)
    n = 200
    p1 = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.1, 0.25, -0.15])))
    s = 1.0 if fix_scale else 1.3
    p2 = (s * (R @ p1.T).T + [0.3, 0.8, -0.5] + rng.normal(0, 0.005, (n, 3))).astype(np.float32)
    out = rng.choice(n, 60, replace=False)
    p2[out] += rng.uniform(0.5, 2.0, (60, 3)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    rj, idx = jax_ransac_sim3(p1, p2, valid, jax.random.PRNGKey(3), fix_scale=fix_scale,
                              inlier_th=0.08)
    rt = tsol.ransac_sim3(t(p1), t(p2), t(valid), fix_scale=fix_scale, inlier_th=0.08,
                          sample_idx=idx)
    assert int(rt.num_inliers) == int(rj.num_inliers) > 100
    assert bool(rt.ok) and bool(rj.ok)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    for a, b in zip(rj.sim3, rt.sim3):
        close(a, b, 1e-5)
    # the port's own draw (a generator) finds the same inlier set here
    own = tsol.ransac_sim3(t(p1), t(p2), t(valid), torch.Generator().manual_seed(0),
                           fix_scale=fix_scale, inlier_th=0.08)
    assert abs(int(own.num_inliers) - int(rj.num_inliers)) <= 2


def test_optimize_sim3():
    rng = np.random.default_rng(2)
    n = 120
    p1c = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                    rng.uniform(1.0, 4.0, n)], -1).astype(np.float32)
    xi_true = np.array([0.05, -0.02, 0.04, 0.02, -0.03, 0.01, 0.05], np.float32)
    g_true, _ = sim3_pair(xi_true)
    p2c = np.asarray(g_true.apply(jnp.asarray(p1c)))
    cam = JCamera.create(**CAM)
    uv1 = np.stack([CAM["fx"] * p1c[:, 0] / p1c[:, 2] + CAM["cx"],
                    CAM["fy"] * p1c[:, 1] / p1c[:, 2] + CAM["cy"]], -1)
    uv2 = np.stack([CAM["fx"] * p2c[:, 0] / p2c[:, 2] + CAM["cx"],
                    CAM["fy"] * p2c[:, 1] / p2c[:, 2] + CAM["cy"]], -1)
    uv1 = (uv1 + rng.normal(0, 0.5, uv1.shape)).astype(np.float32)
    uv2 = (uv2 + rng.normal(0, 0.5, uv2.shape)).astype(np.float32)
    uv2[:10] += 40.0                                   # outliers
    valid = np.ones(n, bool)
    valid[-5:] = False
    is2 = (1.2 ** (-2.0 * rng.integers(0, 4, (2, n)))).astype(np.float32)
    g0j, g0t = sim3_pair(xi_true * 0.8)
    tcam = Camera.create(**CAM)
    for fix in (False, True):
        oj = jsol.optimize_sim3(cam, g0j, jnp.asarray(p1c), jnp.asarray(uv1), jnp.asarray(p2c),
                                jnp.asarray(uv2), jnp.asarray(valid), jnp.asarray(is2[0]),
                                jnp.asarray(is2[1]), fix_scale=fix)
        ot = tsol.optimize_sim3(tcam, g0t, t(p1c), t(uv1), t(p2c), t(uv2), t(valid), t(is2[0]),
                                t(is2[1]), fix_scale=fix)
        for a, b in zip(oj.sim3, ot.sim3):
            close(a, b, 1e-4)
        np.testing.assert_array_equal(ot.inlier.numpy(), np.asarray(oj.inlier))
        assert int(ot.num_inliers) == int(oj.num_inliers) >= 100


def drift_problem():
    """tests/test_sim3_pose_graph.py's classic loop: a circle of 24 poses,
    odometry with systematic drift, one exact loop edge weighted 5."""
    K = 24
    gt = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(
        np.array([np.cos(a), np.sin(a), 0.0, 0, 0, a], np.float32))))
        for a in 2 * np.pi * np.arange(K) / K])
    drift = np.asarray(jse3.se3_exp(jnp.asarray(
        np.array([0.01, 0.004, 0.0, 0.0, 0.0, 0.008], np.float32))))
    est, mR, mt, ei, ej = [gt[0]], [], [], [], []
    for k in range(1, K):
        rel = (drift @ (gt[k] @ np.linalg.inv(gt[k - 1]))).astype(np.float32)
        est.append(rel @ est[-1])
        ei.append(k - 1)
        ej.append(k)
        mR.append(rel[:3, :3])
        mt.append(rel[:3, 3])
    rel = (gt[0] @ np.linalg.inv(gt[K - 1])).astype(np.float32)
    ei.append(K - 1)
    ej.append(0)
    mR.append(rel[:3, :3])
    mt.append(rel[:3, 3])
    est = np.stack(est).astype(np.float32)
    E = len(ei)
    w = np.ones(E, np.float32)
    w[-1] = 5.0
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return dict(R=est[:, :3, :3], t=est[:, :3, 3], s=np.ones(K, np.float32),
                pose_valid=np.ones(K, bool), pose_fixed=fixed,
                edge_i=np.int32(ei), edge_j=np.int32(ej), edge_R=np.stack(mR),
                edge_t=np.stack(mt), edge_s=np.ones(E, np.float32), edge_w=w), gt


@pytest.mark.parametrize("fix_scale", [True, False])
def test_pose_graph_drift(fix_scale):
    p, gt = drift_problem()
    rj = jpg.optimize_pose_graph(jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in p.items()}),
                                 iters=40, fix_scale=fix_scale)
    rt = tpg.optimize_pose_graph(tpg.PoseGraphProblem(**{k: t(v) for k, v in p.items()}),
                                 iters=40, fix_scale=fix_scale)
    for a, b in zip(rj, rt):
        close(a, b, 1e-4)
    # the test's own contract: the loop pulls the chain's end back
    pos = np.einsum("kji,kj->ki", rt.R.numpy(), -rt.t.numpy())
    gpos = np.einsum("kji,kj->ki", gt[:, :3, :3], -gt[:, :3, 3])
    before = np.linalg.norm(np.einsum("kji,kj->ki", p["R"], -p["t"])[-1] - gpos[-1])
    assert np.linalg.norm(pos[-1] - gpos[-1]) < 0.35 * before


def test_pose_graph_padding_and_failed_factorization():
    """Zero-weight padding edges and invalid poses change nothing, and a
    non-positive-definite system gives a zero step (JAX: NaN -> 0)."""
    p, _ = drift_problem()
    K = len(p["s"])
    p2 = dict(p)
    for k in ("edge_i", "edge_j"):
        p2[k] = np.concatenate([p[k], np.int32([3, 0])])
    p2["edge_R"] = np.concatenate([p["edge_R"], p["edge_R"][:2]])
    p2["edge_t"] = np.concatenate([p["edge_t"], p["edge_t"][:2] + 1.0])
    p2["edge_s"] = np.ones(len(p2["edge_i"]), np.float32)
    p2["edge_w"] = np.concatenate([p["edge_w"], np.zeros(2, np.float32)])
    a = tpg.optimize_pose_graph(tpg.PoseGraphProblem(**{k: t(v) for k, v in p.items()}), iters=5)
    b = tpg.optimize_pose_graph(tpg.PoseGraphProblem(**{k: t(v) for k, v in p2.items()}), iters=5)
    close(a.R.numpy(), b.R, 1e-6)
    close(a.t.numpy(), b.t, 1e-6)
    bad = dict(p)
    bad["edge_w"] = -np.ones(len(p["edge_w"]), np.float32) * 1e3
    rj = jpg.optimize_pose_graph(jpg.PoseGraphProblem(**{k: jnp.asarray(v)
                                                          for k, v in bad.items()}), iters=2)
    rt = tpg.optimize_pose_graph(tpg.PoseGraphProblem(**{k: t(v) for k, v in bad.items()}),
                                 iters=2)
    for a_, b_ in zip(rj[:3], rt[:3]):
        close(a_, b_, 1e-5)
    assert rt.R.shape == (K, 3, 3)


def test_refine_points():
    rng = np.random.default_rng(4)
    M, OBS = 64, 5
    X = np.stack([rng.uniform(-1, 1, M), rng.uniform(-1, 1, M), rng.uniform(2, 4, M)],
                 -1).astype(np.float32)
    xis = (rng.standard_normal((M, OBS, 6)) * [0.05, 0.05, 0.05, 0.02, 0.02, 0.02]).astype(
        np.float32)
    poses = np.asarray(jse3.se3_exp(jnp.asarray(xis)))
    pc = np.einsum("moij,mj->moi", poses[..., :3, :3], X) + poses[..., :3, 3]
    uv = np.stack([CAM["fx"] * pc[..., 0] / pc[..., 2] + CAM["cx"],
                   CAM["fy"] * pc[..., 1] / pc[..., 2] + CAM["cy"]], -1)
    uv = (uv + rng.normal(0, 0.7, uv.shape)).astype(np.float32)
    uv[:4, 0] += 30.0                                 # a Huber-weighted outlier each
    obs_valid = (rng.uniform(size=(M, OBS)) < 0.8).astype(np.float32)
    obs_valid[:, :2] = 1.0                            # two views at least: well posed
    obs_valid[:4] = 1.0                               # the outliers' points: five
    pv = np.ones(M, bool)
    pv[-3:] = False
    is2 = np.ones((M, OBS), np.float32)
    X0 = (X + rng.normal(0, 0.03, X.shape)).astype(np.float32)
    Xj, cj = j_refine(JCamera.create(**CAM), jnp.asarray(X0), jnp.asarray(pv),
                      jnp.asarray(poses), jnp.asarray(uv), jnp.asarray(obs_valid),
                      jnp.asarray(is2))
    Xt, ct = t_refine(Camera.create(**CAM), t(X0), t(pv), t(poses), t(uv), t(obs_valid), t(is2))
    close(Xj, Xt, 1e-4)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-3, atol=1e-3)
    close(X0[-3:], Xt[-3:], 0)

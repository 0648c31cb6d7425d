"""Port parity: the Schur-complement local BA (solvers/local_ba.py).

Inputs are the problem of tests/test_local_ba.py::build_problem (8 cameras,
2 fixed, 256 landmarks, 256 observation slots per camera, half of them
stereo), built here in numpy from a seed and fed to both packages.
Tolerances:

* poses within 1e-4 and points within 1e-3 of JAX. The JAX solver sums the
  per-landmark blocks through a bf16 hi/lo one-hot product (~16 mantissa
  bits, ~2^-16 relative); the port sums in f32. Both packages also meet
  the ground-truth thresholds of tests/test_local_ba.py.
* with 10% gross outliers: the final inlier classification agrees on
  >= 99.9% of the observations.
* an empty problem stays finite; a reduced camera system that is not
  positive definite gives a zero camera step (JAX: NaN factor, zeroed;
  port: ``cholesky_ex`` info != 0, zeroed on the device), finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.geometry.camera import Camera as JCamera
from amos_slam_tpu.solvers import local_ba as jba
from amos_slam_tpu_torch import convert
from amos_slam_tpu_torch.geometry import se3 as tse3
from amos_slam_tpu_torch.solvers import local_ba as tba

CAM = dict(fx=535.4, fy=539.2, cx=320.1, cy=247.6, bf=40.0)


def _exp(xi):
    return tse3.se3_exp(torch.from_numpy(np.asarray(xi, np.float32))).numpy()


def build_problem(rng, K=8, M=256, O=256, n_fixed=2, noise_px=0.3,
                  pose_pert=0.02, point_pert=0.03, stereo_frac=0.5):
    """numpy copy of tests/test_local_ba.py::build_problem."""
    pts_gt = rng.uniform(-2.5, 2.5, (M, 3)).astype(np.float32)
    pts_gt[:, 2] = rng.uniform(2.0, 7.0, M)
    poses_gt = []
    for k in range(K):
        xi = np.zeros(6, np.float32)
        xi[0] = 0.15 * k
        xi[4] = 0.02 * k
        poses_gt.append(_exp(xi))
    poses_gt = np.stack(poses_gt)

    obs_uv = np.zeros((K, O, 2), np.float32)
    obs_ur = np.full((K, O), -1.0, np.float32)
    obs_point = np.full((K, O), -1, np.int32)
    obs_valid = np.zeros((K, O), bool)
    for k in range(K):
        pc = (poses_gt[k, :3, :3] @ pts_gt.T).T + poses_gt[k, :3, 3]
        u = 535.4 * pc[:, 0] / pc[:, 2] + 320.1
        v = 539.2 * pc[:, 1] / pc[:, 2] + 247.6
        vis = (pc[:, 2] > 0.3) & (u > 10) & (u < 630) & (v > 10) & (v < 470)
        ids = np.where(vis)[0][:O]
        n = len(ids)
        obs_point[k, :n] = ids
        obs_uv[k, :n, 0] = u[ids] + rng.normal(0, noise_px, n)
        obs_uv[k, :n, 1] = v[ids] + rng.normal(0, noise_px, n)
        st = rng.uniform(size=n) < stereo_frac
        ur = u[ids] - 40.0 / pc[ids, 2] + rng.normal(0, noise_px, n)
        obs_ur[k, :n] = np.where(st, ur, -1.0)
        obs_valid[k, :n] = True

    poses0 = poses_gt.copy()
    for k in range(n_fixed, K):
        poses0[k] = _exp(rng.normal(0, pose_pert, 6)) @ poses_gt[k]
    pts0 = pts_gt + rng.normal(0, point_pert, (M, 3)).astype(np.float32)
    prob = dict(
        kf_pose=poses0.astype(np.float32),
        kf_free=np.arange(K) >= n_fixed,
        kf_valid=np.ones(K, bool),
        points=pts0,
        point_valid=np.ones(M, bool),
        obs_point=obs_point,
        obs_uv=obs_uv,
        obs_ur=obs_ur,
        obs_inv_sigma2=np.ones((K, O), np.float32),
        obs_valid=obs_valid,
    )
    return prob, poses_gt, pts_gt


def solve_both(prob):
    cj = JCamera.create(CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"], bf=CAM["bf"])
    ct = convert.camera_from_numpy(cj, device="cpu")
    rj = jax.jit(lambda p: jba.solve_local_ba(cj, p))(
        jba.BAProblem(**{k: jnp.asarray(v) for k, v in prob.items()}))
    rt = tba.solve_local_ba(ct, convert.tree_from_numpy(tba.BAProblem, prob, "cpu"))
    return ({k: np.asarray(v) for k, v in rj._asdict().items()},
            convert.tree_to_numpy(rt))


def pose_err(T_est, T_gt):
    d = (np.asarray(T_est, np.float64) @ np.linalg.inv(T_gt)).astype(np.float32)
    xi = tse3.se3_log(torch.from_numpy(d)).numpy()
    return np.linalg.norm(xi[:3]), np.linalg.norm(xi[3:])


def test_local_ba_matches_jax(rng):
    prob, poses_gt, pts_gt = build_problem(rng)
    rj, rt = solve_both(prob)
    np.testing.assert_allclose(rt["kf_pose"], rj["kf_pose"], atol=1e-4)
    np.testing.assert_allclose(rt["points"], rj["points"], atol=1e-3)
    counts = np.bincount(prob["obs_point"][prob["obs_valid"]], minlength=256)
    seen = counts >= 2
    assert seen.sum() > 100
    for r in (rj, rt):
        np.testing.assert_allclose(r["kf_pose"][:2], prob["kf_pose"][:2], atol=1e-6)
        for k in range(2, 8):
            t_err, r_err = pose_err(r["kf_pose"][k], poses_gt[k])
            assert t_err < 4e-3 and r_err < 2e-3, (k, t_err, r_err)
        perr = np.linalg.norm(r["points"] - pts_gt, axis=1)
        perr0 = np.linalg.norm(prob["points"] - pts_gt, axis=1)
        assert np.median(perr[seen]) < 0.02
        assert np.median(perr[seen]) < 0.5 * np.median(perr0[seen])
        assert float(r["mean_chi2"]) < 3.0
    assert abs(float(rt["mean_chi2"]) - float(rj["mean_chi2"])) < 1e-3


def test_local_ba_outliers_match_jax(rng):
    prob, poses_gt, _ = build_problem(rng)
    valid = prob["obs_valid"]
    n_out = 0
    for k in range(valid.shape[0]):
        ids = np.where(valid[k])[0]
        bad = ids[: len(ids) // 10]
        prob["obs_uv"][k, bad] += 50.0
        n_out += len(bad)
    rj, rt = solve_both(prob)
    agree = (rt["obs_inlier"] == rj["obs_inlier"])[valid].mean()
    assert agree >= 0.999, agree
    for r in (rj, rt):
        for k in range(2, 8):
            assert pose_err(r["kf_pose"][k], poses_gt[k])[0] < 8e-3
        assert r["obs_inlier"].sum() > 0.8 * (valid.sum() - n_out)


def _empty(K=4, M=16, O=8):
    return dict(
        kf_pose=np.tile(np.eye(4, dtype=np.float32), (K, 1, 1)),
        kf_free=np.zeros(K, bool), kf_valid=np.zeros(K, bool),
        points=np.zeros((M, 3), np.float32), point_valid=np.zeros(M, bool),
        obs_point=np.full((K, O), -1, np.int32), obs_uv=np.zeros((K, O, 2), np.float32),
        obs_ur=np.full((K, O), -1.0, np.float32),
        obs_inv_sigma2=np.ones((K, O), np.float32), obs_valid=np.zeros((K, O), bool),
    )


def test_local_ba_safe_on_empty():
    rj, rt = solve_both(_empty())
    for r in (rj, rt):
        assert np.isfinite(r["kf_pose"]).all() and np.isfinite(r["points"]).all()
    np.testing.assert_allclose(rt["kf_pose"], rj["kf_pose"], atol=1e-6)


@pytest.mark.parametrize("S", [
    np.array([[1.0, 1.0], [1.0, 1.0]]),                  # singular PSD
    np.array([[1.0, 2.0], [2.0, 1.0]]),                  # indefinite
    np.diag([4.0, -1e-3, 2.0]),                          # a negative pivot
], ids=["singular", "indefinite", "negative_pivot"])
def test_camera_step_zero_when_not_positive_definite(S):
    """The Cholesky failure semantics: JAX's cho_factor gives NaNs that its
    solver turns into a zero step; the port's cholesky_ex reports info > 0
    and the step is zeroed the same way, with no host read."""
    S = S.astype(np.float32)
    rhs = np.arange(1, S.shape[0] + 1, dtype=np.float32)
    c = jax.scipy.linalg.cho_factor(jnp.asarray(S), lower=True)
    dj = np.asarray(jax.scipy.linalg.cho_solve(c, jnp.asarray(rhs)))
    dj = np.where(np.isfinite(dj), dj, 0.0)
    dt = tba.solve_camera_step(torch.from_numpy(S), torch.from_numpy(rhs)).numpy()
    np.testing.assert_array_equal(dt, np.zeros_like(rhs))
    np.testing.assert_array_equal(dj, dt)
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(torch.from_numpy(S))   # why the _ex form is used


def test_local_ba_non_positive_definite_system(rng):
    """A free camera with a NaN observation makes the reduced system NaN:
    no camera moves, nothing non-finite comes out, in both packages."""
    prob, _, _ = build_problem(rng, K=4, M=64, O=64)
    prob["obs_uv"][3, 0] = np.nan
    rj, rt = solve_both(prob)
    for r in (rj, rt):
        assert np.isfinite(r["kf_pose"]).all() and np.isfinite(r["points"]).all()
    np.testing.assert_allclose(rt["kf_pose"], rj["kf_pose"], atol=1e-6)
    pose0 = tse3.orthonormalize(torch.from_numpy(prob["kf_pose"])).numpy()
    np.testing.assert_allclose(rt["kf_pose"], pose0, atol=1e-6)

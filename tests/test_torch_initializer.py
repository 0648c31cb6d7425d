"""Port parity: the batched F-RANSAC (solvers/fundamental.py) and the
two-view initializer (solvers/initializer.py).

Inputs: the scenes of tests/test_lk_fundamental.py (200 points, 40 gross
outliers, 0.3 px noise) and tests/test_stereo_init.py (a general scene with
40 gross mismatches and 100 padding rows; a planar scene), built from a
seeded numpy generator. JAX's draws (``jax.random.choice`` with the key
the JAX function splits and draws from, evaluated the same way outside
it) are fed to the port as ``sample_idx`` / ``sample_idx_f`` /
``sample_idx_h``. Tolerances:

* Hartley normalization: T within 1e-6 relative, the points within 1e-5
  (the order of the sums);
* the 8-point F and the 4-point H of the same (Hartley-normalized)
  samples, compared up to sign (``eigh`` fixes none). A minimal solve in
  f32 is conditioning-limited: the null vector of the 9x9 normal matrix
  comes out of two LAPACK builds ~4e-4 apart (median over samples), and
  near-degenerate samples differ by O(1) in both packages alike (each is
  as far from an f64 evaluation as from the other). Held: median 2e-3,
  95th percentile 2e-2, over the samples of distinct points;
* ransac_fundamental: the same inliers; F up to sign within 1e-4 of
  max |F| (normalized by |F[2,2]|, as both return it); distances 1e-2 px
  (3.9e-3 measured, on 50 px outliers);
* _check_rt on a given motion: the same score and good mask, points
  within 2e-4 of their depth (7.3e-5 measured: the f32 DLT's conditioning,
  as in tests/test_torch_map.py);
* initialize_two_view: the same model (H or F) and verdict, the same
  count and mask of good points; the pose within 1e-4 and the good points
  within 1e-3 of their depth on the H path, 5e-3 and 1e-2 on the F path,
  whose pose rests on one 8-point hypothesis's F (1.3e-3 and 3.6e-3
  measured);
* the port's own draw (a torch.Generator): F-RANSAC inliers within 5% of
  JAX's count; the initializer's model, and a pose within 1 deg / 3 deg of
  the ground truth's rotation / translation direction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.geometry import se3 as jse3
from amos_slam_tpu.geometry.camera import Camera as JCamera
from amos_slam_tpu.solvers import fundamental as jfund
from amos_slam_tpu.solvers import initializer as jinit
from amos_slam_tpu_torch.geometry.camera import Camera as TCamera
from amos_slam_tpu_torch.solvers import fundamental as tfund
from amos_slam_tpu_torch.solvers import initializer as tinit

K4 = (500.0, 500.0, 320.0, 240.0)


def t(x):
    return torch.from_numpy(np.array(x))


def project(T, pts, k=K4):
    pc = (T[:3, :3] @ pts.T).T + T[:3, 3]
    return np.stack([k[0] * pc[:, 0] / pc[:, 2] + k[2], k[1] * pc[:, 1] / pc[:, 2] + k[3]], -1)


def pose(xi):
    return np.asarray(jse3.se3_exp(jnp.asarray(np.asarray(xi, np.float32))))


def jax_draw(key, valid, n_hyp, size):
    probs = jnp.asarray(valid).astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return np.asarray(jax.random.choice(key, valid.shape[0], shape=(n_hyp, size), p=probs))


def up_to_sign(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert sign_gap(a, b).max() <= tol * np.abs(b).max()


def f_scene(seed=0, n=200, outliers=40):
    """tests/test_lk_fundamental.py's two views (TUM intrinsics)."""
    rng = np.random.default_rng(seed)
    k = (535.4, 539.2, 320.1, 247.6)
    pts = rng.uniform(-2, 2, (n, 3))
    pts[:, 2] = rng.uniform(2, 8, n)
    T = pose([0.3, 0.05, 0.02, 0.02, -0.04, 0.01])
    x1, x2 = project(np.eye(4), pts, k), project(T, pts, k)
    x1 += rng.normal(0, 0.3, x1.shape)
    x2 += rng.normal(0, 0.3, x2.shape)
    out = rng.choice(n, outliers, replace=False)
    x2[out] += rng.uniform(10, 60, (outliers, 2)) * np.sign(rng.normal(size=(outliers, 2)))
    return x1.astype(np.float32), x2.astype(np.float32), np.ones(n, bool)


def init_scene(planar, seed=0):
    """tests/test_stereo_init.py's general (with padding) and planar scenes."""
    rng = np.random.default_rng(seed)
    n = 300
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    if planar:
        pts[:, 2] = 5.0 + 0.3 * pts[:, 0] + 0.1 * pts[:, 1]
        T2 = pose([0.4, 0.05, 0.02, 0.01, -0.06, 0.02])
        noise, pad = 0.3, 0
    else:
        pts[:, 2] = rng.uniform(3, 9, n)
        T2 = pose([0.4, 0.1, 0.05, 0.02, -0.05, 0.01])
        noise, pad = 0.4, 100
    x1, x2 = project(np.eye(4), pts), project(T2, pts)
    x1 += rng.normal(0, noise, x1.shape)
    x2 += rng.normal(0, noise, x2.shape)
    if not planar:
        bad = rng.choice(n, 40, replace=False)
        x2[bad] += rng.uniform(20, 80, (40, 2))
    x1 = np.concatenate([x1, np.zeros((pad, 2))]).astype(np.float32)
    x2 = np.concatenate([x2, np.zeros((pad, 2))]).astype(np.float32)
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return x1, x2, valid, T2


def sign_gap(a, b):
    """Per matrix, the largest element gap of a and b up to sign."""
    s = np.sign(np.sum(a * b, axis=(-2, -1), keepdims=True))
    return np.abs(a * s - b).max(axis=(-2, -1))


@pytest.mark.parametrize("model", ["F8", "H4"])
def test_minimal_solvers_match_jax(model):
    if model == "F8":
        x1, x2, valid = f_scene()
        jfn, tfn, size = jfund._f_from_8, tfund._f_from_8, 8
    else:
        x1, x2, valid, _ = init_scene(planar=True)
        jfn, tfn, size = jinit._h_from_4, tinit._h_from_4, 4
    x1n, T1 = jfund._normalize_points(jnp.asarray(x1), jnp.asarray(valid))
    x2n, _ = jfund._normalize_points(jnp.asarray(x2), jnp.asarray(valid))
    x1t, T1t = tfund._normalize_points(t(x1), t(valid))
    np.testing.assert_allclose(T1t.numpy(), np.asarray(T1), rtol=1e-6, atol=0)
    np.testing.assert_allclose(x1t.numpy(), np.asarray(x1n), rtol=0, atol=1e-5)
    x1n, x2n = np.asarray(x1n), np.asarray(x2n)
    idx = jax_draw(jax.random.PRNGKey(5), valid, 256, size)
    distinct = np.array([len(set(r)) == size for r in idx])
    gap = sign_gap(tfn(t(x1n[idx]), t(x2n[idx])).numpy(),
                   np.asarray(jfn(jnp.asarray(x1n[idx]), jnp.asarray(x2n[idx]))))[distinct]
    assert np.median(gap) < 2e-3 and np.quantile(gap, 0.95) < 2e-2, np.sort(gap)[-20:]


@pytest.mark.parametrize("padded", [False, True])
def test_ransac_fundamental_matches_jax(padded):
    x1, x2, valid = f_scene(n=100 if padded else 200, outliers=10 if padded else 40)
    if padded:   # tests/test_lk_fundamental.py::test_ransac_fundamental_padding
        x1 = np.concatenate([x1, np.zeros((56, 2), np.float32)])
        x2 = np.concatenate([x2, np.zeros((56, 2), np.float32)])
        valid = np.concatenate([valid, np.zeros(56, bool)])
    key = jax.random.PRNGKey(1 if padded else 0)
    rj = jfund.ransac_fundamental(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), key)
    idx = jax_draw(key, valid, 256, 8)
    rt = tfund.ransac_fundamental(t(x1), t(x2), t(valid), sample_idx=t(idx))
    assert int(rt.num_inliers) == int(rj.num_inliers) > (60 if padded else 140)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    up_to_sign(rt.F.numpy(), np.asarray(rj.F), 1e-4)
    ok = np.asarray(valid)
    np.testing.assert_allclose(rt.dist.numpy()[ok], np.asarray(rj.dist)[ok], atol=1e-2, rtol=0)
    assert np.isinf(rt.dist.numpy()[~ok]).all()
    # the port's own draw (other samples) finds as many inliers within 5%
    own = tfund.ransac_fundamental(t(x1), t(x2), t(valid), torch.Generator().manual_seed(0))
    assert int(own.num_inliers) >= 0.95 * int(rj.num_inliers)


def angle_deg(a, b):
    c = np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
    return np.degrees(np.arccos(np.clip(abs(c), -1, 1)))


@pytest.mark.parametrize("planar", [False, True], ids=["general_F", "planar_H"])
def test_initialize_two_view_matches_jax(planar):
    x1, x2, valid, T2 = init_scene(planar)
    key = jax.random.PRNGKey(1 if planar else 0)
    jc = JCamera.create(*K4)
    rj = jinit.initialize_two_view(jc, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), key)
    k1, k2 = jax.random.split(key)
    tc = TCamera.create(*K4)
    rt = tinit.initialize_two_view(tc, t(x1), t(x2), t(valid),
                                   sample_idx_f=t(jax_draw(k1, valid, 256, 8)),
                                   sample_idx_h=t(jax_draw(k2, valid, 256, 4)))
    assert bool(rj.ok) and bool(rj.used_h) == planar
    assert bool(rt.ok) == bool(rj.ok) and bool(rt.used_h) == bool(rj.used_h)
    assert int(rt.num_good) == int(rj.num_good)
    np.testing.assert_array_equal(rt.point_ok.numpy(), np.asarray(rj.point_ok))
    np.testing.assert_allclose(rt.Tcw2.numpy(), np.asarray(rj.Tcw2),
                               atol=1e-4 if planar else 5e-3, rtol=0)
    good = np.asarray(rj.point_ok)
    pj, pt = np.asarray(rj.points)[good], rt.points.numpy()[good]
    err = np.linalg.norm(pt - pj, axis=-1) / pj[:, 2]
    assert err.max() < (1e-3 if planar else 1e-2), err.max()

    # CheckRT alone on JAX's winning motion: the same verdicts and points
    T = np.asarray(rj.Tcw2)
    sj, Xj, gj = jinit._check_rt(jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3]), jc,
                                 jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid))
    st, Xt, gt = tinit._check_rt(t(T[None, :3, :3]), t(T[None, :3, 3]), tc, t(x1), t(x2),
                                 t(valid[None]))
    assert int(st[0]) == int(sj) >= int(rj.num_good)
    np.testing.assert_array_equal(gt[0].numpy(), np.asarray(gj))
    g = np.asarray(gj)
    err = np.linalg.norm(Xt[0].numpy()[g] - np.asarray(Xj)[g], axis=-1) / np.asarray(Xj)[g][:, 2]
    assert err.max() < 2e-4, err.max()

    # the port's own draw: the right model, near the ground truth
    own = tinit.initialize_two_view(tc, t(x1), t(x2), t(valid), torch.Generator().manual_seed(0))
    assert bool(own.ok) and bool(own.used_h) == planar
    T = own.Tcw2.numpy()
    dR = T[:3, :3] @ T2[:3, :3].T
    assert np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))) < 1.0
    assert angle_deg(T[:3, 3], T2[:3, 3]) < 3.0

"""Port parity: config dataclasses, SE3 and camera functions, state
conversion.

The same inputs, made with numpy from a seed, go through amos_slam_tpu (JAX,
CPU) and amos_slam_tpu_torch (PyTorch, CPU). Tolerance: atol 1e-5 on the
geometry, the f32 rounding of a different evaluation order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu import config as jcfg
from amos_slam_tpu.geometry import camera as jcam
from amos_slam_tpu.geometry import se3 as jse3
from amos_slam_tpu.solvers.pose_opt import PoseObs as JPoseObs
from amos_slam_tpu_torch import config as tcfg
from amos_slam_tpu_torch import convert
from amos_slam_tpu_torch.geometry import camera as tcam
from amos_slam_tpu_torch.geometry import se3 as tse3
from amos_slam_tpu_torch.solvers.pose_opt import PoseObs as TPoseObs

ATOL = 1e-5

CONFIG_CLASSES = [
    "CameraConfig", "ORBConfig", "DynamicsConfig", "TrackingConfig",
    "MapConfig", "SystemConfig",
]


def _field_sig(f):
    default = f.default
    if f.default_factory is not dataclasses.MISSING:
        default = type(f.default_factory()).__name__
    return (f.name, str(f.type), default)


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_fields_match(name):
    a = [_field_sig(f) for f in dataclasses.fields(getattr(jcfg, name))]
    b = [_field_sig(f) for f in dataclasses.fields(getattr(tcfg, name))]
    assert a == b


def test_config_derived_sizes_and_yaml(tmp_path):
    orb_j, orb_t = jcfg.ORBConfig(), tcfg.ORBConfig()
    assert orb_j.level_sizes(640, 480) == orb_t.level_sizes(640, 480)
    assert orb_j.level_budgets() == orb_t.level_budgets()
    assert orb_j.level_scales() == orb_t.level_scales()
    y = tmp_path / "s.yaml"
    y.write_text("%YAML:1.0\nCamera.fx: 517.3\nCamera.width: 320\n"
                 "ORBextractor.nLevels: 4\nCamera.RGB: 0\nThDepth: 35.0\n")
    assert dataclasses.asdict(jcfg.load_yaml(str(y))) == dataclasses.asdict(
        tcfg.load_yaml(str(y)))


def _rotvecs(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    # small, ordinary and near-pi angles
    ang = np.concatenate([
        rng.uniform(0, 1e-5, n // 4), rng.uniform(0.1, 2.5, n - n // 2),
        rng.uniform(np.pi - 1e-3, np.pi - 1e-5, n // 4),
    ]).astype(np.float32)
    return v * ang[:, None]


def _np(x):
    return np.asarray(x)


def test_so3_se3_maps_match(rng):
    phi = _rotvecs(rng, 64)
    xi = np.concatenate([rng.normal(size=(64, 3)).astype(np.float32), phi], 1)
    pj, pt = jnp.asarray(phi), torch.from_numpy(phi)
    xj, xt = jnp.asarray(xi), torch.from_numpy(xi)
    np.testing.assert_allclose(tse3.hat(pt).numpy(), _np(jse3.hat(pj)), atol=ATOL)
    np.testing.assert_allclose(tse3.vee(tse3.hat(pt)).numpy(), phi, atol=ATOL)
    Rj, Rt = jse3.so3_exp(pj), tse3.so3_exp(pt)
    np.testing.assert_allclose(Rt.numpy(), _np(Rj), atol=ATOL)
    np.testing.assert_allclose(
        tse3.so3_log(Rt).numpy(), _np(jse3.so3_log(Rj)), atol=1e-4)
    Tj, Tt = jse3.se3_exp(xj), tse3.se3_exp(xt)
    np.testing.assert_allclose(Tt.numpy(), _np(Tj), atol=ATOL)
    # se3_log amplifies f32 rounding near pi; compare on the ordinary angles
    mid = slice(16, 48)
    np.testing.assert_allclose(
        tse3.se3_log(Tt[mid]).numpy(), _np(jse3.se3_log(Tj[mid])), atol=1e-4)
    np.testing.assert_allclose(tse3.inv_T(Tt).numpy(), _np(jse3.inv_T(Tj)), atol=ATOL)
    np.testing.assert_allclose(
        tse3.rotmat_to_quat(Rt).numpy(), _np(jse3.rotmat_to_quat(Rj)), atol=ATOL)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.quat_to_rotmat(torch.from_numpy(q)).numpy(),
        _np(jse3.quat_to_rotmat(jnp.asarray(q))), atol=ATOL)


def test_make_T_orthonormalize_transform_match(rng):
    R = np.asarray(jse3.so3_exp(jnp.asarray(_rotvecs(rng, 8))))
    R = (R + rng.normal(0, 1e-3, R.shape)).astype(np.float32)   # off SO(3)
    t = rng.normal(size=(8, 3)).astype(np.float32)
    Tj = jse3.make_T(jnp.asarray(R), jnp.asarray(t))
    Tt = tse3.make_T(torch.from_numpy(R), torch.from_numpy(t))
    np.testing.assert_array_equal(Tt.numpy(), _np(Tj))
    np.testing.assert_allclose(
        tse3.orthonormalize(Tt).numpy(), _np(jse3.orthonormalize(Tj)), atol=ATOL)
    pts = rng.normal(size=(8, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.transform_points(Tt, torch.from_numpy(pts)).numpy(),
        _np(jse3.transform_points(Tj, jnp.asarray(pts))), atol=ATOL)


def _cams(dist):
    args = (535.4, 539.2, 320.1, 247.6)
    return (jcam.Camera.create(*args, dist=dist, bf=40.0),
            tcam.Camera.create(*args, dist=dist, bf=40.0, device="cpu"))


def test_camera_functions_match(rng):
    cj, ct = _cams([0.1, -0.05, 1e-3, -2e-3, 0.01])
    np.testing.assert_array_equal(ct.K.numpy(), _np(cj.K))
    pts = np.concatenate([
        rng.uniform(-2, 2, (200, 2)), rng.uniform(0.5, 6, (200, 1))], 1
    ).astype(np.float32)
    uvj, zj = jcam.project(cj, jnp.asarray(pts))
    uvt, zt = tcam.project(ct, torch.from_numpy(pts))
    np.testing.assert_allclose(uvt.numpy(), _np(uvj), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(zt.numpy(), _np(zj))
    uv = rng.uniform(0, 640, (200, 2)).astype(np.float32)
    d = rng.uniform(0.5, 6, 200).astype(np.float32)
    np.testing.assert_allclose(
        tcam.backproject(ct, torch.from_numpy(uv), torch.from_numpy(d)).numpy(),
        _np(jcam.backproject(cj, jnp.asarray(uv), jnp.asarray(d))), atol=ATOL)
    np.testing.assert_allclose(
        tcam.undistort_points(ct, torch.from_numpy(uv)).numpy(),
        _np(jcam.undistort_points(cj, jnp.asarray(uv))), rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(
        tcam.in_image(ct, torch.from_numpy(uv * 1.1 - 20), 16.0).numpy(),
        _np(jcam.in_image(cj, jnp.asarray(uv * 1.1 - 20), 16.0)))


def test_convert_round_trip(rng):
    cj, _ = _cams(None)
    ct = convert.camera_from_numpy(cj, device="cpu")
    assert (ct.width, ct.height) == (cj.width, cj.height)
    np.testing.assert_array_equal(ct.dist.numpy(), _np(cj.dist))
    obs = JPoseObs(
        points_w=jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32)),
        uv=jnp.asarray(rng.normal(size=(5, 2)).astype(np.float32)),
        u_right=jnp.asarray(rng.normal(size=5).astype(np.float32)),
        inv_sigma2=jnp.ones(5, jnp.float32),
        valid=jnp.asarray([True, False, True, True, False]),
    )
    t = convert.tree_from_numpy(TPoseObs, obs, "cpu")
    assert t.valid.dtype == torch.bool and t.uv.dtype == torch.float32
    back = convert.tree_to_numpy(t)
    for name in JPoseObs._fields:
        np.testing.assert_array_equal(back[name], _np(getattr(obs, name)))

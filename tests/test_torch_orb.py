"""Port parity: pyramid, patches, orientation, rBRIEF and ORBPipeline.

One synthetic 320x240 frame, grey values rounded to integers as a camera
delivers them, through both packages (4 levels, 500 features). Tolerances:

* resize weights: within 2 ulp of jax.image.resize's own weight matrices.
* pyramid: within 1e-3 grey levels of an f64 evaluation of those weights,
  and within 1e-2 of the JAX package. The JAX side is the less exact one:
  XLA's CPU matrix product rounds at reduced precision on some CPUs, so
  JAX's levels are only held within 1e-2 of the f64 evaluation.
* blur: 1e-3 grey levels (f32 rounding of exp and of the sums).
* patches: exact; orientations 1e-4 rad; the gather-based descriptor
  sampler equals JAX's one-hot product bit for bit on identical inputs.
* detect_keypoints: level 0 identical (exact margins, exact selection);
  levels >= 1 rest on the resized images, where a margin tie can break the
  other way, so >= 95% of (level, y, x) coincide.
* descriptors >= 99.5% equal bits on coinciding keypoints.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

from amos_slam_tpu.config import CameraConfig as JCam, ORBConfig as JORB
from amos_slam_tpu.frontend.features import ORBPipeline as JPipe
from amos_slam_tpu.ops import orb_descriptor as jorb
from amos_slam_tpu.ops import pyramid as jpyr
from amos_slam_tpu_torch.config import CameraConfig as TCam, ORBConfig as TORB
from amos_slam_tpu_torch.frontend.features import ORBPipeline as TPipe
from amos_slam_tpu_torch.io import synthetic
from amos_slam_tpu_torch.ops import orb_descriptor as torb
from amos_slam_tpu_torch.ops import pyramid as tpyr

CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2,
           width=320, height=240)
ORB = dict(n_features=500, n_levels=4, max_kpts=512)


@pytest.fixture(scope="module")
def frame():
    planes = synthetic.default_room(seed=1)
    T = synthetic.orbit_trajectory(2, radius=0.05, advance=0.1)[0]
    gray, depth = synthetic.render(
        planes, T, fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"], cy=CAM["cy"],
        width=320, height=240)
    return np.round(gray).astype(np.float32), depth


@pytest.fixture(scope="module")
def pipes():
    return JPipe(JORB(**ORB), JCam(**CAM)), TPipe(TORB(**ORB), TCam(**CAM), device="cpu")


@pytest.fixture(scope="module")
def detected(frame, pipes):
    jp, tp = pipes
    rj = jp.detect_keypoints(jnp.asarray(frame[0]))
    rt = tp.detect_keypoints(torch.from_numpy(frame[0]))
    return rj, rt


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n_in,n_out", [(240, 200), (320, 267), (480, 400), (640, 533)])
def test_resize_matrix_equals_jax_weights(n_in, n_out):
    w = np.asarray(jax_scale.compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0, jax_scale._fill_triangle_kernel, True))
    # within 2 ulp: the per-column weight sums are taken in another order
    np.testing.assert_array_max_ulp(tpyr.resize_matrix(n_in, n_out), w.T, maxulp=2)


def test_pyramid_and_blur(frame, pipes):
    _, tp = pipes
    img = frame[0]
    sizes = tp.sizes
    pj = np.asarray(jpyr.build_pyramid(jnp.asarray(img), sizes))
    pt = tpyr.build_pyramid(torch.from_numpy(img), sizes).numpy()
    # f64 evaluation of the same weights, level by level from the port's input
    for lvl in range(1, len(sizes)):
        (ph, pw), (h, w) = sizes[lvl - 1], sizes[lvl]
        wy = tpyr.resize_matrix(ph, h).astype(np.float64)
        wx = tpyr.resize_matrix(pw, w).astype(np.float64)
        ref = wy @ pt[lvl - 1, :ph, :pw].astype(np.float64) @ wx.T
        np.testing.assert_allclose(pt[lvl, :h, :w], ref, atol=1e-3)
        ref_j = wy @ pj[lvl - 1, :ph, :pw].astype(np.float64) @ wx.T
        np.testing.assert_allclose(pj[lvl, :h, :w], ref_j, atol=1e-2)
        assert not pt[lvl, h:].any() and not pt[lvl, :, w:].any()
    np.testing.assert_array_equal(pt[0], pj[0])
    np.testing.assert_allclose(pt, pj, atol=1e-2)
    bj = np.asarray(jpyr.blur_pyramid(jnp.asarray(pj)))
    bt = tpyr.blur_pyramid(_t(pj)).numpy()
    np.testing.assert_allclose(bt, bj, atol=1e-3)


def test_patches_orientation_descriptors(detected, pipes):
    jp, tp = pipes
    (kj, _, blur_j, patches_j), _ = detected
    blur = _t(blur_j)
    level, yx = _t(kj.level), _t(kj.yx_level)
    patches = torb.gather_patches(blur, level, yx)
    np.testing.assert_array_equal(patches.numpy(), np.asarray(patches_j))
    # the TPU branch's one-hot product returns the same patches in bf16
    dense = np.asarray(jorb.gather_patches_dense(
        blur_j, jp.sizes, jp.budgets, kj.yx_level))
    v = np.asarray(kj.valid)
    np.testing.assert_array_equal(
        patches.to(torch.bfloat16).float().numpy()[v], dense[v])

    ang_j = np.asarray(jorb.orientations_from_patches(patches_j))
    ang_t = torb.orientations_from_patches(patches).numpy()
    np.testing.assert_allclose(ang_t, ang_j, atol=1e-4)

    # identical patches and angles: the gather sampler equals the product
    desc_j = np.asarray(jorb.descriptors_from_patches(
        patches_j, kj.angle, jp.sampling_matrix))
    desc_t = torb.descriptors_from_patches(patches, _t(kj.angle), tp.sample_table)
    np.testing.assert_array_equal(desc_t.numpy(), desc_j)

    packed = torb.pack_bits(desc_t)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jorb.pack_bits(jnp.asarray(desc_j))).astype(np.int64))
    np.testing.assert_array_equal(torb.unpack_bits(packed).numpy(), desc_j)


def test_f32_oracles(detected, pipes):
    jp, _ = pipes
    (kj, pyr_j, blur_j, _), _ = detected
    ang_j = np.asarray(jorb.compute_orientations(pyr_j, kj.level, kj.yx_level))
    ang_t = torb.compute_orientations(_t(pyr_j), _t(kj.level), _t(kj.yx_level)).numpy()
    v = np.asarray(kj.valid)
    np.testing.assert_allclose(ang_t[v], ang_j[v], atol=1e-3)
    dj = np.asarray(jorb.compute_descriptors(
        blur_j, kj.level, kj.yx_level, kj.angle, jp.pattern))
    dt = torb.compute_descriptors(
        _t(blur_j), _t(kj.level), _t(kj.yx_level), _t(kj.angle),
        torch.from_numpy(np.asarray(jp.pattern))).numpy()
    assert (dt[v] == dj[v]).mean() >= 0.995


def _keyset(kp, level=None):
    lv = np.asarray(kp.level)
    yx = np.asarray(kp.yx_level).astype(int)
    ok = np.asarray(kp.valid) & ((lv == level) if level is not None else True)
    return {(int(l), int(y), int(x)) for l, (y, x) in zip(lv[ok], yx[ok])}


def test_detect_keypoints(detected):
    (kj, pj, bj, _), (kt, pt, bt, _) = detected
    lv0 = np.asarray(kj.level) == 0
    for name in ("yx_level", "xy", "response", "valid", "level"):
        np.testing.assert_array_equal(
            getattr(kt, name).numpy()[lv0], np.asarray(getattr(kj, name))[lv0], err_msg=name)
    np.testing.assert_allclose(kt.angle.numpy()[lv0], np.asarray(kj.angle)[lv0], atol=1e-4)
    for lvl in range(1, 4):
        sj, st = _keyset(kj, lvl), _keyset(kt, lvl)
        assert len(sj & st) >= 0.95 * max(len(sj), len(st)), (lvl, len(sj), len(st))


def test_describe_and_extract(frame, pipes, detected):
    jp, tp = pipes
    gray, depth = frame
    mask = np.zeros(gray.shape, bool)
    mask[60:140, 100:200] = True
    fj = jp.describe(*[detected[0][i] for i in (0, 3)], jnp.asarray(depth),
                     jnp.asarray(mask))
    ft = tp.describe(*[detected[1][i] for i in (0, 3)], torch.from_numpy(depth),
                     torch.from_numpy(mask))
    kj, kt = detected[0][0], detected[1][0]
    pos_j = {(int(l), int(y), int(x)): i for i, (l, (y, x), v) in enumerate(zip(
        np.asarray(kj.level), np.asarray(kj.yx_level), np.asarray(kj.valid))) if v}
    pairs = [(pos_j[k], i) for i, (l, (y, x), v) in enumerate(zip(
        kt.level.numpy(), kt.yx_level.numpy(), kt.valid.numpy()))
        if v and (k := (int(l), int(y), int(x))) in pos_j]
    ij, it = np.asarray(pairs).T
    assert (ft.desc.numpy()[it] == np.asarray(fj.desc)[ij]).mean() >= 0.995
    for name in ("valid", "depth", "u_right", "inv_sigma2"):
        np.testing.assert_allclose(
            getattr(ft, name).numpy()[it], np.asarray(getattr(fj, name))[ij],
            atol=1e-4, err_msg=name)
    np.testing.assert_allclose(ft.xy_un.numpy()[it], np.asarray(fj.xy_un)[ij], atol=1e-3)
    assert 0 < int(ft.valid.sum()) < int(kt.valid.sum())   # the mask bit

    full = tp.extract(torch.from_numpy(gray), torch.from_numpy(depth))
    np.testing.assert_array_equal(full.desc.numpy(), tp.describe(
        detected[1][0], detected[1][3]).desc.numpy())

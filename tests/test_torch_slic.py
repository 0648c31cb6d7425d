"""Port parity: CIELAB conversion, SLIC + k-means and mask dilation
(ops/slic.py) against the JAX package.

Inputs: a 320x240 render of room_with_mover(seed=1) (grey and colour) and
seeded random masks. The JAX functions run under ``jax.jit``, as
compute_dynamics runs them (XLA then divides by constants as products with
their reciprocals, which the port does too). Tolerances:

* rgb_to_lab: within 1e-4 of JAX (torch has no cbrt: ``t ** (1/3)`` is a
  few ulps from ``jnp.cbrt``), and the textbook sRGB/D65 values of
  tests/test_color_and_adversarial.py;
* dilate_mask: exact at radii 1, 3 and 15;
* slic_kmeans, grey and Lab: pixel_super and pixel_cluster equal on
  >= 99.5% of pixels, center_depth within 1e-4 where the superpixel
  labels agree; the chroma-boundary contract on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.ops import slic as jslic
from amos_slam_tpu_torch.io import synthetic
from amos_slam_tpu_torch.ops import slic as tslic

CAM = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2, width=320, height=240)


@pytest.fixture(scope="module")
def frame():
    planes, mover = synthetic.room_with_mover(seed=1, t=0.1, speed=3.0)
    planes[mover].chroma = (1.6, 0.85, 0.55)
    pose = synthetic.orbit_trajectory(20, radius=0.05, advance=0.1)[3]
    g, d, rgb = synthetic.render(planes, pose, return_rgb=True, **CAM)
    return g, d, rgb.astype(np.float32)


def test_rgb_to_lab_matches_jax_and_textbook(frame):
    rgb = frame[2]
    lj = np.asarray(jax.jit(jslic.rgb_to_lab)(jnp.asarray(rgb)))
    lt = tslic.rgb_to_lab(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(lt, lj, atol=1e-4, rtol=0)
    lab = tslic.rgb_to_lab(torch.tensor(
        [[[255, 255, 255], [0, 0, 0], [255, 0, 0], [0, 255, 0]]], dtype=torch.float32)).numpy()
    np.testing.assert_allclose(lab[0, 0], [100.0, 0.0, 0.0], atol=0.02)
    np.testing.assert_allclose(lab[0, 1], [0.0, 0.0, 0.0], atol=0.02)
    np.testing.assert_allclose(lab[0, 2], [53.24, 80.09, 67.20], atol=0.05)
    np.testing.assert_allclose(lab[0, 3], [87.73, -86.18, 83.18], atol=0.05)


@pytest.mark.parametrize("radius", [1, 3, 15])
def test_dilate_mask_exact(radius):
    rng = np.random.default_rng(radius)
    m = rng.uniform(size=(120, 170)) > 0.997
    m[0, 5] = m[119, 169] = True     # border seeds
    want = np.asarray(jax.jit(jslic.dilate_mask, static_argnums=1)(jnp.asarray(m), radius))
    got = tslic.dilate_mask(torch.from_numpy(m), radius).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["grey", "lab"])
def test_slic_kmeans_matches_jax(frame, mode):
    g, d, rgb = frame
    if mode == "grey":
        fj, ft = jnp.asarray(g), torch.from_numpy(g)
    else:
        fj = jax.jit(jslic.rgb_to_lab)(jnp.asarray(rgb)) * 2.55
        ft = tslic.rgb_to_lab(torch.from_numpy(rgb)) * 2.55
    run = jax.jit(lambda f, dd: jslic.slic_kmeans(f, dd, cell=16, slic_iters=3, k=15))
    rj = run(fj, jnp.asarray(d))
    rt = tslic.slic_kmeans(ft, torch.from_numpy(d), cell=16, slic_iters=3, k=15)
    sup_j, sup_t = np.asarray(rj.pixel_super), rt.pixel_super.numpy()
    assert (sup_t == sup_j).mean() >= 0.995
    assert (rt.pixel_cluster.numpy() == np.asarray(rj.pixel_cluster)).mean() >= 0.995
    # superpixels whose pixels all carry the same label in both packages
    cd_j, cd_t = np.asarray(rj.center_depth), rt.center_depth.numpy()
    same = np.ones(len(cd_j), bool)
    np.logical_and.at(same, sup_j.ravel(), (sup_j == sup_t).ravel())
    assert same.mean() > 0.95
    np.testing.assert_allclose(cd_t[same], cd_j[same], atol=1e-4)
    assert rt.pixel_cluster.min() >= 0 and rt.pixel_cluster.max() < 15


def test_slic_lab_separates_chroma_only_regions():
    """Two regions of equal luma statistics and different chroma: the
    port's Lab SLIC keeps the boundary (the JAX test's contract)."""
    rng = np.random.default_rng(3)
    H, W = 64, 128
    base = rng.uniform(100, 140, (H, W)).astype(np.float32)
    rgb = np.repeat(base[..., None], 3, axis=-1)
    rgb[:, :64, 0] *= 1.5
    rgb[:, :64, 2] *= 0.5
    rgb[:, 64:, 0] *= 0.5
    rgb[:, 64:, 2] *= 1.5
    lab = tslic.rgb_to_lab(torch.from_numpy(rgb)) * 2.55
    r = tslic.slic_kmeans(lab, torch.ones((H, W)), cell=16, k=4)
    lbl = r.pixel_super.numpy()
    assert (lbl[:, 60] == lbl[:, 67]).mean() < 0.05


def test_slic_kmeans_separates_depths(rng):
    """tests/test_pnp_slic.py's depth contract on the port."""
    H, W = 240, 320
    gray = rng.uniform(0, 255, (H, W)).astype(np.float32)
    depth = np.full((H, W), 4.0, np.float32)
    depth[60:180, 80:200] = 1.5
    pc = tslic.slic_kmeans(torch.from_numpy(gray), torch.from_numpy(depth), cell=16,
                           k=8).pixel_cluster.numpy()
    assert set(np.unique(pc[80:160, 100:180])).isdisjoint(set(np.unique(pc[:40, :40])))

"""Port parity: pyramidal LK flow (ops/lk.py) against the JAX package.

Inputs (numpy from seeds): the pure-translation pair and the rendered-motion
pair of tests/test_lk_fundamental.py, both at 320x240 (the JAX package's
dense sampling products are slow on this CPU at 640x480), plus points whose
windows leave the image so that the edge clamp collapses both taps of a
sample. The JAX side runs ``jax.jit(lk_flow)``, as compute_dynamics runs it.

Tolerances:
* the window sampler: bit-equal to JAX's, borders included;
* the dyadic pyramid: bit-equal;
* lk_flow: ``valid`` equal on >= 99% of the tracks; ``pts1`` within
  1e-3 px on >= 94% of the tracks valid in both and within 0.25 px on all
  of them (measured: 99.2% and 0.0017 px on the translation pair, 95.2%
  and 0.121 px on the rendered pair); ``err`` within 1e-3 where ``pts1``
  agrees (measured: equal). The gap on the rest is named: XLA's CPU
  program contracts the window dot products into FMAs, and LK's
  bf16-quantized Gauss-Newton iteration carries those last bits into
  another quantization step on tracks that have not settled (JAX's own
  eager and jitted lk_flow differ by as much, 0.033 px, on such tracks).
* the accuracy contracts of tests/test_lk_fundamental.py on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import zoom

from amos_slam_tpu.ops import lk as jlk
from amos_slam_tpu_torch.io import synthetic
from amos_slam_tpu_torch.ops import lk as tlk

FX, FY, CX, CY = 535.4 / 2, 539.2 / 2, 320.1 / 2, 247.6 / 2
CAM = dict(fx=FX, fy=FY, cx=CX, cy=CY, width=320, height=240)
_jlk = jax.jit(jlk.lk_flow, static_argnames=("levels", "win_half", "iters"))


def _translation_pair(rng):
    base = zoom(rng.uniform(0, 255, (36, 46)), 8, order=1)[:240, :320]
    img0 = base.astype(np.float32)
    img1 = np.roll(np.roll(img0, -4, axis=0), 6, axis=1)
    pts = rng.uniform(50, 190, (128, 2)).astype(np.float32)
    return img0, img1, pts, (6.0, -4.0)


def _rendered_pair(rng):
    planes = synthetic.default_room(seed=3)
    poses = synthetic.orbit_trajectory(8, radius=0.1, advance=0.15)
    (g0, d0), (g1, _) = (synthetic.render(planes, poses[i], **CAM) for i in (3, 4))
    pts = np.stack([rng.uniform(30, 290, 256), rng.uniform(30, 210, 256)], -1).astype(np.float32)
    return g0, d0, g1, pts, poses[4] @ np.linalg.inv(poses[3])


def _both(img0, img1, pts, **kw):
    rj = _jlk(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
              jnp.ones(len(pts), bool), **kw)
    rt = tlk.lk_flow(torch.from_numpy(img0), torch.from_numpy(img1), torch.from_numpy(pts),
                     torch.ones(len(pts), dtype=torch.bool), **kw)
    return rj, rt


def _assert_parity(rj, rt):
    vj, vt = np.asarray(rj.valid), rt.valid.numpy()
    gap = np.abs(rt.pts1.numpy() - np.asarray(rj.pts1)).max(axis=1)
    egap = np.abs(rt.err.numpy() - np.asarray(rj.err))
    assert (vj == vt).mean() >= 0.99
    both = vj & vt
    assert (gap[both] < 1e-3).mean() >= 0.94, np.sort(gap[both])[-10:]
    assert gap[both].max() < 0.25, gap[both].max()
    assert egap[gap < 1e-3].max() < 1e-3


def test_sampler_and_pyramid_bit_equal(rng):
    g0, _, _, _, _ = _rendered_pair(rng)
    pj = jlk._dyadic_pyramid(jnp.asarray(g0), 3)
    pt = tlk._dyadic_pyramid(torch.from_numpy(g0), 3)
    for a, b in zip(pj, pt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # centres inside, near and beyond every border: the clamp collapses taps
    cy = np.concatenate([rng.uniform(-12, 250, 96), [0.25, -3.75, 238.5, 239.2, 120.0]])
    cx = np.concatenate([rng.uniform(-12, 330, 96), [0.25, 318.9, -2.2, 320.5, 319.0]])
    cy, cx = cy.astype(np.float32), cx.astype(np.float32)
    for lvl, img in enumerate(pt):
        s = np.float32(0.5 ** lvl)
        for extra in (0, 1):
            sj = jlk._sample_window(pj[lvl], jnp.asarray(cy * s), jnp.asarray(cx * s), 7, extra)
            st = tlk._sample_window(img, torch.from_numpy(cy * s), torch.from_numpy(cx * s),
                                    7, extra)
            np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_lk_pure_translation_matches_jax(rng):
    img0, img1, pts, shift = _translation_pair(rng)
    rj, rt = _both(img0, img1, pts, levels=3)
    _assert_parity(rj, rt)
    v = rt.valid.numpy()
    assert v.sum() > 100
    d = rt.pts1.numpy()[v] - pts[v]
    assert np.median(np.abs(d - np.array(shift)).max(axis=1)) < 0.3


def test_lk_rendered_motion_matches_jax(rng):
    g0, d0, g1, pts, T_rel = _rendered_pair(rng)
    rj, rt = _both(g0, g1, pts, levels=3)
    _assert_parity(rj, rt)
    # accuracy against the ground-truth reprojection through the depth
    v = rt.valid.numpy()
    assert v.sum() > 150
    xi = np.clip(pts[:, 0].round().astype(int), 0, 319)
    yi = np.clip(pts[:, 1].round().astype(int), 0, 239)
    z = d0[yi, xi]
    pc0 = np.stack([(pts[:, 0] - CX) / FX * z, (pts[:, 1] - CY) / FY * z, z], -1)
    pc1 = pc0 @ T_rel[:3, :3].T + T_rel[:3, 3]
    gt = np.stack([FX * pc1[:, 0] / pc1[:, 2] + CX, FY * pc1[:, 1] / pc1[:, 2] + CY], -1)
    ok = v & (z > 0)
    assert np.median(np.linalg.norm(rt.pts1.numpy()[ok] - gt[ok], axis=1)) < 0.5


@pytest.mark.parametrize("levels,win_half", [(1, 7), (4, 5)])
def test_lk_border_tracks_match_jax(rng, levels, win_half):
    """Sources at and past the border: windows whose taps the clamp
    collapses, tracks that leave the image, invalid inputs."""
    img0, img1, _, _ = _translation_pair(rng)
    pts = np.array([[1.0, 1.0], [318.5, 5.2], [3.3, 237.9], [160.0, 0.0], [0.0, 120.0],
                    [-4.0, 50.0], [330.0, 200.0], [150.2, 100.7]], np.float32)
    rj, rt = _both(img0, img1, pts, levels=levels, win_half=win_half)
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
    np.testing.assert_allclose(rt.err.numpy(), np.asarray(rj.err), atol=1e-3, rtol=0)
    np.testing.assert_allclose(rt.pts1.numpy(), np.asarray(rj.pts1), atol=1e-3, rtol=0)
    assert not rt.valid.numpy()[:7].any()     # the border gate

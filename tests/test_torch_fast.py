"""Port parity: FAST-9 margin, 3x3 NMS and spatially balanced selection.

Tolerances: the plain PyTorch versions equal the JAX package's XLA path
EXACTLY (every operation is a subtraction, min or max, and selection ties
resolve in the same order); against the Pallas kernel run in interpret mode
they are equal on the interior, cropped by HALO+1 as in
tests/test_fast_pallas_interpret.py. On a machine with a card, the CUDA
kernel is held exactly to the XLA formulation here, and to its plain version
in tests/test_torch_kernels.py (which imports no JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.ops import fast as jfast
from amos_slam_tpu.ops.pallas import fast_pallas
from amos_slam_tpu_torch.ops import fast as tfast
from amos_slam_tpu_torch.ops.kernels import fast_margin_nms as fmn_mod

EDGE = fast_pallas.HALO + 1


def _image(rng, h, w, integer=False):
    img = rng.uniform(0, 40, (h, w)).astype(np.float32)
    ys = rng.integers(8, h - 8, 40)
    xs = rng.integers(8, w - 8, 40)
    for y, x in zip(ys, xs):
        img[y : y + 3, x : x + 3] += rng.uniform(80, 160)
    return np.round(img) if integer else img


@pytest.mark.parametrize("shape,integer", [
    ((96, 128), False), ((70, 128), True), ((64, 100), True),
])
def test_plain_margin_and_nms_equal_xla(rng, shape, integer):
    img = _image(rng, *shape, integer=integer)
    m_t = tfast.fast_margin(torch.from_numpy(img))
    m_j = jfast.fast_margin(jnp.asarray(img))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(
        tfast.nms3x3(m_t).numpy(), np.asarray(jfast.nms3x3(m_j)))


def test_plain_batched_equals_vmapped_xla(rng):
    imgs = np.stack([_image(rng, 64, 96, integer=True) for _ in range(3)])
    ref = np.asarray(jax.vmap(lambda im: jfast.nms3x3(jfast.fast_margin(im)))(
        jnp.asarray(imgs)))
    out = fmn_mod.fast_margin_nms_plain(torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_plain_equals_pallas_interpret_on_interior(rng):
    img = _image(rng, 70, 128)
    out = fmn_mod.fast_margin_nms_plain(torch.from_numpy(img[None]))[0].numpy()
    pal = np.asarray(fast_pallas._impl_single(jnp.asarray(img), 64, interpret=True))
    np.testing.assert_array_equal(out[EDGE:-EDGE, EDGE:-EDGE], pal[EDGE:-EDGE, EDGE:-EDGE])
    imgs = np.stack([_image(rng, 64, 128) for _ in range(2)])
    outb = fmn_mod.fast_margin_nms_plain(torch.from_numpy(imgs)).numpy()
    palb = np.asarray(fast_pallas._impl_batched(jnp.asarray(imgs), 64, interpret=True))
    np.testing.assert_array_equal(
        outb[:, EDGE:-EDGE, EDGE:-EDGE], palb[:, EDGE:-EDGE, EDGE:-EDGE])


def _select_both(margin, active_hw, budget, min_th=7.0, border=19, cell=16):
    lj = jfast.select_from_margin(jnp.asarray(margin), active_hw, budget,
                                  min_th, border, cell)
    lt = tfast.select_from_margin(torch.from_numpy(margin), active_hw, budget,
                                  min_th, border, cell)
    return lj, lt


def _assert_level_equal(lj, lt):
    np.testing.assert_array_equal(lt.yx.numpy(), np.asarray(lj.yx))
    np.testing.assert_array_equal(lt.score.numpy(), np.asarray(lj.score))
    np.testing.assert_array_equal(lt.valid.numpy(), np.asarray(lj.valid))


def test_select_from_margin_exact_with_planted_ties(rng):
    # integer margins with many exact ties, within cells and across cells
    margin = rng.integers(0, 12, (160, 224)).astype(np.float32)
    margin[40:120:16, 40:200:16] = 30.0
    lj, lt = _select_both(margin, (150, 210), budget=40)
    _assert_level_equal(lj, lt)
    assert int(np.asarray(lj.valid).sum()) == 40
    # a budget above the number of cells pads with invalid rows
    lj, lt = _select_both(margin, (150, 210), budget=200)
    _assert_level_equal(lj, lt)


def test_top_k_stable_order_matches_lax_top_k():
    x = np.asarray([3, 5, 5, 1, 5, 3, 0, 0], np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(x), 5)
    vt, it = tfast.top_k_stable(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_detect_level_exact(rng):
    img = _image(rng, 120, 160, integer=True)
    lj = jfast.detect_level(jnp.asarray(img), (110, 150), 30, 7.0, 19, 16)
    lt = tfast.detect_level(torch.from_numpy(img), (110, 150), 30, 7.0, 19, 16)
    _assert_level_equal(lj, lt)


@pytest.mark.cuda
def test_cuda_kernel_equals_xla(rng):
    """The CUDA kernel against the JAX package's XLA formulation (JAX on the
    CPU), exactly, per image of a batch whose H is not a tile multiple."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    imgs = np.stack([_image(rng, 70, 128, integer=True) for _ in range(3)])
    ref = np.asarray(jax.vmap(lambda im: jfast.nms3x3(jfast.fast_margin(im)))(
        jnp.asarray(imgs)))
    out = fmn_mod.fast_margin_nms(torch.from_numpy(imgs).cuda())
    np.testing.assert_array_equal(out.cpu().numpy(), ref)

"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither jax nor amos_slam_tpu, so it also runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tests marked ``cuda`` skip without a card. Tolerance: exact equality (the
FAST kernel does only subtractions, minima and maxima).
"""

import numpy as np
import pytest
import torch

from amos_slam_tpu_torch.ops.kernels import fast_margin_nms as fmn_mod


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


def _images(seed, b, h, w):
    rng = np.random.default_rng(seed)
    img = np.round(rng.uniform(0, 40, (b, h, w))).astype(np.float32)
    for i in range(b):
        for y, x in zip(rng.integers(3, h - 6, 40), rng.integers(3, w - 6, 40)):
            img[i, y : y + 3, x : x + 3] += np.round(rng.uniform(80, 160))
    return torch.from_numpy(img)


def test_fast_wrapper_cpu_path_is_plain_and_uncounted():
    imgs = _images(0, 2, 48, 64)
    fmn = fmn_mod.fast_margin_nms
    before = fmn.launches
    assert torch.equal(fmn(imgs), fmn_mod.fast_margin_nms_plain(imgs))
    assert fmn.launches == before
    with pytest.raises(ValueError):
        fmn(torch.empty(2, 8, 8, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 480, 640), (3, 70, 128), (1, 480, 640), (2, 33, 65)])
def test_fast_kernel_equals_plain(cuda, shape):
    fmn = fmn_mod.fast_margin_nms
    x = _images(1, *shape).to(cuda)
    before = fmn.launches
    out = fmn(x)
    torch.cuda.synchronize()
    assert fmn.launches == before + 1
    assert torch.equal(out, fmn_mod.fast_margin_nms_plain(x))


@pytest.mark.cuda
def test_fast_kernel_rejects_bad_input(cuda):
    fmn = fmn_mod.fast_margin_nms
    with pytest.raises(ValueError):
        fmn(torch.zeros(4, 4, device=cuda))                      # rank 2
    with pytest.raises(ValueError):
        fmn(torch.zeros(1, 8, 8, device=cuda).transpose(1, 2))   # not contiguous
    with pytest.raises(ValueError):
        fmn(torch.zeros(1, 8, 8, device=cuda, dtype=torch.float64))

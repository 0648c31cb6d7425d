"""The port's Segmenter (models/segmenter.py) against the JAX package's, on
the CPU.

Both run the full-depth ResNet-50 YOLACT with 5 classes at img_size 128 on
identical random weights (the port's Flax-style init with randomized
batch-norm statistics, carried to JAX by its ``port_state_dict``), with
person_classes (0, 1, 2, 3) and score 0.0 so that random weights give
non-empty masks (~10% of the image), on (96, 128, 3) uint8 frames.

Gates: the input resize (480x640 -> 400x400, f32) within 1e-5 of full
scale of ``jax.image.resize`` (measured 2.3e-6: summation order); f32
masks >= 99.9% equal per image (measured 100%) and non-trivial; bf16
masks >= 97% equal per image (measured 98.4-100%, median 99.7%, over 18
images of six seeds: the bf16 nets differ by about one bf16 ulp of their
outputs, tests/test_torch_yolact.py, which moves detections whose scores
nearly tie); repeated calls equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.models.port_torch import port_state_dict
from amos_slam_tpu.models.segmenter import Segmenter as JSegmenter
from amos_slam_tpu_torch.models.resnet import FrozenBN
from amos_slam_tpu_torch.models.segmenter import Segmenter, flax_init_
from amos_slam_tpu_torch.models.yolact import Resize, Yolact

KW = dict(num_classes=5, person_classes=(0, 1, 2, 3), score_th=0.0, img_size=128)
BF16_VS_F32 = (8e-2, 2e-2)    # max and rms error over |f32|, see below
DTYPES = {"f32": (torch.float32, jnp.float32, 0.999), "bf16": (torch.bfloat16, jnp.bfloat16, 0.97)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(port state_dict, JAX params) of one random full-depth net."""
    model = Yolact(KW["num_classes"])
    flax_init_(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    for m in model.modules():
        if isinstance(m, FrozenBN):
            n = m.weight.shape[0]
            for buf, (lo, hi) in zip((m.weight, m.bias, m.running_mean, m.running_var),
                                     ((0.5, 1.5), (-0.5, 0.5), (-0.5, 0.5), (0.5, 2.0))):
                buf.copy_(torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32)))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    return sd, port_state_dict(sd)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(2).integers(0, 256, (3, 96, 128, 3), dtype=np.uint8)


def test_input_resize_matches_jax():
    rgb = np.random.default_rng(0).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    resize = Resize(h_first=False)
    got = resize(torch.from_numpy(rgb).float().permute(0, 3, 1, 2), (400, 400))
    got = got.permute(0, 2, 3, 1).numpy()
    batch = jax.jit(lambda r: jax.image.resize(r.astype(jnp.float32), (2, 400, 400, 3),
                                               "bilinear"))(rgb)
    one = jax.jit(lambda r: jax.image.resize(r.astype(jnp.float32), (400, 400, 3),
                                             "bilinear"))(rgb[0])
    assert np.abs(got - np.asarray(batch)).max() / 255 < 1e-5
    assert np.abs(got[0] - np.asarray(one)).max() / 255 < 1e-5


@pytest.mark.parametrize("name", list(DTYPES))
def test_segmenter_matches_jax(weights, images, name):
    dtype, jdtype, agree = DTYPES[name]
    sd, params = weights
    js = JSegmenter(params, compute_dtype=jdtype, **KW)
    ts = Segmenter(sd, compute_dtype=dtype, device="cpu", **KW)
    one = ts.person_mask(images[0])
    batch = ts.person_mask_batch(images)
    assert one.dtype == torch.bool and one.shape == (96, 128)
    assert batch.dtype == torch.bool and batch.shape == (3, 96, 128)
    want = [np.asarray(js.person_mask(images[0]))] + list(np.asarray(js.person_mask_batch(images)))
    for got, ref in zip([one.numpy()] + list(batch.numpy()), want):
        assert (got == ref).mean() >= agree
        assert 0.01 < ref.mean() < 0.99 and 0.01 < got.mean() < 0.99


def test_repeated_calls_equal(weights, images):
    sd, _ = weights
    ts = Segmenter(sd, compute_dtype=torch.bfloat16, device="cpu", **KW)
    assert torch.equal(ts.person_mask_batch(images), ts.person_mask_batch(images))
    assert torch.equal(ts.person_mask(images[1]), ts.person_mask(images[1]))
    # torch tensors of any dtype are taken as they are
    assert torch.equal(ts.person_mask(torch.from_numpy(images[1]).float()),
                       ts.person_mask(images[1]))


def test_random_init_is_seeded():
    a = Segmenter(device="cpu", generator=torch.Generator().manual_seed(3), **KW)
    b = Segmenter(device="cpu", generator=torch.Generator().manual_seed(3), **KW)
    c = Segmenter(device="cpu", generator=torch.Generator().manual_seed(4), **KW)
    key = "backbone.layers.3.2.conv2.weight"
    sa, sb, sc = (s.model.state_dict() for s in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa[key], sc[key])
    w = sa[key].float()
    fan_in = w.shape[1] * 9
    assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.05     # lecun-normal
    assert float(w.abs().max()) <= 2 / 0.87962566103423978 / fan_in ** 0.5 * 1.01
    assert float(sa["fpn.lat_layers.0.bias"].abs().max()) == 0.0



def test_bf16_raw_outputs_near_f32(images):
    """The bf16 net against the f32 net on the same weights and frames, for
    the net chip_smoke.py runs (81 classes, Flax's init, seed 0) at
    img_size 128: raw outputs within BF16_VS_F32 = (max, rms) of |f32|
    (measured at most 4.6e-2 max (coef) and 1.0e-2 rms over seeds 0-2 at
    img_size 128 and 400). chip_smoke.py holds the card's bf16 path to its
    f32 path with these tolerances."""
    kw = dict(person_classes=tuple(range(80)), score_th=0.0, img_size=128, device="cpu")
    f32 = Segmenter(compute_dtype=torch.float32, **kw)
    bf16 = Segmenter(f32.model.state_dict(), compute_dtype=torch.bfloat16, **kw)
    for name, a, b in zip(("loc", "conf", "coef", "proto"), f32.raw(images), bf16.raw(images)):
        err = (float((a - b).abs().max() / a.abs().max()), float((a - b).norm() / a.norm()))
        assert err[0] < BF16_VS_F32[0] and err[1] < BF16_VS_F32[1], (name, err)

"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither jax nor amos_slam_tpu, so it also runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tests marked ``cuda`` skip without a card. Tolerance: exact equality (the
FAST kernel does only subtractions, minima, maxima and selects), with and
without per-image extents, on inputs with negative values and nonzero
padding beyond the extents.
"""

import numpy as np
import pytest
import torch

from amos_slam_tpu_torch.config import ORBConfig
from amos_slam_tpu_torch.ops.kernels import fast_margin_nms as fmn_mod

LEVELS = [list(s) for s in ORBConfig().level_sizes(640, 480)]
# the stereo path at KITTI 00-02's canvas: 1241 is not a multiple of 4, so
# staging takes the scalar path
KITTI_LEVELS = [list(s) for s in ORBConfig().level_sizes(1241, 376)]
# name -> ((B, H, W), extents or None, lowest input value)
EXTENT_CASES = {
    "main_path_levels": ((8, 480, 640), LEVELS, -50),
    "main_path_canvas": ((8, 480, 640), None, 0),
    "kitti_stereo_levels": ((8, 376, 1241), KITTI_LEVELS, -50),
    "ragged": ((3, 70, 128), [[70, 128], [37, 65], [1, 1]], -50),
    "ragged_odd_width": ((3, 33, 65), [[33, 65], [17, 3], [32, 64]], -50),
    "equal_to_canvas": ((2, 96, 192), [[96, 192], [96, 192]], -50),
    "one_pixel": ((1, 480, 640), [[1, 1]], -50),
    "zero_tiles_beyond_tiny": ((2, 100, 300), [[1, 1], [5, 3]], -50),
    # the batched route: multistream's 8 pyramids, a mesh group's 4
    "multistream_levels": ((64, 480, 640), LEVELS * 8, -50),
    "mesh_group_levels": ((32, 480, 640), LEVELS * 4, -50),
    # ragged batches of more than one wave of active tiles, aligned and not
    "ragged_beyond_one_wave": ((64, 256, 384), [[256 - 3 * i, 384 - 5 * i] for i in range(64)],
                               -50),
    "ragged_beyond_one_wave_odd_width": ((64, 100, 333),
                                         [[100 - i, 333 - 3 * i] for i in range(64)], -50),
}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


def _images(seed, b, h, w, low=0):
    rng = np.random.default_rng(seed)
    img = np.round(rng.uniform(low, 40, (b, h, w))).astype(np.float32)
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


def test_fast_wrapper_cpu_path_with_extents_is_plain_and_uncounted():
    imgs = _images(2, 2, 48, 64, low=-50)
    ext = torch.tensor([[48, 64], [20, 33]], dtype=torch.int32)
    fmn = fmn_mod.fast_margin_nms
    before = fmn.launches
    assert torch.equal(fmn(imgs, ext), fmn_mod.fast_margin_nms_plain(imgs, ext))
    assert fmn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EXTENT_CASES))
def test_fast_kernel_with_extents_equals_plain(cuda, case):
    shape, hw, low = EXTENT_CASES[case]
    fmn = fmn_mod.fast_margin_nms
    x = _images(3, *shape, low=low).to(cuda)
    ext = None if hw is None else torch.tensor(hw, dtype=torch.int32, device=cuda)
    before = fmn.launches
    out = fmn(x, ext)
    torch.cuda.synchronize()
    assert fmn.launches == before + 1
    assert torch.equal(out, fmn_mod.fast_margin_nms_plain(x, ext))
    if hw is not None:
        for b, (h, w) in enumerate(hw):
            assert not out[b, h:].any() and not out[b, :, w:].any()


@pytest.mark.cuda
def test_fast_kernel_follows_extents_changed_in_place(cuda):
    fmn = fmn_mod.fast_margin_nms
    x = _images(4, 2, 70, 128, low=-50).to(cuda)
    ext = torch.tensor([[70, 128], [70, 128]], dtype=torch.int32, device=cuda)
    assert torch.equal(fmn(x, ext), fmn_mod.fast_margin_nms_plain(x, ext))
    ext[1] = torch.tensor([9, 30], dtype=torch.int32)
    assert torch.equal(fmn(x, ext), fmn_mod.fast_margin_nms_plain(x, ext))


@pytest.mark.cuda
def test_fast_kernel_never_falls_back_to_plain(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    x = _images(5, 2, 64, 128).to(cuda)
    ext = torch.tensor([[64, 128], [30, 40]], dtype=torch.int32, device=cuda)
    expect = (fmn_mod.fast_margin_nms_plain(x), fmn_mod.fast_margin_nms_plain(x, ext))
    monkeypatch.setattr(fmn_mod, "fast_margin_nms_plain", refuse)
    assert torch.equal(fmn_mod.fast_margin_nms(x), expect[0])
    assert torch.equal(fmn_mod.fast_margin_nms(x, ext), expect[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["shape", "dtype", "device", "zero", "too_high", "too_wide"])
def test_fast_kernel_rejects_bad_extents(cuda, bad):
    x = torch.zeros(2, 40, 64, device=cuda)
    ext = {
        "shape": torch.tensor([[40, 64]], dtype=torch.int32, device=cuda),
        "dtype": torch.tensor([[40, 64], [40, 64]], dtype=torch.int64, device=cuda),
        "device": torch.tensor([[40, 64], [40, 64]], dtype=torch.int32),
        "zero": torch.tensor([[40, 64], [0, 64]], dtype=torch.int32, device=cuda),
        "too_high": torch.tensor([[41, 64], [40, 64]], dtype=torch.int32, device=cuda),
        "too_wide": torch.tensor([[40, 64], [40, 65]], dtype=torch.int32, device=cuda),
    }[bad]
    with pytest.raises(ValueError):
        fmn_mod.fast_margin_nms(x, ext)


@pytest.mark.cuda
def test_fast_kernel_vmap_rule_one_launch_over_streams(cuda):
    """The multistream path's launch: 8 streams' (8, 480, 640) pyramids
    through the op's vmap rule are one launch over (64, 480, 640) with the
    level extents repeated, equal to the plain version per image."""
    S = 8
    fmn = fmn_mod.fast_margin_nms
    x = _images(6, S * 8, 480, 640, low=-50).to(cuda).reshape(S, 8, 480, 640)
    ext = torch.tensor(LEVELS, dtype=torch.int32, device=cuda)
    before = fmn.launches
    out = torch.func.vmap(lambda im: fmn(im, ext))(x)
    torch.cuda.synchronize()
    assert fmn.launches == before + 1
    assert out.shape == x.shape
    want = fmn_mod.fast_margin_nms_plain(x.reshape(S * 8, 480, 640), ext.repeat(S, 1))
    assert torch.equal(out.reshape(S * 8, 480, 640), want)


@pytest.mark.cuda
def test_yolact_tiny_train_step_card_equals_cpu(cuda):
    """The training path runs no kernel of the port's own (torch ops, cuDNN
    convs, TF32 off); one yolact_tiny step at batch 4 on the card against
    the CPU path, same weights and batch: loss parts within 1e-4 relative,
    every tensor's update (-lr x momentum) within 1e-3 of its max |update|.
    chip_smoke.py phase 12 makes the same check at yolact_resnet50's width."""
    from amos_slam_tpu_torch.models import configs, data, train
    from amos_slam_tpu_torch.models.segmenter import flax_init_

    cfg = configs.yolact_tiny
    model = cfg.build(device="cpu")
    flax_init_(model, torch.Generator().manual_seed(0))
    params = {k: v.clone() for k, v in model.state_dict().items()}
    ds = data.SyntheticShapes(n=4, size=cfg.img_size, seed=11)
    rng = np.random.default_rng(0)
    samples = [data.augment_sample(ds[i], rng) for i in range(4)]
    out = {}
    for dev in ("cpu", cuda):
        batch = data.samples_to_gt_batch(samples, cfg.img_size, cfg.max_objs, cfg.proto_shape,
                                         device=dev)
        init, step = train.make_train_step(model.to(dev), torch.from_numpy(cfg.priors()).to(dev),
                                           cfg.lr, cfg.momentum, cfg.weight_decay)
        state, loss, aux = step(init({k: v.to(dev) for k, v in params.items()}), batch)
        assert state.params["backbone.conv1.weight"].device.type == torch.device(dev).type
        out[str(dev)] = ({"loss": float(loss), **{k: float(v) for k, v in aux.items()}},
                         {k: (-cfg.lr * m).cpu() for k, m in state.opt_state.items()})
    (parts, upd), (c_parts, c_upd) = out["cuda"], out["cpu"]
    for k, v in c_parts.items():
        assert np.isfinite(parts[k]) and abs(parts[k] - v) <= 1e-4 * abs(v), (k, parts[k], v)
    for k, u in c_upd.items():
        err = float((upd[k] - u).abs().max())
        assert err <= 1e-3 * float(u.abs().max()), (k, err, float(u.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("force", ["tiles", "persistent"])
@pytest.mark.parametrize("width", [160, 165])
def test_fast_kernel_negative_zero_and_negatives(cuda, force, width):
    """Both kernels, whatever the shape would route to, on an aligned width
    (TMA and 16-byte paths) and an odd one (scalar paths): regions of -0.0
    beside +0.0, and negative values (the keys reverse the negatives' order
    and put -0 below +0)."""
    x = _images(7, 24, 96, width, low=-50)
    x[0, 10:20, 10:40] = -0.0
    x[1, 30:50, 60:90] = 0.0
    x[2, 5:25, 5:25] = -x[2, 5:25, 5:25].abs() - 1e-40
    x = x.to(cuda)
    ext = torch.tensor([[96 - i, width - 3 * i] for i in range(24)], dtype=torch.int32,
                       device=cuda)
    k = fmn_mod._FastMarginNMS(force=force)
    out = k(x, ext)
    torch.cuda.synchronize()
    assert k.launches == 1
    assert torch.equal(out, fmn_mod.fast_margin_nms_plain(x, ext))


@pytest.mark.cuda
def test_fast_kernel_route_by_shape(cuda):
    """The wrapper picks the kernel by the number of active tiles against
    the resident blocks of the persistent kernel: on an H100 the main
    path's pyramid takes the tiles kernel, multistream's (64, 480, 640) and
    a mesh group's (32, 480, 640) the persistent one, one launch each."""
    fmn = fmn_mod.fast_margin_nms
    wave = fmn.wave(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert wave >= sms and wave % sms == 0
    for S in (1, 4, 8):
        x = _images(8, S * 8, 480, 640).to(cuda)
        ext = torch.tensor(LEVELS * S, dtype=torch.int32, device=cuda)
        _, n_active = fmn_mod.tile_table(LEVELS * S, 480, 640)
        want = fmn_mod.route(n_active, wave)
        assert want == ("persistent" if n_active > 2 * wave else "tiles")
        assert fmn.route_of(n_active, cuda) == want
        before = fmn.launches
        out = fmn(x, ext)
        torch.cuda.synchronize()
        assert fmn.launches == before + 1
        assert (fmn._table(x, ext).grid > 0) == (want == "persistent")
        assert torch.equal(out, fmn_mod.fast_margin_nms_plain(x, ext))

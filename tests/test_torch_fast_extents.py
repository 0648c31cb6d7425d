"""The FAST kernel's extents contract, on the CPU.

``fast_margin_nms(imgs, extents)`` equals ``nms3x3(fast_margin(imgs))`` over
the whole canvas inside each image's extent ``(h_b, w_b)`` and 0 outside;
``extents=None`` is the whole canvas. Inputs are seeded numpy arrays with
negative values and nonzero padding beyond the extents. Tolerance: exact
equality throughout (every operation is a subtraction, min, max or select).

Besides the plain version, this file holds a tile-by-tile emulation of the
CUDA kernel's algorithm to the plain version (tile table, wrapped halo,
margins from raw circle values with the centre subtracted last and arcs
taken in pairs, the skipped ring beyond the extent, separable NMS, zero
tiles), so the design's exactness claims are checked without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.ops import fast as jfast
from amos_slam_tpu_torch.config import CameraConfig, ORBConfig
from amos_slam_tpu_torch.frontend import features
from amos_slam_tpu_torch.io import synthetic
from amos_slam_tpu_torch.ops import fast as tfast
from amos_slam_tpu_torch.ops.kernels import fast_margin_nms as fmn_mod

TH, TW = fmn_mod.TILE_H, fmn_mod.TILE_W

CASES = {
    "ragged_3x70x128": ((3, 70, 128), [(70, 128), (37, 65), (1, 1)]),
    "odd_width_2x33x65": ((2, 33, 65), [(33, 65), (20, 7)]),
    "levels_4x96x160": ((4, 96, 160), list(ORBConfig(n_levels=4).level_sizes(160, 96))),
    "canvas_2x64x128": ((2, 64, 128), [(64, 128), (64, 128)]),
}


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-50, 255, shape).astype(np.float32)
    b, h, w = shape
    for i in range(b):  # planted blobs so that real corners exist
        for y, x in zip(rng.integers(0, h - 3, 20), rng.integers(0, w - 3, 20)):
            img[i, y : y + 3, x : x + 3] += rng.uniform(80, 160)
    return torch.from_numpy(img)


def _case(name):
    shape, hw = CASES[name]
    return _inputs(sorted(CASES).index(name), shape), torch.tensor(hw, dtype=torch.int32)


def _emulate_kernel(imgs, extents):
    """The CUDA kernel's algorithm, tile by tile, in PyTorch."""
    B, H, W = imgs.shape
    hw = extents.numpy()
    out = torch.full_like(imgs, float("nan"))  # every pixel must be written
    table, n_active = fmn_mod.tile_table(hw, H, W)
    ty, tx = -(-H // TH), -(-W // TW)
    neg_inf = torch.tensor(float("-inf"))
    for k, tile in enumerate(table.tolist()):
        b, rem = divmod(tile, ty * tx)
        y0, x0 = (rem // tx) * TH, (rem % tx) * TW
        if k >= n_active:
            out[b, y0 : y0 + TH, x0 : x0 + TW] = 0.0
            continue
        hb, wb = (int(v) for v in hw[b])
        rows = torch.arange(y0 - 4, y0 + TH + 4) % H
        cols = torch.arange(x0 - 4, x0 + TW + 4) % W
        s = imgs[b][rows][:, cols]                                  # 40 x 72
        mh, mw = TH + 2, TW + 2
        ctr = s[3 : 3 + mh, 3 : 3 + mw]
        v = torch.stack([s[3 + dy : 3 + dy + mh, 3 + dx : 3 + dx + mw]
                         for dy, dx in tfast.CIRCLE16])
        # extremes of the 8 circle values from each odd start, then of the
        # arcs k, k+1 (k even): min(v[k+1..k+8]) against max(v[k], v[k+9])
        odd, even = slice(1, 16, 2), slice(0, 16, 2)
        lo8 = torch.stack([v.roll(-i, 0) for i in range(8)]).amin(0)[odd]
        hi8 = torch.stack([v.roll(-i, 0) for i in range(8)]).amax(0)[odd]
        ends_hi = torch.maximum(v, v.roll(-9, 0))[even]
        ends_lo = torch.minimum(v, v.roll(-9, 0))[even]
        bright = torch.minimum(lo8, ends_hi).amax(0)
        dark = torch.maximum(hi8, ends_lo).amin(0)
        m = torch.clamp(torch.maximum(bright - ctr, ctr - dark), min=0.0)
        y = torch.arange(y0 - 1, y0 + TH + 1)[:, None]
        x = torch.arange(x0 - 1, x0 + TW + 1)[None, :]
        need = (y >= 0) & (y < min(H, hb + 1)) & (x >= 0) & (x < min(W, wb + 1))
        m = torch.where(need, m, neg_inf)
        hmax = torch.maximum(m[:, :-2], torch.maximum(m[:, 1:-1], m[:, 2:]))
        mx = torch.maximum(torch.maximum(hmax[1:-1], hmax[2:]), hmax[:-2])
        c = m[1:-1, 1:-1]
        keep = (y[1:-1] < hb) & (x[:, 1:-1] < wb) & (c >= mx)
        o = torch.where(keep, c, torch.zeros(()))
        out[b, y0 : y0 + TH, x0 : x0 + TW] = o[: H - y0, : W - x0]
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_with_extents_is_full_map_zeroed_outside(name):
    imgs, ext = _case(name)
    full = fmn_mod.fast_margin_nms_plain(imgs)
    out = fmn_mod.fast_margin_nms_plain(imgs, ext)
    for b, (h, w) in enumerate(ext.tolist()):
        assert torch.equal(out[b, :h, :w], full[b, :h, :w])
        assert not out[b, h:].any() and not out[b, :, w:].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_with_extents_equals_xla_inside(name):
    imgs, ext = _case(name)
    ref = np.asarray(jax.vmap(lambda im: jfast.nms3x3(jfast.fast_margin(im)))(
        jnp.asarray(imgs.numpy())))
    out = fmn_mod.fast_margin_nms_plain(imgs, ext).numpy()
    for b, (h, w) in enumerate(ext.tolist()):
        np.testing.assert_array_equal(out[b, :h, :w], ref[b, :h, :w])


def test_extents_none_is_the_whole_canvas():
    imgs, _ = _case("ragged_3x70x128")
    B, H, W = imgs.shape
    today = tfast.nms3x3(tfast.fast_margin(imgs))
    assert torch.equal(fmn_mod.fast_margin_nms_plain(imgs), today)
    assert torch.equal(fmn_mod.fast_margin_nms(imgs), today)
    canvas = torch.tensor([[H, W]] * B, dtype=torch.int32)
    assert torch.equal(fmn_mod.fast_margin_nms(imgs, canvas), today)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_algorithm_emulation_equals_plain(name):
    imgs, ext = _case(name)
    assert torch.equal(_emulate_kernel(imgs, ext), fmn_mod.fast_margin_nms_plain(imgs, ext))


@pytest.mark.parametrize("name", sorted(CASES))
def test_tile_table_lists_every_tile_once_active_first(name):
    (B, H, W), hw = CASES[name]
    table, n_active = fmn_mod.tile_table(hw, H, W)
    ty, tx = -(-H // TH), -(-W // TW)
    assert table.dtype == np.int32
    assert sorted(table.tolist()) == list(range(B * ty * tx))
    b, rem = np.divmod(table, ty * tx)
    y0, x0 = (rem // tx) * TH, (rem % tx) * TW
    h, w = np.asarray(hw)[b].T
    meets = (y0 < h) & (x0 < w)
    assert meets[:n_active].all() and not meets[n_active:].any()


def test_tile_table_of_the_main_path():
    orb, cam = ORBConfig(), CameraConfig()
    sizes = orb.level_sizes(cam.width, cam.height)
    per_level = [fmn_mod.tile_table([s], cam.height, cam.width)[1] for s in sizes]
    assert per_level == [150, 117, 77, 54, 40, 35, 24, 15]
    table, n_active = fmn_mod.tile_table(sizes, cam.height, cam.width)
    assert (n_active, table.size) == (512, 1200)
    assert sum(h * w for h, w in sizes) == 950_532


@pytest.mark.parametrize("bad", ["shape", "dtype", "device", "zero", "too_high", "too_wide"])
def test_bad_extents_raise(bad):
    imgs = _inputs(5, (2, 40, 64))
    ext = {
        "shape": torch.tensor([[40, 64]], dtype=torch.int32),
        "dtype": torch.tensor([[40, 64], [40, 64]], dtype=torch.int64),
        "device": torch.empty((2, 2), dtype=torch.int32, device="meta"),
        "zero": torch.tensor([[40, 64], [0, 64]], dtype=torch.int32),
        "too_high": torch.tensor([[41, 64], [40, 64]], dtype=torch.int32),
        "too_wide": torch.tensor([[40, 64], [40, 65]], dtype=torch.int32),
    }[bad]
    with pytest.raises(ValueError):
        fmn_mod.fast_margin_nms(imgs, ext)


def test_detect_keypoints_identical_with_and_without_extents(monkeypatch):
    cam = CameraConfig(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2,
                       width=320, height=240)
    orb = ORBConfig(n_features=500, n_levels=4, max_kpts=512)
    pipe = features.ORBPipeline(orb, cam, device="cpu")
    planes = synthetic.default_room(seed=1)
    T = synthetic.orbit_trajectory(2, radius=0.05, advance=0.1)[0]
    gray, _ = synthetic.render(planes, T, fx=cam.fx, fy=cam.fy, cx=cam.cx,
                               cy=cam.cy, width=320, height=240)
    image = torch.from_numpy(np.round(gray).astype(np.float32))
    assert pipe.level_extents.tolist() == [list(s) for s in pipe.sizes]
    with_ext = pipe.detect_keypoints(image)[0]
    monkeypatch.setattr(features, "fast_margin_nms",
                        lambda imgs, extents=None: fmn_mod.fast_margin_nms(imgs))
    without = pipe.detect_keypoints(image)[0]
    assert int(with_ext.valid.sum()) > 100
    for name in ("yx_level", "level", "response", "valid", "xy", "angle"):
        assert torch.equal(getattr(with_ext, name), getattr(without, name)), name

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


# ---- the persistent kernel (batched route): keys, three-input reductions,
# a walk of interleaved active and zero tiles ----

I32_MIN = torch.iinfo(torch.int32).min


def _key(x):
    """f32 -> the kernel's order-preserving int32 key (its own inverse on
    the bits)."""
    u = x.view(torch.int32)
    return u ^ ((u >> 31) & 0x7FFFFFFF)


def _unkey(k):
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def _min3(a, b, c):   # __vimin3_s32
    return torch.minimum(torch.minimum(a, b), c)


def _max3(a, b, c):   # __vimax3_s32
    return torch.maximum(torch.maximum(a, b), c)


def _margin_bits(s, mh, mw):
    """margin_key over a staged tile of keys s: the bits of each margin of
    the (mh, mw) block centred on s[3:3 + mh, 3:3 + mw]."""
    v = [s[3 + dy : 3 + dy + mh, 3 + dx : 3 + dx + mw] for dy, dx in tfast.CIRCLE16]
    ctr = s[3 : 3 + mh, 3 : 3 + mw]
    lo = [torch.minimum(v[2 * i + 1], v[(2 * i + 2) % 16]) for i in range(8)]
    hi = [torch.maximum(v[2 * i + 1], v[(2 * i + 2) % 16]) for i in range(8)]
    lq = [torch.minimum(lo[i], lo[(i + 1) % 8]) for i in range(8)]
    hq = [torch.maximum(hi[i], hi[(i + 1) % 8]) for i in range(8)]
    a = [_min3(lq[i], lq[(i + 2) % 8], torch.maximum(v[2 * i], v[(2 * i + 9) % 16]))
         for i in range(8)]
    d = [_max3(hq[i], hq[(i + 2) % 8], torch.minimum(v[2 * i], v[(2 * i + 9) % 16]))
         for i in range(8)]
    bright, dark = _max3(a[0], a[1], a[2]), _min3(d[0], d[1], d[2])
    bright, dark = _max3(bright, a[3], a[4]), _min3(dark, d[3], d[4])
    bright, dark = _max3(bright, a[5], a[6]), _min3(dark, d[5], d[6])
    bright, dark = torch.maximum(bright, a[7]), torch.minimum(dark, d[7])
    fb, fd, fc = _unkey(bright), _unkey(dark), _unkey(ctr)
    # __vimax_s32_relu on the bits of the two differences
    return torch.clamp(torch.maximum((fb - fc).view(torch.int32),
                                     (fc - fd).view(torch.int32)), min=0)


def _emulate_persistent(imgs, extents, grid):
    """The persistent kernel's algorithm in PyTorch: ``grid`` blocks, each
    walking its list of ``persistent_table``, the extents taken from the
    entries; returns the output (NaN where nothing wrote) and the number of
    writes per pixel."""
    B, H, W = imgs.shape
    lists, grid = fmn_mod.persistent_table(extents.numpy(), H, W, grid)
    out = torch.full_like(imgs, float("nan"))
    writes = torch.zeros(imgs.shape, dtype=torch.int32)
    tx = -(-W // TW)
    mh, mw = TH + 2, TW + 2
    for blk in range(grid):
        for b, tyx, hb, wb in lists[blk].tolist():
            if b < 0:
                continue
            y0, x0 = (tyx // tx) * TH, (tyx % tx) * TW
            region = (b, slice(y0, y0 + TH), slice(x0, x0 + TW))
            writes[region] += 1
            if y0 >= hb or x0 >= wb:        # zero tile
                out[region] = 0.0
                continue
            rows = torch.arange(y0 - 4, y0 + TH + 4) % H
            cols = torch.arange(x0 - 4, x0 + TW + 4) % W
            s = _key(imgs[b][rows][:, cols].contiguous())
            m = _margin_bits(s, mh, mw)
            y = torch.arange(y0 - 1, y0 + TH + 1)[:, None]
            x = torch.arange(x0 - 1, x0 + TW + 1)[None, :]
            need = (y >= 0) & (y < min(H, hb + 1)) & (x >= 0) & (x < min(W, wb + 1))
            m = torch.where(need, m, torch.tensor(I32_MIN, dtype=torch.int32))
            hmax = _max3(m[:, :-2], m[:, 1:-1], m[:, 2:])
            mx = _max3(hmax[:-2], hmax[1:-1], hmax[2:])
            c = m[1:-1, 1:-1]
            keep = (y[1:-1] < hb) & (x[:, 1:-1] < wb) & (c >= mx)
            o = torch.where(keep, c.view(torch.float32), torch.zeros(()))
            out[region] = o[: H - y0, : W - x0]
    return out, writes


STREAMS = 3
STREAM_LEVELS = list(ORBConfig(n_levels=4).level_sizes(160, 96))   # 4 levels of 96 x 160


def _streams_case():
    imgs = _inputs(11, (STREAMS * 4, 96, 160))
    imgs[0, 10:20, 10:30] = -0.0           # negative zeros beside +0 and negatives
    imgs[1, 40:50, 60:70] = 0.0
    return imgs, torch.tensor(STREAM_LEVELS * STREAMS, dtype=torch.int32)


@pytest.mark.parametrize("grid", [1, 7, 16, 500])
def test_persistent_emulation_equals_plain_and_xla(grid):
    imgs, ext = _streams_case()
    out, writes = _emulate_persistent(imgs, ext, grid)
    assert torch.equal(writes, torch.ones_like(writes))       # every pixel once
    assert not out.isnan().any()
    assert torch.equal(out, fmn_mod.fast_margin_nms_plain(imgs, ext))
    ref = np.asarray(jax.vmap(jax.vmap(lambda im: jfast.nms3x3(jfast.fast_margin(im))))(
        jnp.asarray(imgs.numpy().reshape(STREAMS, 4, 96, 160)))).reshape(imgs.shape)
    for b, (h, w) in enumerate(ext.tolist()):
        np.testing.assert_array_equal(out[b, :h, :w].numpy(), ref[b, :h, :w])
        assert not out[b, h:].any() and not out[b, :, w:].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_persistent_emulation_equals_plain_on_extent_cases(name):
    imgs, ext = _case(name)
    out, writes = _emulate_persistent(imgs, ext, grid=3)
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(out, fmn_mod.fast_margin_nms_plain(imgs, ext))


def test_key_map_orders_like_floats():
    tiny = np.float32(1e-45)   # the smallest subnormal
    vals = np.array([-np.inf, -3.4e38, -1.5, -1e-38, -tiny, -0.0, 0.0, tiny, 1e-38,
                     1.5, 3.4e38, np.inf], dtype=np.float32)
    rng = np.random.default_rng(3)
    vals = np.concatenate([vals, rng.standard_normal(50).astype(np.float32),
                           (rng.standard_normal(20) * 1e-40).astype(np.float32)])
    x = torch.from_numpy(vals)
    k = _key(x)
    assert torch.equal(_unkey(k).view(torch.int32), x.view(torch.int32))   # bit round trip
    a, b = x[:, None].expand(-1, x.numel()), x[None, :].expand(x.numel(), -1)
    ka, kb = k[:, None].expand_as(a), k[None, :].expand_as(b)
    assert torch.equal(_unkey(torch.minimum(ka, kb)), torch.minimum(a, b))
    assert torch.equal(_unkey(torch.maximum(ka, kb)), torch.maximum(a, b))
    signbit = torch.signbit(x)
    neg_zero_below = (x[:, None] == 0) & (x[None, :] == 0) & signbit[:, None] & ~signbit[None, :]
    assert torch.equal(ka < kb, (a < b) | neg_zero_below)   # -0 < +0 the one difference
    # the clamp: a signed max with 0 on raw bits is max(x, 0) for any x
    assert torch.equal(torch.clamp(x.view(torch.int32), min=0).view(torch.float32),
                       torch.clamp(x, min=0.0))


@pytest.mark.parametrize("case", ["main_path", "multistream_8", "mesh_group_4", "kitti"])
def test_route_by_shape(case):
    """Against one wave of the H100 (132 SMs x 3 blocks = 396): the main
    path's 512 and KITTI's 772 active tiles take the tiles kernel, the
    multistream (4,096) and mesh-group (2,048) launches the persistent one."""
    orb = ORBConfig()
    if case == "kitti":
        H, W = 376, 1241
        hw = orb.level_sizes(W, H)
    else:
        H, W = 480, 640
        hw = list(orb.level_sizes(W, H)) * {"main_path": 1, "multistream_8": 8,
                                            "mesh_group_4": 4}[case]
    _, n_active = fmn_mod.tile_table(hw, H, W)
    want = "tiles" if case in ("main_path", "kitti") else "persistent"
    assert fmn_mod.route(n_active, 396) == want
    k = fmn_mod._FastMarginNMS()
    k._waves[0] = 396
    assert k.route_of(n_active, torch.device("cuda", 0)) == want
    forced = fmn_mod._FastMarginNMS(force="persistent" if want == "tiles" else "tiles")
    forced._waves[0] = 396
    assert forced.route_of(n_active, torch.device("cuda", 0)) != want
    with pytest.raises(ValueError):
        fmn_mod._FastMarginNMS(force="fallback")


@pytest.mark.parametrize("grid", [1, 5, 396])
def test_persistent_table_deals_every_tile_once_and_evenly(grid):
    (B, H, W), hw = (24, 480, 640), list(ORBConfig().level_sizes(640, 480)) * 3
    lists, g = fmn_mod.persistent_table(hw, H, W, grid)
    active, idx, margins = fmn_mod._tile_grid(hw, H, W)
    per_image = active.shape[1] * active.shape[2]
    assert g == min(grid, active.size) and lists.shape[0] == g and lists.shape[2] == 4
    b, tyx, h, w = np.moveaxis(lists, -1, 0)
    tile = np.where(b >= 0, b * per_image + tyx, -1)
    assert sorted(tile[tile >= 0].tolist()) == list(range(active.size))
    assert (h[b >= 0] == np.asarray(hw)[b[b >= 0], 0]).all()
    assert (w[b >= 0] == np.asarray(hw)[b[b >= 0], 1]).all()
    flat = margins.reshape(-1)
    cost = np.where(tile >= 0, flat[tile.clip(0)], 0).sum(1)
    n_act = ((tile >= 0) & (flat[tile.clip(0)] > 0)).sum(1)
    n_zero = ((tile >= 0) & (flat[tile.clip(0)] == 0)).sum(1)
    assert n_act.max() - n_act.min() <= 1 and n_zero.max() - n_zero.min() <= 2
    assert cost.max() <= cost.mean() + flat.max()
    assert fmn_mod.margins_computed(hw, H, W) == int(flat.sum())

"""FAST-9 margin + 3x3 NMS: wrapper of the CUDA kernel in
``csrc/fast_margin_nms.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``amos_slam_tpu/ops/pallas/fast_pallas.py``
(``fast_margin_nms`` :174 and its single/batched grids :110/:128). The
kernel computes ``nms3x3(fast_margin(img))`` per image of a (B, H, W) batch
over the whole canvas and keeps it only inside each image's extent
``(h_b, w_b)`` (0 elsewhere), bit-exactly equal to
:func:`fast_margin_nms_plain`; the source's header says what bounds it on
the card and how its design meets that.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``fast_margin_nms.launches`` counts kernel launches, one per call.

Two kernels of the source serve two routes, chosen by shape (:func:`route`):
a call with at most two waves of resident blocks' worth of active tiles
(those that meet their image's extent) takes the tiles kernel, one block
per tile (the single route: one pyramid, (8, 480, 640) or KITTI's (8, 376,
1241)); a larger one takes the persistent kernel, one wave of blocks each
walking its list of active and zero tiles (the batched route:
multistream's (64, 480, 640), a mesh group's (32, 480, 640)).

The package's wrapper goes through the custom op
``amos_slam_tpu_torch::fast_margin_nms`` so that ``torch.func.vmap`` can
batch it: its vmap rule folds the vmapped axis into B and makes one launch
over (S * B, H, W) with the extents repeated S times (the counterpart of
the Pallas kernel's ``custom_vmap`` to its batched grid, :148-167).
Multistream SLAM vmaps the whole fused frame step over its streams, so one
launch serves every stream's pyramid.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import fast
from . import build

NAME = "fast_margin_nms"
TILE_H, TILE_W = 32, 64
# f32 operations per pixel of the kernel's algorithm: per polarity 24
# min/max for the 8-extremes at odd starts, 16 for the pairs of arcs and 7
# for the extreme over them; 2 centre subtractions, 2 for the polarity merge
# and the clamp at 0; NMS 5.5 max (separable, 44 per 4 x 2 pixels, counted
# as 6) + 1 select.
OPS_PER_PIXEL = 2 * 47 + 2 + 2 + 6 + 1
ROUTES = ("tiles", "persistent")
# the CUDA kernels' names, as a profiler lists them, one per route
KERNEL_NAMES = ("fast_margin_nms_kernel", "fast_margin_nms_persistent_kernel")
# Min/max instructions per margin of each route's kernel, by the pipe-probe
# row whose rate they issue at (tools/time_fast_kernel.py --pipe-probe):
# the tiles kernel's 94 of margin_at and 2 of the clamp, plus its NMS (44
# per 4 x 2 pixels); the persistent kernel's margin_key: 2-input integer
# min/max for pairs, quads and the arc ends (48) and the last step of each
# polarity's reduction (2), three-input DPX for the arcs (16) and the rest
# of the reductions (6), the clamp as one relu max, and its NMS (24 per 4 x
# 2 pixels, three-input).
MINMAX_PER_MARGIN = {
    "tiles": {"f32_minmax": 96 + 5.5},
    "persistent": {"i32_minmax": 50, "vimin3_s32": 11, "vimax3_s32": 11 + 3,
                   "vimax_s32_relu": 1},
}


def _check_extents(imgs: torch.Tensor, extents: torch.Tensor) -> None:
    """Shape, dtype and device of ``extents`` (values: :func:`_extent_values`)."""
    B = imgs.shape[0]
    if not isinstance(extents, torch.Tensor) or extents.dtype != torch.int32 \
            or tuple(extents.shape) != (B, 2) or extents.device != imgs.device:
        desc = (f"{tuple(extents.shape)} {extents.dtype} on {extents.device}"
                if isinstance(extents, torch.Tensor) else type(extents).__name__)
        raise ValueError(f"{NAME}: extents must be a ({B}, 2) int32 tensor on "
                         f"{imgs.device}, got {desc}")


def _extent_values(extents: torch.Tensor, H: int, W: int) -> np.ndarray:
    hw = extents.detach().cpu().numpy()
    if hw.size and not ((hw[:, 0] >= 1).all() and (hw[:, 0] <= H).all()
                        and (hw[:, 1] >= 1).all() and (hw[:, 1] <= W).all()):
        raise ValueError(f"{NAME}: extents must satisfy 1 <= h <= {H} and "
                         f"1 <= w <= {W}, got {hw.tolist()}")
    return hw


def fast_margin_nms_plain(imgs: torch.Tensor,
                          extents: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W) f32 -> (B, H, W) NMS'd FAST-9 margin over the whole
    canvas, zeroed outside each image's extent ``extents[b] = (h_b, w_b)``
    (``None``: the whole canvas), plain PyTorch."""
    out = fast.nms3x3(fast.fast_margin(imgs))
    if extents is None:
        return out
    _check_extents(imgs, extents)
    B, H, W = imgs.shape
    _extent_values(extents, H, W)
    ys = torch.arange(H, device=imgs.device)[None, :, None]
    xs = torch.arange(W, device=imgs.device)[None, None, :]
    inside = (ys < extents[:, 0, None, None]) & (xs < extents[:, 1, None, None])
    return torch.where(inside, out, torch.zeros((), dtype=out.dtype, device=out.device))


def _tile_grid(extents_hw, H: int, W: int):
    """(active (B, ty, tx) bool, tile indices, margins each tile computes)."""
    hw = np.asarray(extents_hw, dtype=np.int64).reshape(-1, 2)
    ty, tx = -(-H // TILE_H), -(-W // TILE_W)
    iy = np.arange(ty)[None, :, None] * TILE_H
    ix = np.arange(tx)[None, None, :] * TILE_W
    h, w = hw[:, 0, None, None], hw[:, 1, None, None]
    active = (iy < h) & (ix < w)
    idx = np.arange(hw.shape[0] * ty * tx).reshape(active.shape)
    # margins over the tile plus a 1-px ring, clipped to [0, min(H, h + 1))
    rows = np.minimum(iy + TILE_H + 1, np.minimum(H, h + 1)) - np.maximum(iy - 1, 0)
    cols = np.minimum(ix + TILE_W + 1, np.minimum(W, w + 1)) - np.maximum(ix - 1, 0)
    margins = np.where(active, rows.clip(0) * cols.clip(0), 0)
    return active, idx, margins


def tile_table(extents_hw, H: int, W: int) -> Tuple[np.ndarray, int]:
    """The tiles kernel's work list for a (B, H, W) canvas with extents
    ``extents_hw`` ((B, 2) ints): every tile index ``b * ty * tx + iy * tx +
    ix`` of the ``TILE_H x TILE_W`` grid once, the tiles that intersect
    their image's extent first. Returns (int32 table, number of those)."""
    active, idx, _ = _tile_grid(extents_hw, H, W)
    table = np.concatenate([idx[active], idx[~active]]).astype(np.int32)
    return table, int(active.sum())


def margins_computed(extents_hw, H: int, W: int) -> int:
    """Margins both kernels compute for these extents: each active tile's
    tile plus its 1-px ring, within the canvas and the extent's ring."""
    return int(_tile_grid(extents_hw, H, W)[2].sum())


def persistent_table(extents_hw, H: int, W: int, grid: int) -> Tuple[np.ndarray, int]:
    """The persistent kernel's work lists for ``grid`` blocks: an int32
    array (grid, L, 4), block k walking row k, each entry ``(b, iy * tx +
    ix, h_b, w_b)`` (the tile's image, its index in the image's tile grid,
    the image's extent) or ``(-1, 0, 0, 0)``; every tile appears once. The
    active tiles are dealt largest margin count first in a snake over the
    blocks, so every block gets an equal share of the arithmetic; the zero
    tiles fill each list up to L, spread evenly between its active tiles.
    Returns (lists, grid), the grid cut to the number of tiles if that is
    smaller."""
    hw = np.asarray(extents_hw, dtype=np.int64).reshape(-1, 2)
    active, idx, margins = _tile_grid(hw, H, W)
    act = idx[active][np.argsort(-margins[active], kind="stable")]
    zero = idx[~active]
    n = act.size + zero.size
    grid = max(1, min(int(grid), n))
    L = -(-n // grid)
    rnd, blk = np.divmod(np.arange(act.size), grid)
    blk = np.where(rnd % 2 == 1, grid - 1 - blk, blk)
    n_act = np.bincount(blk, minlength=grid)
    # grid * L - n < grid padding entries, one each to the blocks with most
    # actives among those with room
    pads = np.zeros(grid, dtype=np.int64)
    room = np.flatnonzero(n_act < L)
    pads[room[np.argsort(-n_act[room], kind="stable")][: grid * L - n]] = 1
    zero_end = np.cumsum(L - n_act - pads)
    order = np.full((grid, L), -1, dtype=np.int64)
    for k in range(grid):
        a_k, z_k = act[blk == k], zero[zero_end[k] - (L - n_act[k] - pads[k]):zero_end[k]]
        # even spread: active i at (i + 0.5) / a, zero j at (j + 0.5) / z
        keys = np.concatenate([(np.arange(a_k.size) + 0.5) / max(a_k.size, 1),
                               (np.arange(z_k.size) + 0.5) / max(z_k.size, 1)])
        seq = np.concatenate([a_k, z_k])[np.argsort(keys, kind="stable")]
        order[k, : seq.size] = seq
    per_image = active.shape[1] * active.shape[2]
    b, tyx = np.divmod(order, per_image)
    lists = np.stack([b, tyx, hw[b, 0], hw[b, 1]], axis=-1)
    lists[order < 0] = (-1, 0, 0, 0)
    return lists.astype(np.int32), grid


def route(n_active: int, wave: int) -> str:
    """The kernel for a call with ``n_active`` active tiles on a card that
    holds ``wave`` blocks of the persistent kernel at once: the persistent
    kernel once each block has more than two active tiles to walk, so that
    staging one overlaps computing another, else the tiles kernel. On the
    H100 (wave 396) the main path's 512 and KITTI's 772 active tiles take
    the tiles kernel, multistream's 4,096 and a mesh group's 2,048 the
    persistent one."""
    return "persistent" if n_active > 2 * wave else "tiles"


class _Table(NamedTuple):
    ref: Optional[weakref.ref]   # the extents tensor it was built from
    version: int                 # that tensor's version counter then
    tiles: torch.Tensor          # int32 table (tiles) or lists (persistent) on the device
    n_active: int
    grid: int                    # persistent kernel's blocks; 0: the tiles kernel


class _FastMarginNMS:
    """Callable wrapper; ``launches`` counts launches of the CUDA kernels.

    The table of an extents tensor is built (and its values checked) once,
    with one read of the extents to the host, and cached for as long as
    that tensor lives unmodified. ``library`` (a build of another source)
    and ``force`` (one of ROUTES, in place of :func:`route`) serve the
    timing tool; a library without the persistent kernel takes the tiles
    kernel.
    """

    def __init__(self, library: Optional[str] = None, force: Optional[str] = None):
        if force not in (None, *ROUTES):
            raise ValueError(f"{NAME}: force must be one of {ROUTES}, got {force!r}")
        self.launches = 0
        self._library = library
        self._force = force
        self._fns = None
        self._waves: Dict[int, int] = {}
        self._tables: Dict[tuple, _Table] = {}

    def _kernels(self):
        """(tiles entry, persistent entry or None, wave query or None)."""
        if self._fns is None:
            lib = build.load(NAME) if self._library is None else ctypes.CDLL(self._library)
            tiles = lib.fast_margin_nms_tiles_f32
            tiles.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            tiles.restype = ctypes.c_int
            persistent = wave = None
            if hasattr(lib, "fast_margin_nms_persistent_f32"):
                persistent = lib.fast_margin_nms_persistent_f32
                persistent.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
                persistent.restype = ctypes.c_int
                wave = lib.fast_margin_nms_wave
                wave.argtypes = []
                wave.restype = ctypes.c_int
            self._fns = (tiles, persistent, wave)
        return self._fns

    def wave(self, device: torch.device) -> int:
        """Blocks of the persistent kernel that ``device`` holds at once
        (0 for a library without it)."""
        index = torch.device(device).index or 0
        if index not in self._waves:
            _, persistent, wave = self._kernels()
            n = 0
            if persistent is not None:
                with torch.cuda.device(index):
                    n = wave()
                if n <= 0:
                    raise RuntimeError(f"{NAME}: occupancy query failed with CUDA error {-n}")
            self._waves[index] = n
        return self._waves[index]

    def route_of(self, n_active: int, device: torch.device) -> str:
        wave = self.wave(device)
        if wave == 0:
            return "tiles"
        return self._force or route(n_active, wave)

    def _table(self, imgs: torch.Tensor, extents: Optional[torch.Tensor]) -> _Table:
        B, H, W = imgs.shape
        if extents is None:
            key = (None, B, H, W, imgs.device)
        else:
            key = (id(extents), B, H, W)
        hit = self._tables.get(key)
        if hit is not None and (extents is None or (
                hit.ref() is extents and hit.version == extents._version)):
            return hit
        if extents is None:
            hw = np.tile(np.asarray([[H, W]]), (B, 1))
            ref, version = None, 0
        else:
            hw = _extent_values(extents, H, W)
            ref, version = weakref.ref(extents), extents._version
        table, n_active = tile_table(hw, H, W)
        grid = 0
        if self.route_of(n_active, imgs.device) == "persistent":
            table, grid = persistent_table(hw, H, W, self.wave(imgs.device))
            table = table.reshape(-1)
        self._tables = {k: v for k, v in self._tables.items()
                        if v.ref is None or v.ref() is not None}
        entry = _Table(ref, version, torch.from_numpy(table).to(imgs.device), n_active, grid)
        self._tables[key] = entry
        return entry

    def __call__(self, imgs: torch.Tensor,
                 extents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The package's kernel through the vmappable custom op; a variant
        built from another source (``library``) launches directly."""
        if self._library is not None or self._force is not None:
            return self.launch(imgs, extents)
        if imgs.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{NAME}: unsupported device {imgs.device}")
        if extents is not None:   # before dispatch, which would pick by device
            _check_extents(imgs, extents)
        return torch.ops.amos_slam_tpu_torch.fast_margin_nms(imgs, extents)

    def launch(self, imgs: torch.Tensor,
               extents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One launch on plain (unbatched) tensors: the plain version for a
        CPU tensor, a kernel for a CUDA tensor."""
        if imgs.device.type == "cpu":
            return fast_margin_nms_plain(imgs, extents)
        if imgs.device.type != "cuda":
            raise ValueError(f"{NAME}: unsupported device {imgs.device}")
        if imgs.dtype != torch.float32 or imgs.ndim != 3 or not imgs.is_contiguous():
            raise ValueError(
                f"{NAME}: needs a contiguous (B, H, W) float32 tensor, got "
                f"{tuple(imgs.shape)} {imgs.dtype} contiguous={imgs.is_contiguous()}"
            )
        B, H, W = imgs.shape
        if H * W >= 2 ** 31:
            raise ValueError(f"{NAME}: an image of {H} x {W} pixels is too large")
        if extents is not None:
            _check_extents(imgs, extents)
            if not extents.is_contiguous():
                raise ValueError(f"{NAME}: extents must be contiguous")
        out = torch.empty_like(imgs)
        if out.numel() == 0:
            return out
        table = self._table(imgs, extents)
        tiles, persistent, _ = self._kernels()
        with torch.cuda.device(imgs.device):
            stream = torch.cuda.current_stream(imgs.device).cuda_stream
            if table.grid:
                rc = persistent(imgs.data_ptr(), out.data_ptr(), table.tiles.data_ptr(),
                                table.tiles.numel() // (4 * table.grid), table.grid, B, H, W,
                                stream)
            else:
                ext = 0 if extents is None else extents.data_ptr()
                rc = tiles(imgs.data_ptr(), out.data_ptr(), ext, table.tiles.data_ptr(),
                           table.n_active, table.tiles.numel(), H, W, stream)
        if rc != 0:
            raise RuntimeError(f"{NAME}: kernel launch failed with CUDA error {rc}")
        self.launches += 1
        return out


fast_margin_nms = _FastMarginNMS()


@torch.library.custom_op(f"amos_slam_tpu_torch::{NAME}", mutates_args=(),
                         schema="(Tensor imgs, Tensor? extents) -> Tensor")
def _fmn_op(imgs: torch.Tensor, extents: Optional[torch.Tensor]) -> torch.Tensor:
    return fast_margin_nms.launch(imgs, extents)


@_fmn_op.register_fake
def _(imgs, extents):
    return torch.empty_like(imgs)


class _Repeated(NamedTuple):
    ref: weakref.ref             # the extents tensor it repeats
    version: int                 # that tensor's version counter then
    tensor: torch.Tensor         # (S * B, 2) int32, built once


_repeated: Dict[tuple, _Repeated] = {}


def repeated_extents(extents: torch.Tensor, S: int) -> torch.Tensor:
    """``extents`` repeated S times along B, built once per (extents, S)
    and kept for as long as that tensor lives unmodified: the same tensor
    every step, so the wrapper's tile table is found in its cache and a
    step reads nothing to the host."""
    global _repeated
    key = (id(extents), S)
    hit = _repeated.get(key)
    if hit is not None and hit.ref() is extents and hit.version == extents._version:
        return hit.tensor
    _repeated = {k: v for k, v in _repeated.items() if v.ref() is not None}
    rep = extents.repeat(S, 1).contiguous()
    _repeated[key] = _Repeated(weakref.ref(extents), extents._version, rep)
    return rep


@_fmn_op.register_vmap
def _(info, in_dims, imgs, extents):
    """One launch over every vmapped image: (S, B, H, W) -> (S * B, H, W),
    the extents repeated S times (or folded the same way when they are
    vmapped too), and the result unfolded."""
    S = info.batch_size
    img_dim, ext_dim = in_dims
    imgs = imgs.movedim(img_dim, 0) if img_dim is not None else imgs.expand(S, *imgs.shape)
    B, H, W = imgs.shape[1:]
    flat = imgs.reshape(S * B, H, W).contiguous()
    if extents is None:
        ext = None
    elif ext_dim is None:
        ext = repeated_extents(extents, S)
    else:
        ext = extents.movedim(ext_dim, 0).reshape(S * B, 2).contiguous()
    return _fmn_op(flat, ext).reshape(S, B, H, W), 0

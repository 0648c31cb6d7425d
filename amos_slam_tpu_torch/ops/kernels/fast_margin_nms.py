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
raises. ``fast_margin_nms.launches`` counts kernel launches.

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


def tile_table(extents_hw, H: int, W: int) -> Tuple[np.ndarray, int]:
    """The kernel's work list for a (B, H, W) canvas with extents
    ``extents_hw`` ((B, 2) ints): every tile index ``b * ty * tx + iy * tx +
    ix`` of the ``TILE_H x TILE_W`` grid once, the tiles that intersect
    their image's extent first. Returns (int32 table, number of those)."""
    hw = np.asarray(extents_hw, dtype=np.int64).reshape(-1, 2)
    ty, tx = -(-H // TILE_H), -(-W // TILE_W)
    iy = np.arange(ty)[None, :, None] * TILE_H
    ix = np.arange(tx)[None, None, :] * TILE_W
    active = (iy < hw[:, 0, None, None]) & (ix < hw[:, 1, None, None])
    idx = np.arange(hw.shape[0] * ty * tx).reshape(active.shape)
    table = np.concatenate([idx[active], idx[~active]]).astype(np.int32)
    return table, int(active.sum())


class _Table(NamedTuple):
    ref: Optional[weakref.ref]   # the extents tensor it was built from
    version: int                 # that tensor's version counter then
    tiles: torch.Tensor          # int32 tile table on the device
    n_active: int


class _FastMarginNMS:
    """Callable wrapper; ``launches`` counts launches of the CUDA kernel.

    The tile table of an extents tensor is built (and its values checked)
    once, with one read of the extents to the host, and cached for as long
    as that tensor lives unmodified.
    """

    def __init__(self, library: Optional[str] = None):
        self.launches = 0
        self._library = library  # a built variant of the source (timing tools)
        self._fn = None
        self._tables: Dict[tuple, _Table] = {}

    def _kernel(self):
        if self._fn is None:
            lib = build.load(NAME) if self._library is None else ctypes.CDLL(self._library)
            fn = lib.fast_margin_nms_tiles_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

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
        self._tables = {k: v for k, v in self._tables.items()
                        if v.ref is None or v.ref() is not None}
        entry = _Table(ref, version, torch.from_numpy(table).to(imgs.device), n_active)
        self._tables[key] = entry
        return entry

    def __call__(self, imgs: torch.Tensor,
                 extents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The package's kernel through the vmappable custom op; a variant
        built from another source (``library``) launches directly."""
        if self._library is not None:
            return self.launch(imgs, extents)
        if imgs.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{NAME}: unsupported device {imgs.device}")
        if extents is not None:   # before dispatch, which would pick by device
            _check_extents(imgs, extents)
        return torch.ops.amos_slam_tpu_torch.fast_margin_nms(imgs, extents)

    def launch(self, imgs: torch.Tensor,
               extents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One launch on plain (unbatched) tensors: the plain version for a
        CPU tensor, the kernel for a CUDA tensor."""
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
        fn = self._kernel()
        with torch.cuda.device(imgs.device):
            stream = torch.cuda.current_stream(imgs.device).cuda_stream
            rc = fn(imgs.data_ptr(), out.data_ptr(),
                    0 if extents is None else extents.data_ptr(),
                    table.tiles.data_ptr(), table.n_active, table.tiles.numel(),
                    H, W, stream)
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

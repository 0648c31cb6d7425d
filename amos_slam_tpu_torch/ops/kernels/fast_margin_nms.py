"""FAST-9 margin + 3x3 NMS: wrapper of the CUDA kernel in
``csrc/fast_margin_nms.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``amos_slam_tpu/ops/pallas/fast_pallas.py``
(``fast_margin_nms`` :174 and its single/batched grids :110/:128). The
kernel computes ``nms3x3(fast_margin(img))`` per image of a (B, H, W) batch,
bit-exactly equal to :func:`fast_margin_nms_plain`; the source's header says
what bounds it on the card and how its design meets that.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``fast_margin_nms.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import fast
from . import build

NAME = "fast_margin_nms"
# f32 operations per pixel of the kernel's algorithm: 16 circle differences,
# 2 x 16 pairwise min/max, 2 x 16 min/max of pairs, 16 x 6 for the arc ends
# and the max/min over arc starts, 3 for the polarity merge and the clamp at
# 0, 8 neighbour max + 1 select for the NMS.
OPS_PER_PIXEL = 16 + 32 + 32 + 96 + 3 + 9


def fast_margin_nms_plain(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32 -> (B, H, W) NMS'd FAST-9 margin, plain PyTorch."""
    return fast.nms3x3(fast.fast_margin(imgs))


class _FastMarginNMS:
    """Callable wrapper; ``launches`` counts launches of the CUDA kernel."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            fn = build.load(NAME).fast_margin_nms_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, imgs: torch.Tensor) -> torch.Tensor:
        if imgs.device.type == "cpu":
            return fast_margin_nms_plain(imgs)
        if imgs.device.type != "cuda":
            raise ValueError(f"{NAME}: unsupported device {imgs.device}")
        if imgs.dtype != torch.float32 or imgs.ndim != 3 or not imgs.is_contiguous():
            raise ValueError(
                f"{NAME}: needs a contiguous (B, H, W) float32 tensor, got "
                f"{tuple(imgs.shape)} {imgs.dtype} contiguous={imgs.is_contiguous()}"
            )
        B, H, W = imgs.shape
        out = torch.empty_like(imgs)
        if out.numel() == 0:
            return out
        fn = self._kernel()
        with torch.cuda.device(imgs.device):
            stream = torch.cuda.current_stream(imgs.device).cuda_stream
            rc = fn(imgs.data_ptr(), out.data_ptr(), B, H, W, stream)
        if rc != 0:
            raise RuntimeError(f"{NAME}: kernel launch failed with CUDA error {rc}")
        self.launches += 1
        return out


fast_margin_nms = _FastMarginNMS()

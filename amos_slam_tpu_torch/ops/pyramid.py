"""Image pyramid construction (port of ops/pyramid.py).

Same layout as the JAX package: the levels live in one stacked (L, H0, W0)
tensor, each level resized into the top-left corner of a full-size slot and
zero beyond its extent.

The JAX package resizes with ``jax.image.resize(..., "bilinear")``, which
anti-aliases when it shrinks: a triangle kernel widened by the inverse scale,
applied as one weight matrix per axis. ``F.interpolate`` without antialias
computes a different filter, so this module builds JAX's weight matrices in
numpy, in f32, and applies them as two products ``Wy @ img @ Wx^T``. What
remains is f32 rounding of the sums (tests/test_torch_orb.py states the
tolerance).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) f32 weights of ``jax.image.resize``'s antialiased
    triangle kernel (jax/_src/image/scale.py ``compute_weight_mat``),
    computed in the same f32 arithmetic."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, f32(0.0))
    return np.ascontiguousarray(w.T.astype(f32))


def resize_weights(
    level_sizes: Sequence[Tuple[int, int]], device
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per level l >= 1 the (Wy, Wx) pair that resizes level l-1 to l."""
    out = []
    for (ph, pw), (h, w) in zip(level_sizes[:-1], level_sizes[1:]):
        out.append((
            torch.from_numpy(resize_matrix(ph, h)).to(device),
            torch.from_numpy(resize_matrix(pw, w)).to(device),
        ))
    return out


def build_pyramid(
    image: torch.Tensor,
    level_sizes: Sequence[Tuple[int, int]],
    weights: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> torch.Tensor:
    """image (H0, W0) -> stacked f32 pyramid (L, H0, W0).

    Each level is resized from the previous one, like the reference's
    cv::resize of mvImagePyramid[level-1]. ``weights`` are
    :func:`resize_weights` of ``level_sizes`` (computed here if omitted)."""
    H0, W0 = image.shape
    image = image.to(torch.float32)
    if weights is None:
        weights = resize_weights(level_sizes, image.device)
    levels = [image]
    for lvl in range(1, len(level_sizes)):
        (ph, pw), (h, w) = level_sizes[lvl - 1], level_sizes[lvl]
        wy, wx = weights[lvl - 1]
        lv = wy @ levels[-1][:ph, :pw] @ wx.T
        levels.append(F.pad(lv, (0, W0 - w, 0, H0 - h)))
    return torch.stack(levels, dim=0)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur over the last two axes, edge-replicated (the
    reference's GaussianBlur 7x7 sigma 2, src/ORBextractor.cc:1525-1541),
    as the same weighted sum of shifts the JAX package takes."""
    r = ksize // 2
    xs = torch.arange(-r, r + 1, dtype=img.dtype, device=img.device)
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    k = k / torch.sum(k)

    def conv1d(x, axis):
        n = x.shape[axis]
        idx = torch.clamp(torch.arange(-r, n + r, device=x.device), 0, n - 1)
        xp = x.index_select(axis, idx)
        out = torch.zeros_like(x)
        for i in range(ksize):
            out = out + k[i] * xp.narrow(axis, i, n)
        return out

    return conv1d(conv1d(img, img.ndim - 1), img.ndim - 2)


def blur_pyramid(pyr: torch.Tensor) -> torch.Tensor:
    """Blur all levels of a stacked pyramid (L, H, W)."""
    return gaussian_blur(pyr)

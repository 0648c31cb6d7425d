"""f32 arithmetic in the order the JAX package's compiled programs use it.

Two habits of XLA decide the last bits of the geometric dynamic stage, and
its thresholds and argmins turn last bits into other decisions:

* under ``jax.jit`` a division by a literal constant becomes a product with
  the constant's f32 reciprocal (CUDA divides a tensor by a Python float
  the same way), so the port writes such divisions as ``x * recip(c)``;
* XLA's CPU reduce adds in index order, one running sum. :func:`seq_sum`
  does the same on the CPU, so the plain path meets the JAX package bit
  for bit there; on the card it is ``torch.sum``, deterministic in its own
  order.
"""

from __future__ import annotations

import numpy as np
import torch


def recip(c: float) -> float:
    """The f32 reciprocal of ``c`` (f32 division of 1 by f32(c))."""
    return float(np.float32(1.0) / np.float32(c))


def seq_sum(x: torch.Tensor, ndim: int = 1) -> torch.Tensor:
    """Sum over the last ``ndim`` dims, in row-major index order on the
    CPU (a running sum from 0, as XLA's CPU reduce), ``torch.sum`` on the
    card."""
    dims = tuple(range(-ndim, 0))
    if x.is_cuda:
        return x.sum(dim=dims)
    flat = x.reshape(x.shape[: x.ndim - ndim] + (-1,))
    acc = flat[..., 0]
    for k in range(1, flat.shape[-1]):
        acc = acc + flat[..., k]
    return acc

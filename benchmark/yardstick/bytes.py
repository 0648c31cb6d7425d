"""The least time a pass over memory needs (a frozen copy of the
arithmetic of the port's ``ops/kernels/timing.bound``), and the bytes of
one launch of the FAST-9 + 3x3 NMS op counted from its extents."""

from __future__ import annotations

from typing import Sequence, Tuple

from .peaks import F32_FLOP_S, HBM_BYTES_S


def bound(read_bytes: float, write_bytes: float, ops: float) -> Tuple[float, str]:
    """Least time in ms of a pass that reads and writes these bytes once
    each and does ``ops`` f32 operations: bytes over HBM bandwidth against
    operations over the f32 rate. Returns (ms, "bytes" or "operations")."""
    t_bytes = (read_bytes + write_bytes) / HBM_BYTES_S * 1e3
    t_ops = ops / F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fast_launch_bytes(n_images: int, level_sizes: Sequence[Tuple[int, int]],
                      H: int, W: int) -> Tuple[int, int]:
    """(bytes read, bytes written) of one launch over ``n_images`` pyramids
    of ``level_sizes`` on (H, W) canvases, float32: each pixel inside a
    level's extent read once, the whole (n_images * L, H, W) output
    written once."""
    read_px = n_images * sum(h * w for h, w in level_sizes)
    write_px = n_images * len(level_sizes) * H * W
    return 4 * read_px, 4 * write_px


def fast_launch_ms(n_images: int, level_sizes, H: int, W: int) -> float:
    """The bytes bound of one such launch, in ms."""
    r, w = fast_launch_bytes(n_images, level_sizes, H, W)
    return bound(r, w, 0.0)[0]

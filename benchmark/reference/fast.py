"""Plain reference of the ORB front end's corner responses: the image
pyramid, FAST-9 corner margins and 3x3 non-maximum suppression.

ORB-SLAM2's extractor (``ORBextractor.cc``) builds ``nlevels`` images, each
the previous one resized by ``1 / scaleFactor``, and scores FAST-9 corners
on the 16-pixel Bresenham circle of radius 3. The response of a pixel here
is its FAST margin: the largest threshold t at which 9 contiguous circle
pixels are all brighter than centre + t or all darker than centre - t (0
where none), kept only where it is the maximum of its 3 x 3 neighbourhood
(0 elsewhere). Each level lies in the top-left corner of a full-size
canvas, zero beyond its extent; circle reads wrap around the canvas and
the neighbourhood outside it counts as -inf; the response is kept only
inside the level's extent. The pyramid's resize is the antialiased
triangle filter of :func:`benchmark.reference.yolact.resize_matrix`.

``dtype=torch.bfloat16`` is the control: the same arithmetic with the
pyramid and the margins in bfloat16.

Plain torch on any device; imports nothing of the port.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .yolact import resize_matrix

CIRCLE16 = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
            (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


def level_sizes(width: int, height: int, scale: float,
                n_levels: int) -> Tuple[Tuple[int, int], ...]:
    """(h, w) of each level: the size divided by scale ** level, rounded."""
    return tuple((int(round(height / scale ** i)), int(round(width / scale ** i)))
                 for i in range(n_levels))


def pyramid(gray: torch.Tensor, sizes: Sequence[Tuple[int, int]],
            dtype=torch.float32) -> torch.Tensor:
    """(H, W) grey image -> (L, H, W) canvas of levels, each resized from the
    one before it and zero beyond its extent."""
    H, W = gray.shape
    levels = [gray.to(dtype)]
    for (ph, pw), (h, w) in zip(sizes[:-1], sizes[1:]):
        wy = torch.from_numpy(resize_matrix(ph, h)).to(gray.device, dtype)
        wx = torch.from_numpy(resize_matrix(pw, w)).to(gray.device, dtype)
        lv = wy @ levels[-1][:ph, :pw] @ wx.T
        levels.append(F.pad(lv, (0, W - w, 0, H - h)))
    return torch.stack(levels)


def fast_margin(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> FAST-9 margin of every pixel, circle reads wrapping."""
    d = torch.stack([torch.roll(img, (-dy, -dx), dims=(-2, -1)) for dy, dx in CIRCLE16]) - img

    def arcs(diff):
        m = diff
        for i in range(1, 9):
            m = torch.minimum(m, torch.roll(diff, -i, dims=0))
        return m.amax(dim=0)

    return torch.clamp(torch.maximum(arcs(d), arcs(-d)), min=0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    flat = score.reshape((-1, 1) + score.shape[-2:])
    mx = F.max_pool2d(flat.float(), 3, stride=1, padding=1).to(score.dtype).reshape(score.shape)
    return torch.where(score >= mx, score, torch.zeros((), dtype=score.dtype, device=score.device))


def responses(gray: torch.Tensor, sizes: Sequence[Tuple[int, int]],
              dtype=torch.float32) -> torch.Tensor:
    """(H, W) grey image in [0, 255] -> (L, H, W) float32 responses, zero
    outside each level's extent."""
    out = nms3x3(fast_margin(pyramid(gray, sizes, dtype))).float()
    H, W = gray.shape
    ys = torch.arange(H, device=gray.device)[:, None]
    xs = torch.arange(W, device=gray.device)[None, :]
    inside = torch.stack([(ys < h) & (xs < w) for h, w in sizes])
    return torch.where(inside, out, torch.zeros((), device=out.device))


def mismatch(got: torch.Tensor, ref: torch.Tensor, tol: float = 1e-3) -> Tuple[int, int]:
    """(pixels whose responses differ by more than ``tol`` grey levels,
    pixels where either side has a corner)."""
    bad = int(((got - ref).abs() > tol).sum())
    either = int(((got > 0) | (ref > 0)).sum())
    return bad, either

"""Rectified stereo matching: left keypoints -> subpixel disparity and depth
(port of ops/stereo.py).

The counterpart of Frame::ComputeStereoMatches (reference
src/Frame.cc:1179-1574): for each left keypoint, the right keypoints in a
row band of +-2 px (scaled by the level) are matched by descriptor
distance, then the match is refined to subpixel by an 11x11 SAD sweep of
+-5 px and a parabola through the best three costs. The band walk is a
masked (N, M) Hamming matrix; the sweep gathers all keypoints' patches at
once, one (N, 11, 11) tensor op per offset.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import hamming
from .f32 import seq_sum


class StereoMatchResult(NamedTuple):
    u_right: torch.Tensor   # (N,) refined right-image u (<0 = no match)
    depth: torch.Tensor     # (N,) bf / disparity (<0 = no match)
    valid: torch.Tensor     # (N,)


def match_stereo(
    left_desc: torch.Tensor,     # (N, 256)
    left_xy: torch.Tensor,       # (N, 2) level-0 coords
    left_level: torch.Tensor,    # (N,)
    left_valid: torch.Tensor,
    right_desc: torch.Tensor,    # (M, 256)
    right_xy: torch.Tensor,
    right_level: torch.Tensor,
    right_valid: torch.Tensor,
    left_img: torch.Tensor,      # (H, W) blurred level-0 image
    right_img: torch.Tensor,
    bf,
    min_z,                       # least depth: the largest disparity is bf / min_z
    max_dist: int = 100,
    win: int = 5,
    sweep: int = 5,
) -> StereoMatchResult:
    H, W = left_img.shape
    dev = left_xy.device
    bf = torch.as_tensor(bf, dtype=torch.float32, device=dev)
    min_z = torch.as_tensor(min_z, dtype=torch.float32, device=dev)
    scale_l = 1.2 ** left_level.to(torch.float32)

    # row band, disparity in (0, bf / min_z], levels at most one apart
    dv = torch.abs(left_xy[:, 1:2] - right_xy[None, :, 1])
    band = dv <= 2.0 * scale_l[:, None]
    disp = left_xy[:, 0:1] - right_xy[None, :, 0]
    max_disp = bf / torch.clamp(min_z, min=1e-3)
    dmask = (disp > 0.0) & (disp <= max_disp)
    level_ok = torch.abs(left_level[:, None] - right_level[None, :]) <= 1
    mask = band & dmask & level_ok & left_valid[:, None] & right_valid[None, :]

    dist = hamming.hamming_matrix(left_desc, right_desc)
    res = hamming.match(hamming.apply_mask(dist, mask), max_dist=max_dist, mutual=False)
    j = torch.clamp(res.idx, min=0)
    u_r0 = right_xy[j, 0]

    # subpixel SAD sweep around the candidate
    r = win
    ar = torch.arange(-r, r + 1, device=dev)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    flat_l, flat_r = left_img.reshape(-1), right_img.reshape(-1)

    def patch(flat, cy, cx):
        yy = torch.clamp(cy[:, None, None] + gy[None], 0, H - 1)
        xx = torch.clamp(cx[:, None, None] + gx[None], 0, W - 1)
        return flat[yy * W + xx]

    ly = torch.round(left_xy[:, 1]).long()
    lx = torch.round(left_xy[:, 0]).long()
    T = patch(flat_l, ly, lx)                                   # (N, P, P)
    # centre-subtracted patches, the reference's IL - centre
    T = T - T[:, r: r + 1, r: r + 1]

    sads = []
    base_x = torch.round(u_r0).long()
    for off in range(-sweep, sweep + 1):
        Rp = patch(flat_r, ly, base_x + off)
        Rp = Rp - Rp[:, r: r + 1, r: r + 1]
        sads.append(seq_sum(torch.abs(T - Rp), ndim=2))
    sad = torch.stack(sads, dim=-1)                             # (N, 2*sweep+1)
    best = torch.argmin(sad, dim=-1)                            # first minimum
    # parabola: x* = best + 0.5 (L - R) / (L - 2C + R)
    c = torch.gather(sad, 1, best[:, None])[:, 0]
    lft = torch.gather(sad, 1, torch.clamp(best - 1, 0, 2 * sweep)[:, None])[:, 0]
    rgt = torch.gather(sad, 1, torch.clamp(best + 1, 0, 2 * sweep)[:, None])[:, 0]
    denom = lft - 2 * c + rgt
    big = torch.abs(denom) > 1e-6
    frac = torch.where(big, 0.5 * (lft - rgt) / torch.where(big, denom, torch.ones_like(denom)),
                       torch.zeros_like(denom))
    frac = torch.clamp(frac, -1.0, 1.0)
    interior = (best > 0) & (best < 2 * sweep)
    u_ref = base_x.to(torch.float32) + (
        best.to(torch.float32) - sweep + torch.where(interior, frac, torch.zeros_like(frac)))

    disparity = left_xy[:, 0] - u_ref
    ok = res.valid & (disparity > 0.1) & (disparity <= max_disp)
    none = torch.full_like(u_ref, -1.0)
    return StereoMatchResult(
        u_right=torch.where(ok, u_ref, none),
        depth=torch.where(ok, bf / torch.clamp(disparity, min=0.1), none),
        valid=ok,
    )

"""Hamming-distance descriptor matching (port of ops/hamming.py).

For {0,1} bitplanes, hamming(a, b) = sum(a) + sum(b) - 2 a.b, so the full
(N, M) distance matrix is one matrix product. CUDA has no int8
``torch.matmul``; the product runs in f32, exact because every partial sum
is an integer <= 256. Windowing is a mask on the distance matrix.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .fast import top_k_stable

BIG = 1 << 20  # "infinite" distance for masked pairs


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 256) x (M, 256) {0,1} int8 -> (N, M) int32 Hamming distances."""
    dot = (a.to(torch.float32) @ b.to(torch.float32).T).to(torch.int32)
    na = torch.sum(a, dim=-1, dtype=torch.int32)
    nb = torch.sum(b, dim=-1, dtype=torch.int32)
    return na[:, None] + nb[None, :] - 2 * dot


class MatchResult(NamedTuple):
    idx: torch.Tensor      # (N,) int best column per row (-1 = no match)
    dist: torch.Tensor     # (N,) int32 best distance (BIG where unmatched)
    valid: torch.Tensor    # (N,) bool


def match(
    dist: torch.Tensor,
    max_dist: int = 50,
    nn_ratio: float = 1.0,
    mutual: bool = True,
    angle_q: Optional[torch.Tensor] = None,
    angle_t: Optional[torch.Tensor] = None,
    hist_bins: int = 30,
    hist_keep: int = 3,
) -> MatchResult:
    """Row-to-column matching with the reference matcher's gates.

    dist: (N, M) int32, pre-masked with BIG outside the window; max_dist:
    absolute gate (TH_LOW/TH_HIGH); nn_ratio: best < ratio * second-best;
    mutual: the row must also be its column's best; angle_q/angle_t:
    orientations for the rotation-histogram gate (the ``hist_keep`` most
    popular of ``hist_bins`` bins, ORBmatcher::ComputeThreeMaxima).

    Ties resolve as in the JAX package: the best column and the columns'
    best rows are the first minima; the second-best distance is the least
    distance left once that first minimum is taken out (``top_k(-dist, 2)``).
    """
    N, M = dist.shape
    rows = torch.arange(N, device=dist.device)
    bidx = torch.argmin(dist, dim=1)
    best = dist[rows, bidx]

    ok = best <= max_dist
    if nn_ratio < 1.0:
        rest = dist.clone()
        # a device scalar: a Python number would be copied from the host,
        # a host sync on the card
        rest[rows, bidx] = torch.full((), torch.iinfo(dist.dtype).max, dtype=dist.dtype,
                                      device=dist.device)
        second = torch.amin(rest, dim=1)
        ok &= best.to(torch.float32) < nn_ratio * second.to(torch.float32)
    if mutual:
        col_best_row = torch.argmin(dist, dim=0)
        ok &= col_best_row[bidx] == rows

    if angle_q is not None and angle_t is not None:
        two_pi = 2.0 * math.pi
        ang = torch.remainder(angle_q - angle_t[bidx], two_pi)
        bin_id = torch.clamp(
            (ang * (hist_bins / two_pi)).to(torch.int32), 0, hist_bins - 1
        ).long()
        # out of place: under vmap the source is batched, the zeros not
        counts = torch.zeros(hist_bins, dtype=torch.int32, device=dist.device)
        counts = counts.scatter_add(0, bin_id, ok.to(torch.int32))
        _, keep_bins = top_k_stable(counts, hist_keep)
        ok &= torch.any(bin_id[:, None] == keep_bins[None, :], dim=-1)

    return MatchResult(
        idx=torch.where(ok, bidx, -1),
        dist=torch.where(ok, best, BIG),
        valid=ok,
    )


def window_mask(
    query_uv: torch.Tensor,
    target_uv: torch.Tensor,
    radius,
    query_valid: torch.Tensor,
    target_valid: torch.Tensor,
) -> torch.Tensor:
    """(N, M) bool: target j within ``radius`` px of query i's predicted
    location (replaces Frame::GetFeaturesInArea's grid lookup)."""
    d = query_uv[:, None, :] - target_uv[None, :, :]
    r2 = torch.as_tensor(radius, dtype=torch.float32, device=query_uv.device) ** 2
    if r2.ndim == 1:
        r2 = r2[:, None]
    inside = torch.sum(d * d, dim=-1) <= r2
    return inside & query_valid[:, None] & target_valid[None, :]


def apply_mask(dist: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, dist, BIG)

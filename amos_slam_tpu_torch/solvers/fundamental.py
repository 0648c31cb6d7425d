"""Epipolar geometry (port of the part of solvers/fundamental.py that the
map and the geometric dynamic stage need). The batched F RANSAC of that
module has one user, the monocular initializer, and comes with it (ROADMAP
queue 1 item 10)."""

from __future__ import annotations

import torch


def epipolar_distance(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Symmetric epipolar distances: (..., 3, 3) F, (N, 2) points ->
    (..., N) max of point-to-line distances in both images (the quantity the
    reference thresholds at 0.5/1.0 px, src/Tracking.cc:939,1143)."""
    ones = torch.ones(x1.shape[:-1] + (1,), dtype=x1.dtype, device=x1.device)
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)
    l2 = torch.einsum("...ij,nj->...ni", F, p1)        # lines in image 2
    l1 = torch.einsum("...ji,nj->...ni", F, p2)        # lines in image 1
    num = torch.abs(torch.sum(l2 * p2, dim=-1))
    d2 = num / torch.clamp(torch.sqrt(l2[..., 0] ** 2 + l2[..., 1] ** 2), min=1e-9)
    d1 = num / torch.clamp(torch.sqrt(l1[..., 0] ** 2 + l1[..., 1] ** 2), min=1e-9)
    return torch.maximum(d1, d2)

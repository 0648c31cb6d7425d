"""SLIC superpixels + k-means depth clustering (port of ops/slic.py).

The reference's cluster module (src/cluster.cc:300-463: SLIC in CIELAB,
then k-means k=15 over superpixel centres with a normalized image + depth
distance), which powers the geometric stage of dynamic rejection
(Frame::CalDyna, src/Frame.cc:517).

As in the JAX package, no scatter: each pixel considers the 9 superpixel
centres of its 3x3 home-cell neighbourhood (per offset, the centre map is an
edge-clamped shift of the (gh, gw) grid, upsampled by block replication),
and the update routes each pixel's fields to centre ``home + offset`` by
per-cell block sums shifted back. The sums run in one fixed order, so the
result does not change from run to run on the card; an ``index_add_`` of
float sums would add with atomics, and the 9-way ``argmin`` turns such last
bits into other labels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

OFFSETS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) RGB in [0, 255] -> CIELAB (L in [0, 100], a/b ~ [-128, 127]).

    D65 white point, sRGB gamma (the reference converts with
    cv::COLOR_BGR2Lab, src/cluster.cc:88-146). torch has no ``cbrt``: the
    cube root is ``t ** (1/3)``, defined here because ``t > eps > 0``; it
    differs from ``jnp.cbrt`` in the last ulps (the parity test holds the
    Lab values to 1e-4)."""
    c = rgb.to(torch.float32) / 255.0
    lin = torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    # sRGB -> XYZ (D65), normalized by the white point
    x = (0.4124564 * r + 0.3575761 * g + 0.1804375 * b) / 0.95047
    y = 0.2126729 * r + 0.7151522 * g + 0.0721750 * b
    z = (0.0193339 * r + 0.1191920 * g + 0.9503041 * b) / 1.08883
    eps, kap = 216.0 / 24389.0, 24389.0 / 27.0

    def f(t):
        return torch.where(t > eps, torch.clamp(t, min=eps) ** (1.0 / 3.0),
                           (kap * t + 16.0) / 116.0)

    fx, fy, fz = f(x), f(y), f(z)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


class ClusterResult(NamedTuple):
    pixel_cluster: torch.Tensor   # (H, W) int64 in [0, k)
    pixel_super: torch.Tensor     # (H, W) int64 superpixel label
    center_cluster: torch.Tensor  # (G,) int64 k-means id per superpixel
    center_depth: torch.Tensor    # (G,) mean depth per superpixel


def _offset_tabs(device):
    """(9,) dy and dx of OFFSETS, built on the device (no host copy)."""
    o = torch.arange(9, device=device)
    return o // 3 - 1, o % 3 - 1


def _shift_grid(grid: torch.Tensor, sign: int = 1) -> torch.Tensor:
    """grid (..., gh, gw) -> (..., 9, gh, gw): for each offset (dy, dx) of
    OFFSETS, the value of grid[i + sign*dy, j + sign*dx] at (i, j),
    edge-clamped."""
    gh, gw = grid.shape[-2:]
    dev = grid.device
    dy, dx = _offset_tabs(dev)
    iy = torch.clamp(torch.arange(gh, device=dev)[None] + sign * dy[:, None], 0, gh - 1)
    ix = torch.clamp(torch.arange(gw, device=dev)[None] + sign * dx[:, None], 0, gw - 1)
    return grid[..., iy[:, :, None], ix[:, None, :]]


def _upsample(grid: torch.Tensor, cell: int, H: int, W: int) -> torch.Tensor:
    """(..., gh, gw) -> (..., H, W) by block replication."""
    up = torch.repeat_interleave(torch.repeat_interleave(grid, cell, dim=-2), cell, dim=-1)
    return up[..., :H, :W]


def _block_sum(img: torch.Tensor, cell: int, gh: int, gw: int) -> torch.Tensor:
    """(..., H, W) -> (..., gh, gw) per-cell sums (a reshape reduction)."""
    H, W = img.shape[-2:]
    p = F.pad(img, (0, gw * cell - W, 0, gh * cell - H))
    return p.reshape(p.shape[:-2] + (gh, cell, gw, cell)).sum(dim=(-3, -1))


def _routed_sums(best_o: torch.Tensor, fields: torch.Tensor, cell: int,
                 gh: int, gw: int) -> torch.Tensor:
    """(F, gh, gw) per-centre sums of each field over the pixels whose
    chosen offset o routes them from home cell (i, j) to centre
    (i + dy, j + dx): the masked block sums of offset o shifted by
    (-dy, -dx), added in OFFSETS order, as the JAX package adds them."""
    o = torch.arange(9, device=best_o.device)
    omask = (best_o[None] == o[:, None, None]).to(fields.dtype)
    bs = _block_sum(omask[:, None] * fields[None], cell, gh, gw)    # (9, F, gh, gw)
    sh = _shift_grid(bs, -1)                                         # (9, F, 9, gh, gw)
    sh = sh[o, :, o]                                                 # (9, F, gh, gw)
    acc = sh[0]
    for j in range(1, 9):
        acc = acc + sh[j]
    return acc


def slic_kmeans(
    image: torch.Tensor,
    depth: torch.Tensor,
    cell: int = 16,
    compactness: float = 10.0,
    slic_iters: int = 5,
    k: int = 15,
    kmeans_iters: int = 10,
) -> ClusterResult:
    """``image``: (H, W) grey or (H, W, C) feature channels (pass
    :func:`rgb_to_lab` output for the reference's CIELAB SLIC)."""
    if image.ndim == 2:
        image = image[..., None]
    H, W, C = image.shape
    dev, dt = image.device, image.dtype
    gh, gw = -(-H // cell), -(-W // cell)
    G = gh * gw

    ys = torch.arange(H, dtype=dt, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=dt, device=dev)[None, :].expand(H, W)
    fields = torch.cat([ys[None], xs[None], image.permute(2, 0, 1),
                        torch.ones((1, H, W), dtype=dt, device=dev)])   # (F, H, W)

    def centers_from_offsets(best_o):
        acc = _routed_sums(best_o, fields, cell, gh, gw)
        return acc[:-1] / torch.clamp(acc[-1], min=1.0)              # (F-1, gh, gw)

    # initial centres: plain cell means (offset 4 == (0, 0) everywhere)
    best_o = torch.full((H, W), 4, dtype=torch.long, device=dev)
    cen = centers_from_offsets(best_o)

    inv_m2 = 1.0 / (compactness * compactness)
    inv_s2 = 1.0 / (cell * cell)
    for _ in range(slic_iters):
        # all 9 candidate distances at once, then the first minimum
        up = _upsample(_shift_grid(cen), cell, H, W)       # (F-1, 9, H, W)
        dyy = ys[None] - up[0]
        dxx = xs[None] - up[1]
        D = (dyy * dyy + dxx * dxx) * inv_s2
        for c in range(C):
            dii = image[None, :, :, c] - up[2 + c]
            D = D + dii * dii * inv_m2
        best_o = torch.argmin(D, dim=0)
        cen = centers_from_offsets(best_o)
    c_y, c_x, c_ch = cen[0], cen[1], cen[2:]

    # depth means per superpixel with the final assignment
    dacc = _routed_sums(best_o, torch.stack([depth.to(dt), fields[-1]]), cell, gh, gw)
    c_d = dacc[0] / torch.clamp(dacc[1], min=1.0)

    # final per-pixel superpixel label (home + chosen offset)
    dy_tab, dx_tab = _offset_tabs(dev)
    hy = torch.arange(H, device=dev)[:, None] // cell
    hx = torch.arange(W, device=dev)[None, :] // cell
    ly = torch.clamp(hy + dy_tab[best_o], 0, gh - 1)
    lx = torch.clamp(hx + dx_tab[best_o], 0, gw - 1)
    label = ly * gw + lx

    # ---- k-means over superpixel centres, normalized features -----------
    # The reference's distEclud (src/cluster.cc:372-385): normalized image
    # position + normalized depth; in colour mode the per-superpixel Lab
    # means join (the reference's commented-out colour term), so a
    # chroma-distinct mover at background depth keeps its own cluster.
    feat_cols = [
        c_x.reshape(-1) / W,
        c_y.reshape(-1) / H,
        c_d.reshape(-1) / torch.clamp(torch.max(c_d), min=1e-6),
    ]
    if C > 1:
        feat_cols += [c.reshape(-1) / 255.0 for c in c_ch]
    feat = torch.stack(feat_cols, dim=-1)                            # (G, 3 [+C])
    stride = max(G // k, 1)
    centers = feat[::stride][:k]
    if centers.shape[0] < k:
        centers = torch.cat([centers, centers[-1:].expand(k - centers.shape[0], -1)])

    assign = None
    for _ in range(kmeans_iters):
        diff = feat[:, None, :] - centers[None]                      # (G, k, D)
        sq = diff * diff
        d = sq[..., 0]
        for j in range(1, sq.shape[-1]):   # the sequential order of XLA's reduce
            d = d + sq[..., j]
        assign = torch.argmin(d, dim=-1)
        one_hot = F.one_hot(assign, k).to(feat.dtype)                # (G, k)
        sums = one_hot.T @ feat                                      # exact f32 product
        cnt = one_hot.sum(dim=0)
        new_c = sums / torch.clamp(cnt[:, None], min=1.0)
        centers = torch.where(cnt[:, None] > 0, new_c, centers)
    center_cluster = assign

    # per-pixel k-means id: each offset's shifted cluster grid, then select
    cc9 = _upsample(_shift_grid(center_cluster.reshape(gh, gw)), cell, H, W)
    pixel_cluster = torch.gather(cc9, 0, best_o[None])[0]

    return ClusterResult(
        pixel_cluster=pixel_cluster,
        pixel_super=label,
        center_cluster=center_cluster,
        center_depth=c_d.reshape(-1),
    )


def dilate_mask(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary dilation with a (2r+1)^2 square structuring element (the
    reference dilates the person mask with radius 15 before keypoint
    removal, src/ORBextractor.cc:1697-1704). Exactly the JAX package's
    zero-padded shift-max: a separable pair of stride-1 max pools."""
    m = mask.to(torch.float32)[None, None]
    if radius > 0:
        k = 2 * radius + 1
        m = F.max_pool2d(m, (k, 1), stride=1, padding=(radius, 0))
        m = F.max_pool2d(m, (1, k), stride=1, padding=(0, radius))
    return m[0, 0] > 0.5

"""Keypoint orientation (intensity centroid) and rotated-BRIEF descriptors
(port of ops/orb_descriptor.py).

Descriptors are {0,1} int8 bitplanes (N, 256), as in the JAX package, so
Hamming distance is a matrix product (ops/hamming.py). The sampling pattern
is generated from a numpy seed, so both packages use the same pattern bit
for bit.

The fast path works on one (N, 37, 37) patch per keypoint. Its descriptor
sampler (:func:`descriptors_from_patches`) is, in the JAX package, a product
of bf16 patches with a (1369, 16384) one-hot matrix: 23 G multiply-adds at
N = 1024 for a result that is a gather. Here it is that gather, of the same
bf16-rounded patch values at the same indices (:func:`_bin_sample_indices`),
so the bits are identical.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

PATCH_R = 15          # IC_Angle patch radius (reference HALF_PATCH_SIZE)
PATTERN_CLIP = 13     # max |coordinate| of BRIEF sample points

PATCH_RAD = 18        # covers rotated pattern offsets: |round(R(theta) p)| <= 18
PATCH_SIZE = 37       # 2*PATCH_RAD+1; with the 19 px detection border, whole
                      # patches never clip against the image
N_ROT_BINS = 32


def make_brief_pattern(seed: int, n_bits: int = 256) -> np.ndarray:
    """(n_bits, 2, 2) int32: two (x, y) sample points per bit.

    Gaussian BRIEF pattern (sigma = patch/5), clipped to +-PATTERN_CLIP,
    deterministic in ``seed``.
    """
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, (2 * PATTERN_CLIP + 1) / 5.0, size=(n_bits, 2, 2))
    return np.clip(np.round(pts), -PATTERN_CLIP, PATTERN_CLIP).astype(np.int32)


def _flat_take(pyr_flat: torch.Tensor, H: int, W: int, level, y, x):
    """Gather pyr[(level, y, x)] with clamped coordinates."""
    y = torch.clamp(y, 0, H - 1)
    x = torch.clamp(x, 0, W - 1)
    return pyr_flat[(level * H + y) * W + x]


def compute_orientations(
    pyr: torch.Tensor, level: torch.Tensor, yx: torch.Tensor
) -> torch.Tensor:
    """Intensity-centroid angles (radians), the f32 oracle: exact circular
    patch moments (the reference IC_Angle's umax extents,
    src/ORBextractor.cc:108) from column/row prefix sums.

    pyr: (L, H, W) unblurred pyramid; level: (N,) int; yx: (N, 2) level
    coords. Returns (N,) float32.
    """
    L, H, W = pyr.shape
    r = PATCH_R
    dev = pyr.device
    dxs = np.arange(-r, r + 1)
    bs = np.floor(np.sqrt(r * r - dxs * dxs + 1e-9)).astype(np.int64)

    zv = torch.zeros((L, 1, W), dtype=pyr.dtype, device=dev)
    Pv = torch.cat([zv, torch.cumsum(pyr, dim=1)], dim=1)
    zh = torch.zeros((L, H, 1), dtype=pyr.dtype, device=dev)
    Ph = torch.cat([zh, torch.cumsum(pyr, dim=2)], dim=2)

    y0 = torch.round(yx[:, 0]).long()
    x0 = torch.round(yx[:, 1]).long()
    lv = level.long()
    dx_j = torch.as_tensor(dxs, device=dev)
    b_j = torch.as_tensor(bs, device=dev)
    w = dx_j[None].to(pyr.dtype)

    xx = torch.clamp(x0[:, None] + dx_j[None], 0, W - 1)
    ytop = torch.clamp(y0[:, None] - b_j[None], 0, H)
    ybot = torch.clamp(y0[:, None] + b_j[None] + 1, 0, H)
    flatV = Pv.reshape(-1)
    base = lv[:, None] * (H + 1) * W
    colsum = flatV[base + ybot * W + xx] - flatV[base + ytop * W + xx]
    m10 = torch.sum(colsum * w, dim=1)

    yy = torch.clamp(y0[:, None] + dx_j[None], 0, H - 1)
    xleft = torch.clamp(x0[:, None] - b_j[None], 0, W)
    xright = torch.clamp(x0[:, None] + b_j[None] + 1, 0, W)
    flatH = Ph.reshape(-1)
    baseH = lv[:, None] * H * (W + 1)
    rowsum = (
        flatH[baseH + yy * (W + 1) + xright] - flatH[baseH + yy * (W + 1) + xleft]
    )
    m01 = torch.sum(rowsum * w, dim=1)
    return torch.atan2(m01, m10)


def compute_descriptors(
    blurred_pyr: torch.Tensor,
    level: torch.Tensor,
    yx: torch.Tensor,
    angle: torch.Tensor,
    pattern: torch.Tensor,
) -> torch.Tensor:
    """Rotated BRIEF bitplanes, the f32 oracle: per-sample gathers at the
    exact keypoint angle. Returns (N, 256) int8 in {0, 1}."""
    L, H, W = blurred_pyr.shape
    flat = blurred_pyr.reshape(-1)
    c, s = torch.cos(angle), torch.sin(angle)

    px = pattern[..., 0].to(torch.float32)                  # (256, 2)
    py = pattern[..., 1].to(torch.float32)
    rx = px[None] * c[:, None, None] - py[None] * s[:, None, None]
    ry = px[None] * s[:, None, None] + py[None] * c[:, None, None]
    xs = torch.round(yx[:, 1, None, None] + rx).long()      # (N, 256, 2)
    ys = torch.round(yx[:, 0, None, None] + ry).long()

    vals = _flat_take(flat, H, W, level.long()[:, None, None], ys, xs)
    return (vals[..., 0] < vals[..., 1]).to(torch.int8)


# ---------------------------------------------------------------------------
# Patch-based extraction (the main path).
# ---------------------------------------------------------------------------

def _bin_sample_indices(pattern: np.ndarray, n_bins: int) -> np.ndarray:
    """(n_bins * 512,) int32 flat in-patch pixel index per (bin, sample).

    Entry b*512 + 2*s + j is the patch pixel of sample point j of bit s
    under rotation bin b (theta_b = -pi + b * 2pi/n_bins), replicating
    compute_descriptors' rotate-then-round at the quantized angle.
    """
    R, P = PATCH_RAD, PATCH_SIZE
    px = pattern[..., 0].astype(np.float64)
    py = pattern[..., 1].astype(np.float64)
    step = 2 * np.pi / n_bins
    out = np.zeros((n_bins, px.size), np.int32)
    for b in range(n_bins):
        th = -np.pi + b * step
        c, s = np.cos(th), np.sin(th)
        ix = np.clip(np.round(px * c - py * s).astype(np.int64) + R, 0, P - 1)
        iy = np.clip(np.round(px * s + py * c).astype(np.int64) + R, 0, P - 1)
        out[b] = (iy * P + ix).reshape(-1)
    return out.reshape(-1)


def bin_sample_table(pattern: np.ndarray, device, n_bins: int = N_ROT_BINS) -> torch.Tensor:
    """(n_bins, 512) int64 device table of :func:`_bin_sample_indices`."""
    idx = _bin_sample_indices(pattern, n_bins).reshape(n_bins, -1)
    return torch.from_numpy(idx.astype(np.int64)).to(device)


def _orientation_weights() -> tuple[np.ndarray, np.ndarray]:
    """(P^2,) m10/m01 weight vectors over the reference's circular patch:
    column x contributes rows |y| <= floor(sqrt(15^2 - x^2)) (the umax
    extents of IC_Angle, src/ORBextractor.cc:108)."""
    R, P = PATCH_RAD, PATCH_SIZE
    d = np.arange(P) - R
    b = np.floor(np.sqrt(np.maximum(PATCH_R * PATCH_R - d * d, 0) + 1e-9))
    inside = (np.abs(d[:, None]) <= b[None, :]) & (
        np.abs(d[None, :]) <= PATCH_R
    )                                             # [y, x]
    w10 = (d[None, :] * inside).astype(np.float32).reshape(-1)
    w01 = (d[:, None] * inside).astype(np.float32).reshape(-1)
    return w10, w01


def gather_patches(pyr: torch.Tensor, level: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """(N, P, P) pixel patches centred on the keypoints.

    yx is (N, 2) (y, x) at the keypoint's own level; pyr is the stacked
    (L, H, W) pyramid. Like ``lax.gather(mode="clip")`` in the JAX package,
    the patch START is clamped so the whole patch lies in its level slot
    (pixels are not clamped one by one)."""
    L, H, W = pyr.shape
    P = PATCH_SIZE
    lv = torch.clamp(level.long(), 0, L - 1)
    y0 = torch.clamp(torch.round(yx[:, 0]).long() - PATCH_RAD, 0, H - P)
    x0 = torch.clamp(torch.round(yx[:, 1]).long() - PATCH_RAD, 0, W - P)
    ar = torch.arange(P, device=pyr.device)
    rows = (lv * H + y0)[:, None, None] + ar[None, :, None]
    idx = rows * W + x0[:, None, None] + ar[None, None, :]
    return pyr.reshape(-1)[idx]


@functools.lru_cache(maxsize=None)
def _orientation_weights_on(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The m10/m01 weights on ``device``, uploaded once: an upload per call
    is a blocking copy, a host sync on the card."""
    return tuple(torch.from_numpy(v).to(device) for v in _orientation_weights())


def orientations_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per patch (same moment sums as IC_Angle)."""
    w10, w01 = _orientation_weights_on(patches.device)
    flat = patches.reshape(patches.shape[0], -1)
    return torch.atan2(flat @ w01, flat @ w10)


def descriptors_from_patches(
    patches: torch.Tensor, angle: torch.Tensor, table: torch.Tensor,
    n_bins: int = N_ROT_BINS,
) -> torch.Tensor:
    """Rotated-BRIEF bitplanes from pre-gathered patches.

    patches: (N, P, P) float32 blurred patches; angle: (N,) radians;
    table: :func:`bin_sample_table`. The angle is quantized to ``n_bins``
    and the patch values are rounded to bf16 before the comparisons, as in
    the JAX package. Returns (N, 256) int8 in {0, 1}.
    """
    N = patches.shape[0]
    # True division by a device tensor: CUDA turns division by a Python
    # scalar into a product with its reciprocal, which can move an angle
    # that sits on a bin edge into the next bin.
    step = torch.full((), 2 * math.pi / n_bins, dtype=angle.dtype, device=angle.device)
    bins = torch.remainder(torch.round((angle + math.pi) / step).long(), n_bins)
    flat = patches.reshape(N, -1).to(torch.bfloat16)
    vals = torch.gather(flat, 1, table[bins]).reshape(N, -1, 2)
    return (vals[..., 0] < vals[..., 1]).to(torch.int8)


def pack_bits(desc_bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) {0,1} -> (N, 8) packed words (bit i of word w = bit 32*w + i),
    as int64 holding the JAX package's uint32 values."""
    n = desc_bits.shape[-1]
    words = desc_bits.reshape(desc_bits.shape[:-1] + (n // 32, 32)).long()
    weights = torch.ones((), dtype=torch.long, device=desc_bits.device) << torch.arange(
        32, device=desc_bits.device
    )
    return torch.sum(words * weights, dim=-1)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(N, 8) packed words -> (N, 256) int8 bitplanes."""
    shifts = torch.arange(32, device=packed.device)
    bits = (packed.long()[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (-1,)).to(torch.int8)

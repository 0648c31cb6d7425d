"""Binary bag-of-words vocabulary (port of loop/vocabulary.py).

The counterpart of DBoW2's TemplatedVocabulary (a k-branching, L-deep tree
of 256-bit ORB descriptors, tf-idf BowVectors, L1 scoring). The tree is
flattened to one dense tensor per level -- level l holds the k^(l+1) node
centroids as {0,1} int8 bitplanes -- so the descriptor -> word transform is
L rounds of "argmin Hamming distance among my k children". Training is
hierarchical binary k-means whose centroid update is a bitwise majority
vote, all nodes of a level at once through integer segment sums.

Distances are exact f32 products (CUDA has no integer matmul; every value is
an integer <= 256), and ``torch.argmin`` takes the first minimum, as
``jnp.argmin`` does: binary descriptors tie often.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device


class Vocabulary(NamedTuple):
    """Flattened k^L tree. levels[l] has shape (k^(l+1), 256) int8 -- the
    centroids of all nodes at depth l+1 (children of depth-l nodes).
    node_valid[l]: (k^(l+1),) bool. idf: (k^L,) float32 leaf weights."""

    k: int
    depth: int
    levels: Tuple[torch.Tensor, ...]
    node_valid: Tuple[torch.Tensor, ...]
    idf: torch.Tensor

    @property
    def n_words(self) -> int:
        return self.k ** self.depth

    def to(self, device) -> "Vocabulary":
        return self._replace(levels=tuple(l.to(device) for l in self.levels),
                             node_valid=tuple(v.to(device) for v in self.node_valid),
                             idf=self.idf.to(device))


def _hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 256) x (..., C, 256) -> (..., C) int32."""
    af, bf = a.to(torch.float32), b.to(torch.float32)
    dot = torch.einsum("...i,...ci->...c", af, bf).to(torch.int32)
    na = torch.sum(a, dim=-1, dtype=torch.int32)[..., None]
    nb = torch.sum(b, dim=-1, dtype=torch.int32)
    return na + nb - 2 * dot


def _em_level(centers, cvalid, assign, desc, k: int, n_node: int, iters: int):
    """One vocabulary level's k-means EM (majority-vote centroid update)."""
    N = desc.shape[0]
    dev = desc.device
    desc_i = desc.to(torch.int32)
    ar = torch.arange(k, device=dev)
    new_assign = assign
    for _ in range(iters):
        # candidates for each descriptor: its parent's k children
        cand = (assign[:, None] * k + ar[None, :]).long()        # (N, k)
        d = _hamming(desc, centers[cand])
        d = torch.where(cvalid[cand], d, 1 << 20)
        child = torch.argmin(d, dim=-1)
        new_assign = assign * k + child.to(torch.int32)
        ones = torch.zeros((n_node, 256), dtype=torch.int32, device=dev)
        ones.index_add_(0, new_assign.long(), desc_i)
        cnt = torch.zeros(n_node, dtype=torch.int32, device=dev)
        cnt.index_add_(0, new_assign.long(), torch.ones(N, dtype=torch.int32, device=dev))
        maj = (2 * ones > cnt[:, None]).to(torch.int8)
        has = cnt > 0
        centers = torch.where(has[:, None], maj, centers)
        cvalid = cvalid | has
    return centers, cvalid, new_assign


def train_vocabulary(
    descriptors: np.ndarray,   # (N, 256) {0,1} int8/bool training set
    k: int = 8,
    depth: int = 4,
    iters: int = 6,
    seed: int = 0,
    *,
    device=None,
) -> Vocabulary:
    """Hierarchical binary k-means (Hamming metric, majority-vote medians).

    The seeds come from ``np.random.default_rng(seed)`` as in the JAX
    package, so both train the same tree. Empty branches are invalid and
    keep their parent's centroid, so transform never selects them.
    ``device`` defaults to the CUDA card (``device="cpu"`` for the plain
    path); the EM runs there."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    desc = torch.from_numpy(np.ascontiguousarray(descriptors.astype(np.int8))).to(device)
    N = desc.shape[0]
    assign = torch.zeros(N, dtype=torch.int32, device=device)
    levels, valids = [], []
    for lvl in range(depth):
        n_parent = k ** lvl
        n_node = k ** (lvl + 1)
        # init: for each parent, k random members as child seeds
        assign_np = assign.cpu().numpy()
        centers = np.zeros((n_node, 256), np.int8)
        cvalid = np.zeros(n_node, bool)
        for p in range(n_parent):
            members = np.where(assign_np == p)[0]
            if len(members) == 0:
                continue
            picks = rng.choice(members, size=min(k, len(members)), replace=False)
            for j, m in enumerate(picks):
                centers[p * k + j] = descriptors[m]
                cvalid[p * k + j] = True
        centers_t, cvalid_t, assign = _em_level(
            torch.from_numpy(centers).to(device), torch.from_numpy(cvalid).to(device),
            assign, desc, k, n_node, iters)
        levels.append(centers_t)
        valids.append(cvalid_t)

    # idf weights: log(N / n_i) like DBoW2's TF_IDF
    n_words = k ** depth
    counts = np.bincount(assign.cpu().numpy(), minlength=n_words).astype(np.float64)
    idf = np.log(max(N, 1) / np.maximum(counts, 1.0)).astype(np.float32)
    idf[counts == 0] = 0.0
    return Vocabulary(k=k, depth=depth, levels=tuple(levels), node_valid=tuple(valids),
                      idf=torch.from_numpy(idf).to(device))


def _transform_impl(levels, node_valid, desc, k: int, depth: int) -> torch.Tensor:
    N = desc.shape[0]
    node = torch.zeros(N, dtype=torch.int64, device=desc.device)
    ar = torch.arange(k, device=desc.device)
    for lvl in range(depth):
        cand = node[:, None] * k + ar[None, :]
        d = _hamming(desc, levels[lvl][cand])
        d = torch.where(node_valid[lvl][cand], d, 1 << 20)
        node = node * k + torch.argmin(d, dim=-1)
    return node


def transform(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor):
    """Descriptors (N, 256) -> (word ids (N,) int64, tf-idf weights (N,)).

    Invalid rows get word -1 / weight 0 (TemplatedVocabulary::transform)."""
    words = _transform_impl(voc.levels, voc.node_valid, desc, voc.k, voc.depth)
    w = voc.idf[words]
    return torch.where(valid, words, -1), torch.where(valid, w, 0.0)


def bow_vector(words: np.ndarray, weights: np.ndarray, n_words: int):
    """Aggregate per-descriptor words into an L1-normalized sparse BowVector
    (host side): returns (unique_words, normalized_weights)."""
    sel = words >= 0
    w = np.bincount(words[sel], weights=weights[sel], minlength=n_words)
    nz = np.nonzero(w)[0]
    vals = w[nz]
    s = vals.sum()
    if s > 0:
        vals = vals / s
    return nz.astype(np.int64), vals.astype(np.float32)


def l1_score(w1, v1, w2, v2) -> float:
    """DBoW2 L1 similarity: 1 - 0.5*|v1 - v2|_1 over the union support =
    the sum of minima over the common words."""
    common, i1, i2 = np.intersect1d(w1, w2, assume_unique=True, return_indices=True)
    if len(common) == 0:
        return 0.0
    return float(np.minimum(v1[i1], v2[i2]).sum())

"""Vocabulary persistence: the native .npz format and the DBoW2 ORBvoc.txt
import (port of loop/vocab_io.py; numpy IO, the same .npz keys: ``k``,
``depth``, ``idf``, ``level{l}``, ``valid{l}``).

The reference loads a pretrained text vocabulary at start-up
(src/System.cc:84, TemplatedVocabulary::loadFromTextFile).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .vocabulary import Vocabulary


def _vocabulary(k, depth, levels, valids, idf, device) -> Vocabulary:
    device = resolve_device(device)
    return Vocabulary(
        k=int(k), depth=int(depth),
        levels=tuple(torch.from_numpy(np.asarray(l, np.int8)).to(device) for l in levels),
        node_valid=tuple(torch.from_numpy(np.asarray(v, bool)).to(device) for v in valids),
        idf=torch.from_numpy(np.asarray(idf, np.float32)).to(device),
    )


def save_npz(path: str, voc: Vocabulary):
    np.savez_compressed(
        path,
        k=voc.k,
        depth=voc.depth,
        idf=voc.idf.cpu().numpy(),
        **{f"level{i}": l.cpu().numpy() for i, l in enumerate(voc.levels)},
        **{f"valid{i}": v.cpu().numpy() for i, v in enumerate(voc.node_valid)},
    )


def load_npz(path: str, *, device=None) -> Vocabulary:
    """Load a .npz vocabulary onto ``device`` (the CUDA card by default)."""
    z = np.load(path)
    depth = int(z["depth"])
    return _vocabulary(z["k"], depth, [z[f"level{i}"] for i in range(depth)],
                       [z[f"valid{i}"] for i in range(depth)], z["idf"], device)


def load_orbvoc_txt(path: str, *, device=None) -> Vocabulary:
    """Import a DBoW2 text vocabulary (ORBvoc.txt format).

    Format: header ``k L scoring weighting``; then one node per line:
    ``parent_id is_leaf byte0 .. byte31 weight`` in BFS order. Nodes are
    re-indexed into the dense k-ary level arrays; absent children are
    invalid. Leaf weights become idf entries. ``device`` defaults to the
    CUDA card."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, descs, weights, is_leaf = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            is_leaf.append(int(parts[1]) != 0)
            descs.append([int(b) for b in parts[2:34]])
            weights.append(float(parts[34]))

    n = len(parents)
    parents = np.asarray(parents)
    descs = np.asarray(descs, np.uint8)
    weights = np.asarray(weights, np.float32)
    bits = np.unpackbits(descs, axis=1, bitorder="little").astype(np.int8)

    # dense k-ary slots level by level (the original ids are BFS: node 0 is
    # the root): slot(node) = slot(parent) * k + sibling index
    slot = np.full(n + 1, -1, np.int64)
    level_of = np.full(n + 1, -1, np.int64)
    child_count: dict = {}
    levels = [np.zeros((k ** (l + 1), 256), np.int8) for l in range(L)]
    valids = [np.zeros(k ** (l + 1), bool) for l in range(L)]
    idf = np.zeros(k ** L, np.float32)

    for i in range(n):
        nid = i + 1
        p = parents[i]
        if p == 0:
            pslot, plvl = 0, -1
        else:
            pslot, plvl = slot[p], level_of[p]
        j = child_count.get(p, 0)
        child_count[p] = j + 1
        if j >= k:
            continue
        lvl = plvl + 1
        if lvl >= L:
            continue
        s = pslot * k + j
        slot[nid] = s
        level_of[nid] = lvl
        levels[lvl][s] = bits[i]
        valids[lvl][s] = True
        if is_leaf[i] or lvl == L - 1:
            # a leaf above the bottom level continues down its first-child
            # chain to slot s * k^(L-1-lvl)
            idf[s * (k ** (L - 1 - lvl))] = weights[i]
            for ll in range(lvl + 1, L):
                s = s * k
                levels[ll][s] = bits[i]
                valids[ll][s] = True

    return _vocabulary(k, L, levels, valids, idf, device)

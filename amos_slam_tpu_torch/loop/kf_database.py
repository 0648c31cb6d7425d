"""Keyframe database: BoW inverted index + candidate detection (port of
loop/kf_database.py, host numpy copied as it is).

The counterpart of the reference's KeyFrameDatabase
(src/KeyFrameDatabase.cc): an inverted file word -> keyframes, candidates by
shared-word counting with the 0.8 * maxCommonWords gate, L1 scoring, and
covisibility-group accumulation with the 0.75 * bestAccScore gate. Dict and
list orders decide the candidate order, so they follow the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .vocabulary import bow_vector, l1_score


class KeyFrameDatabase:
    def __init__(self, n_words: int):
        self.n_words = n_words
        self.inverted: Dict[int, List[int]] = {}
        self.kf_bow: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def add(self, kf: int, words: np.ndarray, weights: np.ndarray):
        nz, vals = bow_vector(words, weights, self.n_words)
        self.kf_bow[kf] = (nz, vals)
        for w in nz.tolist():
            self.inverted.setdefault(w, []).append(kf)

    def erase(self, kf: int):
        bow = self.kf_bow.pop(kf, None)
        if bow is None:
            return
        for w in bow[0].tolist():
            lst = self.inverted.get(w)
            if lst and kf in lst:
                lst.remove(kf)

    def remap(self, lut: np.ndarray):
        """Rewrite keyframe slot ids after a map compaction (lut: old->new,
        -1 = culled keyframe, which is dropped from the index)."""
        self.kf_bow = {int(lut[k]): v for k, v in self.kf_bow.items() if lut[k] >= 0}
        self.inverted = {w: [int(lut[k]) for k in lst if lut[k] >= 0]
                         for w, lst in self.inverted.items()}

    def score(self, kf_a: int, kf_b: int) -> float:
        wa, va = self.kf_bow[kf_a]
        wb, vb = self.kf_bow[kf_b]
        return l1_score(wa, va, wb, vb)

    def _shared_word_counts(self, nz: np.ndarray, exclude: Sequence[int]) -> Dict[int, int]:
        ex = set(exclude)
        counts: Dict[int, int] = {}
        for w in nz.tolist():
            for kf in self.inverted.get(w, ()):
                if kf in ex:
                    continue
                counts[kf] = counts.get(kf, 0) + 1
        return counts

    def query(
        self,
        words: np.ndarray,
        weights: np.ndarray,
        exclude: Sequence[int] = (),
        min_score: float = 0.0,
        covis: Optional[np.ndarray] = None,
        max_candidates: int = 8,
    ) -> List[int]:
        """Candidate keyframes for relocalization / loop closure: shared-word
        count > 0.8 * max, L1 score >= min_score, then (with ``covis``
        weights) scores accumulated over covisibility groups, keeping the
        candidates within 0.75 of the best."""
        nz, vals = bow_vector(words, weights, self.n_words)
        counts = self._shared_word_counts(nz, exclude)
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = max(0.8 * max_common, 1.0)

        scored: List[Tuple[float, int]] = []
        for kf, c in counts.items():
            if c < min_common:
                continue
            wb, vb = self.kf_bow[kf]
            s = l1_score(nz, vals, wb, vb)
            if s >= min_score:
                scored.append((s, kf))
        if not scored:
            return []

        if covis is None:
            scored.sort(reverse=True)
            return [kf for _, kf in scored[:max_candidates]]

        # covisibility-group accumulation (KeyFrameDatabase.cc:150-240)
        base = {kf: s for s, kf in scored}
        acc: List[Tuple[float, int]] = []
        for s, kf in scored:
            neigh = np.argsort(-covis[kf])[:10]
            group_score = s
            best_kf, best_s = kf, s
            for nb in neigh.tolist():
                if covis[kf][nb] <= 0:
                    break
                if nb in base:
                    group_score += base[nb]
                    if base[nb] > best_s:
                        best_kf, best_s = nb, base[nb]
            acc.append((group_score, best_kf))
        best_acc = max(a for a, _ in acc)
        keep = [kf for a, kf in acc if a >= 0.75 * best_acc]
        seen, out = set(), []
        for kf in keep:
            if kf not in seen:
                seen.add(kf)
                out.append(kf)
        return out[:max_candidates]

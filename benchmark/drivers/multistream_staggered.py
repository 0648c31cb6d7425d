"""``multistream`` with the streams at different points of the path:
stream s starts ``stagger_frames`` x s frames into the sequence (played
forward and back), so each stream's motion, and with it its keyframe
decisions, runs out of phase with the others'. Each stream is handed its
own frame and is checked against its own ground truth."""

from __future__ import annotations

import numpy as np
import torch

from .. import scene
from .multistream import Driver as Streams


class Staggered:
    """A rendered sequence (``benchmark.traffic.Sequence``) read with a
    start offset per stream; steps map to (S, len(steps)) frames."""

    def __init__(self, seq, offsets: np.ndarray):
        self.seq, self.offsets = seq, np.asarray(offsets)
        self.fps, self.depth_factor = seq.fps, seq.depth_factor
        self.rows = torch.arange(len(offsets), device=seq.gray.device)[:, None]

    def _index(self, steps) -> np.ndarray:
        return scene.playback(np.asarray(steps)[None, :] + self.offsets[:, None], self.seq.n)

    def _pick(self, t: torch.Tensor, steps) -> torch.Tensor:
        return t[self.rows, torch.as_tensor(self._index(steps), device=t.device)]

    def frames(self, steps):
        """(grey f32, depth m f32), each (S, len(steps), H, W)."""
        return (self._pick(self.seq.gray, steps).to(torch.float32),
                self._pick(self.seq.depth, steps).to(torch.float32) / self.depth_factor)

    def gray_u8(self, steps) -> torch.Tensor:
        return self._pick(self.seq.gray, steps)

    def gray_of(self, s: int, k: int) -> torch.Tensor:
        return self.seq.gray[s, int(scene.playback(k + self.offsets[s], self.seq.n))]

    def rgb_of(self, frames) -> torch.Tensor:
        return torch.stack([self.gray_of(s, k) for s, k in frames])[..., None].expand(-1, -1, -1, 3)

    def gt(self, steps) -> np.ndarray:
        """(len(steps), S, 4, 4): each stream's own ground truth."""
        return self.seq.poses[self._index(steps).T]


class Driver(Streams):
    def make_inputs(self):
        marks = super().make_inputs()
        self.seq = Staggered(self.seq, self.traffic["stagger_frames"] * np.arange(self.S))
        return marks

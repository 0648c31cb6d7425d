"""What the benchmark reads from the timed path: the FAST op's launches
(their shapes, and the responses of sampled frames) and stage one's net
outputs of sampled frames (a forward hook on the segmenter's model).

A driver names the frames each program call covers, in order, as (stream,
step) pairs (:meth:`Capture.covering`); a FAST launch over B images of L
levels covers the next B / L of them, a segmenter call all of them. A
launch or call that covers a sampled step keeps a copy of its output.
"""

from __future__ import annotations

import contextlib
from typing import List, Set, Tuple

import numpy as np
import torch


def samples(seed: int, warm: int, traffic: dict) -> Tuple[Set[int], Set[int]]:
    """The steps whose FAST responses and net outputs the check reads,
    drawn from the seed among the window's first ``span`` steps."""
    c = traffic["check"]
    rng = np.random.default_rng([seed % 2 ** 63, 7])
    span = c["span"]
    fast = warm + rng.choice(span, size=min(c["fast_frames"], span), replace=False)
    net = warm + rng.choice(span, size=min(c["net_frames"], span), replace=False)
    return {int(k) for k in fast}, {int(k) for k in net}


class Capture:
    def __init__(self, levels: int, fast_steps: Set[int], net_steps: Set[int]):
        self.levels = levels
        self.fast_steps = set(fast_steps)
        self.net_steps = set(net_steps)
        self.fast: List[Tuple[List[Tuple[int, int]], torch.Tensor]] = []
        self.net: List[Tuple[List[Tuple[int, int]], Tuple[torch.Tensor, ...]]] = []
        self.launch_shapes: List[Tuple[int, ...]] = []
        self.recording_shapes = False
        self._frames: List[Tuple[int, int]] = []
        self._pos = 0
        self._seg_frames: List[Tuple[int, int]] = []
        self._undo = []

    # -- called by the drivers (benchmark/drivers) ------------------------
    @contextlib.contextmanager
    def covering(self, frames, seg: bool = False):
        """Program calls inside cover ``frames`` ((stream, step) pairs)."""
        frames = list(frames)
        if seg:
            self._seg_frames = frames
        else:
            self._frames, self._pos = frames, 0
        try:
            yield
        finally:
            if seg:
                self._seg_frames = []
            else:
                self._frames, self._pos = [], 0

    # -- hooks into the program -------------------------------------------
    def attach_fast(self, op) -> None:
        """Wrap ``op.launch`` (the FAST op's one launch on plain tensors)."""
        launch = op.launch

        def recording(imgs, extents=None):
            out = launch(imgs, extents)
            self._on_fast(imgs, out)
            return out

        op.launch = recording
        self._undo.append(lambda: delattr(op, "launch"))

    def attach_net(self, model: torch.nn.Module) -> None:
        h = model.register_forward_hook(lambda m, a, out: self._on_net(out))
        self._undo.append(h.remove)

    def detach(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo = []

    def _on_fast(self, imgs, out):
        if self.recording_shapes:
            self.launch_shapes.append(tuple(imgs.shape))
        n = imgs.shape[0] // self.levels
        frames = self._frames[self._pos: self._pos + n]
        self._pos += n
        if any(k in self.fast_steps for _, k in frames):
            self.fast.append((frames, out.detach().clone()))

    def _on_net(self, out):
        frames = self._seg_frames
        if any(k in self.net_steps for _, k in frames):
            self.net.append((frames, tuple(t.detach().clone() for t in out)))

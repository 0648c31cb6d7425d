"""Offline replay, closed loop: each chunk of ``chunk`` frames makes one
``Segmenter.person_mask_batch`` call (with a segmenter) and one
``System.track_rgbd_chunk`` call with its masks; the next chunk is
dispatched as soon as the call returns. The window closes when the last
chunk's poses are on the host."""

from __future__ import annotations

from time import perf_counter as now

import numpy as np
from torch.profiler import record_function

from ._system import SystemDriver


class Driver(SystemDriver):
    def _chunk(self, record: bool = False):
        W = self.traffic["chunk"]
        steps = list(range(self.k, self.k + W))
        g, d = self.seq.frames(steps)
        masks = None
        if self.seg is not None:
            rgb = self.seq.gray_u8(steps)[0][..., None].expand(-1, -1, -1, 3)
            with record_function("bench.segmenter"), self.cap.covering(
                    [(0, k) for k in steps], seg=True):
                masks = self.timed_seg(lambda: self.seg.person_mask_batch(rgb), record)
        with record_function("bench.track_rgbd_chunk"), self.cap.covering([(0, k) for k in steps]):
            T = self.slam.track_rgbd_chunk(g[0], d[0], [k / self.seq.fps for k in steps],
                                           seg_masks=masks)
        self.k += W
        return T

    def warmup(self) -> None:
        while self.k < self.warm:
            self._chunk()
        self.sync()

    def window(self, seconds: float, record: bool = False) -> dict:
        k0, t0 = self.k, now()
        T, marks = None, []
        while now() - t0 < seconds:
            T = self._chunk(record)
            marks.append((now() - t0, self.k - k0))
        with record_function("bench.poses_to_host"):
            np.asarray(T.cpu())
        self.window_steps = (k0, self.k)
        return {"frames": self.k - k0, "wall_s": now() - t0, "marks": marks}

    def traced_steps(self, n: int) -> int:
        k0 = self.k
        T = None
        while self.k < k0 + n:
            T = self._chunk()
        T.cpu()
        return self.k - k0

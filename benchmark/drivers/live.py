"""A live camera, one frame in flight: each frame makes one
``Segmenter.person_mask`` call (with a segmenter), then one
``System.track_rgbd`` call with its mask, and its pose is read to the host
before the next frame is sent. A frame's latency runs from the segmenter
call to its pose on the host."""

from __future__ import annotations

from time import perf_counter as now

import numpy as np
from torch.profiler import record_function

from ._system import SystemDriver


class Driver(SystemDriver):
    def _frame(self, record: bool = False) -> float:
        k = self.k
        t = now()
        g, d = self.seq.frames([k])
        mask = None
        if self.seg is not None:
            rgb = self.seq.gray_u8([k])[0, 0][..., None].expand(-1, -1, 3)
            with record_function("bench.segmenter"), self.cap.covering([(0, k)], seg=True):
                mask = self.timed_seg(lambda: self.seg.person_mask(rgb), record)
        with record_function("bench.track_rgbd"), self.cap.covering([(0, k)]):
            T = self.slam.track_rgbd(g[0, 0], d[0, 0], k / self.seq.fps, seg_mask=mask)
        with record_function("bench.pose_to_host"):
            np.asarray(T.cpu())
        self.k += 1
        return (now() - t) * 1e3

    def warmup(self) -> None:
        while self.k < self.warm:
            self._frame()

    def window(self, seconds: float, record: bool = False) -> dict:
        k0, t0 = self.k, now()
        lat, marks = [], []
        while now() - t0 < seconds:
            lat.append(self._frame(record))
            marks.append((now() - t0, self.k - k0))
        self.window_steps = (k0, self.k)
        return {"frames": self.k - k0, "wall_s": now() - t0, "marks": marks,
                "latencies_ms": lat}

    def traced_steps(self, n: int) -> int:
        for _ in range(n):
            self._frame()
        return n

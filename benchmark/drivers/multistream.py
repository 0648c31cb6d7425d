"""Every stream steps together through ``MultiStreamSLAM.step``, closed
loop: the next step is dispatched as soon as the call returns. The window
closes when supervision is flushed and the last step's poses are on the
host."""

from __future__ import annotations

from time import perf_counter as now

import numpy as np
import torch
from torch.profiler import record_function

from ._rgbd import RGBDDriver


class Driver(RGBDDriver):
    def program(self, syscfg) -> None:
        from amos_slam_tpu_torch.parallel.multistream import MultiStreamSLAM

        self.min_lm = syscfg.tracking.min_inliers_local_map
        self.ms = MultiStreamSLAM(syscfg, self.S, device=self.device)
        # each resolved step's (S, 3) supervision rows, as the program
        # resolves them
        self.sups = {}
        resolve = self.ms._resolve_step

        def recording(st, heavy, frame, sup):
            self.sups[frame] = np.array(sup)
            return resolve(st, heavy, frame, sup)

        self.ms._resolve_step = recording
        self.poses = []

    def _step(self):
        k = self.k
        g, d = self.seq.frames([k])
        with record_function("bench.multistream_step"), self.cap.covering(
                [(s, k) for s in range(self.S)]):
            if k == 0:
                self.ms.initialize(g[:, 0], d[:, 0])
                T = self.ms.state.Tcw
            else:
                T, _ = self.ms.step(g[:, 0], d[:, 0])
        self.poses.append(T)
        self.k += 1
        return T

    def warmup(self) -> None:
        while self.k < self.warm:
            self._step()
        self.sync()

    def window(self, seconds: float, record: bool = False) -> dict:
        k0, t0 = self.k, now()
        T, marks = None, []
        while now() - t0 < seconds:
            T = self._step()
            marks.append((now() - t0, (self.k - k0) * self.S))
        with record_function("bench.flush"):
            self.ms.flush()
            np.asarray(T.cpu())
        self.window_steps = (k0, self.k)
        return {"frames": (self.k - k0) * self.S, "wall_s": now() - t0, "marks": marks}

    def traced_steps(self, n: int) -> int:
        for _ in range(n):
            T = self._step()
        self.ms.flush()
        T.cpu()
        return n * self.S

    def finish(self) -> dict:
        self.ms.flush()
        est = torch.stack(self.poses).cpu().numpy().astype(np.float64)     # (n, S, 4, 4)
        failed = 0
        for k in range(self.warm, len(est)):
            sup = self.sups.get(k)
            for s in range(self.S):
                lost = sup is not None and sup[s, 1] < self.min_lm and sup[s, 0] < 10
                failed += int(lost or not np.isfinite(est[k, s]).all())
        self._poses(est)
        diag = {"keyframes": [int(m.n_kfs) for m in self.ms.maps]}
        return {"attempted": (len(est) - self.warm) * self.S, "failed": failed, "diag": diag}

    def close(self) -> None:
        super().close()
        self.ms = self.poses = None

"""What the single-stream drivers share: one ``System`` over the sequence,
and the run's poses, per-frame states and keyframe flags read after the
window."""

from __future__ import annotations

import numpy as np

from ._rgbd import RGBDDriver


class SystemDriver(RGBDDriver):
    def program(self, syscfg) -> None:
        from amos_slam_tpu_torch.system import System

        self.min_lm = syscfg.tracking.min_inliers_local_map
        self.slam = System(syscfg, device=self.device)
        self.kf_flags = []

    def finish(self) -> dict:
        """Every frame's corrected pose and its ground truth (for the
        check), frames after the warm-up that came back LOST or
        non-finite, and the keyframe flag of each frame."""
        first = self.warm
        est = np.asarray(self.slam.corrected_poses_np(), np.float64)[:, None]
        self.slam.shutdown()
        stats = self.slam.stats
        lost = [s["inliers"] < self.min_lm and s["matches"] < 10 for s in stats]
        finite = np.isfinite(est).reshape(len(est), -1).all(axis=1)
        failed = sum(1 for i in range(first, len(est))
                     if not finite[i] or (i < len(lost) and lost[i]))
        loop = self.slam.loop
        self.kf_flags = [bool(s.get("kf")) for s in stats]
        self._poses(est)
        diag = {"keyframes": int(self.slam.map.n_kfs),
                "relocalized": sum(1 for s in stats if s.get("reloc")),
                "lost": sum(lost[first:]),
                "loops_closed": [] if loop is None else [list(x) for x in loop.loops_closed]}
        return {"attempted": len(est) - first, "failed": failed, "diag": diag}

    def fill(self, run) -> None:
        super().fill(run)
        k0, k1 = self.window_steps
        run.keyframe_flags = self.kf_flags[k0:k1]

    def close(self) -> None:
        super().close()
        self.slam = None

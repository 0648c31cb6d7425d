"""What the example mains share: the device option, the per-frame
progress line and the closing timing summary."""

from __future__ import annotations

import argparse
import time

import numpy as np


def add_common(ap: argparse.ArgumentParser, out: str) -> None:
    ap.add_argument("--out", default=out)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises without one)")


def n_frames(total: int, max_frames: int) -> int:
    return total if max_frames <= 0 else min(total, max_frames)


class Timer:
    """Per-frame wall time of the tracking calls, each ended by a device
    sync (the pose is read to the host), and the summary the reference's
    mains print (median / mean, rgbd_tum.cc:168-169)."""

    def __init__(self):
        self.times = []

    def track(self, fn, *args):
        t0 = time.perf_counter()
        Tcw = fn(*args)
        np.asarray(Tcw.cpu())
        self.times.append(time.perf_counter() - t0)
        return Tcw

    def progress(self, i: int, n: int, slam, every: int) -> None:
        if i % every == 0:
            s = slam.stats[-1]
            print(f"[{i}/{n}] {slam.state.name} inliers={s['inliers']} "
                  f"kfs={slam.map.n_kfs} pts={slam.map.n_pts}")

    def summary(self) -> str:
        t = np.asarray(self.times)
        if not len(t):
            return "no frames tracked"
        return (f"median {np.median(t) * 1e3:.1f} ms | mean {t.mean() * 1e3:.1f} ms "
                f"({1.0 / t.mean():.1f} FPS)")

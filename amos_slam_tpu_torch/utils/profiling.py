"""Structured tracing and profiling (port of utils/profiling.py).

Named regions around pipeline stages (``torch.profiler.record_function``,
visible in a trace), a trace context manager that writes one Chrome trace
readable in Perfetto or TensorBoard, and a host-side span timer with an
aggregated report.

The program emits its layer spans (the names in :data:`SPANS`) through
:func:`span`: a ``record_function`` region while a profiler records
(``torch.profiler.profile``, :func:`device_trace`), nothing otherwise. Being
profiler records, they lie on the same timeline as the kernels they launch.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

# The program's layer spans, outermost layers first (README, "Tracing").
SPANS = (
    "slam.dynamics",            # frontend/dynamics.py: compute_dynamics, the geometric stage
    "slam.dynamics.flow",       # its LK flow and SAD gate
    "slam.dynamics.pnp",        # its PnP-RANSAC and the two reprojection passes
    "slam.dynamics.clusters",   # its CIELAB conversion and SLIC / k-means
    "slam.dynamics.vote",       # its supports, gates and cluster votes, up to the masks
    "slam.orb.detect",          # ORBPipeline.detect_keypoints, the FAST op included
    "slam.orb.describe",        # ORBPipeline.describe
    "slam.track",               # the fused steps' tracking tail; System's slow-path tracker
    "slam.map.view",            # the local-map view build
    "slam.supervision",         # host supervision: drains, waits, state machine, decisions
    "slam.supervision.wait",    # the host blocked on a copy from the card
    "slam.kf.insert",           # keyframe insertion (and compaction)
    "slam.kf.triangulate",      # new landmarks: dispatch and resolve
    "slam.kf.maintain",         # fusion and culling: dispatch and resolve
    "slam.kf.local_ba",         # SlamMap.run_local_ba
    "slam.kf.loop",             # the loop closer: BoW dispatch, detect, verify, correct
    "slam.segmenter.net",       # Segmenter.raw: resize, normalise, the net
    "slam.segmenter.masks",     # detection, mask assembly and the resize out
    "train.loader.wait",        # models/data.py: DataLoader blocked on its prefetch queue
    "train.grads",              # models/train.value_and_grads: forward, loss and backward
    "train.loss",               # its multibox loss after the net: matching, OHEM, the mask term
    "train.sgd",                # models/train.sgd_update
)
_OFF = contextlib.nullcontext()


def annotate(name: str):
    """Named region that shows up in traces (use around dispatches)."""
    return record_function(name)


def span(name: str, frame=None):
    """The program's span ``name`` (one of :data:`SPANS`): a
    ``record_function`` region while a profiler records, else a null
    context (one read of the profiler's flag). ``frame``, for keyframe
    work, is the id of the frame that decided it, given as the record's
    ``args`` (work that runs during a later frame's call is tied back to
    it)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return record_function(name, None if frame is None else f"frame={frame}")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the host and, where a CUDA card is present, the device; one
    ``*.pt.trace.json`` is written under ``log_dir`` on exit."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class SpanTimer:
    """Host-side span aggregation: cheap, always-on, printable."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            with record_function(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1

    def report(self) -> str:
        lines = ["span                              calls   total_ms    avg_ms"]
        for name in sorted(self.total, key=lambda n: -self.total[n]):
            t = self.total[name] * 1e3
            c = self.count[name]
            lines.append(f"{name:32s} {c:7d} {t:10.1f} {t / c:9.2f}")
        return "\n".join(lines)

    def reset(self):
        self.total.clear()
        self.count.clear()

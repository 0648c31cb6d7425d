"""Structured tracing and profiling (port of utils/profiling.py).

Named regions around pipeline stages (``torch.profiler.record_function``,
visible in a trace), a trace context manager that writes one Chrome trace
readable in Perfetto or TensorBoard, and a host-side span timer with an
aggregated report.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


def annotate(name: str):
    """Named region that shows up in traces (use around dispatches)."""
    return record_function(name)


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

"""The traced window: ``torch.profiler`` over host and device, reduced to
plain lists that the per-layer readers (``metrics/``) and the breakdown
read.

Device events are those the profiler places on the card (kernels, copies,
fills); busy time is the union of their intervals inside the window. An
idle gap, a stretch of the window in which nothing ran on the card, is
named by what the host was doing at its middle: the innermost of the
benchmark's own spans (``bench.*``) and the innermost operation under it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW_SPAN = "bench.traced_window"
# the profiler's kinds of work on the card (it also mirrors each
# record_function span onto the device timeline: no work)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    start_ns: int
    end_ns: int
    device: List[Tuple[str, int, int]] = field(default_factory=list)   # (name, start, end)
    kernels: List[Tuple[str, int, int]] = field(default_factory=list)  # the kernels among them
    host: List[Tuple[str, int, int]] = field(default_factory=list)
    frames: int = 0

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device intervals, clipped to the window."""
        iv = sorted((max(s, self.start_ns), min(e, self.end_ns)) for _, s, e in self.device
                    if e > self.start_ns and s < self.end_ns)
        out: List[List[int]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> List[Tuple[int, int]]:
        gaps, t = [], self.start_ns
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end_ns > t:
            gaps.append((t, self.end_ns))
        return gaps

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops: Dict[str, float] = {}
        for name, s, e in self.device:
            key = name[:96]
            ops[key] = ops.get(key, 0.0) + (e - s) / 1e9
        gaps: Dict[str, float] = {}
        for (a, b), name in zip(self.idle_gaps(), self.name_gaps()):
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e9
        return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda r: -r[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda r: -r[1])[:top]}

    def name_gaps(self) -> List[str]:
        """What the host was doing at the middle of each idle gap."""
        mids = [(a + b) // 2 for a, b in self.idle_gaps()]
        host = sorted(self.host, key=lambda h: (h[1], -h[2]))
        names, i = [], 0
        spans: List[Tuple[str, int, int]] = []
        ops: List[Tuple[str, int, int]] = []
        for t in mids:
            while i < len(host) and host[i][1] <= t:
                ev = host[i]
                stack = spans if ev[0].startswith("bench.") else ops
                while stack and stack[-1][2] < ev[1]:
                    stack.pop()
                stack.append(ev)
                i += 1
            for stack in (spans, ops):
                while stack and stack[-1][2] < t:
                    stack.pop()
            span = next((s[0] for s in reversed(spans) if s[0] != WINDOW_SPAN), "-")
            op = ops[-1][0] if ops else "-"
            names.append(f"{span} / {op}"[:96])
        return names


@contextlib.contextmanager
def traced():
    """Profile the body on host and device; yields a :class:`Trace` that
    is filled in when the body ends (device synchronised first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    out = Trace(0, 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            yield out
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        rec = (e.name(), s, s + e.duration_ns())
        kind = _kind(e, cuda)
        if kind in DEVICE_WORK:
            out.device.append(rec)
            if kind == "kernel":
                out.kernels.append(rec)
        elif e.device_type() != cuda:
            out.host.append(rec)
            if rec[0] == WINDOW_SPAN:
                out.start_ns, out.end_ns = rec[1], rec[2]


def _kind(e, cuda) -> str:
    """The profiler's kind of an event (``activity_type``), inferred from
    its device and name on releases of torch that do not give it."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.device_type() != cuda:
        return "cpu_op"
    name = e.name()
    if getattr(e, "is_user_annotation", lambda: False)() or name.startswith("bench."):
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"

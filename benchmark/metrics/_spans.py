"""The program's layer spans in a traced window: the ``record_function``
regions whose names begin with ``slam.`` (the port's
``utils.profiling.SPANS``), which lie on the device trace's clock.

:func:`span_stats` gives, for each span name, its time inside the window,
inclusive (the union of its intervals) and self (less the part that nested
``slam.*`` spans cover), its count, the host's kernel launch calls inside
it (at any depth, and where it is the innermost span), and the device idle
time whose gaps have their middle under it, each gap attributed to the
innermost span. :func:`coverage` says how much of a benchmark span's host
time, device idle time and launches the program's spans account for. A
program that emits no spans leaves every table empty.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

PREFIX = "slam."
# the host calls that put a kernel on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")

Span = Tuple[str, int, int]


@dataclass
class SpanStats:
    inclusive_ns: int = 0     # the union of the name's intervals
    self_ns: int = 0          # less what nested slam.* spans cover
    count: int = 0            # occurrences not nested in the same name
    launches: int = 0         # launch calls inside it, at any depth
    launches_self: int = 0    # launch calls whose innermost span it is
    idle_ns: int = 0          # idle gaps whose middle has it as innermost span


def spans(trace, prefix: str = PREFIX) -> List[Span]:
    """The window's spans named ``prefix*``, clipped to the window, sorted
    by start (the outer first at equal starts)."""
    out = [(n, max(s, trace.start_ns), min(e, trace.end_ns)) for n, s, e in trace.host
           if n.startswith(prefix) and e > trace.start_ns and s < trace.end_ns]
    return sorted(out, key=lambda sp: (sp[1], -sp[2]))


def union_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _sweep(sp: List[Span], points: List[int]):
    """For each time in ``points`` (sorted), the stack of spans that hold
    it, outermost first."""
    stack: List[Span] = []
    i = 0
    for t in points:
        while i < len(sp) and sp[i][1] <= t:
            while stack and stack[-1][2] < sp[i][1]:
                stack.pop()
            stack.append(sp[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        yield [x for x in stack if x[1] <= t <= x[2]]


def launch_times(trace) -> List[int]:
    return sorted(s for n, s, _ in trace.host
                  if n in LAUNCH_CALLS and trace.start_ns <= s < trace.end_ns)


def span_stats(trace, prefix: str = PREFIX) -> Dict[str, SpanStats]:
    sp = spans(trace, prefix)
    out: Dict[str, SpanStats] = {}
    child_ns = [0] * len(sp)
    stack: List[int] = []
    for k, (name, s, e) in enumerate(sp):
        while stack and sp[stack[-1]][2] < e:
            stack.pop()
        st = out.setdefault(name, SpanStats())
        if stack:
            child_ns[stack[-1]] += e - s
        if not any(sp[j][0] == name for j in stack):
            st.count += 1
        stack.append(k)
    for k, (name, s, e) in enumerate(sp):
        out[name].self_ns += e - s - child_ns[k]
    for name, st in out.items():
        st.inclusive_ns = union_ns((s, e) for n, s, e in sp if n == name)
    for held in _sweep(sp, launch_times(trace)):
        for name in {x[0] for x in held}:
            out[name].launches += 1
        if held:
            out[held[-1][0]].launches_self += 1
    gaps = trace.idle_gaps()
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    for (_, dur), held in zip(mids, _sweep(sp, [m for m, _ in mids])):
        if held:
            out[held[-1][0]].idle_ns += dur
    return out


def union_of(trace, prefix: str) -> Optional[int]:
    """The union of the window's spans named ``prefix*`` (ns), or None if
    there are none."""
    sp = spans(trace, prefix)
    return union_ns((s, e) for _, s, e in sp) if sp else None


def per_frame_ms(run, ns: Optional[int]) -> Optional[float]:
    t = run.trace
    if ns is None or t is None or t.frames <= 0:
        return None
    return ns / 1e6 / t.frames


def emits_spans(run) -> bool:
    """Whether the window holds the program's supervision spans: its host
    side ran and recorded them (a program without spans records none)."""
    t = run.trace
    return t is not None and any(n == "slam.supervision" for n, _, _ in t.host)


def coverage(trace, outer: str) -> dict:
    """How much of the benchmark spans named ``outer`` the program's spans
    account for: the share of their host time inside some ``slam.*`` span;
    of the device idle time whose gaps have their middle under them, the
    share that has it under a ``slam.*`` span too; and the launch calls
    inside ``slam.*`` spans, against all launch calls and the kernels of the
    window."""
    out_sp = [x for x in spans(trace, outer) if x[0] == outer]
    sp = spans(trace)
    host = union_ns((s, e) for _, s, e in out_sp)
    both = union_ns((max(s, a), min(e, b)) for _, a, b in out_sp for _, s, e in sp
                    if s < b and e > a)
    gaps = sorted(((a + b) // 2, b - a) for a, b in trace.idle_gaps())
    mids = [m for m, _ in gaps]
    idle = idle_in = 0
    for (_, dur), in_outer, in_slam in zip(gaps, _sweep(out_sp, mids), _sweep(sp, mids)):
        if in_outer:
            idle += dur
            idle_in += dur if in_slam else 0
    launches = launch_times(trace)
    inside = sum(1 for held in _sweep(sp, launches) if held)
    return {"host_share": both / host if host else None,
            "idle_share": idle_in / idle if idle else None,
            "launch_calls_in_spans": inside, "launch_calls": len(launches),
            "kernels": len(trace.kernels),
            "launch_share": inside / len(trace.kernels) if trace.kernels else None}

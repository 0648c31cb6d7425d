"""Readings of the host and the card taken just before and just after the
measured window, outside it, for standard error: where a run's host time
went (the process's CPU seconds, the main thread's, the machine's busy and
stolen shares, context switches) and the card's clocks, temperature and
power. They tell a slower host from more work."""

from __future__ import annotations

import os
import resource
import subprocess
import time
from typing import Dict, List, Tuple

GPU_FIELDS = "clocks.sm,clocks.mem,temperature.gpu,power.draw,clocks_throttle_reasons.active"


def _proc_stat() -> List[int]:
    """The machine's CPU jiffies: user, nice, system, idle, iowait, irq,
    softirq, steal."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return []


def gpu() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={GPU_FIELDS}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip() if res.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def snapshot(card: bool) -> Dict[str, object]:
    t = os.times()
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall": time.perf_counter(), "user": t.user, "sys": t.system,
            "thread": time.thread_time(), "stat": _proc_stat(),
            "vcsw": ru.ru_nvcsw, "ivcsw": ru.ru_nivcsw, "gpu": gpu() if card else "-"}


def slices(marks: List[Tuple[float, int]], width: float = 10.0) -> List[float]:
    """Frames per second in consecutive ``width``-second slices of the
    window, from the drivers' (seconds, frames done) marks."""
    out, t0, f0 = [], 0.0, 0
    for t, f in marks:
        if t - t0 >= width:
            out.append((f - f0) / (t - t0))
            t0, f0 = t, f
    return out


def report(a: Dict[str, object], b: Dict[str, object], frames: int,
           marks: List[Tuple[float, int]]) -> str:
    wall = b["wall"] - a["wall"]
    d = [y - x for x, y in zip(a["stat"], b["stat"])]
    total = sum(d) or 1
    busy = (total - d[3] - d[4]) / total if d else float("nan")
    steal = d[7] / total if len(d) > 7 else float("nan")
    n = max(frames, 1)
    return (f"host over the window: {wall:.3f} s, {frames} frames; process cpu "
            f"{(b['user'] - a['user'] + b['sys'] - a['sys']) / n * 1e3:.2f} ms/frame "
            f"(sys {(b['sys'] - a['sys']) / n * 1e3:.2f}), main thread "
            f"{(b['thread'] - a['thread']) / n * 1e3:.2f} ms/frame, wall {wall / n * 1e3:.2f} "
            f"ms/frame; machine busy {busy:.4f}, steal {steal:.4f} of {os.cpu_count()} cpus; "
            f"context switches {b['vcsw'] - a['vcsw']} voluntary, "
            f"{b['ivcsw'] - a['ivcsw']} involuntary; frames/s by 10 s slice "
            f"{[round(x, 3) for x in slices(marks)]}; card ({GPU_FIELDS}) before "
            f"[{a['gpu']}] after [{b['gpu']}]")

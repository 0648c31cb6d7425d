"""Timing of kernels on the card, and the bound they are held to.

A kernel's time is the median over runs of many back-to-back launches
between two CUDA events, divided by their count. A launch from Python costs
more host time than a ~10 us kernel takes on the device, so a spin kernel
holds the stream while the host enqueues the launches: the events then time
the device, not the host's launch rate. nvidia-smi's SM clock and power are
read beside the timing. Nothing here runs at import.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, List, Optional, Tuple

import torch

# NVIDIA H100 SXM data-sheet peaks (dense): HBM bandwidth, f32 non-tensor
# rate (which counts an FMA as two operations).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
LANES_PER_SM = 128  # f32 lanes of a Hopper SM: one sub/min/max each per clock


def loop_ms(fn: Callable[[], object], launches: int, runs: int = 5,
            hold: bool = True) -> Tuple[float, List[float], int]:
    """The median over ``runs`` of ``launches`` back-to-back calls of fn()
    between two CUDA events, divided by ``launches``, after warm-up.

    With ``hold``, ``torch.cuda._sleep`` holds the stream while the host
    enqueues the calls; a run whose start event had already passed when the
    last call was enqueued (the queue ran dry) is taken again with a longer
    hold, up to twice. Returns (median ms, per-run ms, runs that stayed
    held)."""
    for _ in range(max(3, launches // 10)):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    per_run, held = [], 0
    for _ in range(runs):
        cycles = int(4 * host_s * 2e9) + 1_000_000
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if hold:
                torch.cuda._sleep(cycles)
            start.record()
            for _ in range(launches):
                fn()
            end.record()
            ok = hold and not start.query()
            end.synchronize()
            if ok or not hold:
                break
            cycles *= 4
        held += ok
        per_run.append(start.elapsed_time(end) / launches)
    return statistics.median(per_run), per_run, held


def smi(query: str) -> str:
    """One nvidia-smi reading of the first card, e.g. ``"name,power.limit"``."""
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def smi_under_load(query: str, fn: Callable[[], object],
                   seconds: float = 2.0) -> List[str]:
    """nvidia-smi readings every 100 ms while fn() runs in bursts of 50."""
    proc = subprocess.Popen(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}", "--format=csv,noheader",
         "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    return [line.strip() for line in out.splitlines() if line.strip()]


def sm_mhz(readings: List[str]) -> Optional[float]:
    """The highest SM clock among readings whose first field is clocks.sm."""
    mhz = []
    for r in readings:
        try:
            mhz.append(float(r.split(",")[0].split()[0]))
        except (IndexError, ValueError):
            pass
    return max(mhz) if mhz else None


def bound(read_bytes: float, write_bytes: float, ops: float) -> Tuple[float, str]:
    """Least time of a pass that reads and writes these bytes once each and
    does ``ops`` f32 operations: bytes over HBM bandwidth vs operations over
    the published f32 rate. Returns (ms, "bytes" or "operations")."""
    t_bytes = (read_bytes + write_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lane_ms(ops: float, mhz: float, sms: int) -> float:
    """Time of ``ops`` f32 operations at one per lane per clock."""
    return ops / (sms * LANES_PER_SM * mhz * 1e6) * 1e3

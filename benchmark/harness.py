"""One run of one cell: resolve it by name, set up, warm up, measure,
check, and build the result line.

``BENCHMARK.json`` names the cell's configuration (``file``) and traffic;
everything else is found by name under this folder: the traffic's
parameters in ``traffic/<traffic>.json`` (whose ``driver`` names
``drivers/<driver>.py``, which makes the inputs, builds and drives the
program and hands over what the check reads), the cell's correctness
limits in ``checks/<cell>.json``, each compared number in
``compare/<number>.py``, and each per-layer metric's reader in
``metrics/<metric>.py``. Nothing here knows a configuration's kind.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from time import perf_counter as now
from typing import Callable, Dict, List, Optional

import numpy as np

from . import check, hostinfo
from .trace import Trace, traced

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "amos_slam_tpu")
# end-to-end metrics read from the card alone: a run on the CPU has none
CARD_ONLY = ("program_memory_peak_gb",)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclass
class RunInfo:
    """What the per-layer readers read."""
    config: dict
    traffic: dict
    frames: int = 0                       # frames tracked in the window, all streams
    window_s: float = 0.0
    latencies_ms: List[float] = field(default_factory=list)
    keyframe_flags: List[bool] = field(default_factory=list)
    seg_event_ms: List[float] = field(default_factory=list)
    trace: Optional[Trace] = None
    fast_launch_shapes: List[tuple] = field(default_factory=list)
    fast_kernel_names: tuple = ()


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The cell of ``BENCHMARK.json`` named ``workload`` with its files."""
    m = load_manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    here = root / HERE.name
    return Cell(
        name=workload, chips=w["chips"], config=_json(root / conf["file"]),
        traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=_json(here / "checks" / f"{workload}.json")["limits"],
        end_to_end=[e for e in m["end_to_end"] if _applies(e, workload)],
        per_layer=[p for p in m["per_layer"] if _applies(p, workload)],
    )


def _load(kind: str, name: str, root: Path):
    """The module ``<kind>/<name>.py`` of the benchmark folder under
    ``root``, loaded from its file (a metric's name may hold dots)."""
    path = root / HERE.name / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``read`` of ``metrics/<metric>.py``."""
    return _load("metrics", metric, root).read


def driver(name: str, root: Path = ROOT):
    """``Driver`` of ``drivers/<name>.py``."""
    return _load("drivers", name, root).Driver


def compare(number: str, root: Path = ROOT):
    """``compare/<number>.py``: the number's ``value`` and ``control``."""
    return _load("compare", number, root)


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's (compared whole: the port's name begins with the JAX
    package's)."""
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit, from nvidia-smi."""
    try:
        res = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        t0: Optional[float] = None, log=None, root: Path = ROOT) -> dict:
    """One run of ``cell``; returns the result line as a dict. ``log``
    collects the lines for standard error."""
    import torch

    t0 = now() if t0 is None else t0
    log = [] if log is None else log
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    marks = [("start", t0), ("imports", now())]
    info = RunInfo(config=cell.config, traffic=cell.traffic)
    drv = driver(cell.traffic["driver"], root)(cell, seed, dev)
    marks += drv.make_inputs()
    inputs_bytes = 0
    if cuda:
        # the peak from here on: the inputs stay on the card (reported
        # apart below), what it took to make them does not count
        torch.cuda.reset_peak_memory_stats(dev)
        inputs_bytes = int(torch.cuda.memory_allocated(dev))
    try:
        marks += drv.build()
        drv.warmup()
        marks.append(("warm-up", now()))
        setup_s = now() - t0
        log.append("setup_s by part: " + ", ".join(
            f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:])))
        before = hostinfo.snapshot(cuda)
        w = drv.window(seconds, trace)
        after = hostinfo.snapshot(cuda)
        log.append(hostinfo.report(before, after, w["frames"], w["marks"]))
        info.frames, info.window_s = w["frames"], w["wall_s"]
        info.latencies_ms = w.get("latencies_ms", [])
        if trace:
            with traced() as tinfo:
                tinfo.frames = drv.traced()
            info.trace = tinfo
        fin = drv.finish()
        drv.fill(info)
        log.append(f"run: {json.dumps(fin['diag'])}")
        peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
        log.append(f"memory: peak {peak} bytes, of which the cell's inputs held on the card "
                   f"{inputs_bytes} and the program {peak - inputs_bytes}")
    finally:
        drv.close()
    if cuda:
        torch.cuda.empty_cache()

    # the check, once the window has closed and the program's state is freed
    out = drv.outputs()
    values = {n: compare(n, root).value(out) for n in cell.limits}
    judged = check.judge(values, cell.limits)
    log.extend(check.report_lines(judged))

    if trace:
        metrics = {}
        for p in cell.per_layer:
            v = reader(p["name"], root)(info)
            if v is not None:
                metrics[p["name"]] = {"value": v, "unit": p["unit"]}
    else:
        e2e = {"setup_s": setup_s, "frames_per_s": info.frames / info.window_s}
        if cuda:
            # the program's own peak on the card: the cell's inputs, held
            # there since before the peak was reset, are the benchmark's
            e2e[CARD_ONLY[0]] = (peak - inputs_bytes) / 1e9
        if info.latencies_ms:
            e2e["frame_ms_p95"] = float(np.percentile(info.latencies_ms, 95))
        metrics = {e["name"]: {"value": e2e[e["name"]], "unit": e["unit"]}
                   for e in cell.end_to_end if e["name"] in e2e}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": all(d["ok"] for d in judged.values()),
              "attempted": int(fin["attempted"]), "failed": int(fin["failed"]),
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = info.trace.busy_s()
        device_info["window_s"] = info.trace.window_s
        result["breakdown"] = info.trace.breakdown()
    result["card"] = card() if cuda else "cpu"
    result["inputs_bytes"] = inputs_bytes
    result["checks"] = {n: {"value": d["value"], "limit": d["limit"]} for n, d in judged.items()}
    return result


def dumps(result: dict) -> str:
    """One JSON line; a number that is not finite is written as a string."""
    def fix(x):
        if isinstance(x, float) and not math.isfinite(x):
            return str(x)
        if isinstance(x, dict):
            return {k: fix(v) for k, v in x.items()}
        if isinstance(x, list):
            return [fix(v) for v in x]
        return x
    return json.dumps(fix(result))

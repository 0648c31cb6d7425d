"""BENCHMARK.json against the files the harness finds by name, the harness
finding a new configuration, cell, driver and metric added as files, and
the rule that nothing here imports JAX or the JAX package."""

import ast
import json
import shutil
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(harness.__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = harness.load_manifest()
NAMES = [w["name"] for w in MANIFEST["workloads"]]
# top-level import names nothing under the benchmark may use: JAX, and
# the JAX package (compared whole: the port's name begins with it), and
# the scripts that measure the JAX package
FORBIDDEN = {"jax", "jaxlib", "flax", "amos_slam_tpu", "bench", "chip_smoke"}
PORT = "amos_slam_tpu_torch"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("name", NAMES)
def test_each_cell_resolves_to_its_files(name):
    cell = harness.resolve(name)
    assert harness.driver(cell.traffic["driver"]).__name__ == "Driver"
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    reported = {e["name"] for e in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for p in cell.per_layer:
        assert p["moves"] in reported
        assert callable(harness.reader(p["name"]))
    for number in cell.limits:
        mod = harness.compare(number)
        assert callable(mod.value) and callable(mod.control)


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    layers = {}
    for p in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{p['name']}.py").is_file()
        for w in p.get("workloads", []):
            assert w in NAMES
        layers.setdefault(p["layer"].split(" (")[0], set()).add(p["layer"])
    assert all(len(v) == 1 for v in layers.values())


TOY_DRIVER = """
from time import perf_counter as now
from types import SimpleNamespace

import torch


class Driver:
    def __init__(self, cell, seed, device):
        self.n, self.traffic, self.seed, self.device = cell.config["n"], cell.traffic, seed, device
        self.got, self.k = [], 0

    def make_inputs(self):
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        self.x = torch.rand(self.traffic["rows"], self.n, generator=g, device=self.device)
        return [("inputs", now())]

    def build(self):
        self.prog = lambda row: row.sum()
        return [("program", now())]

    def _step(self):
        self.got.append(float(self.prog(self.x[self.k % self.x.shape[0]])))
        self.k += 1

    def warmup(self):
        while self.k < self.traffic["warmup_frames"]:
            self._step()

    def window(self, seconds, record=False):
        k0, t0, marks = self.k, now(), []
        while now() - t0 < seconds:
            self._step()
            marks.append((now() - t0, self.k - k0))
        return {"frames": self.k - k0, "wall_s": now() - t0, "marks": marks}

    def traced(self):
        for _ in range(self.traffic["trace_frames"]):
            self._step()
        return self.traffic["trace_frames"]

    def finish(self):
        return {"attempted": self.k, "failed": 0, "diag": {"steps": self.k}}

    def fill(self, run):
        pass

    def close(self):
        self.prog = None

    def outputs(self):
        return SimpleNamespace(x=self.x, got=self.got)
"""

TOY_COMPARE = """
import numpy as np


def value(out):
    ref = out.x.double().numpy().sum(axis=1)
    return max(abs(g - ref[k % len(ref)]) for k, g in enumerate(out.got))


def control(out, frames):
    x = out.x.numpy()
    half = x.astype(np.float16).sum(axis=1, dtype=np.float16).astype(np.float64)
    return float(np.abs(half - x.astype(np.float64).sum(axis=1)).max())
"""


def test_new_files_are_found_by_name(tmp_path):
    """Configurations of two kinds, traffic mixes with their drivers, a
    cell's limits with a number of its own and a per-layer metric, added
    as new files and entries, resolve without an edit to any file that
    was there: a same-shaped copy (16 streams), and a kind that has no
    SLAM system, whose driver builds its own program and whose check
    compares its own number; that one also runs end to end."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads(json.dumps(MANIFEST))
    b = root / BENCH.name
    cfg = json.loads((ROOT / MANIFEST["configs"][1]["file"]).read_text())
    cfg["name"] = "orbslam2-tum-rgbd-x16"
    cfg["streams"] = 16
    (b / "configs" / "orbslam2-tum-rgbd-x16.json").write_text(json.dumps(cfg))
    m["configs"].append({"name": cfg["name"], "source": "https://example.org/x16",
                         "file": "benchmark/configs/orbslam2-tum-rgbd-x16.json",
                         "reduced": [], "why": "sixteen streams"})
    tr = json.loads((b / "traffic" / "walk-streams.json").read_text())
    tr["driver"] = "multistream_staggered"
    (b / "traffic" / "walk-staggered.json").write_text(json.dumps(tr))
    (b / "drivers" / "multistream_staggered.py").write_text(
        "from .multistream import Driver as Base\n\n\nclass Driver(Base):\n    pass\n")
    (b / "checks" / "orbslam2-x16.staggered.json").write_text(
        json.dumps({"limits": {"ate_m": 0.03}}))
    m["workloads"].append({"name": "orbslam2-x16.staggered", "config": cfg["name"],
                           "traffic": "walk-staggered", "chips": 1, "why": "staggered"})
    # a kind of configuration the harness has never seen
    (b / "configs" / "toy-sum.json").write_text(json.dumps({"name": "toy-sum", "n": 64,
                                                            "reduced": []}))
    m["configs"].append({"name": "toy-sum", "source": "https://example.org/toy",
                         "file": "benchmark/configs/toy-sum.json", "reduced": [],
                         "why": "row sums"})
    (b / "traffic" / "toy-rows.json").write_text(json.dumps(
        {"driver": "toy", "rows": 16, "warmup_frames": 2, "trace_frames": 4}))
    (b / "drivers" / "toy.py").write_text(TOY_DRIVER)
    (b / "compare" / "row_sum_gap.py").write_text(TOY_COMPARE)
    (b / "checks" / "toy-sum.rows.json").write_text(json.dumps({"limits": {"row_sum_gap": 1e-3}}))
    m["workloads"].append({"name": "toy-sum.rows", "config": "toy-sum", "traffic": "toy-rows",
                           "chips": 1, "why": "row sums"})
    for e in m["end_to_end"]:
        if e["name"] == "frames_per_s":
            e["workloads"].append("toy-sum.rows")
    (b / "metrics" / "steps_per_s.py").write_text(
        "def read(run):\n    return run.frames / run.window_s if run.window_s else None\n")
    m["per_layer"].append({"name": "steps_per_s", "unit": "steps/s", "better": "higher",
                           "source": "host_clock", "layer": "host dispatch",
                           "moves": "frames_per_s",
                           "workloads": ["orbslam2-x16.staggered", "toy-sum.rows"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = harness.resolve("orbslam2-x16.staggered", root)
    assert cell.config["streams"] == 16 and cell.limits == {"ate_m": 0.03}
    assert "steps_per_s" in [p["name"] for p in cell.per_layer]
    assert harness.driver(cell.traffic["driver"], root).__mro__[1].__name__ == "Driver"
    info = harness.RunInfo(config=cell.config, traffic=cell.traffic, frames=32, window_s=2.0)
    assert harness.reader("steps_per_s", root)(info) == 16.0

    toy = harness.resolve("toy-sum.rows", root)
    r = harness.run(toy, 2 ** 31 + 5, 0.2, False, "cpu", root=root)
    assert r["correct"] and r["checks"]["row_sum_gap"]["value"] < 1e-4
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"} and r["attempted"] > 2
    r = harness.run(toy, 2 ** 31 + 5, 0.2, True, "cpu", root=root)
    assert r["metrics"]["steps_per_s"]["value"] > 0
    mod = harness.compare("row_sum_gap", root)
    drv = harness.driver("toy", root)(toy, 2 ** 31 + 5, "cpu")
    drv.make_inputs()
    assert mod.control(drv.outputs(), 0) > 1e-3


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        tops = {name.split(".")[0] for name in _imports(f)}
        assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)


def test_references_import_nothing_of_the_port():
    for f in sorted([*(BENCH / "reference").glob("*.py"), *(BENCH / "yardstick").glob("*.py")]):
        tops = {name.split(".")[0] for name in _imports(f)}
        assert PORT not in tops, f


def test_forbidden_modules_compare_whole_names():
    import sys

    import amos_slam_tpu_torch  # noqa: F401

    assert "amos_slam_tpu_torch" not in harness.forbidden_modules()
    if "amos_slam_tpu" in sys.modules:
        pytest.skip("the JAX package is loaded in this process")
    sys.modules["amos_slam_tpu"] = sys.modules["json"]
    try:
        assert "amos_slam_tpu" in harness.forbidden_modules()
    finally:
        del sys.modules["amos_slam_tpu"]


@pytest.mark.parametrize("bare", [False, True])
def test_command_without_a_card_prints_no_result(tmp_path, bare):
    """Without a CUDA card (this machine) the command exits with 2 and
    prints nothing on standard output, also in a directory that holds only
    BENCHMARK.json and the benchmark's folder."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cwd = ROOT
    if bare:
        cwd = tmp_path
        shutil.copy(ROOT / "BENCHMARK.json", cwd)
        shutil.copytree(BENCH, cwd / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, *MANIFEST["command"][1:], "--workload", NAMES[0],
                          "--seed", str(2 ** 31 + 1), "--seconds", "1", "--trace", "0"],
                         cwd=cwd, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""

"""On the card (marked ``cuda``; skips without one): the benchmark's
command for each cell, a short window, traced, ends with a correct result
line that carries every per-layer metric the cell lists, and the controls
fail the cell's limits at its own size.

    python -m pytest -m cuda benchmark/tests/test_bench_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(harness.__file__).resolve().parents[1]
CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_traced_run_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed", str(2 ** 31 + 17),
         "--seconds", "12", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=360, check=True)
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    expected = {p["name"] for p in harness.resolve(name).per_layer}
    assert set(r["metrics"]) == expected
    for name_, m in r["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (name_, m)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_controls_fail_on_the_card(card, name):
    import torch

    from benchmark import control

    cell = harness.resolve(name)
    r = control.readings(cell, 2 ** 31 + 29, torch.device("cuda"), 200)
    for number, limit in cell.limits.items():
        assert r[number] > limit, (number, r[number], limit)

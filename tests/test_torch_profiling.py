"""The port's ``utils/profiling.py`` against the JAX package's: the
``SpanTimer`` report, character for character, for the same spans with
``time.perf_counter`` patched to the same ticks in both; ``reset``;
``device_trace`` writing one JSON trace that holds the ``annotate`` and
``SpanTimer`` regions (host activity only here: there is no card)."""

import glob
import json
import time

import pytest
import torch

from amos_slam_tpu.utils import profiling as JP
from amos_slam_tpu_torch.utils import profiling as TP

# (name, seconds) in call order: repeats, a sub-millisecond span, a long
# name cut by neither report, and ties in total time
SPANS = [("extract", 0.0123), ("track", 0.0450), ("extract", 0.0101), ("local_ba", 0.3000),
         ("track", 0.0402), ("a_span_name_longer_than_32_characters", 0.0004),
         ("tie_a", 0.002), ("tie_b", 0.002)]


def run_spans(module, monkeypatch):
    ticks = iter([t for _, dt in SPANS for t in (100.0, 100.0 + dt)])
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    timer = module.SpanTimer()
    for name, _ in SPANS:
        with timer.span(name):
            pass
    monkeypatch.undo()
    return timer


def test_span_timer_report_equals_jax(monkeypatch):
    j, t = run_spans(JP, monkeypatch), run_spans(TP, monkeypatch)
    assert t.report() == j.report()
    assert dict(t.count) == dict(j.count) == {"extract": 2, "track": 2, "local_ba": 1,
                                             "a_span_name_longer_than_32_characters": 1,
                                             "tie_a": 1, "tie_b": 1}
    lines = t.report().splitlines()
    assert lines[0] == "span                              calls   total_ms    avg_ms"
    assert lines[1].startswith("local_ba ") and len(lines) == 1 + 6


def test_span_timer_reset(monkeypatch):
    t = run_spans(TP, monkeypatch)
    t.reset()
    assert not t.total and not t.count
    assert t.report() == JP.SpanTimer().report()


def test_span_records_errors_and_reraises():
    t = TP.SpanTimer()
    with pytest.raises(KeyError):
        with t.span("fails"):
            raise KeyError("x")
    assert t.count["fails"] == 1 and t.total["fails"] >= 0.0


def test_device_trace_writes_annotated_json(tmp_path):
    timer = TP.SpanTimer()
    with TP.device_trace(str(tmp_path)):
        with TP.annotate("port_annotate_region"):
            x = torch.ones(64, 64) @ torch.ones(64, 64)
        with timer.span("port_span_region"):
            x = x + 1
    files = glob.glob(str(tmp_path / "*.json"))
    assert len(files) == 1, files
    events = json.load(open(files[0]))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"port_annotate_region", "port_span_region"} <= names
    assert float(x[0, 0]) == 65.0 and timer.count["port_span_region"] == 1

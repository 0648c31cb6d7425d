"""The program's layer spans in a traced window (``metrics/_spans.py``) and
the per-layer readers built on them, on a canned trace with nested
``slam.*`` spans, launch calls and idle gaps: self against inclusive time,
a span nested in its own name, the union of ``slam.kf.*``, the division
per frame and per keyframe, the idle gaps attributed to the innermost
span, and readers that find no span returning nothing. Then the
manifest's entries for these readers, and their names against the port's
span catalogue."""

import pytest

from benchmark import harness
from benchmark.metrics import _spans
from benchmark.trace import WINDOW_SPAN, Trace

MS = 1_000_000   # ns
CELLS = {"amos-tum.walk-chunk": ["dynamics_ms_per_frame", "orb_ms_per_frame",
                                 "tracking_ms_per_frame", "supervision_ms_per_frame",
                                 "supervision_wait_ms_per_frame", "keyframe_ms_per_frame"],
         "amos-tum.walk-live": ["keyframe_ms", "local_ba_ms"],
         "orbslam2-x8.walk": ["orb_ms_per_frame.streams", "tracking_ms_per_frame.streams",
                              "supervision_ms_per_frame.streams",
                              "keyframe_ms_per_frame.streams"]}
NEW = [m for ms in CELLS.values() for m in ms]
CANNED = [  # (name, start ms, end ms)
    ("slam.supervision", 0, 10), ("slam.supervision.wait", 2, 4),
    ("slam.kf.insert", 5, 9), ("slam.kf.local_ba", 6, 8),
    ("slam.dynamics", 10, 40), ("slam.dynamics.pnp", 15, 30),
    ("slam.orb.detect", 40, 50), ("slam.orb.describe", 50, 55),
    ("slam.track", 55, 80), ("slam.map.view", 60, 62),
    ("slam.kf.insert", 70, 75), ("slam.kf.triangulate", 71, 72),
    ("slam.supervision", 80, 85), ("slam.supervision", 81, 83),
]
LAUNCHES = [1, 3, 12, 16, 20, 45, 56, 71.5, 87, 95]
KERNELS = [(11, 13), (31, 33), (51, 53), (63, 65), (86, 88)]


def canned(with_spans=True) -> Trace:
    """A 100 ms window of 2 frames: one chunk call (0-90 ms) holding the
    spans above; kernels leave idle gaps whose middles fall at 5.5 (under
    kf.insert), 22 (dynamics.pnp), 42 (orb.detect), 58 and 75.5 (track)
    and 94 ms (outside the call)."""
    t = Trace(0, 100 * MS, frames=2)
    t.kernels = [(f"k{i}", int(a * MS), int(b * MS)) for i, (a, b) in enumerate(KERNELS)]
    t.device = list(t.kernels)
    t.host = [(WINDOW_SPAN, 0, 100 * MS), ("bench.track_rgbd_chunk", 0, 90 * MS),
              ("aten::mul", 46 * MS, 47 * MS)]
    t.host += [("cudaLaunchKernel", int(x * MS), int(x * MS) + 5000) for x in LAUNCHES]
    if with_spans:
        t.host += [(n, a * MS, b * MS) for n, a, b in CANNED]
    return t


def info(cell, trace):
    c = harness.resolve(cell)
    return harness.RunInfo(config=c.config, traffic=c.traffic, trace=trace)


def test_span_stats_self_inclusive_counts():
    st = _spans.span_stats(canned())
    sup = st["slam.supervision"]
    # 0-10 (less the wait and the insertion) and 80-85 holding 81-83
    assert (sup.inclusive_ns, sup.self_ns, sup.count) == (15 * MS, 9 * MS, 2)
    ins = st["slam.kf.insert"]
    assert (ins.inclusive_ns, ins.self_ns, ins.count) == (9 * MS, 6 * MS, 2)
    trk = st["slam.track"]
    assert (trk.inclusive_ns, trk.self_ns) == (25 * MS, 18 * MS)
    assert st["slam.dynamics"].inclusive_ns == 30 * MS
    assert st["slam.dynamics"].self_ns == 15 * MS
    assert sum(s.self_ns for s in st.values()) == 85 * MS   # each instant counted once


def test_span_stats_launches_and_idle():
    st = _spans.span_stats(canned())
    assert st["slam.supervision"].launches == 2 and st["slam.supervision"].launches_self == 1
    assert st["slam.supervision.wait"].launches_self == 1
    assert st["slam.dynamics"].launches == 3 and st["slam.dynamics.pnp"].launches_self == 2
    assert st["slam.track"].launches == 2 and st["slam.kf.triangulate"].launches_self == 1
    assert sum(s.launches_self for s in st.values()) == 8
    idle = {n: s.idle_ns / MS for n, s in st.items() if s.idle_ns}
    assert idle == {"slam.kf.insert": 11, "slam.dynamics.pnp": 18, "slam.orb.detect": 18,
                    "slam.track": 31}


def test_coverage_of_a_benchmark_span():
    cov = _spans.coverage(canned(), "bench.track_rgbd_chunk")
    assert cov["host_share"] == pytest.approx(85 / 90)
    assert cov["idle_share"] == 1.0          # the gap at 94 ms lies outside the call
    assert (cov["launch_calls_in_spans"], cov["launch_calls"], cov["kernels"]) == (8, 10, 5)
    bare = _spans.coverage(canned(False), "bench.track_rgbd_chunk")
    assert bare["host_share"] == 0.0 and bare["idle_share"] == 0.0
    assert bare["launch_calls_in_spans"] == 0


def test_gaps_are_named_by_the_innermost_span():
    names = canned().name_gaps()
    assert names[1] == "bench.track_rgbd_chunk / slam.dynamics.pnp"
    assert names[-1] == "- / -"


@pytest.mark.parametrize("name,value", [
    ("dynamics_ms_per_frame", 15.0), ("orb_ms_per_frame", 7.5), ("tracking_ms_per_frame", 9.0),
    ("supervision_ms_per_frame", 4.5), ("supervision_wait_ms_per_frame", 1.0),
    ("keyframe_ms_per_frame", 4.5), ("keyframe_ms", 4.5), ("local_ba_ms", 2.0)])
def test_readers_on_the_canned_trace(name, value):
    cell = next(c for c, ms in CELLS.items() if name in ms)
    assert harness.reader(name)(info(cell, canned())) == pytest.approx(value)


@pytest.mark.parametrize("name", [m for m in NEW if m.endswith(".streams")])
def test_streams_readers_read_as_their_base(name):
    run = info("orbslam2-x8.walk", canned())
    assert harness.reader(name)(run) == harness.reader(name[: -len(".streams")])(run)
    assert harness.reader(name)(run) is not None


@pytest.mark.parametrize("name", NEW)
def test_readers_without_spans_read_nothing(name):
    cell = next(c for c, ms in CELLS.items() if name in ms)
    assert harness.reader(name)(info(cell, canned(False))) is None
    assert harness.reader(name)(info(cell, None)) is None


def test_layers_that_did_not_run_read_zero_or_nothing():
    """Supervision ran and never waited, and no keyframe work ran: the
    per-frame readers read 0, the per-keyframe and per-call ones nothing."""
    t = canned()
    t.host = [h for h in t.host if not h[0].startswith(("slam.kf.", "slam.supervision.wait"))]
    assert harness.reader("supervision_wait_ms_per_frame")(
        info("amos-tum.walk-chunk", t)) == 0.0
    assert harness.reader("keyframe_ms_per_frame")(info("amos-tum.walk-chunk", t)) == 0.0
    assert harness.reader("keyframe_ms")(info("amos-tum.walk-live", t)) is None
    assert harness.reader("local_ba_ms")(info("amos-tum.walk-live", t)) is None


def test_manifest_entries_resolve_and_move_what_their_cells_report():
    per_layer = {p["name"]: p for p in harness.load_manifest()["per_layer"]}
    for cell, names in CELLS.items():
        c = harness.resolve(cell)
        reported = {e["name"] for e in c.end_to_end}
        listed = {p["name"] for p in c.per_layer}
        for name in names:
            p = per_layer[name]
            assert name in listed and p["workloads"] == [cell]
            assert p["moves"] in reported and p["source"] == "device_trace"
            assert p["unit"] == "ms" and p["better"] == "lower"
            assert callable(harness.reader(name))


def test_read_names_are_the_ports_spans():
    """The names the readers read, and the canned trace's, are spans of the
    port's catalogue; each prefix read names some of them."""
    from amos_slam_tpu_torch.utils.profiling import SPANS

    read = {"slam.dynamics", "slam.track", "slam.supervision", "slam.supervision.wait",
            "slam.kf.insert", "slam.kf.local_ba"} | {n for n, _, _ in CANNED}
    assert read <= set(SPANS), read - set(SPANS)
    for prefix in ("slam.orb.", "slam.kf.", _spans.PREFIX):
        assert any(n.startswith(prefix) for n in SPANS), prefix

"""Each per-layer reader on a canned trace, and the trace's reduction:
busy time as the union of device intervals, idle gaps named by the host
span and operation at their middle, and readers that find nothing to read
returning nothing."""

import pytest

from benchmark import harness
from benchmark.trace import WINDOW_SPAN, Trace

MS = 1_000_000   # ns
CHUNK = harness.resolve("amos-tum.walk-chunk")
STREAMS = harness.resolve("orbslam2-x8.walk")
FAST = "fast_margin_nms_kernel(float const*, float*, int)"
FAST_P = "fast_margin_nms_persistent_kernel(float const*, float*)"


def canned(fast_name=FAST) -> Trace:
    """A 100 ms window of 2 frames: kernels at 10-20, 15-30 (overlapping)
    and 60-70 ms, a FAST kernel at 80-82 ms, a copy at 90-91 ms."""
    t = Trace(0, 100 * MS, frames=2)
    t.kernels = [("k_a", 10 * MS, 20 * MS), ("k_b", 15 * MS, 30 * MS),
                 ("k_a", 60 * MS, 70 * MS), (fast_name, 80 * MS, 82 * MS)]
    t.device = t.kernels + [("Memcpy HtoD (Pinned -> Device)", 90 * MS, 91 * MS)]
    t.host = [(WINDOW_SPAN, 0, 100 * MS), ("bench.track_rgbd", 0, 99 * MS),
              ("aten::index", 40 * MS, 50 * MS), ("cudaStreamSynchronize", 92 * MS, 99 * MS)]
    return t


def info(cell, **kw):
    base = dict(config=cell.config, traffic=cell.traffic,
                fast_kernel_names=("fast_margin_nms_kernel", "fast_margin_nms_persistent_kernel"))
    base.update(kw)
    return harness.RunInfo(**base)


def test_trace_reduction():
    t = canned()
    assert t.busy_intervals() == [(10 * MS, 30 * MS), (60 * MS, 70 * MS), (80 * MS, 82 * MS),
                                  (90 * MS, 91 * MS)]
    assert t.busy_s() == pytest.approx(0.033)
    assert t.idle_gaps()[1] == (30 * MS, 60 * MS)
    names = t.name_gaps()
    assert names[1] == "bench.track_rgbd / aten::index"
    assert names[-1] == "bench.track_rgbd / cudaStreamSynchronize"
    b = t.breakdown()
    assert b["device_ops"][0] == ["k_a", pytest.approx(0.02)]
    assert b["idle_gaps"][0][0] == "bench.track_rgbd / aten::index"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_device_readers():
    run = info(CHUNK, trace=canned(), fast_launch_shapes=[(8, 480, 640)])
    assert harness.reader("device_idle_share")(run) == pytest.approx(67.0)
    assert harness.reader("launches_per_frame")(run) == 2.0
    # the bytes bound of one (8, 480, 640) launch over its 2 ms
    assert harness.reader("fast_roofline.single")(run) == pytest.approx(
        100 * 0.00406943 / 2.0, rel=1e-5)
    assert harness.reader("fast_roofline.batched")(run) is None


def test_batched_roofline_reads_only_batched_launches():
    run = info(STREAMS, trace=canned(FAST_P), fast_launch_shapes=[(64, 480, 640)])
    assert harness.reader("fast_roofline.batched")(run) == pytest.approx(
        100 * 8 * 0.00406943 / 2.0, rel=1e-5)
    assert harness.reader("fast_roofline.single")(run) is None


def test_host_readers():
    run = info(CHUNK, frames=100, window_s=20.0, seg_event_ms=[16.0] * 12 + [8.0],
               latencies_ms=[200.0] * 10, keyframe_flags=[False, True] + [False] * 8)
    assert harness.reader("segmenter_ms_per_frame")(run) == pytest.approx(2.0)
    assert harness.reader("tracked_frames_per_s")(run) == pytest.approx(5.0)
    # 118.28 GFLOP per image x 5 frames/s over 989 TFLOP/s
    assert harness.reader("mfu")(run) == pytest.approx(100 * 118.281897344e9 * 5 / 989e12)
    run.latencies_ms[3] = 400.0
    assert harness.reader("keyframe_frame_ms")(run) == 400.0


@pytest.mark.parametrize("copy", [f"{b}.live" for b in (
    "device_idle_share", "launches_per_frame", "segmenter_ms_per_frame", "mfu",
    "fast_roofline.single")] + ["device_idle_share.streams", "launches_per_frame.streams"])
def test_live_readers_read_as_their_base(copy):
    """A metric's copies for other cells (``<metric>.live``, which move the
    latency's tail; ``<metric>.streams``, in the multistream cell) read
    what their base metric reads."""
    base, cell = copy.rsplit(".", 1)
    cell = harness.resolve({"live": "amos-tum.walk-live", "streams": "orbslam2-x8.walk"}[cell])
    run = info(cell, trace=canned(), fast_launch_shapes=[(8, 480, 640)], frames=100,
               window_s=20.0, seg_event_ms=[16.0] * 12 + [8.0])
    assert harness.reader(copy)(run) == harness.reader(base)(run)
    assert harness.reader(copy)(run) is not None


def test_readers_with_nothing_to_read_return_nothing():
    empty = info(STREAMS)
    for p in MANIFEST_PER_LAYER:
        assert harness.reader(p)(empty) is None, p


MANIFEST_PER_LAYER = [p["name"] for p in harness.load_manifest()["per_layer"]]

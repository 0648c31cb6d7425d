"""orb_ms_per_frame (ms): the host time of ORB extraction in the traced
window, the union of the spans ``slam.orb.detect`` and
``slam.orb.describe`` (the FAST op included), over the window's frames
(all streams)."""

from benchmark.metrics import _spans


def read(run):
    return _spans.per_frame_ms(run, None if run.trace is None
                               else _spans.union_of(run.trace, "slam.orb."))

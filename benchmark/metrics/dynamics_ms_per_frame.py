"""dynamics_ms_per_frame (ms): the host time of the program's geometric
stage in the traced window, the span ``slam.dynamics`` inclusive of its
parts (flow, PnP, clusters, vote), over the window's frames."""

from benchmark.metrics import _spans


def read(run):
    return _spans.per_frame_ms(run, None if run.trace is None
                               else _spans.union_of(run.trace, "slam.dynamics"))

"""local_ba_ms (ms): the host time of one local BA in the traced window,
the span ``slam.kf.local_ba`` over its count; nothing if none ran."""

from benchmark.metrics import _spans


def read(run):
    if run.trace is None:
        return None
    st = _spans.span_stats(run.trace).get("slam.kf.local_ba")
    return None if st is None else st.inclusive_ns / 1e6 / st.count

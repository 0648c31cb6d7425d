"""keyframe_ms (ms): the host time of keyframe work in the traced window,
the union of the spans ``slam.kf.*``, per keyframe inserted there (the
count of ``slam.kf.insert``); nothing if none was."""

from benchmark.metrics import _spans


def read(run):
    if run.trace is None:
        return None
    st = _spans.span_stats(run.trace).get("slam.kf.insert")
    if st is None or st.count == 0:
        return None
    return _spans.union_of(run.trace, "slam.kf.") / 1e6 / st.count

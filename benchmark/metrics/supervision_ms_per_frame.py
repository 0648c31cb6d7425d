"""supervision_ms_per_frame (ms): the self time of the span
``slam.supervision`` in the traced window (drains, the state machine,
keyframe decisions), without the ``slam.*`` spans nested in it (the host's
waits on the card and the keyframe work it runs), over the window's frames
(all streams)."""

from benchmark.metrics import _spans


def read(run):
    if run.trace is None:
        return None
    st = _spans.span_stats(run.trace).get("slam.supervision")
    return None if st is None else _spans.per_frame_ms(run, st.self_ns)

"""tracking_ms_per_frame (ms): the self time of the span ``slam.track`` in
the traced window (the motion model, the local-map track, the pose and
velocity update and the supervision pack; less the keyframe work and view
builds the slow path nests in it), over the window's frames (all
streams)."""

from benchmark.metrics import _spans


def read(run):
    if run.trace is None:
        return None
    st = _spans.span_stats(run.trace).get("slam.track")
    return None if st is None else _spans.per_frame_ms(run, st.self_ns)

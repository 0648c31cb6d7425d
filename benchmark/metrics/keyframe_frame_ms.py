"""keyframe_frame_ms (ms): over the keyframes decided in the window, the
median of the longest latency among the frames in whose calls the
keyframe is decided, inserted and maintained: the deciding frame k and,
with pipelined supervision, frames k + 1 and k + 2 (the program's
keyframe flags, ``System.stats``, say which frames decided one)."""

import statistics


def read(run):
    lat, kf = run.latencies_ms, run.keyframe_flags
    if not lat or not kf:
        return None
    worst = [max(lat[k: k + 3]) for k, f in enumerate(kf[: len(lat)]) if f]
    return statistics.median(worst) if worst else None

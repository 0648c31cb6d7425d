"""launches_per_frame: kernels the card ran in the traced window, over
the frames tracked in it (all streams)."""


def read(run):
    t = run.trace
    if t is None or t.frames <= 0:
        return None
    n = len(t.kernels)
    return n / t.frames if n else None

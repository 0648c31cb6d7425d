"""tracked_frames_per_s (frames/s): every frame tracked in the measured
window, all streams, over the window's wall time, taken as the end-to-end
``frames_per_s`` is; read in a ``--trace 1`` run from its untraced window,
in a cell whose host-clock frame rate spreads too widely to be bounded."""


def read(run):
    if run.frames <= 0 or run.window_s <= 0:
        return None
    return run.frames / run.window_s

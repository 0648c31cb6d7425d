"""segmenter_ms_per_frame (ms): the time between the CUDA events the
harness records before and after each segmenter call of the window,
summed over the window's calls, over the window's frames."""


def read(run):
    if not run.seg_event_ms or run.frames <= 0:
        return None
    return sum(run.seg_event_ms) / run.frames

"""supervision_wait_ms_per_frame (ms): the time the host spent blocked on
a copy from the card in the traced window, the span
``slam.supervision.wait``, over the window's frames. A window whose
supervision spans hold no wait reads 0 (the host never blocked); a window
without supervision spans reads nothing."""

from benchmark.metrics import _spans


def read(run):
    if not _spans.emits_spans(run):
        return None
    return _spans.per_frame_ms(run, _spans.union_of(run.trace, "slam.supervision.wait") or 0)

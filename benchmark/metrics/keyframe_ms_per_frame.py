"""keyframe_ms_per_frame (ms): the host time of keyframe work in the traced
window, the union of the spans ``slam.kf.*`` (insertion, triangulation,
fusion and culling, local BA, the loop closer), over the window's frames
(all streams). A window whose supervision spans started no keyframe work
reads 0; a window without supervision spans reads nothing."""

from benchmark.metrics import _spans


def read(run):
    if not _spans.emits_spans(run):
        return None
    return _spans.per_frame_ms(run, _spans.union_of(run.trace, "slam.kf.") or 0)

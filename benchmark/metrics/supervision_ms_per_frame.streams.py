"""supervision_ms_per_frame.streams: ``supervision_ms_per_frame`` in the
multistream cell, per stream-frame, where the bounded end-to-end metric is
the program's memory and the frame rate is read per layer
(``tracked_frames_per_s``)."""

from benchmark.metrics.supervision_ms_per_frame import read  # noqa: F401

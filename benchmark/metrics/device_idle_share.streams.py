"""device_idle_share.streams: ``device_idle_share`` in the multistream cell, where
the bounded end-to-end metric is the program's memory and the frame rate
is read per layer (``tracked_frames_per_s``)."""

from benchmark.metrics.device_idle_share import read  # noqa: F401

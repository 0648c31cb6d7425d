"""launches_per_frame.streams: ``launches_per_frame`` in the multistream cell, where
the bounded end-to-end metric is the program's memory and the frame rate
is read per layer (``tracked_frames_per_s``)."""

from benchmark.metrics.launches_per_frame import read  # noqa: F401

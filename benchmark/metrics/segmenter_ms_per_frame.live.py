"""segmenter_ms_per_frame.live (ms): ``segmenter_ms_per_frame`` in the live
cell (one image per call), where it moves the latency's tail rather than
the frame rate."""

from benchmark.metrics.segmenter_ms_per_frame import read  # noqa: F401

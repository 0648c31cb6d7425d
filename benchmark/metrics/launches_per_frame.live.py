"""launches_per_frame.live: ``launches_per_frame`` in the live cell, where
it moves the latency's tail rather than the frame rate."""

from benchmark.metrics.launches_per_frame import read  # noqa: F401

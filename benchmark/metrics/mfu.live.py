"""mfu.live (%): ``mfu`` in the live cell, where it moves the latency's
tail rather than the frame rate."""

from benchmark.metrics.mfu import read  # noqa: F401

"""device_idle_share.live (%): ``device_idle_share`` in the live cell,
where it moves the latency's tail rather than the frame rate."""

from benchmark.metrics.device_idle_share import read  # noqa: F401

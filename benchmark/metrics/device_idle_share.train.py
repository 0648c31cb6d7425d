"""device_idle_share.train (%): ``device_idle_share`` in the training
cell."""

from benchmark.metrics.device_idle_share import read  # noqa: F401

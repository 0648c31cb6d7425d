"""fast_roofline.single.live (%): ``fast_roofline.single`` in the live
cell, where it moves the latency's tail rather than the frame rate."""

from benchmark.metrics._fast_roofline import roofline


def read(run):
    return roofline(run, batched=False)

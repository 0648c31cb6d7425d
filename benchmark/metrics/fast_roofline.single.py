"""fast_roofline.single (%): the FAST op on one frame's pyramid (L, H, W)
per launch; see ``_fast_roofline``."""

from benchmark.metrics._fast_roofline import roofline


def read(run):
    return roofline(run, batched=False)

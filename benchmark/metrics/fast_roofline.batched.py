"""fast_roofline.batched (%): the FAST op on every stream's pyramid
(S * L, H, W) per launch; see ``_fast_roofline``."""

from benchmark.metrics._fast_roofline import roofline


def read(run):
    return roofline(run, batched=True)

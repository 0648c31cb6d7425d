"""mfu.train (%): 3 x the forward convolution FLOPs of one image
(``yardstick.flops``, from the configuration's shapes: the forward, and
the backward's products for the inputs' and the weights' gradients) times
the window's images, over the window's wall time, over the card's f32
peak (``yardstick.peaks``; the configuration trains in f32, TF32 off)."""

from benchmark.yardstick.flops import yolact_flops_per_image
from benchmark.yardstick.peaks import F32_FLOP_S


def read(run):
    c = run.config
    if "backbone_layers" not in c or run.frames <= 0 or run.window_s <= 0:
        return None
    flops = 3 * yolact_flops_per_image(c["img_size"], c["num_classes"],
                                       tuple(c["backbone_layers"]))
    return 100.0 * flops * run.frames / run.window_s / F32_FLOP_S

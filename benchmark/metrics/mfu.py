"""mfu (%): stage one's model FLOPs (``yardstick.flops``, counted from the
configuration's shapes) times the window's frames, over the window's
wall time, over the card's dense bf16 peak (``yardstick.peaks``)."""

from benchmark.yardstick.flops import yolact_flops_per_image
from benchmark.yardstick.peaks import BF16_FLOP_S


def read(run):
    seg = run.config.get("segmenter")
    if not seg or run.frames <= 0 or run.window_s <= 0:
        return None
    flops = yolact_flops_per_image(seg["img_size"], seg["num_classes"],
                                   tuple(seg["backbone_layers"]))
    return 100.0 * flops * run.frames / run.window_s / BF16_FLOP_S

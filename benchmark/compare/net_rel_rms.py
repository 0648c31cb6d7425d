"""net_rel_rms: stage one's net outputs of the sampled frames, read by a
forward hook on the segmenter's model, against the float32 reference
(``reference/yolact.py``, TF32 off). Control: the reference with fp8
convolutions, the precision below the configuration's bf16, on the
segmenter calls that cover the sampled frames."""

from benchmark import check


def value(out) -> float:
    return check.net_gap(out.net, out.params, out.rgb_of, out.img_size, out.layers)


def control(out, frames: int) -> float:
    W, warm = out.chunk, out.warm
    calls = sorted({warm + (k - warm) // W * W for k in out.net_steps})
    net = [([(0, c + j) for j in range(W)], None) for c in calls]
    return check.net_gap(net, out.params, out.rgb_of, out.img_size, out.layers, control="fp8")

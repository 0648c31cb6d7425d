"""Model FLOPs of YOLACT ResNet-FPN inference, counted from the
configuration's shapes: 2 x the multiply-adds of every convolution of the
backbone, the FPN, ProtoNet and the prediction head at each of the five
levels. The resizes between them (interpolation) and the detection after
them are not counted. The count reads the architecture, not the program,
so a change to how the program computes a layer does not move it."""

from __future__ import annotations

from typing import Dict, Tuple

FPN_DIM = 256
PROTO_DIM = 32
N_ANCHORS = 3


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def yolact_conv_flops(img_size: int = 550, num_classes: int = 81,
                      layers: Tuple[int, ...] = (3, 4, 6, 3)) -> Dict[str, int]:
    """FLOPs of one image's forward by part (``backbone``, ``fpn``,
    ``proto_net``, ``prediction_layers``)."""
    flops = {"backbone": 0, "fpn": 0, "proto_net": 0, "prediction_layers": 0}

    def conv(part, cin, cout, k, n_in, s=1, p=0):
        n = _out(n_in, k, s, p)
        flops[part] += 2 * cin * k * k * cout * n * n
        return n

    n = conv("backbone", 3, 64, 7, img_size, 2, 3)
    n = _out(n, 3, 2, 1)                                   # max pool
    cin, planes, sizes = 64, 64, []
    for s, blocks in enumerate(layers):
        for b in range(blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            conv("backbone", cin, planes, 1, n)
            m = conv("backbone", planes, planes, 3, n, stride, 1)
            conv("backbone", planes, planes * 4, 1, m)
            if b == 0:
                conv("backbone", cin, planes * 4, 1, n, stride)
            cin, n = planes * 4, m
        sizes.append(n)
        planes *= 2
    c3, c4, c5 = sizes[1:]
    for c, size in zip((2048, 1024, 512), (c5, c4, c3)):
        conv("fpn", c, FPN_DIM, 1, size)
    for size in (c5, c4, c3):
        conv("fpn", FPN_DIM, FPN_DIM, 3, size, 1, 1)
    p6 = conv("fpn", FPN_DIM, FPN_DIM, 3, c5, 2, 1)
    p7 = conv("fpn", FPN_DIM, FPN_DIM, 3, p6, 2, 1)
    for _ in range(3):
        conv("proto_net", FPN_DIM, 256, 3, c3, 1, 1)
    conv("proto_net", 256, 256, 3, 2 * c3, 1, 1)
    conv("proto_net", 256, PROTO_DIM, 1, 2 * c3)
    for size in (c3, c4, c5, p6, p7):
        conv("prediction_layers", FPN_DIM, 256, 3, size, 1, 1)
        for cout in (4 * N_ANCHORS, num_classes * N_ANCHORS, PROTO_DIM * N_ANCHORS):
            conv("prediction_layers", 256, cout, 3, size, 1, 1)
    return flops


def yolact_flops_per_image(img_size: int = 550, num_classes: int = 81,
                           layers: Tuple[int, ...] = (3, 4, 6, 3)) -> int:
    return sum(yolact_conv_flops(img_size, num_classes, layers).values())

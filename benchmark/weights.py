"""Weights made on the card from the seed, in a few large draws, in the
type they are served in."""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.yolact import param_shapes

# a normal truncated at +-2 standard deviations has this standard deviation
TRUNC_STD = 0.87962566103423978


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` for one use (``salt``) of ``seed``."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + salt) % 2 ** 63)


def yolact_params(seed: int, num_classes: int, layers, device, dtype=torch.bfloat16,
                  class_bias: Dict[int, float] = None) -> Dict[str, torch.Tensor]:
    """A YOLACT state dict in dbolya/yolact's names: conv weights
    lecun-normal (a normal truncated at +-2 standard deviations, variance 1
    / fan_in), conv biases N(0, 0.01^2), frozen batch norm near identity
    with some spread (weight 1 + N(0, 0.1^2), bias and mean N(0, 0.1^2),
    variance exp(N(0, 0.2^2))), so every term of the net is exercised.
    ``class_bias`` adds to the confidence head's bias of each named class
    (a detection class, the background not counted) at every prior."""
    shapes = param_shapes(num_classes, tuple(layers))
    gen = generator(seed, 1, device)
    convs = [k for k, s in shapes.items() if len(s) == 4]
    vecs = [k for k, s in shapes.items() if len(s) == 1]
    z = torch.randn(sum(math.prod(shapes[k]) for k in convs), generator=gen, device=device)
    z.clamp_(-2.0, 2.0)
    v = torch.randn(sum(math.prod(shapes[k]) for k in vecs), generator=gen, device=device)
    out, off = {}, 0
    for k in convs:
        s = shapes[k]
        n = math.prod(s)
        std = (1.0 / (s[1] * s[2] * s[3])) ** 0.5 / TRUNC_STD
        out[k] = (z[off: off + n].view(s) * std).to(dtype)
        off += n
    off = 0
    for k in vecs:
        n = shapes[k][0]
        x = v[off: off + n]
        off += n
        if k.endswith("running_var"):
            x = torch.exp(0.2 * x)
        elif k.endswith("weight"):
            x = 1.0 + 0.1 * x
        elif k.endswith("running_mean") or ".bn" in k or "downsample.1" in k:
            x = 0.1 * x
        else:                                   # a conv's bias
            x = 0.01 * x
        if k.endswith("conf_layer.bias") and class_bias:
            x = x.view(-1, num_classes).clone()
            for c, b in class_bias.items():
                x[:, 1 + c] += b                # column 0 is the background
            x = x.view(-1)
        out[k] = x.to(dtype)
    return {k: out[k] for k in shapes}

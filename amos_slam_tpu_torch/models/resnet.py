"""ResNet backbone for YOLACT (port of models/resnet.py).

Module and buffer names are the reference's PyTorch names
(``conv1``, ``bn1``, ``layers.{stage}.{block}.conv1..3`` / ``bn1..3`` /
``downsample.0`` / ``downsample.1``; batch norm as ``weight``, ``bias``,
``running_mean``, ``running_var``), so a reference ``.pth`` loads with
``load_state_dict`` and :func:`..models.port_torch.load_pth`.

Rounding follows the JAX package in any dtype: batch norm is applied in the
activations' dtype from its own parameters (not folded into the convs), and
a conv's bias is a separate add after the product (:class:`Conv2d`), as
Flax computes both. In bf16 every op then rounds where XLA's does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose bias is added after the product, in the
    output's dtype (Flax's ``y = conv(x, kernel); y += bias``): in bf16 the
    product rounds, then the sum rounds, as in the JAX package."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight, None, self.stride, self.padding)
        return y if self.bias is None else y + self.bias[:, None, None]


class FrozenBN(nn.Module):
    """Inference batch norm, y = (x - mean) / sqrt(var + eps) * w + b,
    computed as the JAX package's FrozenBN (resnet.py:34-35) in the
    buffers' dtype: ``inv = rsqrt(var + eps) * w``,
    ``x * inv + (b - mean * inv)``."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBN(planes)
        self.conv3 = Conv2d(planes, cout, 1, bias=False)
        self.bn3 = FrozenBN(cout)
        # Flax's 1x1 'SAME' conv pads 0 at any stride and size
        self.downsample = (nn.Sequential(Conv2d(cin, cout, 1, stride=stride, bias=False),
                                         FrozenBN(cout)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class ResNet(nn.Module):
    """Returns (C2, C3, C4, C5); layers=(3, 4, 6, 3) is ResNet-50."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBN(64)
        self.layers = nn.ModuleList()
        cin, planes = 64, 64
        for stage, n_blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(cin, planes, stride if b == 0 else 1, downsample=b == 0))
                cin = planes * Bottleneck.expansion
            self.layers.append(nn.Sequential(*blocks))
            planes *= 2

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)     # pads with -inf, as Flax
        outs = []
        for stage in self.layers:
            y = stage(y)
            outs.append(y)
        return tuple(outs)

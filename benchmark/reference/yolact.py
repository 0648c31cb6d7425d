"""Plain reference of YOLACT ResNet50-FPN inference: the net's (loc, conf,
coef, proto) from RGB frames, in float32 with TF32 off.

Follows dbolya/yolact (``yolact.py``, ``backbone.py``: ResNet-50 with
frozen batch norm, FPN with P3-P7, ProtoNet, one prediction head shared by
the five levels; ``yolact_resnet50_config``: 550 px, 81 classes, 32
prototypes, 3 aspect ratios) and reads a state dict under that
repository's parameter names. Departures, each also made by the port: the
input frame is resized to 550 x 550 with an antialiased triangle filter
(``jax.image.resize``'s, not ``F.interpolate``'s), and the FPN's and
ProtoNet's upsampling uses the same filter (equal to bilinear with
half-pixel centres when it enlarges).

``precision="fp8"`` is the control: every convolution's input and weight
rounded to float8 e4m3 with a per-tensor scale (amax / 448), as an fp8
inference path would, the rest as above.

Imports nothing of the port; plain torch on any device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MEANS_BGR = (103.94, 116.78, 123.68)
STD_BGR = (57.38, 57.12, 58.40)
FPN_DIM = 256
PROTO_DIM = 32
N_ANCHORS = 3
RESNET50 = (3, 4, 6, 3)
E4M3_MAX = 448.0


def param_shapes(num_classes: int = 81, layers=RESNET50) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every tensor of the state dict, in dbolya/yolact's
    names (convs: ``weight`` (out, in, k, k) and, outside the backbone,
    ``bias``; frozen batch norm: ``weight``, ``bias``, ``running_mean``,
    ``running_var``)."""
    out: Dict[str, Tuple[int, ...]] = {}

    def conv(name, cin, cout, k, bias):
        out[f"{name}.weight"] = (cout, cin, k, k)
        if bias:
            out[f"{name}.bias"] = (cout,)

    def bn(name, c):
        for p in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{p}"] = (c,)

    conv("backbone.conv1", 3, 64, 7, False)
    bn("backbone.bn1", 64)
    cin, planes = 64, 64
    for s, n in enumerate(layers):
        for b in range(n):
            p = f"backbone.layers.{s}.{b}"
            conv(f"{p}.conv1", cin, planes, 1, False)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3, False)
            bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3", planes, planes * 4, 1, False)
            bn(f"{p}.bn3", planes * 4)
            if b == 0:
                conv(f"{p}.downsample.0", cin, planes * 4, 1, False)
                bn(f"{p}.downsample.1", planes * 4)
            cin = planes * 4
        planes *= 2
    for i, c in enumerate((2048, 1024, 512)):
        conv(f"fpn.lat_layers.{i}", c, FPN_DIM, 1, True)
    for i in range(3):
        conv(f"fpn.pred_layers.{i}", FPN_DIM, FPN_DIM, 3, True)
    for i in range(2):
        conv(f"fpn.downsample_layers.{i}", FPN_DIM, FPN_DIM, 3, True)
    for k in ("0", "2", "4", "8"):
        conv(f"proto_net.{k}", FPN_DIM, 256, 3, True)
    conv("proto_net.10", 256, PROTO_DIM, 1, True)
    h = "prediction_layers.0"
    conv(f"{h}.upfeature.0", FPN_DIM, 256, 3, True)
    conv(f"{h}.bbox_layer", 256, 4 * N_ANCHORS, 3, True)
    conv(f"{h}.conf_layer", 256, num_classes * N_ANCHORS, 3, True)
    conv(f"{h}.mask_layer", 256, PROTO_DIM * N_ANCHORS, 3, True)
    return out


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of the antialiased triangle filter: output i
    samples the input at (i + 0.5) * n_in / n_out - 0.5 with a triangle
    widened by n_in / n_out when shrinking, weights normalised to sum 1,
    float64."""
    inv = n_in / n_out
    width = max(inv, 1.0)
    centre = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(centre[:, None] - np.arange(n_in)[None, :]) / width
    w = np.maximum(0.0, 1.0 - x)
    return w / w.sum(axis=1, keepdims=True)


def resize(x: torch.Tensor, size) -> torch.Tensor:
    """(..., H, W) -> (..., h, w) by :func:`resize_matrix` on both axes."""
    wy = torch.from_numpy(resize_matrix(x.shape[-2], size[0])).to(x.device, x.dtype)
    wx = torch.from_numpy(resize_matrix(x.shape[-1], size[1])).to(x.device, x.dtype)
    return wy @ x @ wx.T


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Net:
    def __init__(self, params: Dict[str, torch.Tensor], precision: str, device):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32 or fp8, got {precision!r}")
        self.p = {k: v.to(device, torch.float32) for k, v in params.items()}
        self.fp8 = precision == "fp8"

    def conv(self, name, x, stride=1, padding=0):
        w = self.p[f"{name}.weight"]
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        y = F.conv2d(x, w, None, stride, padding)
        b = self.p.get(f"{name}.bias")
        return y if b is None else y + b[:, None, None]

    def bn(self, name, x):
        p = self.p
        inv = torch.rsqrt(p[f"{name}.running_var"] + 1e-5) * p[f"{name}.weight"]
        shift = p[f"{name}.bias"] - p[f"{name}.running_mean"] * inv
        return x * inv[:, None, None] + shift[:, None, None]

    def backbone(self, x, layers) -> List[torch.Tensor]:
        y = torch.relu(self.bn("backbone.bn1", self.conv("backbone.conv1", x, 2, 3)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        outs = []
        for s, n in enumerate(layers):
            for b in range(n):
                p = f"backbone.layers.{s}.{b}"
                stride = 2 if (b == 0 and s > 0) else 1
                z = torch.relu(self.bn(f"{p}.bn1", self.conv(f"{p}.conv1", y)))
                z = torch.relu(self.bn(f"{p}.bn2", self.conv(f"{p}.conv2", z, stride, 1)))
                z = self.bn(f"{p}.bn3", self.conv(f"{p}.conv3", z))
                short = (self.bn(f"{p}.downsample.1", self.conv(f"{p}.downsample.0", y, stride))
                         if b == 0 else y)
                y = torch.relu(z + short)
            outs.append(y)
        return outs

    def fpn(self, c3, c4, c5):
        p5 = self.conv("fpn.lat_layers.0", c5)
        p4 = self.conv("fpn.lat_layers.1", c4) + resize(p5, c4.shape[-2:])
        p3 = self.conv("fpn.lat_layers.2", c3) + resize(p4, c3.shape[-2:])
        p3 = torch.relu(self.conv("fpn.pred_layers.2", p3, 1, 1))
        p4 = torch.relu(self.conv("fpn.pred_layers.1", p4, 1, 1))
        p5 = torch.relu(self.conv("fpn.pred_layers.0", p5, 1, 1))
        p6 = self.conv("fpn.downsample_layers.0", p5, 2, 1)
        p7 = self.conv("fpn.downsample_layers.1", p6, 2, 1)
        return p3, p4, p5, p6, p7

    def proto(self, p3):
        y = p3
        for k in ("0", "2", "4"):
            y = torch.relu(self.conv(f"proto_net.{k}", y, 1, 1))
        y = resize(y, (2 * y.shape[-2], 2 * y.shape[-1]))
        y = torch.relu(self.conv("proto_net.8", y, 1, 1))
        return torch.relu(self.conv("proto_net.10", y)).permute(0, 2, 3, 1)

    def head(self, x, num_classes):
        h = "prediction_layers.0"
        y = torch.relu(self.conv(f"{h}.upfeature.0", x, 1, 1))
        B = x.shape[0]

        def flat(t, n):
            return t.permute(0, 2, 3, 1).reshape(B, -1, n)

        return (flat(self.conv(f"{h}.bbox_layer", y, 1, 1), 4),
                flat(self.conv(f"{h}.conf_layer", y, 1, 1), num_classes),
                flat(torch.tanh(self.conv(f"{h}.mask_layer", y, 1, 1)), PROTO_DIM))


@torch.no_grad()
def forward(params: Dict[str, torch.Tensor], rgb: torch.Tensor, img_size: int = 550,
            precision: str = "f32", layers=RESNET50) -> Tuple[torch.Tensor, ...]:
    """(B, H, W, 3) RGB frames in [0, 255] -> (loc (B, P, 4), conf (B, P,
    C), coef (B, P, 32), proto (B, S/4, S/4, 32)), float32."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        net = _Net(params, precision, rgb.device)
        num_classes = net.p["prediction_layers.0.conf_layer.weight"].shape[0] // N_ANCHORS
        x = rgb.to(torch.float32).permute(0, 3, 1, 2)
        x = resize(x, (img_size, img_size)).flip(1)                 # BGR
        mean = torch.tensor(MEANS_BGR, device=x.device)[:, None, None]
        std = torch.tensor(STD_BGR, device=x.device)[:, None, None]
        x = (x - mean) / std
        _, c3, c4, c5 = net.backbone(x, layers)
        levels = net.fpn(c3, c4, c5)
        proto = net.proto(levels[0])
        outs = [net.head(p, num_classes) for p in levels]
        loc, conf, coef = (torch.cat(t, dim=1) for t in zip(*outs))
        return loc, conf, coef, proto
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

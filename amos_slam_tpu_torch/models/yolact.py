"""YOLACT instance segmentation (port of models/yolact.py).

ResNet-FPN backbone, ProtoNet mask prototypes, one PredictionHead shared
by the five FPN levels, fast-NMS detection. Module names are the
reference's PyTorch names (``fpn.lat_layers``, ``proto_net.{0,2,4,8,10}``,
``prediction_layers.0.{upfeature.0, bbox_layer, conf_layer, mask_layer}``),
so the JAX package's ``port_state_dict`` reads this model's ``state_dict``
unchanged, and ``convert.yolact_state_dict`` is its inverse.

The net takes and returns NCHW tensors except ``proto``, which is NHWC
(B, Hp, Wp, PROTO_DIM) as the JAX model returns it. Detection and mask
assembly are batched over B with static shapes and no host read: the
counterpart of the JAX segmenter's ``jax.vmap`` over images.

``jax.image.resize`` (the FPN's upsampling, ProtoNet's x2) is
:class:`Resize`: JAX's antialiased triangle weights, rounded to the
activations' dtype as JAX casts them, applied one axis at a time with the
product rounded to that dtype after each axis, in the axis order of XLA's
two contractions. ``F.interpolate`` computes another filter and, in bf16,
rounds once instead of twice.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.f32 import recip
from ..ops.fast import top_k_stable
from ..ops.pyramid import resize_matrix
from .resnet import Conv2d, ResNet

# COCO config of the reference (src/python/config.py yolact_base_config)
IMG_SIZE = 550
NUM_CLASSES = 81          # 80 + background
PROTO_DIM = 32
FPN_DIM = 256
SCALES = (24, 48, 96, 192, 384)
ASPECT_RATIOS = (1.0, 0.5, 2.0)
MEANS = np.array([103.94, 116.78, 123.68], np.float32)   # BGR means
STD = np.array([57.38, 57.12, 58.40], np.float32)


class Resize(nn.Module):
    """``jax.image.resize(x, ..., "bilinear")`` over the last two axes of
    (..., H, W). ``h_first`` is the axis XLA contracts first: H for the
    NHWC activations and the output mask, W for the input frames.
    Products run in f32 on the dtype-rounded weights and round to x's
    dtype after each axis. Weights are cached per shape, dtype and
    device."""

    def __init__(self, h_first: bool = True):
        super().__init__()
        self.h_first = h_first
        self._cache = {}

    def _weights(self, h, oh, w, ow, dtype, device):
        key = (h, oh, w, ow, dtype, device)
        if key not in self._cache:
            def mat(n, m):
                return torch.from_numpy(resize_matrix(n, m)).to(dtype).to(device, torch.float32)
            self._cache[key] = (mat(h, oh), mat(w, ow).T.contiguous())
        return self._cache[key]

    def forward(self, x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
        wy, wxt = self._weights(x.shape[-2], size[0], x.shape[-1], size[1], x.dtype, x.device)
        if self.h_first:
            y = (wy @ x.float()).to(x.dtype)
            return (y.float() @ wxt).to(x.dtype)
        y = (x.float() @ wxt).to(x.dtype)
        return (wy @ y.float()).to(x.dtype)


class FPN(nn.Module):
    """Feature pyramid: laterals on C5..C3 (``lat_layers`` in that,
    reversed, order; ``pred_layers`` too), 3x3 smoothing with relu, and two
    stride-2 levels P6, P7 from P5."""

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048), dim: int = FPN_DIM):
        super().__init__()
        self.lat_layers = nn.ModuleList([Conv2d(c, dim, 1) for c in reversed(in_channels)])
        self.pred_layers = nn.ModuleList([Conv2d(dim, dim, 3, padding=1) for _ in range(3)])
        self.downsample_layers = nn.ModuleList(
            [Conv2d(dim, dim, 3, stride=2, padding=1) for _ in range(2)])
        self.resize = Resize(h_first=True)

    def forward(self, c3, c4, c5):
        lat, pred, down = self.lat_layers, self.pred_layers, self.downsample_layers
        p5 = lat[0](c5)
        p4 = lat[1](c4) + self.resize(p5, c4.shape[-2:])
        p3 = lat[2](c3) + self.resize(p4, c3.shape[-2:])
        p3 = torch.relu(pred[2](p3))
        p4 = torch.relu(pred[1](p4))
        p5 = torch.relu(pred[0](p5))
        p6 = down[0](p5)
        p7 = down[1](p6)
        return p3, p4, p5, p6, p7


class ProtoNet(nn.ModuleDict):
    """Mask prototypes from P3: three 3x3 convs with relu (0, 2, 4), a x2
    resize (6), a 3x3 conv with relu (8), a 1x1 conv to PROTO_DIM (10) and
    a final relu; the keys are the reference Sequential's indices."""

    def __init__(self, dim: int = PROTO_DIM):
        super().__init__({
            "0": Conv2d(FPN_DIM, 256, 3, padding=1),
            "2": Conv2d(256, 256, 3, padding=1),
            "4": Conv2d(256, 256, 3, padding=1),
            "6": Resize(h_first=True),
            "8": Conv2d(256, 256, 3, padding=1),
            "10": Conv2d(256, dim, 1),
        })

    def forward(self, p3):
        y = p3
        for k in ("0", "2", "4"):
            y = torch.relu(self[k](y))
        y = self["6"](y, (2 * y.shape[-2], 2 * y.shape[-1]))
        y = torch.relu(self["8"](y))
        return torch.relu(self["10"](y))


class PredictionHead(nn.Module):
    """The head shared by every FPN level: boxes, class logits and tanh
    mask coefficients per (pixel, anchor), flattened in NHWC order."""

    def __init__(self, num_classes: int = NUM_CLASSES, num_anchors: int = len(ASPECT_RATIOS),
                 proto_dim: int = PROTO_DIM):
        super().__init__()
        self.num_classes, self.proto_dim = num_classes, proto_dim
        self.upfeature = nn.Sequential(Conv2d(FPN_DIM, 256, 3, padding=1), nn.ReLU())
        self.bbox_layer = Conv2d(256, 4 * num_anchors, 3, padding=1)
        self.conf_layer = Conv2d(256, num_classes * num_anchors, 3, padding=1)
        self.mask_layer = Conv2d(256, proto_dim * num_anchors, 3, padding=1)

    def forward(self, x):
        y = self.upfeature(x)
        B = x.shape[0]

        def flat(t, n):
            return t.permute(0, 2, 3, 1).reshape(B, -1, n)

        return (flat(self.bbox_layer(y), 4), flat(self.conf_layer(y), self.num_classes),
                flat(torch.tanh(self.mask_layer(y)), self.proto_dim))


class Yolact(nn.Module):
    def __init__(self, num_classes: int = NUM_CLASSES,
                 backbone_layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.backbone = ResNet(backbone_layers)
        self.fpn = FPN()
        self.proto_net = ProtoNet()
        self.prediction_layers = nn.ModuleList([PredictionHead(num_classes)])

    def forward(self, images: torch.Tensor):
        """images: (B, 3, H, W) normalized. Returns (loc (B, P, 4),
        conf (B, P, C), coef (B, P, PROTO_DIM), proto (B, Hp, Wp, PROTO_DIM))."""
        _, c3, c4, c5 = self.backbone(images)
        levels = self.fpn(c3, c4, c5)
        proto = self.proto_net(levels[0]).permute(0, 2, 3, 1)
        head = self.prediction_layers[0]
        outs = [head(p) for p in levels]
        loc, conf, coef = (torch.cat(t, dim=1) for t in zip(*outs))
        return loc, conf, coef, proto


def make_priors(img_size: int = IMG_SIZE) -> np.ndarray:
    """Anchor boxes (cx, cy, w, h) normalized, (P, 4) f32: one scale per
    level, square-rooted aspect ratios, ``ceil(img_size / stride)`` cells
    per side (10,077 priors at 400, 19,248 at 550)."""
    priors = []
    for lvl, scale in enumerate(SCALES):
        stride = 2 ** (lvl + 3)          # P3 stride 8 ... P7 stride 128
        fs = (img_size + stride - 1) // stride
        for y in range(fs):
            for x in range(fs):
                cx = (x + 0.5) / fs
                cy = (y + 0.5) / fs
                for ar in ASPECT_RATIOS:
                    r = np.sqrt(ar)
                    priors.append([cx, cy, scale * r / img_size, scale / r / img_size])
    return np.asarray(priors, np.float32)


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """SSD-style decode with variances (0.1, 0.2) -> (x1, y1, x2, y2)."""
    cxy = priors[:, :2] + loc[..., :2] * 0.1 * priors[:, 2:]
    wh = priors[:, 2:] * torch.exp(loc[..., 2:] * 0.2)
    return torch.cat([cxy - wh * 0.5, cxy + wh * 0.5], dim=-1)


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) xyxy -> (..., N, N) IoU."""
    a, b = boxes[..., :, None, :], boxes[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, K, 4) normalized xyxy
    scores: torch.Tensor   # (B, K)
    classes: torch.Tensor  # (B, K) int32 (0-based, background removed)
    coefs: torch.Tensor    # (B, K, PROTO_DIM)
    valid: torch.Tensor    # (B, K) bool


def detect(loc: torch.Tensor, conf: torch.Tensor, coef: torch.Tensor, priors: torch.Tensor,
           top_k: int = 100, pre_nms: int = 200, conf_th: float = 0.05,
           nms_iou: float = 0.5) -> Detections:
    """Fast-NMS detection over a batch: loc (B, P, 4), conf (B, P, C),
    coef (B, P, PROTO_DIM), priors (P, 4).

    Per image, as the JAX package's ``detect``: the ``pre_nms`` highest
    best-class scores form a class-agnostic pool; a candidate is dropped
    if a higher-ranked candidate of its class overlaps it by IoU >
    ``nms_iou``; the ``top_k`` best survivors are returned. Both top-k
    steps keep equal values in ascending index order (``lax.top_k``)."""
    boxes = decode_boxes(loc, priors)                        # (B, P, 4)
    probs = torch.softmax(conf, dim=-1)[..., 1:]             # drop background
    best_score, best_cls = probs.max(dim=-1)                 # first maximum, as argmax
    top_score, top_idx = top_k_stable(best_score, pre_nms)   # (B, pre_nms)
    cand_boxes = torch.take_along_dim(boxes, top_idx[..., None], dim=1)
    cand_cls = torch.take_along_dim(best_cls, top_idx, dim=1)
    cand_coef = torch.take_along_dim(coef, top_idx[..., None], dim=1)
    ok = top_score > conf_th

    iou = _iou_matrix(cand_boxes)
    same = cand_cls[..., :, None] == cand_cls[..., None, :]
    earlier = torch.ones(pre_nms, pre_nms, dtype=torch.bool, device=loc.device).tril(-1)
    max_iou = torch.where(earlier & same, iou, 0.0).amax(dim=-1)
    keep = ok & (max_iou <= nms_iou)

    score = torch.where(keep, top_score, 0.0)
    sel_score, sel = top_k_stable(score, top_k)
    return Detections(
        boxes=torch.take_along_dim(cand_boxes, sel[..., None], dim=1),
        scores=sel_score,
        classes=torch.take_along_dim(cand_cls, sel, dim=1).to(torch.int32),
        coefs=torch.take_along_dim(cand_coef, sel[..., None], dim=1),
        valid=sel_score > conf_th,
    )


def linspace01(n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` bit for bit: ``i * f32(1 / (n - 1))``
    (XLA's product with the reciprocal), then exactly 1."""
    steps = torch.arange(n - 1, dtype=torch.float32, device=device) * recip(n - 1)
    return torch.cat([steps, torch.ones(1, dtype=torch.float32, device=device)])


def assemble_masks(proto: torch.Tensor, det: Detections, mask_th: float = 0.5) -> torch.Tensor:
    """(B, Hp, Wp, PROTO_DIM) prototypes + detections -> (B, K, Hp, Wp)
    binary masks, cropped to their boxes."""
    m = torch.sigmoid(torch.einsum("bhwc,bkc->bkhw", proto, det.coefs))
    Hp, Wp = proto.shape[1:3]
    ys = linspace01(Hp, proto.device)[:, None]
    xs = linspace01(Wp, proto.device)[None, :]
    b = det.boxes[..., None, None]                           # (B, K, 4, 1, 1)
    inside = ((xs >= b[:, :, 0]) & (xs <= b[:, :, 2])
              & (ys >= b[:, :, 1]) & (ys <= b[:, :, 3]))
    return (m > mask_th) & inside & det.valid[..., None, None]

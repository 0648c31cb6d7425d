"""Plain reference of one YOLACT training step: the multibox loss, its
gradients by ``torch.autograd`` and one SGD step with momentum and weight
decay, in float32 with TF32 off (or in the dtype of the tensors given).

The net is :mod:`reference.yolact`'s (ResNet-FPN, ProtoNet, one shared
prediction head), here from normalised (B, 3, S, S) images, with every
tensor of the state dict differentiated. The loss follows dbolya/yolact's
``layers/modules/multibox_loss.py`` for ``yolact_resnet50_config``:
priors matched to ground truth at IoU 0.5 (each ground truth also forces
its best prior), smooth-L1 on the positives' encoded boxes (variances 0.1
and 0.2), cross-entropy on the positives and on hard negatives mined at 3
per positive (OHEM), and the prototype mask term, a binary cross-entropy
of sigmoid(proto @ coef) against the matched mask inside its box;
weighted 1.5 (boxes), 1 (classes) and 6.125 (masks). SGD as
``torch.optim.SGD`` with momentum and weight decay: ``g' = g + wd p``,
``m = g' + momentum m`` (m starting at 0), ``p = p - lr m``.

Departures from the published step, each as the program under test takes
it:

* the mask term covers every positive prior (dbolya trains at most
  ``masks_to_train`` = 100 per image, drawn at random), evaluated per
  image over its positives; the program pads them to the batch's largest
  count, which adds only zeros;
* OHEM keeps every negative tied with the k-th hardest (dbolya keeps
  exactly k, ties in its sort's order), and every prior that is not
  positive is a candidate (dbolya leaves IoU 0.4-0.5 neutral);
* each term is normalised by its own image's positives, then averaged over
  the batch (dbolya divides the batch's sums by its total positives);
* no semantic segmentation term (the net has no such head), and batch
  norm's weight, bias, mean and variance are stepped like every tensor
  (dbolya freezes batch norm);
* priors: one scale per level, aspect ratios 1, 1/2, 2 applied as
  (w, h) = scale (sqrt(a), 1 / sqrt(a)) (dbolya's ``use_square_anchors``
  makes its three anchors per cell square);
* a padded ground truth's best prior is prior 0 and, matched after a
  valid one with the same best prior, un-forces it (the JAX package's
  scatter order);
* the mask crop's pixel grid is ``i * f32(1 / (n - 1))``, the last 1
  (``jnp.linspace``); the BCE is taken from the logits (the stable form);
* the learning rate stays at its first value (dbolya steps it down at
  iteration 280,000, far beyond any run here).

``precision``: ``"f32"`` (TF32 off, the configuration's), ``"tf32"``
(TF32 on for convolutions and products: the precision just below, a
control) and ``"bf16"`` (bf16 autocast, a control). The TF32 switches are
restored on return.

Imports nothing of the port; plain torch on any device.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import yolact as net_ref

SCALES = (24, 48, 96, 192, 384)
ASPECT_RATIOS = (1.0, 0.5, 2.0)
VARIANCES = (0.1, 0.2)


class Hyper(NamedTuple):
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    pos_iou: float = 0.5
    neg_ratio: int = 3
    box_weight: float = 1.5
    mask_weight: float = 6.125


def priors(img_size: int) -> torch.Tensor:
    """(P, 4) float32 (cx, cy, w, h) of the five levels (strides 8-128),
    cells row by row, three aspect ratios per cell."""
    rows = []
    for lvl, scale in enumerate(SCALES):
        fs = math.ceil(img_size / 2 ** (lvl + 3))
        for y in range(fs):
            for x in range(fs):
                for ar in ASPECT_RATIOS:
                    r = math.sqrt(ar)
                    rows.append(((x + 0.5) / fs, (y + 0.5) / fs, scale * r / img_size,
                                 scale / r / img_size))
    return torch.tensor(np.asarray(rows, np.float32))


def grid(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` in float32: i * f32(1 / (n - 1)), then 1."""
    step = torch.tensor(np.float32(1.0) / np.float32(n - 1), device=device)
    g = torch.arange(n, dtype=torch.float32, device=device) * step
    g[-1] = 1.0
    return g


def outputs(params: Dict[str, torch.Tensor], images: torch.Tensor, layers):
    """(loc, conf, coef, proto) of :mod:`reference.yolact`'s net on
    normalised (B, 3, S, S) images, the parameters used as given."""
    net = net_ref._Net({}, "f32", images.device)
    net.p = params
    num_classes = params["prediction_layers.0.conf_layer.weight"].shape[0] // net_ref.N_ANCHORS
    _, c3, c4, c5 = net.backbone(images, layers)
    levels = net.fpn(c3, c4, c5)
    proto = net.proto(levels[0])
    outs = [net.head(p, num_classes) for p in levels]
    loc, conf, coef = (torch.cat(t, dim=1) for t in zip(*outs))
    return loc, conf, coef, proto


def _iou(pri: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(P, 4) cxcywh priors x (G, 4) xyxy boxes -> (P, G) IoU."""
    p = torch.cat([pri[:, :2] - pri[:, 2:] / 2, pri[:, :2] + pri[:, 2:] / 2], dim=1)
    lo = torch.maximum(p[:, None, :2], boxes[None, :, :2])
    hi = torch.minimum(p[:, None, 2:], boxes[None, :, 2:])
    inter = (hi - lo).clamp(min=0).prod(dim=2)
    area_p = (p[:, 2] - p[:, 0]) * (p[:, 3] - p[:, 1])
    area_b = (boxes[:, 2:] - boxes[:, :2]).clamp(min=0).prod(dim=1)
    return inter / (area_p[:, None] + area_b[None, :] - inter).clamp(min=1e-9)


def match(pri: torch.Tensor, boxes: torch.Tensor, labels: torch.Tensor, pos_iou: float):
    """One image: (positive (P,) bool, matched ground truth (P,) long).
    A prior is positive with its best ground truth above ``pos_iou``; each
    ground truth, in order, then takes its best prior (the later one
    winning a shared prior), which is positive if that ground truth is
    valid."""
    valid = labels >= 0
    iou = torch.where(valid[None, :], _iou(pri, boxes), torch.full((), -1.0, device=pri.device))
    best_iou, best_gt = iou.max(dim=1)
    best_prior = iou.argmax(dim=0)
    forced_by = torch.full((pri.shape[0],), -1, dtype=torch.long, device=pri.device)
    for g in range(boxes.shape[0]):
        forced_by[best_prior[g]] = g
    forced = (forced_by >= 0) & valid[forced_by.clamp(min=0)]
    pos = (best_iou > pos_iou) | forced
    return pos, torch.where(forced, forced_by, best_gt)


def encode(matched: torch.Tensor, pri: torch.Tensor) -> torch.Tensor:
    """xyxy boxes -> SSD offsets from their priors."""
    centre = (matched[:, :2] + matched[:, 2:]) / 2
    wh = (matched[:, 2:] - matched[:, :2]).clamp(min=1e-6)
    return torch.cat([(centre - pri[:, :2]) / (VARIANCES[0] * pri[:, 2:]),
                      torch.log(wh / pri[:, 2:]) / VARIANCES[1]], dim=1)


def image_loss(loc, conf, coef, proto, pri, boxes, labels, masks, h: Hyper):
    """(box, class, mask) terms of one image, each over its positives."""
    P = loc.shape[0]
    pos, gt = match(pri, boxes, labels, h.pos_iou)
    n_pos = pos.sum().clamp(min=1)

    d = (loc - encode(boxes[gt], pri)).abs()
    l_box = (torch.where(d < 1, 0.5 * d * d, d - 0.5).sum(dim=1) * pos).sum() / n_pos

    target = torch.where(pos, labels[gt].long() + 1, 0)
    logp = torch.log_softmax(conf, dim=1)
    ce = -logp.gather(1, target[:, None])[:, 0]
    with torch.no_grad():
        bg = torch.where(pos, -math.inf, -logp[:, 0])
        k = int(torch.minimum(h.neg_ratio * n_pos, P - n_pos))
        kth = torch.topk(bg, max(k, 1)).values[-1]
        neg = ~pos & (bg >= kth) & torch.isfinite(bg)
    l_cls = (ce * (pos | neg)).sum() / n_pos

    idx = pos.nonzero()[:, 0]
    Hp, Wp = proto.shape[:2]
    logits = torch.einsum("hwc,nc->nhw", proto, coef[idx])
    bce = F.binary_cross_entropy_with_logits(logits, masks[gt[idx]], reduction="none")
    b = boxes[gt[idx]][:, :, None, None]
    ys, xs = grid(Hp, proto.device)[:, None], grid(Wp, proto.device)[None, :]
    inside = (xs >= b[:, 0]) & (xs <= b[:, 2]) & (ys >= b[:, 1]) & (ys <= b[:, 3])
    per_prior = (bce * inside).sum(dim=(1, 2)) / inside.sum(dim=(1, 2)).clamp(min=1)
    l_mask = per_prior.sum() / n_pos
    return l_box, l_cls, l_mask


def loss(params, images, boxes, labels, masks, layers, h: Hyper = Hyper()):
    """(total, {"loc", "conf", "mask"}): each term averaged over the
    batch's images, total = 1.5 loc + conf + 6.125 mask."""
    # bf16 outputs (the autocast control) are widened; the reductions stay f32
    loc, conf, coef, proto = (t.float() if t.dtype == torch.bfloat16 else t
                              for t in outputs(params, images, layers))
    pri = priors(images.shape[-1]).to(loc.device)       # float32 in any dtype
    terms = [image_loss(loc[b], conf[b], coef[b], proto[b], pri, boxes[b], labels[b], masks[b],
                        h) for b in range(images.shape[0])]
    l_box, l_cls, l_mask = (torch.stack(t).mean() for t in zip(*terms))
    total = h.box_weight * l_box + l_cls + h.mask_weight * l_mask
    return total, {"loc": l_box, "conf": l_cls, "mask": l_mask}


@contextlib.contextmanager
def _precision(precision: str, device: torch.device):
    if precision not in ("f32", "tf32", "bf16"):
        raise ValueError(f"precision must be f32, tf32 or bf16, got {precision!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        if precision == "bf16":
            with torch.autocast(device.type, dtype=torch.bfloat16):
                yield
        else:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def step(params: Dict[str, torch.Tensor], momentum: Dict[str, torch.Tensor], images, boxes,
         labels, masks, layers, h: Hyper = Hyper(), precision: str = "f32") -> dict:
    """One step from (params, momentum) on a batch: ``loss``, ``parts``
    (detached), ``grads``, and the new ``momentum`` and ``params``, each a
    dict under the params' keys."""
    keys = list(params)
    leaves = {k: params[k].detach().requires_grad_() for k in keys}
    with _precision(precision, images.device):
        total, parts = loss(leaves, images, boxes, labels, masks, layers, h)
        grads = torch.autograd.grad(total, [leaves[k] for k in keys])
    new_m, new_p = {}, {}
    with torch.no_grad():
        for k, g in zip(keys, grads):
            p = params[k]
            new_m[k] = g.to(p.dtype) + h.weight_decay * p + h.momentum * momentum[k]
            new_p[k] = p - h.lr * new_m[k]
    return {"loss": total.detach(), "parts": {k: v.detach() for k, v in parts.items()},
            "grads": dict(zip(keys, grads)), "momentum": new_m, "params": new_p}


def update_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Tuple[float, str]:
    """The largest, over tensors, of max |got - ref| / max |ref|, and the
    tensor that has it."""
    worst, name = 0.0, ""
    for k, r in ref.items():
        den = float(r.abs().max())
        gap = float((got[k].to(r.dtype) - r).abs().max()) / den if den > 0 else (
            0.0 if float(got[k].abs().max()) == 0 else math.inf)
        if not gap <= worst:
            worst, name = gap, k
    return worst, name

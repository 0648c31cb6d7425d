"""YOLACT training: multibox loss with OHEM and the SGD-momentum step
(port of models/train.py).

The reference's training stack (src/python/train.py:172,
layers/modules/multibox_loss.py) in the JAX package's form: one loss over
static-shaped padded ground truth, its gradient, and SGD with momentum and
weight decay. ``params`` is a dict keyed as the port's ``Yolact.state_dict``
and the forward is ``torch.func.functional_call(model, params, images)``.
As in the JAX package, whose ``FrozenBN`` holds ``scale``, ``bias``,
``mean`` and ``var`` as Flax params, every tensor of the dict is
differentiated and stepped, batch norm's ``weight``, ``bias``,
``running_mean`` and ``running_var`` included. Training runs in f32 (TF32
is off package-wide). The data-parallel step over a process group is
``parallel/data_parallel.py``; it shares :func:`value_and_grads` and
:func:`sgd_update` with :func:`make_train_step`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..utils.profiling import span
from .yolact import Yolact, linspace01


class GTBatch(NamedTuple):
    """Padded ground truth for a batch.

    images: (B, 3, S, S) normalized (the JAX package's are (B, S, S, 3));
    boxes: (B, G, 4) normalized xyxy; labels: (B, G) int32 (-1 pad, 0-based
    foreground classes); masks: (B, G, Hp, Wp) float32 {0,1} at proto res.
    """

    images: torch.Tensor
    boxes: torch.Tensor
    labels: torch.Tensor
    masks: torch.Tensor


def _encode(matched: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """xyxy gt -> SSD offsets wrt priors (variances 0.1/0.2)."""
    g_c = (matched[..., :2] + matched[..., 2:]) * 0.5
    g_wh = torch.clamp(matched[..., 2:] - matched[..., :2], min=1e-6)
    d_c = (g_c - priors[:, :2]) / (0.1 * priors[:, 2:])
    d_wh = torch.log(g_wh / priors[:, 2:]) / 0.2
    return torch.cat([d_c, d_wh], dim=-1)


def _prior_gt_iou(priors: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(P, 4 cxcywh) x (..., G, 4 xyxy) -> (..., P, G) IoU."""
    p = torch.cat([priors[:, :2] - priors[:, 2:] * 0.5, priors[:, :2] + priors[:, 2:] * 0.5],
                  dim=-1)
    b = boxes[..., None, :, :]
    x1 = torch.maximum(p[:, None, 0], b[..., 0])
    y1 = torch.maximum(p[:, None, 1], b[..., 1])
    x2 = torch.minimum(p[:, None, 2], b[..., 2])
    y2 = torch.minimum(p[:, None, 3], b[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ap = (p[:, 2] - p[:, 0]) * (p[:, 3] - p[:, 1])
    ag = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
          * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))
    return inter / torch.clamp(ap[:, None] + ag[..., None, :] - inter, min=1e-9)


@torch.no_grad()
def _match(priors: torch.Tensor, boxes: torch.Tensor, labels: torch.Tensor,
           pos_iou: float):
    """Priors to ground truth, per image: (pos (B, P) bool, gt_idx (B, P)).

    A prior is positive with its best gt when their IoU exceeds
    ``pos_iou``, and each valid gt forces its best prior positive with it.
    The JAX package forces with two scatters over ``best_prior``
    (``.at[best_prior].set``), whose indices repeat: a padded gt's IoU is
    -1 everywhere, so its best prior is prior 0, and two gts may share a
    best prior. XLA's scatter applies duplicate updates in order, the last
    one winning (measured on its CPU, eager and jitted); here each prior
    takes the last gt that names it, the max over a (G, P) match table, so
    no duplicate scatter (unordered on CUDA) is made."""
    G, P = boxes.shape[-2], priors.shape[0]
    gt_valid = labels >= 0                                         # (B, G)
    iou = torch.where(gt_valid[:, None, :], _prior_gt_iou(priors, boxes), -1.0)
    best_gt = iou.argmax(dim=2)                                    # (B, P), first max
    best_iou = iou.amax(dim=2)
    best_prior = iou.argmax(dim=1)                                 # (B, G)
    hit = best_prior[:, :, None] == torch.arange(P, device=iou.device)   # (B, G, P)
    g = torch.arange(G, device=iou.device)[None, :, None]
    last = torch.where(hit, g, -1).amax(dim=1)                     # (B, P), -1: no gt
    forced = (last >= 0) & torch.gather(gt_valid, 1, last.clamp(min=0))
    pos = (best_iou > pos_iou) | forced
    gt_idx = torch.where(forced, last, best_gt)
    return pos, gt_idx


def _mask_loss(proto: torch.Tensor, coef: torch.Tensor, pos: torch.Tensor,
               gt_idx: torch.Tensor, boxes: torch.Tensor, masks: torch.Tensor,
               n_pos: torch.Tensor) -> torch.Tensor:
    """The mask term per image, (B,): the mean over positive priors (sum
    over ``n_pos``) of the BCE between sigmoid(proto @ coef) and the
    matched gt mask, averaged inside the gt box.

    The JAX package evaluates it densely, (P, Hp, Wp) per image, and
    multiplies by ``pos``: a non-positive prior adds 0 x a finite BCE to
    the loss and exactly 0 to the gradient. So only the positives are
    evaluated here, padded per image to the batch's largest count K (one
    host read of that count per call): (B, K, Hp, Wp) instead of (B, P, Hp,
    Wp), which at P = 19,248 priors and a 138 x 138 proto would not fit on
    the card. Same loss and gradients, up to the order of the sums."""
    B = pos.shape[0]
    counts = pos.sum(dim=1)
    K = int(counts.max())
    order = torch.argsort((~pos).to(torch.uint8), dim=1, stable=True)[:, :K]   # positives first
    valid = torch.arange(K, device=pos.device) < counts[:, None]           # (B, K)
    g = torch.take_along_dim(gt_idx, order, dim=1)                           # (B, K)
    coef_k = torch.take_along_dim(coef, order[..., None], dim=1)             # (B, K, C)
    m_pred = torch.einsum("bhwc,bkc->bkhw", proto, coef_k)
    m_gt = masks[torch.arange(B, device=pos.device)[:, None], g]             # (B, K, Hp, Wp)
    # optax.sigmoid_binary_cross_entropy
    bce = -m_gt * F.logsigmoid(m_pred) - (1.0 - m_gt) * F.logsigmoid(-m_pred)
    # crop to the gt box like the reference (mask loss inside the box only)
    Hp, Wp = proto.shape[1:3]
    ys = linspace01(Hp, pos.device)[:, None]
    xs = linspace01(Wp, pos.device)[None, :]
    b = torch.take_along_dim(boxes, g[..., None], dim=1)[..., None, None]    # (B, K, 4, 1, 1)
    inside = ((xs >= b[:, :, 0]) & (xs <= b[:, :, 2])
              & (ys >= b[:, :, 1]) & (ys <= b[:, :, 3]))
    area = torch.clamp(inside.sum(dim=(2, 3)), min=1)
    m_loss = (bce * inside).sum(dim=(2, 3)) / area
    return (m_loss * valid).sum(dim=1) / n_pos


def multibox_loss(
    model: Yolact,
    params: Dict[str, torch.Tensor],
    priors: torch.Tensor,
    batch: GTBatch,
    pos_iou: float = 0.5,
    neg_ratio: int = 3,
    mask_weight: float = 6.125,
    box_weight: float = 1.5,
):
    """Reference multibox_loss.py contract: smooth-L1 loc on positives,
    OHEM cross-entropy conf (neg:pos = 3), BCE on assembled+cropped masks.
    Returns (loss, {"loc", "conf", "mask"}), each a batch mean."""
    loc, conf, coef, proto = functional_call(model, params, (batch.images,), strict=True)
    with span("train.loss"):
        return _loss(loc, conf, coef, proto, priors, batch, pos_iou, neg_ratio, mask_weight,
                     box_weight)


def _loss(loc, conf, coef, proto, priors, batch: GTBatch, pos_iou: float, neg_ratio: int,
          mask_weight: float, box_weight: float):
    """:func:`multibox_loss` from the net's outputs."""
    P = loc.shape[1]
    priors = torch.as_tensor(priors, dtype=torch.float32, device=loc.device)
    pos, gt_idx = _match(priors, batch.boxes, batch.labels, pos_iou)
    n_pos = torch.clamp(pos.sum(dim=1), min=1)                               # (B,)

    # localization
    target = _encode(torch.take_along_dim(batch.boxes, gt_idx[..., None], dim=1), priors)
    diff = torch.abs(loc - target)
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    loss_loc = (sl1.sum(dim=-1) * pos).sum(dim=1) / n_pos

    # classification with OHEM (labels are 0-based foreground; +1 makes
    # room for background class 0)
    labels = torch.take_along_dim(batch.labels, gt_idx, dim=1)
    cls_target = torch.where(pos, labels + 1, 0).long()
    logp = torch.log_softmax(conf, dim=-1)
    ce = -torch.take_along_dim(logp, cls_target[..., None], dim=-1)[..., 0]
    with torch.no_grad():
        # hard negatives: the k highest background losses, ties at the
        # threshold kept (``>=``), as the JAX package selects them
        neg_score = torch.where(pos, -torch.inf, -logp[..., 0])
        k = torch.minimum(neg_ratio * n_pos, P - n_pos)
        ranked = torch.sort(neg_score, dim=1, descending=True).values
        thresh = torch.take_along_dim(ranked, (k.clamp(1, P) - 1)[:, None], dim=1)
        neg = ~pos & (neg_score >= thresh) & torch.isfinite(neg_score)
    loss_conf = (ce * (pos | neg)).sum(dim=1) / n_pos

    loss_mask = _mask_loss(proto, coef, pos, gt_idx, batch.boxes, batch.masks, n_pos)
    ll, lc, lm = loss_loc.mean(), loss_conf.mean(), loss_mask.mean()
    return box_weight * ll + lc + mask_weight * lm, {"loc": ll, "conf": lc, "mask": lm}


class TrainState(NamedTuple):
    params: dict        # state_dict-keyed tensors, batch norm's four included
    opt_state: dict     # the momentum trace, under the same keys
    step: torch.Tensor  # () int32


def value_and_grads(model: Yolact, priors: torch.Tensor, params: Dict[str, torch.Tensor],
                    batch: GTBatch):
    """(loss, aux, grads) of :func:`multibox_loss` at ``params``: ``grads``
    a list in the dict's key order, every tensor differentiated."""
    with span("train.grads"):
        keys = list(params)
        leaves = [params[k].detach().requires_grad_() for k in keys]
        loss, aux = multibox_loss(model, dict(zip(keys, leaves)), priors, batch)
        grads = list(torch.autograd.grad(loss, leaves))
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


@torch.no_grad()
def sgd_update(state: TrainState, grads, lr: float, momentum: float,
               weight_decay: float) -> TrainState:
    """One SGD step with momentum and decayed weights (``grads`` in the
    key order of ``state.params``): optax's ``chain(add_decayed_weights(
    weight_decay), sgd(lr, momentum))`` written out, ``g' = g + wd * p``,
    ``m = g' + momentum * m`` (``m`` starting at zero), ``p = p - lr * m``."""
    with span("train.sgd"):
        keys = list(state.params)
        p = [state.params[k] for k in keys]
        g = torch._foreach_add(list(grads), p, alpha=weight_decay)
        m = torch._foreach_add(g, [state.opt_state[k] for k in keys], alpha=momentum)
        new_p = torch._foreach_add(p, m, alpha=-lr)
        return TrainState(dict(zip(keys, new_p)), dict(zip(keys, m)), state.step + 1)


def init_train_state(params) -> TrainState:
    """Step 0: ``params`` (state_dict-keyed) and a zero momentum trace."""
    params = dict(params)
    dev = next(iter(params.values())).device
    return TrainState(params, {k: torch.zeros_like(v) for k, v in params.items()},
                      torch.zeros((), dtype=torch.int32, device=dev))


def make_train_step(model: Yolact, priors: torch.Tensor, lr: float = 1e-3,
                    momentum: float = 0.9, weight_decay: float = 5e-4):
    """(init, step) of SGD with momentum and weight decay over every tensor
    of ``params`` (:func:`sgd_update`). ``step(state, batch)`` returns (new
    state, loss, aux) and leaves ``state`` as it was."""

    def step(state: TrainState, batch: GTBatch):
        loss, aux, grads = value_and_grads(model, priors, state.params, batch)
        return sgd_update(state, grads, lr, momentum, weight_decay), loss, aux

    return init_train_state, step

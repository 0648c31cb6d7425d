"""The data-parallel YOLACT train step over a ``torch.distributed`` group.

The JAX package jits ``make_train_step`` with the batch sharded over a
``("dp",)`` mesh and the state replicated (tests/test_yolact_train.py):
the loss and gradients of the global batch, one SGD update, the state
left replicated. Here each rank of a process group holds the state and
its equal share of the batch. The loss is a per-image mean over the batch
and batch norm trains as parameters with no batch statistics
(models/train.py), so the mean of the ranks' gradients is the global
batch's gradient: each step all-reduces the gradients, the loss and its
parts in one flat bucket (a SUM, then a division by the group's size),
and every rank applies the same update (``models.train.sgd_update``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.train import GTBatch, TrainState, init_train_state, sgd_update, value_and_grads
from ..models.yolact import Yolact

_AUX = ("loc", "conf", "mask")


def make_data_parallel_step(model: Yolact, priors: torch.Tensor, group=None, lr: float = 1e-3,
                            momentum: float = 0.9, weight_decay: float = 5e-4):
    """(init, step) of ``models.train.make_train_step`` over the ranks of
    ``group`` (``None``: the default process group, which must exist; no
    group raises, never a single-process step in its place).

    ``init(params)`` broadcasts the params from the group's first rank,
    so every rank starts from the same state. ``step(state, local_batch)``
    takes this rank's images (every rank the same count; unequal counts
    raise on every rank) and returns (new state, loss, aux) of the global
    batch, equal on every rank."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "amos_slam_tpu_torch: make_data_parallel_step needs an initialized process "
            "group (torch.distributed.init_process_group)")
    world = dist.get_world_size(group)
    src = dist.get_global_rank(group, 0) if group is not None else 0

    def init(params) -> TrainState:
        state = init_train_state({k: v.clone() for k, v in params.items()})
        tensors = list(state.params.values())
        flat = _flatten(tensors)
        dist.broadcast(flat, src, group=group)
        for t, v in zip(tensors, _unflatten(flat, tensors)):
            t.copy_(v)
        return state

    def step(state: TrainState, local_batch: GTBatch):
        loss, aux, grads = value_and_grads(model, priors, state.params, local_batch)
        n = float(local_batch.images.shape[0])
        counts = torch.tensor([n, n * n], dtype=loss.dtype, device=loss.device)
        scalars = torch.stack([loss] + [aux[k] for k in _AUX])
        tensors = grads + [scalars, counts]
        flat = _flatten(tensors)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        *grads, scalars, counts = _unflatten(flat, tensors)
        # sizes n_r are equal exactly when world * sum(n_r^2) == sum(n_r)^2
        total, squares = counts.tolist()
        if world * squares != total * total:
            raise ValueError(
                f"amos_slam_tpu_torch: the global batch of {int(total)} images is not split "
                f"evenly over {world} ranks (this rank holds {int(n)})")
        grads = torch._foreach_div(grads, world)
        scalars = scalars / world
        new = sgd_update(state, grads, lr, momentum, weight_decay)
        return new, scalars[0], dict(zip(_AUX, scalars[1:]))

    return init, step


def _flatten(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflatten(flat: torch.Tensor, like):
    parts = torch.split(flat, [t.numel() for t in like])
    return [p.view(t.shape).to(t.dtype) for p, t in zip(parts, like)]

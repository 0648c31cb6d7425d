"""Training, closed loop: each step takes the next batch from the port's
``models.data.DataLoader`` (its one host thread decoding, augmenting and
uploading ahead) and runs ``models.train.make_train_step``'s step on a
``TrainState``; the next step is dispatched as soon as the call returns.
The window closes when the last step's loss is on the host. ``frames``
counts images trained (steps x the configuration's ``batch_size``).

The program is built from the configuration file through the port's
entry points: ``models.configs.get_config(<net>)`` with the file's fields,
``YolactConfig.build``, ``make_train_step``, and the loader over
``SyntheticShapes`` with ``AugmentConfig``. The first weights come from
the seed through the port's initializer. For the check, the driver keeps the input state
and batch of ``check.steps`` steps drawn from the seed among the window's
first ``check.span`` steps, and the program's loss, parts and new state
after each (``compare/train_loss_rel.py``, ``compare/train_update_rel.py``).
"""

from __future__ import annotations

import dataclasses
import inspect
from time import perf_counter as now
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from ..reference.yolact_train import Hyper

# configuration keys that are fields of the port's YolactConfig
FIELDS = ("img_size", "num_classes", "backbone_layers", "proto_hw", "lr", "momentum",
          "weight_decay", "lr_steps", "lr_gamma", "max_iter", "batch_size")
# configuration keys that are multibox_loss's arguments (the step takes its defaults)
LOSS_ARGS = ("pos_iou", "neg_ratio", "mask_weight", "box_weight")


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_clone(v) for v in tree)) if hasattr(tree, "_fields") else tuple(
            _clone(v) for v in tree)
    return tree


def check_steps(seed: int, warm: int, check: dict) -> set:
    """The steps whose input and output the check reads."""
    rng = np.random.default_rng([seed % 2 ** 63, 7])
    span = check["span"]
    return {warm + int(k) for k in rng.choice(span, size=min(check["steps"], span),
                                              replace=False)}


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, seed
        self.cfg, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        self.batch = self.cfg["batch_size"]
        self.warm = self.traffic["warmup_steps"]
        self.check_steps = check_steps(seed, self.warm, self.traffic["check"])
        self.dataset = self.params = self.loader = self.state = self.step_fn = None
        self.losses = []          # per step, (loss, loc, conf, mask) on the card
        self.captured = []
        self.window_steps = (0, 0)
        self.k = 0

    # -- set-up -------------------------------------------------------------
    def yolact_config(self):
        """The port's registered config of the file's ``net``, with the
        file's fields."""
        from amos_slam_tpu_torch.models import configs

        c = self.cfg
        return dataclasses.replace(configs.get_config(c["net"]), **{
            k: tuple(c[k]) if isinstance(c[k], list) else c[k] for k in FIELDS})

    def make_inputs(self):
        from amos_slam_tpu_torch.models import data

        ds = self.traffic["dataset"]
        self.dataset = data.SyntheticShapes(n=ds["n"], size=ds["size"],
                                            max_shapes=ds["max_shapes"], seed=self.seed)
        return [("dataset", now())]

    def _params(self):
        """The net's first weights from the seed: the port's initializer
        (``models.segmenter.flax_init_``) on the host, moved to the card."""
        if self.params is None:
            from amos_slam_tpu_torch.models.segmenter import flax_init_

            model = self.yolact_config().build(device="cpu")
            flax_init_(model, torch.Generator().manual_seed(self.seed % 2 ** 63))
            self.params = {k: v.to(self.device) for k, v in model.state_dict().items()}
        return self.params

    def _loader(self):
        from amos_slam_tpu_torch.models import data

        yc = self.yolact_config()
        return data.DataLoader(self.dataset, self.batch, yc.img_size, self.traffic["max_objs"],
                               yc.proto_shape, data.AugmentConfig(**self.traffic["augment"]),
                               seed=self.seed, prefetch=self.traffic["prefetch"],
                               device=self.device)

    def build(self):
        from amos_slam_tpu_torch.models import train

        defaults = inspect.signature(train.multibox_loss).parameters
        for key in LOSS_ARGS:
            if defaults[key].default != self.cfg[key]:
                raise ValueError(f"{key} {self.cfg[key]} is not the train step's "
                                 f"{defaults[key].default}")
        yc = self.yolact_config()
        model = yc.build(device=self.device)
        priors = torch.from_numpy(yc.priors()).to(self.device)
        init, self.step_fn = train.make_train_step(model, priors, yc.lr, yc.momentum,
                                                   yc.weight_decay)
        self.state = init(self._params())
        marks = [("weights and model", now())]
        self.loader = self._loader()
        marks.append(("loader", now()))
        return marks

    # -- the loop -----------------------------------------------------------
    def _step(self):
        with record_function("bench.next_batch"):
            batch = next(self.loader)
        k = self.k
        with record_function("bench.train_step"):
            before = _clone((self.state, batch)) if k in self.check_steps else None
            state, loss, aux = self.step_fn(self.state, batch)
            self.losses.append(torch.stack([loss, aux["loc"], aux["conf"], aux["mask"]]))
            if before is not None:
                self.captured.append({"step": k, "state": before[0], "batch": before[1],
                                      "loss": loss.clone(), "parts": _clone(aux),
                                      "out": _clone(state)})
        self.state = state
        self.k += 1
        return loss

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        while self.k < self.warm:
            self._step()
        self.sync()

    def window(self, seconds: float, record: bool = False) -> dict:
        k0, t0 = self.k, now()
        loss, marks = None, []
        while now() - t0 < seconds:
            loss = self._step()
            marks.append((now() - t0, (self.k - k0) * self.batch))
        with record_function("bench.loss_to_host"):
            float(loss)
        self.window_steps = (k0, self.k)
        return {"frames": (self.k - k0) * self.batch, "wall_s": now() - t0, "marks": marks}

    def traced(self) -> int:
        n = self.traffic["trace_steps"]
        for _ in range(n):
            loss = self._step()
        float(loss)
        return n * self.batch

    def finish(self) -> dict:
        """Images of the steps after the warm-up, and those of steps whose
        loss or parts came back non-finite."""
        losses = torch.stack(self.losses).cpu().numpy()
        after = losses[self.warm:]
        bad = int((~np.isfinite(after).all(axis=1)).sum())
        diag = {"steps": len(losses), "loss_first": losses[0].tolist(),
                "loss_last": losses[-1].tolist(),
                "loader_batches": getattr(self.loader, "batches", None),
                "loader_waits": getattr(self.loader, "waits", None)}
        return {"attempted": len(after) * self.batch, "failed": bad * self.batch, "diag": diag}

    def fill(self, run) -> None:
        pass

    def close(self) -> None:
        if self.loader is not None:
            self.loader.stop()
        self.loader = self.state = self.step_fn = None

    # -- what the check reads ---------------------------------------------
    def control_batches(self, n: int):
        """The first ``n`` batches a run with this seed trains on."""
        loader = self._loader()
        try:
            return [next(loader) for _ in range(n)]
        finally:
            loader.stop()

    def outputs(self) -> SimpleNamespace:
        c = self.cfg
        hyper = Hyper(lr=c["lr"], momentum=c["momentum"], weight_decay=c["weight_decay"],
                      pos_iou=c["pos_iou"], neg_ratio=c["neg_ratio"],
                      box_weight=c["box_weight"], mask_weight=c["mask_weight"])
        return SimpleNamespace(captured=self.captured, params=self._params,
                               batches=self.control_batches, hyper=hyper,
                               layers=tuple(c["backbone_layers"]), cache={})

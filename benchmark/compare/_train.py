"""What the training cell's two numbers share: the plain reference's step
(``reference/yolact_train.py``) recomputed once per run on each captured
step (the input state and batch the timed path kept), and on the controls'
inputs, cached on the driver's ``outputs()``."""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from ..reference import yolact_train as R

PRECISIONS_BELOW = ("tf32", "bf16")


def _ref(out, state, batch, precision="f32") -> dict:
    b = batch
    return R.step(state.params, state.opt_state, b.images, b.boxes, b.labels, b.masks,
                  out.layers, out.hyper, precision)


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def loss_gap(loss, parts, ref) -> float:
    """The largest relative gap of the loss and its three parts (+inf if
    any is not finite)."""
    pairs = [(loss, ref["loss"])] + [(parts[k], ref["parts"][k]) for k in ref["parts"]]
    return max(_finite(abs(float(g) - float(r)) / abs(float(r))) for g, r in pairs)


def step_gap(params, new_params, ref, lr: float) -> float:
    """Over every tensor, max |p' - p + lr m| over max |lr m|, where p and
    p' are the parameters before and after the step under test and m the
    reference's new momentum (so ``-lr m`` is the reference's update,
    exact in float64), less one f32 spacing of p' per element: storing p'
    in f32 rounds it by up to half of one, which no step can avoid. A step
    that leaves p unchanged, or applies another rate or sign, reads ~1."""
    worst = 0.0
    for k, m in ref["momentum"].items():
        want = -lr * m.double()
        q = new_params[k]
        ulp = (torch.nextafter(q.abs(), torch.full_like(q, math.inf)) - q.abs()).double()
        off = ((q.double() - params[k].double() - want).abs() - ulp).clamp_min(0)
        den = float(want.abs().max())
        gap = float(off.max()) / den if den > 0 else (0.0 if float(off.max()) == 0 else math.inf)
        if not gap <= worst:
            worst = gap
    return _finite(worst)


def update_gap(params, new, ref, lr: float) -> float:
    """The larger of the update's gap and the new momentum's, each over
    every tensor (+inf if not finite): ``step_gap`` of the parameters
    ``new.params`` against ``params``, and max |m - reference m| over max
    |reference m|, the trace the next step starts from."""
    mom = R.update_gap(new.opt_state, ref["momentum"])[0]
    return max(step_gap(params, new.params, ref, lr), _finite(mom))


def readings(out) -> dict:
    """{"loss": ..., "update": ...} of the captured steps against the
    reference (+inf where nothing was captured)."""
    if "readings" not in out.cache:
        loss = upd = -math.inf
        for c in out.captured:
            ref = _ref(out, c["state"], c["batch"])
            loss = max(loss, loss_gap(c["loss"], c["parts"], ref))
            upd = max(upd, update_gap(c["state"].params, c["out"], ref, out.hyper.lr))
            del ref
        out.cache["readings"] = {"loss": loss if out.captured else math.inf,
                                 "update": upd if out.captured else math.inf}
    return out.cache["readings"]


def controls(out) -> dict:
    """Each precision below f32 against the reference in f32, on the
    second batch of the seed's run from the state after the first (the
    momentum set): {precision: {"loss": ..., "update": ...}}."""
    if "controls" not in out.cache:
        b0, b1 = out.batches(2)
        params = out.params()
        zero = {k: torch.zeros_like(v) for k, v in params.items()}
        first = _ref(out, SimpleNamespace(params=params, opt_state=zero), b0)
        state = SimpleNamespace(params=first["params"], opt_state=first["momentum"])
        del first
        ref = _ref(out, state, b1)
        res = {}
        for p in PRECISIONS_BELOW:
            got = _ref(out, state, b1, p)
            new = SimpleNamespace(params=got["params"], opt_state=got["momentum"])
            res[p] = {"loss": loss_gap(got["loss"], got["parts"], ref),
                      "update": update_gap(state.params, new, ref, out.hyper.lr)}
            del got
        out.cache["controls"] = res
    return out.cache["controls"]

"""The comparison that decides ``correct``: what the timed path produced,
against the plain references, each number (``compare/<number>.py``) held
to its limit from ``checks/<cell>.json``. The numbers the RGB-D cells
compare:

* ``net_rel_rms``: stage one's net outputs (loc, conf, coef, proto) of the
  sampled frames against :func:`reference.yolact.forward` in float32 on
  the same frames and weights: the largest, over frames and outputs, of
  the output's root-mean-square gap over the reference's root mean square.
* ``fast_mismatch_share``: the FAST op's responses of the sampled frames
  against :func:`reference.fast.responses` of the same grey frames: pixels
  whose responses differ by more than 1e-3 grey levels, over the pixels
  where either side has a corner, summed over the sampled frames and
  levels.
* ``ate_m``: the largest, over streams, ATE RMSE (Umeyama-aligned,
  :mod:`reference.evaluate`) of every tracked frame of the run against
  the rendered ground truth.

A number with nothing to read (no sampled frame was reached) reads +inf,
which fails its limit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference import evaluate
from .reference import fast as fast_ref
from .reference import yolact as yolact_ref


def net_gap(captured, params, rgb_of, img_size: int, layers, control: str = "") -> float:
    """Largest relative RMS gap of the captured outputs to the float32
    reference (``control``: of the reference in that precision, ``"fp8"``,
    on the same frames instead). ``rgb_of(frames)`` gives the (B, H, W, 3)
    frames a call saw."""
    worst = -math.inf
    for frames, outs in captured:
        rgb = rgb_of(frames)
        ref = yolact_ref.forward(params, rgb, img_size, "f32", layers)
        got = yolact_ref.forward(params, rgb, img_size, control, layers) if control else outs
        for g, r in zip(got, ref):
            g = g.float()
            num = (g - r).reshape(g.shape[0], -1).norm(dim=1)
            den = r.reshape(r.shape[0], -1).norm(dim=1).clamp(min=1e-30)
            worst = max(worst, float((num / den).max()))
        del ref, got
    return worst if worst > -math.inf else math.inf


def fast_share(captured, gray_of, sizes, control: Optional[torch.dtype] = None) -> float:
    """Mismatch share of the captured FAST responses (``control``: of the
    reference computed in that dtype on the same frames instead) against
    the float32 reference. ``gray_of(stream, step)`` gives the (H, W) grey
    frame."""
    bad = either = 0
    L = len(sizes)
    for frames, out in captured:
        for j, (s, k) in enumerate(frames):
            g = gray_of(s, k)
            ref = fast_ref.responses(g, sizes)
            got = (fast_ref.responses(g, sizes, control) if control is not None
                   else out[j * L: (j + 1) * L].float())
            b, e = fast_ref.mismatch(got, ref)
            bad += b
            either += e
    return bad / either if either else math.inf


def ate(est: np.ndarray, gt: np.ndarray) -> float:
    """Largest ATE RMSE over streams; est (n, S, 4, 4), gt (n, 4, 4)."""
    gt_pos = evaluate.positions_from_cw(np.asarray(gt, np.float64))
    worst = 0.0
    for s in range(est.shape[1]):
        e = np.asarray(est[:, s], np.float64)
        if not np.isfinite(e).all():
            return math.inf
        worst = max(worst, evaluate.ate_rmse(evaluate.positions_from_cw(e), gt_pos))
    return worst


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number passes at or under it."""
    out = {}
    for name, limit in limits.items():
        v = values.get(name, math.inf)
        out[name] = {"value": v, "limit": limit, "ok": bool(v <= limit)}
    return out


def report_lines(judged: Dict[str, dict]) -> List[str]:
    return [f"check {n}: {d['value']!r} limit {d['limit']!r} {'ok' if d['ok'] else 'FAILED'}"
            for n, d in judged.items()]

"""What the training cell's span readers share: the program's ``train.*``
spans in the traced window (``utils.profiling.SPANS``), per training step
(the traced images over the configuration's ``batch_size``). A window that holds no
``train.grads`` span (a program without training spans) reads nothing;
one that does, but not the spans read, reads 0."""

from __future__ import annotations

from typing import Iterable, Optional

from benchmark.metrics import _spans


def per_step_ms(run, names: Iterable[str]) -> Optional[float]:
    """The union of the window's spans named in ``names``, in ms per step."""
    t = run.trace
    if t is None or t.frames <= 0:
        return None
    sp = _spans.spans(t, "train.")
    if not any(n == "train.grads" for n, _, _ in sp):
        return None
    names = set(names)
    ns = _spans.union_ns((s, e) for n, s, e in sp if n in names)
    return ns / 1e6 / (t.frames / run.config["batch_size"])

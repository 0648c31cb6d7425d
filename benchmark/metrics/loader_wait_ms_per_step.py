"""loader_wait_ms_per_step (ms): the time the training loop spent blocked
on the loader's queue in the traced window, the span
``train.loader.wait``, per step; 0 where the loader was always ahead."""

from benchmark.metrics import _train


def read(run):
    return _train.per_step_ms(run, ["train.loader.wait"])

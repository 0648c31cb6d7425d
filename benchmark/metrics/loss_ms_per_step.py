"""loss_ms_per_step (ms): the host time of the multibox loss in the traced
window, the span ``train.loss`` (from the net's outputs to the scalar,
with the host read of the positives' count, which waits for the forward
on the card), per step."""

from benchmark.metrics import _train


def read(run):
    return _train.per_step_ms(run, ["train.loss"])

"""train_step_ms (ms): the host time of the train step in the traced
window, the union of the spans ``train.grads`` (forward, loss, backward)
and ``train.sgd`` (the SGD update), per step."""

from benchmark.metrics import _train


def read(run):
    return _train.per_step_ms(run, ["train.grads", "train.sgd"])

"""train_loss_rel: of the sampled training steps, the largest relative gap
of the loss and of its three parts (boxes, classes, masks) that the
timed path produced, against the plain reference's step
(``reference/yolact_train.py``, f32, TF32 off) from the same input state
and batch. Control: the reference in each precision below the
configuration's f32 (TF32 on; bf16 autocast) against it in f32; the
reading is the smaller of the two, so it fails a limit only if both do."""

from benchmark.compare import _train


def value(out) -> float:
    return _train.readings(out)["loss"]


def control(out, frames: int) -> float:
    return min(r["loss"] for r in _train.controls(out).values())

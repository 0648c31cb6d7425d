"""train_update_rel: of the sampled training steps, the larger of two
gaps against the plain reference's step (``reference/yolact_train.py``,
f32, TF32 off) from the same input state and batch: the parameters'
change (over every tensor, max |p' - p + lr m_ref| over max |lr m_ref|,
less one f32 spacing of p' for its rounding), and the new momentum (max
|m - m_ref| over max |m_ref|). Control: as ``train_loss_rel``'s, on the
update."""

from benchmark.compare import _train


def value(out) -> float:
    return _train.readings(out)["update"]


def control(out, frames: int) -> float:
    return min(r["update"] for r in _train.controls(out).values())

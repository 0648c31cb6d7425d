"""ate_m (m): the largest, over streams, Umeyama-aligned ATE RMSE of every
tracked frame against the rendered ground truth. Control: a tracker whose
state never changes (every pose the first; also what a stream left out of
the batch reads) over ``frames`` frames."""

import numpy as np

from benchmark import check


def value(out) -> float:
    return check.ate(out.est, out.gt)


def control(out, frames: int) -> float:
    gt = out.gt_of(np.arange(frames))
    frozen = np.repeat(gt[:1, None], frames, axis=0)
    return check.ate(np.repeat(frozen, out.streams, axis=1), gt)

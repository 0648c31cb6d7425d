"""ate_m.staggered (m): ``ate_m`` where each stream follows its own part
of the path: the largest, over streams, of the Umeyama-aligned ATE RMSE
of the stream's tracked frames against its own ground truth (``out.gt``
(n, S, 4, 4)). Control: a tracker whose state never changes (each
stream's every pose its first) over ``frames`` frames."""

import numpy as np

from benchmark import check


def value(out) -> float:
    est, gt = out.est, out.gt
    return max(check.ate(est[:, s: s + 1], gt[:, s]) for s in range(est.shape[1]))


def control(out, frames: int) -> float:
    gt = out.gt_of(np.arange(frames))
    return max(check.ate(np.repeat(gt[:1, s: s + 1], frames, axis=0), gt[:, s])
               for s in range(gt.shape[1]))

"""The port's COCO-style evaluation (models/eval.py) against the JAX
package's, on the CPU: host numpy in both, so results are exactly equal
(NaN where both give NaN).

One deviation: the JAX package's ``mask_iou`` reshapes with
``reshape(len(a), -1)``, which numpy refuses for an empty set, so its
mask mAP raises whenever a class is predicted in an image whose ground
truth lacks it. The port gives sizes explicitly; there the port is held to
the JAX package's ``evaluate_detections`` run with the port's
``mask_iou`` in place of its own.
"""

import numpy as np
import pytest

from amos_slam_tpu.models import eval as JE
from amos_slam_tpu_torch.models import eval as TE

H, W = 12, 16


def random_boxes(rng, n):
    xy = rng.uniform(0, 0.7, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (n, 2))], -1).astype(np.float32)


def random_set(rng, n_img, n_cls, gt_max, pred_max, jitter=0.03):
    """Ground truths, and predictions made from them (jittered copies, some
    relabelled) plus random false positives."""
    preds, gts = [], []
    for _ in range(n_img):
        g = int(rng.integers(0, gt_max + 1))
        gb = random_boxes(rng, g)
        gc = rng.integers(0, n_cls, g)
        gm = rng.random((g, H, W)) < 0.5
        keep = rng.random(g) < 0.7
        fp = int(rng.integers(0, pred_max + 1))
        pb = np.concatenate([gb[keep] + rng.normal(0, jitter, (int(keep.sum()), 4)),
                             random_boxes(rng, fp)]).astype(np.float32)
        pc = np.concatenate([np.where(rng.random(int(keep.sum())) < 0.8, gc[keep],
                                      rng.integers(0, n_cls, int(keep.sum()))),
                             rng.integers(0, n_cls, fp)])
        pm = np.concatenate([gm[keep] ^ (rng.random((int(keep.sum()), H, W)) < 0.1),
                             rng.random((fp, H, W)) < 0.5])
        preds.append({"boxes": pb, "scores": rng.random(len(pb)).astype(np.float32),
                      "classes": pc, "masks": pm})
        gts.append({"boxes": gb, "classes": gc, "masks": gm})
    return preds, gts


def same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert (np.isnan(a[k]) and np.isnan(b[k])) or a[k] == b[k], (k, a[k], b[k])


CASES = {
    "dense": dict(n_img=6, n_cls=4, gt_max=5, pred_max=4),
    "sparse": dict(n_img=8, n_cls=6, gt_max=2, pred_max=1),
    "one_image": dict(n_img=1, n_cls=2, gt_max=6, pred_max=6),
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("seed", (0, 1))
def test_box_map_equals_jax(case, seed):
    preds, gts = random_set(np.random.default_rng(seed), **CASES[case])
    same(TE.evaluate_detections(preds, gts), JE.evaluate_detections(preds, gts))


@pytest.mark.parametrize("case", CASES)
def test_mask_map_equals_jax(case, monkeypatch):
    preds, gts = random_set(np.random.default_rng(7), **CASES[case])
    port = TE.evaluate_detections(preds, gts, iou_type="mask")
    try:
        ref = JE.evaluate_detections(preds, gts, iou_type="mask")
    except ValueError:
        monkeypatch.setattr(JE, "mask_iou", TE.mask_iou)
        ref = JE.evaluate_detections(preds, gts, iou_type="mask")
    same(port, ref)


def test_empty_classes_and_predictions():
    rng = np.random.default_rng(3)
    preds, gts = random_set(rng, n_img=4, n_cls=3, gt_max=4, pred_max=2)
    empty = {"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros((0,), np.float32),
             "classes": np.zeros((0,), np.int64), "masks": np.zeros((0, H, W), bool)}
    cases = {
        "no_predictions": ([empty] * 4, gts),
        "one_image_without_predictions": ([empty] + preds[1:], gts),
        "class_only_predicted": (preds, [dict(g, classes=np.where(g["classes"] == 2, 1,
                                                                  g["classes"])) for g in gts]),
        "class_never_predicted": ([dict(p, classes=np.where(p["classes"] == 0, 1, p["classes"]))
                                   for p in preds], gts),
        "no_ground_truth": (preds, [{"boxes": np.zeros((0, 4), np.float32),
                                     "classes": np.zeros((0,), np.int64),
                                     "masks": np.zeros((0, H, W), bool)}] * 4),
    }
    for name, (p, g) in cases.items():
        same(TE.evaluate_detections(p, g), JE.evaluate_detections(p, g))
    out = TE.evaluate_detections([empty] * 4, gts)
    assert out["mAP"] == 0.0
    assert np.isnan(TE.evaluate_detections(*cases["no_ground_truth"])["mAP"])


def test_helpers_equal_jax():
    rng = np.random.default_rng(4)
    a, b = random_boxes(rng, 7), random_boxes(rng, 5)
    np.testing.assert_array_equal(TE.box_iou(a, b), JE.box_iou(a, b))
    ma, mb = rng.random((7, H, W)) < 0.5, rng.random((5, H, W)) < 0.5
    np.testing.assert_array_equal(TE.mask_iou(ma, mb), JE.mask_iou(ma, mb))
    assert TE.mask_iou(ma, mb[:0]).shape == (7, 0)
    scores, matched = rng.random(20), rng.random(20) < 0.5
    for n_gt in (0, 5, 20):
        x, y = TE.average_precision(scores, matched, n_gt), JE.average_precision(scores, matched,
                                                                                   n_gt)
        assert (np.isnan(x) and np.isnan(y)) or x == y
    np.testing.assert_array_equal(TE.IOU_THRESHOLDS, JE.IOU_THRESHOLDS)

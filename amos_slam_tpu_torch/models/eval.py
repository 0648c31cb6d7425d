"""Detection/segmentation evaluation: COCO-style mAP (port of
models/eval.py, a copy: the JAX package's module is host numpy already).

Replaces the reference's YOLACT evaluation stack (src/python/eval.py:882 +
run_coco_eval.py: box and mask AP at IoU 0.5:0.95). Host-side numpy -- this
is offline evaluation, not the SLAM loop. Detections from the port's
``detect`` / ``assemble_masks`` are read to the host first
(``tensor.cpu().numpy()``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M)."""
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def mask_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,H,W) x (M,H,W) binary -> (N,M). Either set may be empty: the
    JAX package's ``reshape(len(a), -1)`` raises on an empty set, which
    ``evaluate_detections`` makes whenever a class is predicted in an image
    whose ground truth lacks it; the sizes are explicit here."""
    a = a.reshape(len(a), int(np.prod(a.shape[1:]))).astype(np.float32)
    b = b.reshape(len(b), int(np.prod(b.shape[1:]))).astype(np.float32)
    inter = a @ b.T
    union = a.sum(1)[:, None] + b.sum(1)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def average_precision(
    scores: np.ndarray, matched: np.ndarray, n_gt: int
) -> float:
    """101-point interpolated AP (COCO) from per-detection match flags."""
    if n_gt == 0:
        return float("nan")
    order = np.argsort(-scores)
    tp = matched[order].astype(np.float64)
    fp = 1.0 - tp
    tp_c = np.cumsum(tp)
    fp_c = np.cumsum(fp)
    recall = tp_c / n_gt
    precision = tp_c / np.maximum(tp_c + fp_c, 1e-9)
    # precision envelope + 101-point sampling
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    rs = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, rs, side="left")
    p = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(p.mean())


def evaluate_detections(
    predictions: Sequence[Dict],
    ground_truths: Sequence[Dict],
    iou_type: str = "box",
) -> Dict[str, float]:
    """COCO-style mAP over images.

    predictions[i]: {"boxes" (N,4), "scores" (N,), "classes" (N,),
                     optional "masks" (N,H,W)}
    ground_truths[i]: {"boxes" (G,4), "classes" (G,), optional "masks"}
    Returns {"mAP": .., "AP50": .., "AP75": ..}.
    """
    classes = set()
    for g in ground_truths:
        classes.update(np.asarray(g["classes"]).tolist())

    ap_per_t: Dict[float, List[float]] = {t: [] for t in IOU_THRESHOLDS}
    for cls in sorted(classes):
        for t in IOU_THRESHOLDS:
            scores_all, match_all, n_gt = [], [], 0
            for pred, gt in zip(predictions, ground_truths):
                g_sel = np.asarray(gt["classes"]) == cls
                n_g = int(g_sel.sum())
                n_gt += n_g
                p_sel = np.asarray(pred["classes"]) == cls
                p_scores = np.asarray(pred["scores"])[p_sel]
                if p_sel.sum() == 0:
                    continue
                if iou_type == "mask" and "masks" in pred:
                    iou = mask_iou(
                        np.asarray(pred["masks"])[p_sel],
                        np.asarray(gt["masks"])[g_sel]
                        if n_g
                        else np.zeros((0,) + np.asarray(pred["masks"]).shape[1:]),
                    )
                else:
                    iou = box_iou(
                        np.asarray(pred["boxes"])[p_sel],
                        np.asarray(gt["boxes"])[g_sel]
                        if n_g
                        else np.zeros((0, 4)),
                    )
                order = np.argsort(-p_scores)
                taken = np.zeros(n_g, bool)
                m = np.zeros(len(p_scores), bool)
                for pi in order:
                    if n_g == 0:
                        break
                    j = int(np.argmax(np.where(taken, -1.0, iou[pi])))
                    if iou[pi, j] >= t and not taken[j]:
                        taken[j] = True
                        m[pi] = True
                scores_all.append(p_scores)
                match_all.append(m)
            if n_gt == 0:
                continue
            if scores_all:
                ap = average_precision(
                    np.concatenate(scores_all), np.concatenate(match_all), n_gt
                )
            else:
                ap = 0.0
            ap_per_t[t].append(ap)

    def agg(ts):
        vals = [v for t in ts for v in ap_per_t[t]]
        return float(np.mean(vals)) if vals else float("nan")

    return {
        "mAP": agg(IOU_THRESHOLDS),
        "AP50": agg([IOU_THRESHOLDS[0]]),
        "AP75": agg([IOU_THRESHOLDS[5]]),
    }

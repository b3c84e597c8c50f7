"""Event-level mean average precision for interval detection (a copy of
``audioyolo_tpu/infer/eval_map.py``, which imports no JAX).

Per class, predictions are sorted by confidence and greedily matched to
unmatched ground-truth events of the same class and file when their 1-D
interval IoU is at least the threshold; AP is the area under the
interpolated precision-recall curve; mAP averages over classes (and
optionally IoU thresholds, COCO-style 0.5:0.05:0.95).
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

# A detection: (file_id, class_idx, confidence, start, end)
# A ground truth: (file_id, class_idx, start, end)


def _interval_iou(s1, e1, s2, e2) -> float:
    inter = max(0.0, min(e1, e2) - max(s1, s2))
    union = (e1 - s1) + (e2 - s2) - inter
    return inter / union if union > 0 else 0.0


def event_average_precision(
    detections: Sequence[Tuple],
    ground_truth: Sequence[Tuple],
    class_idx: int,
    iou_threshold: float = 0.5,
) -> float:
    """VOC-style continuous-interpolation AP for one class."""
    gts = [g for g in ground_truth if g[1] == class_idx]
    dets = sorted((d for d in detections if d[1] == class_idx), key=lambda d: -d[2])
    n_gt = len(gts)
    if n_gt == 0:
        return float("nan")

    matched: Dict[int, bool] = {}
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, (fid, _, conf, s, e) in enumerate(dets):
        best_iou, best_j = 0.0, -1
        for j, (gfid, _, gs, ge) in enumerate(gts):
            if gfid != fid or matched.get(j, False):
                continue
            iou = _interval_iou(s, e, gs, ge)
            if iou > best_iou:
                best_iou, best_j = iou, j
        if best_j >= 0 and best_iou >= iou_threshold:
            matched[best_j] = True
            tp[i] = 1
        else:
            fp[i] = 1

    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-12)

    # monotone precision envelope + area under PR
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def event_map(
    detections: Sequence[Tuple],
    ground_truth: Sequence[Tuple],
    num_classes: int,
    iou_thresholds: Iterable[float] = (0.5,),
) -> Dict[str, float]:
    """Returns ``{"mAP@<t>": ..., "mAP": mean-over-thresholds}`` (classes with
    no ground truth are excluded from the mean)."""
    out: Dict[str, float] = {}
    per_thr = []
    for thr in iou_thresholds:
        aps = [
            event_average_precision(detections, ground_truth, c, thr)
            for c in range(num_classes)
        ]
        aps = [a for a in aps if not np.isnan(a)]
        val = float(np.mean(aps)) if aps else float("nan")
        out[f"mAP@{thr:g}"] = val
        per_thr.append(val)
    out["mAP"] = float(np.nanmean(per_thr)) if per_thr else float("nan")
    return out

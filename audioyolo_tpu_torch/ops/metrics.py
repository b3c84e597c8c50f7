"""Classification metrics computed on the device (port of
``audioyolo_tpu/ops/metrics.py``).

Accuracy and macro precision, recall and F1 over masked label vectors, with
fixed-shape reductions so that a train step never waits for the host.
Macro averaging follows sklearn's default label set: the mean runs over the
classes that appear in the targets or the predictions (zero_division=0).
"""

from __future__ import annotations

from typing import Dict

import torch


def masked_classification_metrics(pred_labels: torch.Tensor, true_labels: torch.Tensor,
                                  mask: torch.Tensor, num_classes: int) -> Dict[str, torch.Tensor]:
    """``pred_labels``/``true_labels``: int (N,); ``mask``: bool (N,).

    Returns accuracy and macro precision/recall/f1 as float32 scalars; an
    all-masked input gives NaN for each (the reference's empty-batch branch).
    """
    m = mask.float()
    total = m.sum()
    classes = torch.arange(num_classes, device=pred_labels.device)
    pred_oh = (pred_labels[:, None] == classes[None, :]).float() * m[:, None]
    true_oh = (true_labels[:, None] == classes[None, :]).float() * m[:, None]

    tp = (pred_oh * true_oh).sum(0)
    pred_count = pred_oh.sum(0)
    true_count = true_oh.sum(0)
    fp = pred_count - tp
    fn = true_count - tp

    present = ((pred_count + true_count) > 0).float()
    n_present = torch.clamp_min(present.sum(), 1.0)
    zero = torch.zeros((), device=tp.device)
    precision_c = torch.where(tp + fp > 0, tp / torch.clamp_min(tp + fp, 1e-12), zero)
    recall_c = torch.where(tp + fn > 0, tp / torch.clamp_min(tp + fn, 1e-12), zero)
    f1_c = torch.where(precision_c + recall_c > 0,
                       2.0 * precision_c * recall_c / torch.clamp_min(precision_c + recall_c, 1e-12),
                       zero)

    nan = torch.full((), float("nan"), device=tp.device)
    empty = total == 0
    hits = ((pred_labels == true_labels).float() * m).sum()
    return {
        "accuracy": torch.where(empty, nan, hits / torch.clamp_min(total, 1.0)),
        "precision": torch.where(empty, nan, (precision_c * present).sum() / n_present),
        "recall": torch.where(empty, nan, (recall_c * present).sum() / n_present),
        "f1": torch.where(empty, nan, (f1_c * present).sum() / n_present),
    }

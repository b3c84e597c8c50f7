"""Fixed-capacity 1-D interval NMS (port of ``audioyolo_tpu/ops/nms.py``).

K proposals in, K score-ordered keep flags out; batching across clips is the
leading axis. The greedy suppression itself is kernel 2 on CUDA tensors
(``nms_kernel.greedy_suppress_blocked``): its flags are bit-identical to the
plain version, so the card always takes it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .nms_kernel import greedy_suppress_blocked


def interval_iou_matrix(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of intervals. ``x1, x2``: (..., K). Returns (..., K, K)."""
    inter = torch.clamp_min(
        torch.minimum(x2[..., :, None], x2[..., None, :])
        - torch.maximum(x1[..., :, None], x1[..., None, :]),
        0.0,
    )
    w = torch.clamp_min(x2 - x1, 0.0)
    union = w[..., :, None] + w[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-12)


def batched_interval_nms(
    preds: torch.Tensor,
    iou_threshold: float = 0.1,
    conf_threshold: float = 0.2,
    sample_duration: float = 60.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NMS + confidence filter over combined-scale predictions.

    ``preds``: (B, K, 3+C), layout ``[objectness_logit, class_logits...,
    center_sec, width_sec]``. Returns ``(order, keep, confidence)``:
    ``order`` (B, K) int64 proposal ids by descending confidence (stable);
    ``keep`` (B, K) bool, survives NMS and ``conf > conf_threshold``, aligned
    with ``order``; ``confidence`` (B, K) = sigmoid(obj) * max softmax(cls),
    sorted.
    """
    centers = preds[..., -2]
    widths = preds[..., -1]
    x1 = torch.clamp(centers - widths / 2.0, 0.0, sample_duration)
    x2 = torch.clamp(centers + widths / 2.0, 0.0, sample_duration)

    obj = torch.sigmoid(preds[..., 0])
    cls = torch.softmax(preds[..., 1:-2], dim=-1)
    conf = obj * cls.max(dim=-1).values

    neg_s, order = torch.sort(-conf, dim=-1, stable=True)
    conf_s = -neg_s
    x1_s = torch.gather(x1, -1, order).contiguous()
    x2_s = torch.gather(x2, -1, order).contiguous()

    keep = greedy_suppress_blocked(x1_s, x2_s, iou_threshold)
    keep = keep & (conf_s > conf_threshold)
    return order, keep, conf_s

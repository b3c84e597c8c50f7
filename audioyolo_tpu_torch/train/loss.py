"""Detection loss with its metrics computed on the device (port of
``audioyolo_tpu/train/loss.py``).

Per scale: a CIoU interval loss on the matched (target, cell, anchor) pairs,
an objectness loss (BCE with logits, or focal) against a grid of detached
CIoU values, and a class loss (multi-label BCE with label smoothing, or CE
weighted by class weights); confidence weights 4/2/1 over the scales and the
total ``box_w * lbox + conf_w * lconf + class_w * lcls``.

Kept as the JAX package has them:

- where several pairs set the objectness target of one (clip, cell, anchor),
  the largest CIoU wins (the reference keeps its last write);
- the reference's CIoU alpha term ``v / ((1+e) - iou) + v``, operator
  precedence included, with the denominator clamped at ``e``;
- clips with ``clip_valid`` False (padding of the last batch) take part in no
  term and no metric.

Every shape is fixed, so a step never waits for the host. A branch that
``torch.where`` does not select still back-propagates, so every division
has a denominator clamped away from 0 and every NaN is a constant: the
gradients stay finite on a batch with no valid targets or with only
ignore-index targets. The metrics are computed on detached values.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.metrics import masked_classification_metrics
from .assign import assign_targets_to_scale

METRIC_KEYS = (
    "aggregate_loss", "mean_ciou", "conf_loss", "avg_pos_conf", "avg_neg_conf",
    "class_loss", "accuracy", "f1", "precision", "recall",
)
IGNORE_INDEX = -100


def _clip0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0.0)``: a maximum, whose gradient splits evenly at a tie."""
    return torch.maximum(x, x.new_zeros(()))


def compute_ciou(pred_cw: torch.Tensor, target_cw: torch.Tensor, e: float = 1e-8,
                 h: float = 10.0) -> torch.Tensor:
    """CIoU between (center, width) intervals lifted to height-``h`` boxes,
    clipped at 0. Broadcasts over leading axes; the last axis is (center,
    width). The alpha term carries no gradient."""
    pc, pw = pred_cw[..., 0], pred_cw[..., 1]
    tc, tw = target_cw[..., 0], target_cw[..., 1]
    px1, px2 = pc - pw / 2.0, pc + pw / 2.0
    tx1, tx2 = tc - tw / 2.0, tc + tw / 2.0

    inter = _clip0(torch.minimum(px2, tx2) - torch.maximum(px1, tx1)) * h
    union = pw * h + tw * h - inter
    iou = inter / (union + e)

    enc_w = torch.maximum(px2, tx2) - torch.minimum(px1, tx1)
    c2 = enc_w ** 2 + h ** 2 + e
    v = (4.0 / math.pi ** 2) * (torch.atan(tw / h) - torch.atan(pw / h)) ** 2
    rho2 = (pc - tc) ** 2
    # in float32 a perfect overlap rounds iou to 1, so (1+e)-iou is 0 and the
    # reference's formula 0/0; the denominator is clamped at e
    a = (v / torch.clamp_min((1.0 + e) - iou, e) + v).detach()
    return _clip0(iou - (rho2 / c2 + a * v))


def bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, the stable form."""
    return _clip0(logits) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def focal_loss_with_logits(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                           gamma: float = 1.5) -> torch.Tensor:
    """Elementwise focal BCE: ``alpha * (1 - exp(-bce))**gamma * bce``."""
    bce = bce_logits(logits, targets)
    return alpha * (1.0 - torch.exp(-bce)) ** gamma * bce


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, empty_value: float = 0.0) -> torch.Tensor:
    m = mask.to(x.dtype)
    n = m.sum()
    return torch.where(n > 0, (x * m).sum() / torch.clamp_min(n, 1.0),
                       x.new_full((), empty_value))


class AudioDetectionLoss:
    """``loss(preds, targets) -> (scalar, metrics dict)``.

    ``preds``: (sm, md, lg) decoded predictions, each (B, G, A, 3+C) with
    layout [objectness logit, class logits..., center_sec, width_sec].
    ``targets``: ``classes`` (B, N) int, ``centers``/``widths`` (B, N)
    float32, ``valid`` (B, N) bool and optionally ``clip_valid`` (B,) bool,
    on the predictions' device.
    """

    def __init__(self, anchors_dict: Dict[str, Sequence[float]], num_classes: int,
                 anchor_t: float = 4.0, edge_t: float = 0.5, sample_duration: float = 60.0,
                 box_w: float = 1.0, conf_w: float = 1.0, class_w: float = 1.0,
                 multi_label: bool = False, class_weights: Optional[np.ndarray] = None,
                 label_smoothing: float = 0.0, batch_scale_loss: bool = False,
                 alpha: Optional[float] = None, gamma: Optional[float] = None,
                 ignore_index: int = IGNORE_INDEX):
        self.anchors = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in anchors_dict.items()}
        self.num_classes = int(num_classes)
        self.anchor_t = float(anchor_t)
        self.edge_t = float(edge_t)
        self.sample_duration = float(sample_duration)
        self.box_w, self.conf_w, self.class_w = float(box_w), float(conf_w), float(class_w)
        self.multi_label = bool(multi_label)
        self.class_weights = (None if class_weights is None
                              else torch.tensor(np.asarray(class_weights, np.float32)))
        self.label_smoothing = float(label_smoothing)
        self.batch_scale_loss = bool(batch_scale_loss)
        self.focal = alpha is not None and gamma is not None
        self.alpha, self.gamma = alpha, gamma
        self.ignore_index = int(ignore_index)
        self._consts: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    def _const(self, name: str, device: torch.device) -> torch.Tensor:
        """An anchor vector or the class weights on ``device``, copied once:
        a copy from pageable host memory each step would wait for the card."""
        key = (name, device)
        if key not in self._consts:
            src = self.class_weights if name == "class_weights" else self.anchors[name]
            self._consts[key] = src.to(device)
        return self._consts[key]

    def _conf_loss(self, logits, targets, mask):
        if self.focal:
            elem = focal_loss_with_logits(logits, targets, self.alpha, self.gamma)
        else:
            elem = bce_logits(logits, targets)
        return _masked_mean(elem, mask)

    def scale_loss(self, preds: torch.Tensor, targets: Dict[str, torch.Tensor],
                   anchors: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...], Dict[str, torch.Tensor]]:
        b, g, a, _ = preds.shape
        dev = preds.device
        classes, centers, widths = targets["classes"], targets["centers"], targets["widths"]
        clip_valid = targets.get("clip_valid")
        if clip_valid is None:
            clip_valid = torch.ones((b,), dtype=torch.bool, device=dev)
        valid = targets["valid"] & clip_valid[:, None]

        asn = assign_targets_to_scale(classes, centers, widths, valid, g, anchors,
                                      self.anchor_t, self.edge_t, self.sample_duration)
        cell, pv = asn["cell"], asn["pair_valid"]  # (B, N, A, 3)
        bb = torch.arange(b, device=dev)[:, None, None, None]
        aa = torch.arange(a, device=dev)[None, None, :, None]
        match = preds[bb, cell, aa]  # (B, N, A, 3, 3+C)

        p_cw = match[..., -2:]
        t_cw = torch.stack([centers, widths], dim=-1)[:, :, None, None, :]
        ciou = compute_ciou(p_cw, t_cw.expand_as(p_cw))  # (B, N, A, 3)
        n_pairs = pv.float().sum()
        ciou_loss = _masked_mean(1.0 - ciou, pv)

        # objectness target: detached CIoU at matched cells (the largest where
        # pairs collide), 0 elsewhere; every value is >= 0, so an amax over a
        # zero grid is the JAX package's ``.at[...].max``
        ciou_d = ciou.detach()
        flat = ((bb * g + cell) * a + aa).reshape(-1)
        t_conf = preds.new_zeros(b * g * a).scatter_reduce(
            0, flat, torch.where(pv, ciou_d, 0.0).reshape(-1), reduce="amax", include_self=True).view(b, g, a)
        p_conf = preds[..., 0]
        clip_grid = clip_valid[:, None, None].expand(b, g, a)
        conf_loss = self._conf_loss(p_conf, t_conf, clip_grid)

        # class loss over pairs whose target is not the ignore index
        cls_pv = pv & (classes[:, :, None, None] != self.ignore_index)
        p_cls = match[..., 1: 1 + self.num_classes]
        t_cls = torch.clamp_min(classes, 0).long()[:, :, None, None]  # a safe index
        n_cls = cls_pv.float().sum()
        nan = preds.new_full((), float("nan"))
        if self.multi_label:
            cn = 0.5 * self.label_smoothing
            onehot = torch.arange(self.num_classes, device=dev) == t_cls[..., None]
            t_probs = torch.where(onehot, 1.0 - cn, cn)
            bce = bce_logits(p_cls, t_probs)
            class_loss = torch.where(
                n_cls > 0,
                (bce * cls_pv[..., None]).sum() / torch.clamp_min(n_cls * self.num_classes, 1.0),
                nan)
        else:
            logp = F.log_softmax(p_cls, dim=-1)
            nll = -torch.gather(logp, -1, t_cls[..., None].expand(*p_cls.shape[:-1], 1))[..., 0]
            if self.class_weights is None:
                w = torch.ones_like(nll)
            else:
                # CrossEntropyLoss(weight=...) divides by the selected targets' weights
                cw = self._const("class_weights", dev)
                w = cw[torch.clamp_min(classes, 0).long()][:, :, None, None].expand_as(nll)
            wm = w * cls_pv.to(nll.dtype)
            class_loss = torch.where(n_cls > 0, (nll * wm).sum() / torch.clamp_min(wm.sum(), 1e-12),
                                     nan)

        with torch.no_grad():
            pos_conf = torch.sigmoid(match[..., 0].detach())
            cls_metrics = masked_classification_metrics(
                p_cls.detach().argmax(-1).reshape(-1), t_cls.expand(cls_pv.shape).reshape(-1),
                cls_pv.reshape(-1), self.num_classes)
            metrics = {
                "mean_ciou": _masked_mean(ciou_d, pv, float("nan")),
                "conf_loss": conf_loss.detach(),
                "avg_pos_conf": _masked_mean(pos_conf, pv, float("nan")),
                "avg_neg_conf": _masked_mean(torch.sigmoid(p_conf.detach()),
                                             (t_conf == 0) & clip_grid, float("nan")),
                "class_loss": class_loss.detach(),
                **cls_metrics,
            }
        zero = preds.new_zeros(())
        losses = (
            torch.where(n_pairs > 0, ciou_loss, zero),
            torch.where(torch.isnan(conf_loss), zero, conf_loss),
            torch.where(torch.isnan(class_loss), zero, class_loss),
        )
        return losses, metrics

    def __call__(self, preds: Sequence[torch.Tensor],
                 targets: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        sm, md, lg = preds
        dev = sm.device
        parts: List[Tuple[Tuple[torch.Tensor, ...], Dict[str, torch.Tensor]]] = [
            self.scale_loss(p, targets, self._const(k, dev))
            for p, k in ((sm, "sm"), (md, "md"), (lg, "lg"))]
        (sb, sc, sl), (mb, mc, ml), (lb, lc, ll) = (p[0] for p in parts)
        lbox = sb + mb + lb
        lconf = sc * 4.0 + mc * 2.0 + lc * 1.0
        lcls = sl + ml + ll
        batch_scale = float(sm.shape[0]) if self.batch_scale_loss else 1.0
        loss = (self.box_w * lbox + self.conf_w * lconf + self.class_w * lcls) * batch_scale

        metrics = {"aggregate_loss": loss.detach()}
        for key in METRIC_KEYS[1:]:
            # pandas-style NaN-skipping mean over the three scales
            metrics[key] = torch.nanmean(torch.stack([p[1][key] for p in parts]))
        return loss, metrics

    @staticmethod
    def metrics_vector(metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The (10,) device vector in ``METRIC_KEYS`` order."""
        return torch.stack([metrics[k] for k in METRIC_KEYS])

"""FLOPs of the plain reference model, counted from the configuration's
shapes: ``torch.utils.flop_counter`` over the reference on the ``meta``
device (convolutions, matrix products; elementwise work is not counted)."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.detector import Detector, checkpoint_shapes


def forward_flops_per_window(cfg: dict, num_classes: int) -> int:
    """FLOPs of one 60 s window through frontend, backbone, neck and decode."""
    sd = {k: torch.empty(s, device="meta") for k, s in checkpoint_shapes(cfg, num_classes).items()}
    det = Detector(cfg, sd, "meta")
    wave = torch.empty(1, int(round(float(cfg["sample_duration"]) * int(cfg["sample_rate"]))),
                       device="meta")
    with FlopCounterMode(display=False) as counter:
        det(wave)
    return int(counter.get_total_flops())


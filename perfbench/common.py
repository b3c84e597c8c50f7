"""Set-up and checks shared by the inference drivers: seeded weights
written as a train-form checkpoint, the class map, and the reference's
rows over windows of the WAV files both sides read."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import weights
from .reference import detections as D
from .reference.detector import Detector
from .reference.frontend import float32_posture
from .traffic import files

CLASSES = {0: "alarm", 1: "music"}  # the shipped task's map: class names in sorted order


def checkpoint(ctx) -> Tuple[Dict[str, torch.Tensor], str, str]:
    """(state dict on the device, its ``.pt`` path, the class map's path).
    The weights are the configuration's (its ``weights_seed``), whatever the
    run seed: every run of a cell serves one checkpoint."""
    sd = weights.make(ctx.cfg, len(CLASSES), int(ctx.config["weights_seed"]), ctx.device)
    path = os.path.join(ctx.tmp, "weights.pt")
    torch.save(sd, path)
    cmap = os.path.join(ctx.tmp, "class_map.json")
    with open(cmap, "w") as f:
        json.dump({str(k): v for k, v in CLASSES.items()}, f)
    return sd, path, cmap


class Clock:
    """Set-up time by part, printed on standard error."""

    def __init__(self):
        self.t = time.perf_counter()
        self.parts: List[Tuple[str, float]] = []

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append((name, now - self.t))
        self.t = now

    def report(self, what: str, setup_s: float) -> None:
        body = " ".join(f"{n}={s:.3f}" for n, s in self.parts)
        print(f"perfbench: {what} setup_s={setup_s:.3f} {body}", file=sys.stderr)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


class Reference:
    """The plain detector on the seed's weights, run over windows
    ``(path, first sample)`` of the WAV files, in blocks: in float32, and
    with its body's products in bf16 (the yardstick, ``Detector``)."""

    def __init__(self, ctx, sd: Dict[str, torch.Tensor], block: int = 32):
        float32_posture()
        self.cfg = ctx.cfg
        self.det = Detector(ctx.cfg, sd, ctx.device)
        self.yard = Detector(ctx.cfg, sd, ctx.device, body_bf16=True)
        self.device = ctx.device
        self.block = block
        self.window = int(round(float(ctx.cfg["sample_duration"]) * int(ctx.cfg["sample_rate"])))
        self.duration = float(ctx.cfg["sample_duration"])

    def preds(self, windows: Sequence[Tuple[str, int]]):
        """(float32 predictions, yardstick predictions), (N, K, 3 + C) each."""
        out, yard = [], []
        for i in range(0, len(windows), self.block):
            chunk = windows[i: i + self.block]
            x = np.stack([files.read_pcm16(p, s, self.window) for p, s in chunk])
            wave = torch.from_numpy(x).to(self.device).float() / 32768.0
            out.append(self.det(wave).cpu())
            yard.append(self.yard(wave).cpu())
        if not out:
            return torch.zeros(0), torch.zeros(0)
        return torch.cat(out), torch.cat(yard)

    def compare(self, program, windows, iou: float, conf: float, keep: int,
                witness: bool = False) -> Dict[str, float]:
        """The program's rows of ``windows`` against the reference, beside
        the yardstick's rows (``D.compare_windows``)."""
        preds, yard = self.preds(windows)
        ref_rows = D.window_rows(preds, iou, conf, keep, self.duration)
        return D.compare_windows(program, preds, ref_rows, iou, conf, self.duration, yard=yard,
                                 witness=witness)


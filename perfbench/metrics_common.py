"""Arithmetic the per-layer metric readers share. Each reader is
``read(trace, facts) -> float | None``: ``trace`` is the reduced profile
(``trace.reduce``), ``facts`` what the driver counted; None leaves the
metric out of the line."""

from __future__ import annotations

from typing import Dict, Optional

from .count import peaks


def idle_pct(trace: Dict, facts: Dict) -> Optional[float]:
    if trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def mfu_pct(trace: Dict, facts: Dict) -> Optional[float]:
    if not facts.get("flops") or trace["window_s"] <= 0:
        return None
    return 100.0 * facts["flops"] / (trace["window_s"] * peaks.BF16_FLOPS)


def kernel1_roofline_pct(trace: Dict, facts: Dict) -> Optional[float]:
    names = facts.get("kernel1")
    if not names:
        return None
    total, launches = 0.0, 0
    for name, (seconds, count) in trace["kernels"].items():
        if any(n in name for n in names):
            total += seconds
            if names[-1] in name:
                launches += count
    if launches == 0 or total <= 0:
        return None
    return 100.0 * facts["mel_bound_s"] / (total / launches)

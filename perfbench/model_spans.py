"""Arithmetic of the per-layer metrics that read the card's time inside the
program's model spans (``ayt.model.*``, ``audioyolo_tpu_torch/models/``):
each span's device twin, whose busy time the reduced trace holds under
``device_spans`` ({span: [busy seconds inside its twins, twins]},
``trace.reduce``). Readers are ``read(trace, facts)`` as in
``metrics_common``; each gives None where the span was not recorded, as in
a program that has no model spans. A batch is one ``ayt.stream.drain``.

The profiler gives each launch to the innermost span around it: the twin
of ``ayt.model.backbone`` holds only what the backbone launches outside the
spans nested in it (a ConvNeXt backbone's ``ayt.model.stage1`` ..
``stage4``), so the backbone's busy time is that of its own twins and of
its stages' together."""

from __future__ import annotations

from typing import Dict, Optional

from .program_spans import DRAIN, program_totals

BACKBONE = "ayt.model.backbone"
NESTED = {BACKBONE: tuple(f"ayt.model.stage{s}" for s in range(1, 5))}


def busy_s(name: str, trace: Dict) -> Optional[float]:
    """The card's busy seconds inside the span's twins and those of the
    spans nested in it, or None where the span left no twin."""
    spans = trace.get("device_spans", {})
    got = spans.get(name)
    if got is None or got[1] == 0:
        return None
    return got[0] + sum(spans[n][0] for n in NESTED.get(name, ()) if n in spans)


def backbone_ms(trace: Dict, facts: Dict) -> Optional[float]:
    """The card's busy milliseconds inside the backbone's span per batch."""
    busy, batches = busy_s(BACKBONE, trace), program_totals().get(DRAIN, {}).get("count", 0)
    if busy is None or batches == 0:
        return None
    return 1e3 * busy / batches


def backbone_busy_pct(trace: Dict, facts: Dict) -> Optional[float]:
    """The backbone's share of the card's busy time in the slice."""
    busy = busy_s(BACKBONE, trace)
    if busy is None or trace["busy_s"] <= 0:
        return None
    return 100.0 * busy / trace["busy_s"]

"""Arithmetic of the per-layer metrics that read the program's own spans
(``audioyolo_tpu_torch/utils/trace.py``): the streaming path's stages,
recorded only while the traced run's profiler records, so their aggregate
holds the slice and nothing else. Readers are ``read(trace, facts)`` as in
``metrics_common``; each gives None when its span was not recorded, as in
a program that has no spans. A batch is one ``ayt.stream.drain``: it runs
once per device batch."""

from __future__ import annotations

import importlib.util
from typing import Dict, Optional

DRAIN = "ayt.stream.drain"
MODULE = "audioyolo_tpu_torch.utils.trace"


def program_totals() -> Dict[str, Dict[str, float]]:
    """The program's span aggregate, or nothing where the program has no
    span module."""
    if importlib.util.find_spec(MODULE) is None:
        return {}
    return importlib.import_module(MODULE).totals()


def pct_of_window(name: str, trace: Dict) -> Optional[float]:
    """The span's total time over the slice's."""
    got = program_totals().get(name)
    if got is None or trace["window_s"] <= 0:
        return None
    return 100.0 * got["total_s"] / trace["window_s"]


def ms_per_batch(name: str, key: str = "total_s") -> Optional[float]:
    """The span's total (or self) time over the slice's device batches."""
    spans = program_totals()
    got, batches = spans.get(name), spans.get(DRAIN, {}).get("count", 0)
    if got is None or batches == 0:
        return None
    return 1e3 * got[key] / batches


def input_wait_pct(trace: Dict, facts: Dict) -> Optional[float]:
    return pct_of_window("ayt.stream.wait_input", trace)


def device_wait_pct(trace: Dict, facts: Dict) -> Optional[float]:
    return pct_of_window("ayt.stream.wait_device", trace)


def read_ms(trace: Dict, facts: Dict) -> Optional[float]:
    return ms_per_batch("ayt.stream.read")


def stack_ms(trace: Dict, facts: Dict) -> Optional[float]:
    return ms_per_batch("ayt.stream.stack")


def pin_ms(trace: Dict, facts: Dict) -> Optional[float]:
    return ms_per_batch("ayt.stream.pin")


def drain_ms(trace: Dict, facts: Dict) -> Optional[float]:
    return ms_per_batch(DRAIN, "self_s")

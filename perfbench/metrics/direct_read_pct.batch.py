"""Share of the traced slice's device batches that the producer read
straight into their host tensor (``ayt.stream.read_direct``, once per such
batch) over all of them (``ayt.stream.drain``, once per batch). None where
the program records no direct read, as a program without that path."""

from typing import Dict, Optional

from perfbench.program_spans import DRAIN, program_totals


def read(trace: Dict, facts: Dict) -> Optional[float]:
    spans = program_totals()
    direct, batches = spans.get("ayt.stream.read_direct"), spans.get(DRAIN, {}).get("count", 0)
    if direct is None or batches == 0:
        return None
    return 100.0 * direct["count"] / batches

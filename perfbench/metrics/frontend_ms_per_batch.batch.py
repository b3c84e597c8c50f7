"""Milliseconds of the card's busy time inside the frontend's span
(``ayt.model.frontend``'s device twins: kernel 1's staging and main
passes, the resampling launches of a program whose staging does not
resample, the dB and standardisation passes) per device batch. None where
the program has no such span."""

from typing import Dict, Optional

from perfbench import program_spans
from perfbench.model_spans import busy_s

FRONTEND = "ayt.model.frontend"


def read(trace: Dict, facts: Dict) -> Optional[float]:
    busy = busy_s(FRONTEND, trace)
    batches = program_spans.program_totals().get(program_spans.DRAIN, {}).get("count", 0)
    if busy is None or batches == 0:
        return None
    return 1e3 * busy / batches

"""Share of kernel 1's runs in the traced slice whose staging pass
resampled the waveform: launches of ``stage_frames_kernel_resample`` over
launches of ``mel_power_kernel``, by kernel name. None where the program
launched no such kernel, as a program whose staging does not resample."""

from typing import Dict, Optional

RESAMPLE = "stage_frames_kernel_resample"
MAIN = "mel_power_kernel"


def launches(trace: Dict, name: str) -> int:
    return sum(n for kernel, (_, n) in trace["kernels"].items() if name in kernel)


def read(trace: Dict, facts: Dict) -> Optional[float]:
    staged, runs = launches(trace, RESAMPLE), launches(trace, MAIN)
    if staged == 0 or runs == 0:
        return None
    return 100.0 * staged / runs

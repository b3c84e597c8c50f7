"""Representative synthetic event audio for int8 calibration and the bench
(the port's copy of ``audioyolo_tpu/utils/synth_audio.py``; numpy only).

The int8 body calibrates per-conv activation absmax scales
(``models/quant.py``); calibrating on pure ``standard_normal`` noise misses
the dynamic range that event audio drives through the frontend (tonal
events sit ~20 dB above the noise floor in the demo domain). These clips
mirror the demo-dataset generator (``tools/make_synth_dataset.py``:
chord/tone events of 2.5-50 s over a -40 dB noise floor) without a dataset
on disk, so ``bench_cli`` stays self-contained.

The RNG call sequence is the JAX package's, call for call, so one seed gives
the same clips bit for bit in both packages.
"""

from __future__ import annotations

import numpy as np

_CLASS_SYNTH = {
    "music": lambda t: 0.25 * (
        np.sin(2 * np.pi * 220.0 * t) + 0.6 * np.sin(2 * np.pi * 277.2 * t)
        + 0.4 * np.sin(2 * np.pi * 329.6 * t)
    ),
    "alarm": lambda t: 0.35 * (
        np.sin(2 * np.pi * 1760.0 * t) + 0.5 * np.sin(2 * np.pi * 2217.5 * t)
    ),
}


def synth_event_clips(
    n: int, sample_rate: int, duration: float, seed: int = 7
) -> np.ndarray:
    """``(n, 1, duration*sample_rate)`` float32 clips with 1-5 tonal events
    each over a noise floor: the demo task's signal statistics."""
    rng = np.random.default_rng(seed)
    total = int(round(duration * sample_rate))
    t = np.arange(total) / sample_rate
    out = np.empty((n, 1, total), np.float32)
    classes = list(_CLASS_SYNTH)
    for i in range(n):
        x = (0.01 * rng.standard_normal(total)).astype(np.float32)
        cursor = float(rng.uniform(0.5, 3.0))
        for _ in range(int(rng.integers(1, 6))):
            width = float(rng.uniform(2.5, min(50.0, duration)))
            start, end = cursor, min(cursor + width, duration - 0.3)
            if end - start < 2.5:
                break
            cls = classes[int(rng.integers(0, len(classes)))]
            mask = (t >= start) & (t < end)
            x[mask] += _CLASS_SYNTH[cls](t[mask]).astype(np.float32)
            cursor = end + float(rng.uniform(0.5, 2.0))
            if cursor > duration - 3.0:
                break
        out[i, 0] = x
    return out

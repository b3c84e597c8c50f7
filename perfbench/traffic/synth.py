"""Synthetic event audio.

:func:`synth_event_clips` is a frozen copy of the measured package's
``utils/synth_audio.py::synth_event_clips`` (itself the JAX package's, call
for call): chord and tone events of 2.5-50 s over a -40 dB noise floor, the
demo task's signal statistics. :func:`event_layout` and :func:`render` make
the same kind of audio in bulk: the events are drawn on the host from the
seed, the noise floor and the tones are computed on the device from a
seeded ``torch.Generator``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

CLASSES = ("music", "alarm")
_CLASS_SYNTH = {
    "music": lambda t: 0.25 * (
        np.sin(2 * np.pi * 220.0 * t) + 0.6 * np.sin(2 * np.pi * 277.2 * t)
        + 0.4 * np.sin(2 * np.pi * 329.6 * t)
    ),
    "alarm": lambda t: 0.35 * (
        np.sin(2 * np.pi * 1760.0 * t) + 0.5 * np.sin(2 * np.pi * 2217.5 * t)
    ),
}
_TONES = {"music": ((0.25, 220.0), (0.15, 277.2), (0.1, 329.6)),
          "alarm": ((0.35, 1760.0), (0.175, 2217.5))}


def synth_event_clips(n: int, sample_rate: int, duration: float, seed: int = 7) -> np.ndarray:
    """``(n, 1, duration*sample_rate)`` float32 clips with 1-5 tonal events
    each over a noise floor."""
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


Event = Tuple[float, float, str]


def event_layout(rng: np.random.Generator, duration: float) -> List[Event]:
    """The events ``(start s, end s, class)`` of one ``duration``-second
    segment, drawn as :func:`synth_event_clips` draws them."""
    events: List[Event] = []
    cursor = float(rng.uniform(0.5, 3.0))
    for _ in range(int(rng.integers(1, 6))):
        width = float(rng.uniform(2.5, min(50.0, duration)))
        start, end = cursor, min(cursor + width, duration - 0.3)
        if end - start < 2.5:
            break
        events.append((start, end, CLASSES[int(rng.integers(0, len(CLASSES)))]))
        cursor = end + float(rng.uniform(0.5, 2.0))
        if cursor > duration - 3.0:
            break
    return events


def render(n_samples: int, events: List[Event], sample_rate: int,
           gen: torch.Generator, device) -> torch.Tensor:
    """(n_samples,) float32 audio on ``device``: 0.01 x N(0, 1) noise from
    ``gen`` plus each event's tones over [start, end) (times in seconds from
    the start of the signal)."""
    x = 0.01 * torch.randn(n_samples, generator=gen, device=device)
    for start, end, cls in events:
        i0 = max(int(np.ceil(start * sample_rate)), 0)
        i1 = min(int(np.ceil(end * sample_rate)), n_samples)
        if i1 <= i0:
            continue
        t = torch.arange(i0, i1, device=device, dtype=torch.float64) / sample_rate
        tone = sum(a * torch.sin(2 * np.pi * f * t) for a, f in _TONES[cls])
        x[i0:i1] += tone.float()
    return x

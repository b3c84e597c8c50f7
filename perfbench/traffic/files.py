"""Directories of PCM16 mono WAV files drawn from the seed.

A traffic mix names its files by groups of a count and a length, fixed or
log-uniform between two bounds. The lengths are drawn once from the mix's
own ``length_seed``, so every run seed measures the same sizes; the run seed
orders the files and draws their audio. Every 60 s of a file is laid out by
:func:`synth.event_layout` and rendered on the device; the whole set is
quantised to int16 there and written with a plain RIFF header.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch

from . import synth


def lengths(spec: Dict, seed: int, rate: int) -> List[int]:
    """Sample counts of the files a ``spec`` asks for, in the order the run
    ``seed`` gives them: each group ``{"count", "seconds"}`` (fixed) or
    ``{"count", "log_uniform_s": [lo, hi]}``, drawn from ``length_seed``
    and rounded to whole samples."""
    rng = np.random.default_rng(int(spec["length_seed"]))
    out: List[int] = []
    for group in spec["groups"]:
        for _ in range(int(group["count"])):
            if "seconds" in group:
                sec = float(group["seconds"])
            else:
                lo, hi = (float(v) for v in group["log_uniform_s"])
                sec = math.exp(rng.uniform(math.log(lo), math.log(hi)))
            out.append(int(round(sec * rate)))
    order = np.random.default_rng([int(seed), 3]).permutation(len(out))
    return [out[i] for i in order]


def wav_header(n_samples: int, rate: int) -> bytes:
    data = n_samples * 2
    return b"".join([
        b"RIFF", (36 + data).to_bytes(4, "little"), b"WAVE",
        b"fmt ", (16).to_bytes(4, "little"), (1).to_bytes(2, "little"),
        (1).to_bytes(2, "little"), rate.to_bytes(4, "little"),
        (rate * 2).to_bytes(4, "little"), (2).to_bytes(2, "little"),
        (16).to_bytes(2, "little"), b"data", data.to_bytes(4, "little")])


def read_pcm16(path: str, start: int, count: int) -> np.ndarray:
    """``count`` int16 samples of a file this module wrote, from ``start``,
    zero-padded past its end."""
    data = np.memmap(path, dtype=np.int16, mode="r", offset=44)
    out = np.zeros(count, np.int16)
    piece = data[start: start + count]
    out[: piece.size] = piece
    return out


def audio(lengths_: List[int], seed: int, rate: int, device, window_s: float = 60.0):
    """int16 host arrays, one per file, of event audio drawn from ``seed``."""
    rng = np.random.default_rng([int(seed), 1])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 17)
    seg = int(round(window_s * rate))
    out = []
    for n in lengths_:
        events = []
        for k in range(-(-n // seg)):
            events += [(s + k * window_s, e + k * window_s, c)
                       for s, e, c in synth.event_layout(rng, window_s)]
        x = synth.render(n, events, rate, gen, device)
        out.append(torch.clamp(torch.round(x * 32768.0), -32768, 32767)
                   .to(torch.int16).cpu().numpy())
    return out


def write_dir(directory: str, clips: List[np.ndarray], rate: int) -> List[str]:
    """Write ``clips`` as ``file_000.wav`` .. under ``directory``."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, clip in enumerate(clips):
        path = os.path.join(directory, f"file_{i:03d}.wav")
        with open(path, "wb") as f:
            f.write(wav_header(clip.size, rate))
            f.write(clip.astype("<i2").tobytes())
        paths.append(path)
    return paths

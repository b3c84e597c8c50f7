"""Kernel 1's least work: the DFT of every frame, its power and the mel
product, from the call's shapes. Operations: 2*M*F*2N' for the real DFT
(N' = n_fft/2 + 1 bins, real and imaginary parts), 3*M*N' for the power,
2*M*N'*n_mels for the mel product, M = frames in the batch. Bytes: every
input frame read once in the type it arrives in, the mel output written once
in float32, and the bf16 constants read once."""

from __future__ import annotations

from typing import Dict

from . import peaks


def bound(frames: int, frame_len: int, n_freq: int, n_mels: int, in_bytes: int,
          phases: int = 1) -> Dict[str, float]:
    flops = 2.0 * frames * frame_len * 2 * n_freq + 3.0 * frames * n_freq \
        + 2.0 * frames * n_freq * n_mels
    nbytes = (frames * frame_len * in_bytes + frames * n_mels * 4
              + phases * frame_len * 2 * n_freq * 2 + n_freq * n_mels * 2)
    t_ops, t_mem = flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes, "seconds": max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes"}

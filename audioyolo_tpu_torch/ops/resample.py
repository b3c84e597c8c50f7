"""Band-limited sinc resampling (port of ``audioyolo_tpu/ops/resample.py``).

The polyphase windowed-sinc filter bank is built in float64 numpy exactly as
the JAX package builds it (torchaudio ``sinc_interp_hann`` numerics,
lowpass_filter_width 6, rolloff 0.99). The resample itself is the two-band
GEMM: the signal viewed as ``q``-sample rows, each row times the ``(q, p)``
main band plus the first ``2*width`` samples of the next row times the
``(2*width, p)`` overlap band. Both products are plain float32
``torch.matmul`` (TF32 off, ``device.set_fp32_posture``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def sinc_resample_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
    dtype=np.float32,
) -> Tuple[np.ndarray, int]:
    """Polyphase windowed-sinc filter bank ``(P, 2*width + Q)`` and ``width``,
    with ``P = new/g`` output phases and ``Q = orig/g`` the input stride."""
    if orig_freq <= 0 or new_freq <= 0:
        raise ValueError("sample rates must be positive")
    g = math.gcd(int(orig_freq), int(new_freq))
    q = int(orig_freq) // g
    p = int(new_freq) // g

    base_freq = min(q, p) * rolloff
    width = int(math.ceil(lowpass_filter_width * q / base_freq))

    idx = np.arange(-width, width + q, dtype=np.float64) / q
    phase_t = -np.arange(p, dtype=np.float64)[:, None] / p + idx[None, :]
    t = phase_t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * (base_freq / q)
    return kernel.astype(dtype), width


def polyphase_taps(kernel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The bank's nonzero taps: ``(P, T)`` float32, each phase's taps from its
    first nonzero entry to its last, zero-padded to a common ``T``, and
    ``(P,)`` int32, the column of each phase's first nonzero entry. The
    entries left out are exact float32 zeros (the clipped sinc underflows),
    so a sum over the taps equals the sum over the bank's row."""
    k = np.asarray(kernel, np.float32)
    nz = k != 0
    first = nz.argmax(axis=1)
    last = k.shape[1] - 1 - nz[:, ::-1].argmax(axis=1)
    n = last - first + 1
    taps = np.zeros((k.shape[0], int(n.max())), np.float32)
    for j in range(k.shape[0]):
        taps[j, : n[j]] = k[j, first[j]: last[j] + 1]
    return taps, first.astype(np.int32)


def window_bank(taps: np.ndarray, first: np.ndarray, q: int, p: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The taps laid out per run of 8 outputs, as kernel 1's resampling
    staging pass reads them.

    Output ``n`` (phase ``j = n % p``) reads inputs from ``s(n) - width``
    on, ``s(n) = (n // p) * q + first[j]``. The ``L = lcm(p, 8)`` outputs
    of a row repeat with the input advanced by ``L / p * q``, so a run of 8
    outputs starting at ``8 * r`` (mod ``L``) has fixed phases and fixed
    input offsets ``s(8r + e) - s(8r)``. Returns ``wbank`` (L/8, 8, U)
    float32, output ``e``'s taps at its offset and exact zeros elsewhere
    (``U``, the widest run's input window, rounded up to 4), and ``wstart``
    (L/8,) int32, ``s(8r)``."""
    taps = np.asarray(taps, np.float32)
    first = np.asarray(first, np.int64)
    n_taps = taps.shape[1]
    runs = p * 8 // math.gcd(p, 8) // 8
    n = np.arange(8 * runs)
    s = (n // p) * q + first[n % p]
    offsets = (s.reshape(runs, 8) - s[::8, None])
    if offsets.min() < 0:
        raise ValueError("the bank's first nonzero taps do not advance with the phase")
    width = -(-(int(offsets.max()) + n_taps) // 4) * 4
    wbank = np.zeros((runs, 8, width), np.float32)
    for r in range(runs):
        for e in range(8):
            d = offsets[r, e]
            wbank[r, e, d: d + n_taps] = taps[(8 * r + e) % p]
    return wbank, s[::8].astype(np.int32)


class Resampler(nn.Module):
    """Stateless resampler; the filter bands are non-persistent buffers."""

    def __init__(self, orig_freq: int, new_freq: int,
                 lowpass_filter_width: int = 6, rolloff: float = 0.99):
        super().__init__()
        self.orig_freq = int(orig_freq)
        self.new_freq = int(new_freq)
        g = math.gcd(self.orig_freq, self.new_freq)
        self.q = self.orig_freq // g
        self.p = self.new_freq // g
        kernel, width = sinc_resample_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
        self.width = width
        kkp = torch.from_numpy(np.ascontiguousarray(kernel.T))  # (K, P)
        # own storages, not views of kkp: torch.export saves each constant whole
        self.register_buffer("kernel_a", kkp[: self.q].clone(), persistent=False)
        self.register_buffer("kernel_b", kkp[self.q:].clone(), persistent=False)
        # (out_ch=P, in_ch=1, taps) for the strided-conv form (2*width > q)
        self.register_buffer("kernel", torch.from_numpy(kernel)[:, None, :], persistent=False)

    def output_length(self, length: int) -> int:
        return int(math.ceil(self.new_freq * length / self.orig_freq))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Resample along the last axis. ``x``: (..., time) float tensor."""
        if self.orig_freq == self.new_freq:
            return x
        in_shape = x.shape
        length = in_shape[-1]
        q, w, p = self.q, self.width, self.p
        xf = x.reshape(-1, length).float()
        target = self.output_length(length)
        if 2 * w > q:  # overlap wider than a row: one strided convolution
            y = F.conv1d(F.pad(xf[:, None, :], (w, w + q)), self.kernel, stride=q)
            y = y.transpose(1, 2).reshape(xf.shape[0], -1)[:, :target]
            return y.reshape(in_shape[:-1] + (y.shape[-1],)).to(x.dtype)
        nblocks = length // q + 1
        pad_right = (nblocks + 1) * q - w - length
        rows = F.pad(xf, (w, pad_right)).reshape(xf.shape[0], nblocks + 1, q)
        y = (torch.matmul(rows[:, :nblocks], self.kernel_a)
             + torch.matmul(rows[:, 1:, : 2 * w], self.kernel_b))
        if target % p == 0:
            y = y[:, : target // p, :].reshape(xf.shape[0], target)
        else:
            y = y.reshape(xf.shape[0], -1)[:, :target]
        return y.reshape(in_shape[:-1] + (y.shape[-1],)).to(x.dtype)

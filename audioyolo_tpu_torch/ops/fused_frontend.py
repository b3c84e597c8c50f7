"""Fused resample+frame+window+DFT as phase-grouped GEMMs (port of
``audioyolo_tpu/ops/fused_frontend.py``).

Everything before the power spectrum is linear, so the polyphase resampler
and the window-folded DFT compose into one constant matrix per phase,
``C_r = A_r @ W``, built once in float64 numpy. With resampler block ``p``
and hop ``h``, every ``n_ph = lcm(p, h)/h`` frames the alignment repeats
(8 for 22 050 -> 16 000 Hz, hop 1000): frame ``f = n_ph*g + r`` reads the raw
window ``x[span*g + off_r : span*g + off_r + F]`` through ``C_r``. The host
frames the raw audio into (B, n_ph, n_groups, frame_len) and the device runs
one GEMM per phase.

A 2-D int16 batch is framed by the native C memcpy loop
(``data/native.py::frame_i16``); other input by the numpy form, which is
also the tests' reference.

The ``int8`` posture runs the GEMM on int8 frames against an int8 copy of
``C_r`` (:meth:`FusedFrameDFT.int8_matrix`, one scale per frequency shared by
its real and imaginary columns) with int32 sums (:meth:`power_int8`, through
``ops/int8.py``); the scales fold into the mel filterbank and the mel output
(``ops/frontend.py``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .frontend import dft_power_matrix, hann_window, posture_matmul
from .int8 import int8_mm
from .resample import sinc_resample_kernel


@functools.lru_cache(maxsize=8)
def get_fused_frame_dft(orig_freq: int, new_freq: int, n_fft: int, hop: int,
                        win_length: int, n_frames: int,
                        lowpass_filter_width: int = 6,
                        rolloff: float = 0.99) -> "FusedFrameDFT":
    """Cached constructor: the float64 per-phase precompute takes seconds and
    instances hold only host numpy, never changed after init."""
    return FusedFrameDFT(orig_freq, new_freq, n_fft, hop, win_length, n_frames,
                         lowpass_filter_width, rolloff)


class FusedFrameDFT:
    """Precomputed phase-grouped resample+frame+DFT operator (host numpy)."""

    def __init__(self, orig_freq: int, new_freq: int, n_fft: int, hop: int,
                 win_length: int, n_frames: int, lowpass_filter_width: int = 6,
                 rolloff: float = 0.99):
        if hop != n_fft:
            raise ValueError("fused frontend requires hop == n_fft (no overlap)")
        self.orig_freq, self.new_freq = int(orig_freq), int(new_freq)
        self.n_fft, self.hop = int(n_fft), int(hop)
        self.n_freq = n_fft // 2 + 1
        self.n_frames = int(n_frames)

        window = np.zeros(n_fft, dtype=np.float64)
        w = hann_window(win_length, periodic=True, dtype=np.float64)
        off = (n_fft - win_length) // 2
        window[off: off + win_length] = w
        W = dft_power_matrix(n_fft, window, dtype=np.float64)  # (n_fft, 2*n_freq)

        g = math.gcd(self.orig_freq, self.new_freq)
        q, p = self.orig_freq // g, self.new_freq // g

        if self.orig_freq == self.new_freq:
            self.n_ph, self.span, self.width = 1, self.hop, 0
            self.frame_len = self.n_fft
            self.offsets = np.array([0], np.int64)
            self.c = W.astype(np.float32)[None]  # (1, n_fft, 2F)
        else:
            kernel, width = sinc_resample_kernel(
                orig_freq, new_freq, lowpass_filter_width, rolloff, dtype=np.float64)
            self.width = width
            n_ph = (p * hop) // math.gcd(p, hop) // hop
            if self.n_frames % n_ph:
                raise ValueError(f"n_frames={n_frames} not divisible by phase count {n_ph}")
            self.n_ph = n_ph
            blocks_per_group = n_ph * hop // p
            self.span = blocks_per_group * q

            taps = kernel.shape[1]
            offs, mats = [], []
            frame_len = 0
            for r in range(n_ph):
                m0 = r * hop
                b_lo = m0 // p
                b_hi = (m0 + hop - 1) // p
                flen = (b_hi - b_lo) * q + taps
                frame_len = max(frame_len, flen)
                offs.append(b_lo * q)
                c = np.zeros((flen, W.shape[1]), np.float64)
                for u in range(hop):
                    m = m0 + u
                    b, ph = divmod(m, p)
                    lo = (b - b_lo) * q
                    c[lo: lo + taps] += kernel[ph][:, None] * W[u][None, :]
                mats.append(c)
            if frame_len > self.span:
                # frame_host's per-phase reshape assumes the windows of one
                # phase never overlap; refuse, and the frontend keeps the
                # waveform path
                raise ValueError(
                    f"fused frontend requires frame_len <= span (non-overlapping "
                    f"phase windows); got frame_len={frame_len} > span={self.span} "
                    f"for {orig_freq}->{new_freq}, hop={hop}")
            self.frame_len = frame_len
            self.offsets = np.asarray(offs, np.int64)
            padded = np.zeros((n_ph, frame_len, W.shape[1]), np.float64)
            for r, c in enumerate(mats):
                padded[r, : c.shape[0]] = c
            self.c = padded.astype(np.float32)

        self.n_groups = self.n_frames // self.n_ph

    def frame_host(self, x: np.ndarray, alloc=None) -> np.ndarray:
        """(..., L) raw audio -> (..., n_ph, n_groups, frame_len), any dtype.

        Zero-pads ``width`` samples left (the resampler's context) and what
        the last windows need on the right. A (B, L) int16 batch takes the
        native framer; otherwise each phase is a reshape view plus a tail
        slice, and ``np.stack`` makes the one copy. ``alloc(shape, dtype)``,
        when given, returns the array the frames are written into (a pinned
        host buffer, say) and is what this returns.
        """
        shape = x.shape[:-1] + (self.n_ph, self.n_groups, self.frame_len)
        out = None if alloc is None else alloc(shape, x.dtype)
        if x.ndim == 2 and x.dtype == np.int16:
            from ..data import native

            return native.frame_i16(x, self, out=out)
        framed = self.frame_numpy(x)
        if out is None:
            return framed
        out[...] = framed
        return out

    def frame_numpy(self, x: np.ndarray) -> np.ndarray:
        """:meth:`frame_host`'s numpy form, for any input."""
        lead = x.shape[:-1]
        L = x.shape[-1]
        need = int(self.offsets.max()) + self.n_groups * self.span
        xp = np.pad(x, [(0, 0)] * len(lead) + [(self.width, max(0, need - self.width - L))])
        phases = [
            xp[..., off: off + self.n_groups * self.span]
            .reshape(lead + (self.n_groups, self.span))[..., : self.frame_len]
            for off in self.offsets
        ]
        return np.stack(phases, axis=-3)

    def int8_matrix(self):
        """``(c_i8 (n_ph, F, 2*n_freq) int8, s_k (n_freq,) float32)``: ``C``
        quantized per frequency column, symmetric, with one scale for a
        frequency's real and imaginary columns so that ``s_k**2`` folds into
        the mel filterbank's rows. float64 numpy, as the JAX package computes
        it, cached."""
        if not hasattr(self, "_c_i8"):
            c = np.asarray(self.c, np.float64)
            nf = self.n_freq
            colmax = np.abs(c).max(axis=(0, 1))
            s_k = np.maximum(np.maximum(colmax[:nf], colmax[nf:]), 1e-30) / 127.0
            sc = np.concatenate([s_k, s_k])
            self._c_i8 = np.clip(np.round(c / sc), -127, 127).astype(np.int8)
            self._sk = s_k.astype(np.float32)
        return self._c_i8, self._sk

    def power_int8(self, q: torch.Tensor, c_i8: torch.Tensor,
                   storage_dtype=None) -> torch.Tensor:
        """(B, n_ph, n_groups, frame_len) int8 frames -> (B, n_ph, n_groups,
        n_freq) float32 power in phase order, unscaled: the true power over
        ``(s_clip * s_k)**2``.

        ``c_i8`` is :meth:`int8_matrix`'s matrix as a tensor on ``q``'s
        device, (n_ph, K, N) with K >= frame_len and N >= 2*n_freq (zero
        padding is exact). One int32 GEMM per phase (``int8_mm``), exact:
        |acc| <= 127 * 127 * frame_len. ``storage_dtype=torch.bfloat16``
        rounds the accumulator to bf16 before the power, as
        ``tpu_config.int8_spectrum: bf16`` asks.
        """
        b, r, g, f = q.shape
        kp = c_i8.shape[1]
        if kp != f:
            q = F.pad(q, (0, kp - f))
        acc = torch.stack([int8_mm(q[:, i].reshape(b * g, kp), c_i8[i]).reshape(b, g, -1)
                           for i in range(r)], dim=1)
        af = acc.to(storage_dtype).float() if storage_dtype is not None else acc.float()
        nf = self.n_freq
        return af[..., :nf] ** 2 + af[..., nf:2 * nf] ** 2

    def reorder_frames(self, x: torch.Tensor) -> torch.Tensor:
        """(B, n_ph, n_groups, C) phase order -> (B, n_frames, C) time order
        (frame f = g*n_ph + r)."""
        return x.transpose(1, 2).reshape(x.shape[0], self.n_frames, x.shape[-1])

    def __call__(self, framed: torch.Tensor, c: torch.Tensor, power: float = 2.0,
                 reorder: bool = True, precision: str = "highest",
                 storage_dtype=None) -> torch.Tensor:
        """(B, n_ph, n_groups, frame_len) -> power spectrogram, float32.

        ``c`` is ``self.c`` as a float32 tensor on ``framed``'s device. One
        GEMM per phase in ``precision`` (``frontend.posture_matmul``). int16
        frames are dequantized as PCM16 (x / 32768). ``storage_dtype=
        torch.bfloat16`` (the ``bf16`` posture) runs the GEMM on bf16
        operands and rounds the spectrum to bf16 before the power, as the
        JAX package stores it. Returns (B, n_frames, n_freq) when
        ``reorder``, else (B, n_ph, n_groups, n_freq) in phase order.
        """
        if not framed.is_floating_point():
            framed = framed.float() * (1.0 / 32768.0)
        if storage_dtype is not None:
            spec = posture_matmul(framed, c.unsqueeze(0), "default").to(storage_dtype).float()
        else:
            spec = posture_matmul(framed, c.unsqueeze(0), precision)
        nf = self.n_freq
        p = spec[..., :nf] ** 2 + spec[..., nf:] ** 2
        if reorder:
            p = self.reorder_frames(p)
        if power == 2.0:
            return p
        if power == 1.0:
            return torch.sqrt(p)
        return p ** (power / 2.0)

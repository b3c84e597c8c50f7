"""Spectral frontend: waveform or phase-grouped frames -> (B, n_mels, T, 2)
log-mel + MFCC feature image (port of ``audioyolo_tpu/ops/frontend.py``).

The constants (windows, DFT, mel filterbank, DCT) are built on the host in
float64 numpy exactly as the JAX package builds them. On the device the
frontend is GEMMs plus elementwise work.

Postures, read from ``tpu_config`` as the JAX package reads them. Each sets
how the DFT and mel products round (``posture_matmul``); the resampler and
the small DCT product stay float32 in every posture (the JAX package runs its
resampler at ``HIGHEST``, and the port keeps the 32 x 32 DCT float32 as kernel
1's posture always has):

- ``frontend_precision: highest`` (the default): float32 products, TF32 off.
- ``high``: the TPU's ``Precision.HIGH``, three bf16 passes (``hi*hi +
  hi*lo + lo*hi`` of each operand split into a bf16 head and a bf16 tail)
  with float32 sums: about 16 bits of each operand.
- ``default``: one bf16 pass, float32 sums and a float32 result (the JAX
  package's ``preferred_element_type=float32``). With ``pallas_frontend: on``
  and power 2 the DFT -> power -> mel stage is kernel 1 instead
  (``mel_kernel.fused_mel_power``: the same roundings plus a bf16 power),
  on CUDA tensors, and its plain version on CPU tensors, for phase-grouped
  frames and the waveform path's frames alike (there with one phase and the
  window-folded DFT matrix); power other than 2 takes the GEMMs, as the JAX
  package falls back to its GEMM pair. On the card, a waveform at another
  rate than the model's, cut into non-overlapping frames (``hop == n_fft``,
  no centering, no taper, one shared mel config), skips the resampler's
  GEMMs: kernel 1's staging pass resamples it (``mel_kernel.ResampleStage``,
  the same float32 taps, summed in float32) as it rounds the frames to bf16.
- ``bf16``: ``default`` with the phase-grouped spectrum stored in bf16.
- ``int8``: ``default``, and the ``(q, scale)`` frames of
  :meth:`SpectralFrontend.frame_host_int8` go through an int8 x int8 ->
  int32 DFT (``FusedFrameDFT.power_int8``) with the column scales folded into
  the mel rows and the clip scales into the mel output.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config, load_config
from .int8 import _round_up
from .mel_kernel import MelKernelFrontend, ResampleStage, mel_power_staged
from .resample import Resampler

# --------------------------------------------------------------------------
# Host-side constant builders (float64 -> float32)
# --------------------------------------------------------------------------


def hann_window(n: int, periodic: bool = True, dtype=np.float32) -> np.ndarray:
    """Raised-cosine window (``periodic=True`` is torch.hann_window's default)."""
    if n == 1:
        return np.ones(1, dtype=dtype)
    denom = n if periodic else n - 1
    k = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * k / denom))).astype(dtype)


_WINDOW_FNS = {
    "hann": np.hanning,
    "hamming": np.hamming,
    "blackman": np.blackman,
    "bartlett": np.bartlett,
    "kaiser": lambda n: np.kaiser(n, 12.0),  # torch.kaiser_window default beta
}


def taper_window(name: str, n: int, periodic: bool = False, dtype=np.float32) -> np.ndarray:
    """``torch.<name>_window(n, periodic=...)`` equivalent for the input taper."""
    try:
        fn = _WINDOW_FNS[name]
    except KeyError:
        raise ValueError(
            f"unsupported taper window '{name}'; supported: {sorted(_WINDOW_FNS)}"
        ) from None
    if n == 1:
        return np.ones(1, dtype=dtype)
    if periodic:
        return fn(n + 1)[:n].astype(dtype)
    return fn(n).astype(dtype)


def dft_power_matrix(n_fft: int, window: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Window-folded real-DFT matrix ``(n_fft, 2*(n_fft//2+1))``:
    ``frames @ W`` gives ``[Re X_k | Im X_k]`` of the onesided spectrum."""
    n_freq = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freq, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    cos = np.cos(ang) * window.astype(np.float64)[:, None]
    sin = -np.sin(ang) * window.astype(np.float64)[:, None]
    return np.concatenate([cos, sin], axis=1).astype(dtype)


def _hz_to_mel(f: np.ndarray, mel_scale: str) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    mel = f / f_sp
    return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mel)


def _mel_to_hz(m: np.ndarray, mel_scale: str) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    freq = f_sp * m
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freq)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0,
                   f_max: Optional[float] = None, mel_scale: str = "htk",
                   norm: Optional[str] = "slaney", dtype=np.float32) -> np.ndarray:
    """Triangular mel filterbank, shape ``(n_freqs, n_mels)``."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel(np.array(f_min), mel_scale),
                        _hz_to_mel(np.array(f_max), mel_scale), n_mels + 2)
    f_pts = _mel_to_hz(m_pts, mel_scale)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(dtype)


def dct_matrix(n_mfcc: int, n_mels: int, ortho: bool = True, dtype=np.float32) -> np.ndarray:
    """DCT-II basis ``(n_mels, n_mfcc)``; ``mels @ D`` gives cepstra."""
    n = np.arange(n_mels, dtype=np.float64)[:, None]
    k = np.arange(n_mfcc, dtype=np.float64)[None, :]
    d = 2.0 * np.cos(np.pi / n_mels * (n + 0.5) * k)
    if ortho:
        d[:, :1] = d[:, :1] / math.sqrt(2.0)
        d = d * math.sqrt(1.0 / (2.0 * n_mels))
    return d.astype(dtype)


# --------------------------------------------------------------------------
# Tensor ops
# --------------------------------------------------------------------------


def frame_signal(x: torch.Tensor, n_fft: int, hop: int, center: bool,
                 pad_mode: str) -> torch.Tensor:
    """(B, samples) -> (B, n_frames, n_fft)."""
    if center:
        pad = n_fft // 2
        mode = {"reflect": "reflect", "constant": "constant", "replicate": "replicate"}[pad_mode]
        x = F.pad(x, (pad, pad), mode=mode)
    return x.unfold(-1, n_fft, hop)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def posture_matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """``a @ b`` with float32 output, its operands rounded as ``precision``
    says: ``highest`` float32; ``default`` (and ``bf16``, ``int8``) one bf16
    pass, as the float32 product of the bf16-rounded operands (each product
    of two bf16 values is exact in float32, so this is a bf16 GEMM with
    float32 sums); ``high`` three bf16 passes, ``hi*hi + hi*lo + lo*hi``,
    run as one product over a three times longer inner axis."""
    a, b = a.float(), b.float()
    if precision == "highest":
        return torch.matmul(a, b)
    a_hi, b_hi = _bf16(a), _bf16(b)
    if precision == "high":
        a3 = torch.cat([a_hi, a_hi, _bf16(a - a_hi)], dim=-1)
        b3 = torch.cat([b_hi, _bf16(b - b_hi), b_hi], dim=-2)
        return torch.matmul(a3, b3)
    return torch.matmul(a_hi, b_hi)


def stft_power(x: torch.Tensor, dft_w: torch.Tensor, n_fft: int, hop: int,
               center: bool = False, pad_mode: str = "reflect",
               power: float = 2.0, precision: str = "highest") -> torch.Tensor:
    """(B, samples) -> (B, n_frames, n_freq) power spectrogram, the GEMM in
    ``precision`` (``posture_matmul``)."""
    frames = frame_signal(x.float(), n_fft, hop, center, pad_mode)
    spec = posture_matmul(frames, dft_w, precision)
    n_freq = n_fft // 2 + 1
    p = spec[..., :n_freq] ** 2 + spec[..., n_freq:] ** 2
    if power == 2.0:
        return p
    if power == 1.0:
        return torch.sqrt(p)
    return p ** (power / 2.0)


def amplitude_to_db(x: torch.Tensor, top_db: Optional[float] = None,
                    multiplier: float = 10.0, amin: float = 1e-10,
                    ref: float = 1.0) -> torch.Tensor:
    """Power -> decibels with an optional per-sample floor ``top_db`` below
    the maximum over all non-batch axes."""
    db = multiplier * torch.log10(torch.clamp_min(x, amin))
    db = db - multiplier * math.log10(max(amin, ref))
    if top_db is not None:
        floor = torch.amax(db, dim=tuple(range(1, db.dim())), keepdim=True) - top_db
        db = torch.maximum(db, floor)
    return db


def standardize_per_channel(x: torch.Tensor, e: float = 1e-5) -> torch.Tensor:
    """Zero mean, unit (unbiased) std over the trailing two axes."""
    mu = torch.mean(x, dim=(-2, -1), keepdim=True)
    n = x.shape[-2] * x.shape[-1]
    var = torch.sum((x - mu) ** 2, dim=(-2, -1), keepdim=True) / max(n - 1, 1)
    return (x - mu) / (torch.sqrt(var) + e)


# --------------------------------------------------------------------------
# Composed frontend
# --------------------------------------------------------------------------


POSTURES = ("highest", "high", "default", "bf16", "int8")


def _posture(cfg: Config) -> Tuple[str, bool]:
    """(precision, kernel 1 asked for) from ``tpu_config``: kernel 1 is
    asked for by ``pallas_frontend: on`` in the postures that run one bf16
    pass (``default``, ``bf16``, ``int8``), as in the JAX package."""
    tc = cfg.raw.get("tpu_config") or {}
    prec = str(tc.get("frontend_precision", "highest")).lower()
    if prec not in POSTURES:
        raise ValueError(f"unknown frontend_precision '{prec}'")
    on = str(tc.get("pallas_frontend", "off")).lower() == "on"
    return prec, on and prec in ("default", "bf16", "int8")


class MelBranch(nn.Module):
    """One MelSpectrogram equivalent (window-folded DFT GEMM + mel GEMM), with
    torchaudio's MelSpectrogram defaults for missing keys."""

    def __init__(self, mel_cfg: dict, sr_model: int, use_kernel: bool = False,
                 precision: str = "highest"):
        super().__init__()
        self.precision = precision
        self.n_fft = int(mel_cfg.get("n_fft", 400))
        self.win_length = int(mel_cfg.get("win_length") or self.n_fft)
        self.hop = int(mel_cfg.get("hop_length") or self.win_length // 2)
        self.center = bool(mel_cfg.get("center", True))
        self.pad_mode = mel_cfg.get("pad_mode", "reflect")
        self.power = float(mel_cfg.get("power", 2.0))
        self.n_mels = int(mel_cfg.get("n_mels", 128))

        window = np.zeros(self.n_fft, dtype=np.float64)
        w = hann_window(self.win_length, periodic=True, dtype=np.float64)
        off = (self.n_fft - self.win_length) // 2
        window[off: off + self.win_length] = w
        dft_w = dft_power_matrix(self.n_fft, window)
        self.mel_fb_np = mel_filterbank(
            self.n_fft // 2 + 1, self.n_mels, sr_model,
            f_min=float(mel_cfg.get("f_min", 0.0)), f_max=mel_cfg.get("f_max"),
            mel_scale=mel_cfg.get("mel_scale", "htk"), norm=mel_cfg.get("norm"),
        )
        self.register_buffer("mel_fb", torch.from_numpy(self.mel_fb_np), persistent=False)
        self.kernel = None
        if use_kernel and self.power == 2.0:  # kernel 1 computes power 2 only
            self.kernel = MelKernelFrontend(dft_w[None], self.mel_fb_np)
        else:
            self.register_buffer("dft_w", torch.from_numpy(dft_w), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, samples) -> (B, n_frames, n_mels) mel power."""
        if self.kernel is not None:
            frames = frame_signal(x.float(), self.n_fft, self.hop, self.center, self.pad_mode)
            return self.kernel(frames.contiguous()[:, None])[:, 0]
        p = stft_power(x, self.dft_w, self.n_fft, self.hop, self.center,
                       self.pad_mode, self.power, self.precision)
        return posture_matmul(p, self.mel_fb, self.precision)


class SpectralFrontend(nn.Module):
    """Waveform at the dataset rate, or phase-grouped frames from
    :meth:`frame_host`, -> (B, n_mels, n_frames, 2) NHWC feature image.

    Channel 0 is the log-mel image, channel 1 the MFCC image, both through
    the 80 dB floor and (optionally) standardized per sample and channel.
    All constants are non-persistent buffers: ``.to(device)`` moves them and
    a model's ``state_dict`` holds none of them.
    """

    def __init__(self, config=None):
        super().__init__()
        cfg = load_config(config)
        self.cfg = cfg
        mel_cfg = cfg.raw["melspectrogram_config"]
        mfcc_cfg = cfg.raw["mfcc_config"]
        self.precision, kernel = _posture(cfg)
        tc = cfg.raw.get("tpu_config") or {}
        self.fused_storage_dtype = torch.bfloat16 if self.precision == "bf16" else None
        self.fused_int8 = self.precision == "int8"
        # int8 posture only: the DFT's int32 accumulator stored in bf16
        self.int8_spectrum_dtype = (
            torch.bfloat16 if str(tc.get("int8_spectrum", "int32")).lower() in ("bf16", "bfloat16")
            else None)
        self.sr_in = cfg.sample_rate
        self.sr_model = cfg.new_sample_rate
        self.resampler = Resampler(self.sr_in, self.sr_model)

        self.mel = MelBranch(mel_cfg, self.sr_model, kernel, self.precision)
        self.use_kernel = self.mel.kernel is not None
        self.n_mels = self.mel.n_mels
        mk = dict(mfcc_cfg.get("melkwargs") or {})
        self.shared_mel = mk == dict(mel_cfg)
        self.mfcc_mel = (self.mel if self.shared_mel
                         else MelBranch(mk, self.sr_model, kernel, self.precision))
        self.n_mfcc = int(mfcc_cfg["n_mfcc"])
        self.log_mels = bool(mfcc_cfg.get("log_mels", False))
        self.register_buffer("dct_m", torch.from_numpy(dct_matrix(
            self.n_mfcc, self.mfcc_mel.n_mels,
            ortho=mfcc_cfg.get("norm", "ortho") == "ortho")), persistent=False)

        taper = None
        if cfg.raw.get("taper_input"):
            taper = torch.from_numpy(taper_window(
                cfg.raw.get("taper_window", "hann"), cfg.model_samples, periodic=False))
        self.register_buffer("taper", taper, persistent=False)
        self.scale_input = bool(cfg.raw.get("scale_input", True))

        # Kernel 1 stages the waveform straight from the dataset rate where
        # the frames do not overlap (forward takes it for CUDA tensors, where
        # the kernel takes the rate pair)
        self.resample_stage = None
        if (self.use_kernel and self.sr_in != self.sr_model and self.taper is None
                and not self.mel.center and self.mel.hop == self.mel.n_fft and self.shared_mel):
            r = self.resampler
            self.resample_stage = ResampleStage(
                r.kernel[:, 0].numpy(), r.width, r.q, r.p, self.mel.n_fft,
                self.mel.kernel.ct.shape[-1])

        # Fused resample+frame+DFT path for phase-grouped frames: eligible
        # for non-overlapping frames, no centering or taper, one shared mel
        # config (the shipped config).
        self.fused = None
        self.fused_kernel = None
        if (self.taper is None and not self.mel.center
                and self.mel.hop == self.mel.n_fft and self.shared_mel):
            from .fused_frontend import get_fused_frame_dft

            try:
                self.fused = get_fused_frame_dft(
                    self.sr_in, self.sr_model, self.mel.n_fft, self.mel.hop,
                    self.mel.win_length, cfg.n_frames)
            except ValueError:  # frame count not phase-divisible, overlapping windows
                self.fused = None
        if self.fused is not None:
            if self.use_kernel:
                self.fused_kernel = MelKernelFrontend(self.fused.c, self.mel.mel_fb_np)
            else:
                self.register_buffer("fused_c", torch.from_numpy(self.fused.c),
                                     persistent=False)
            if self.fused_int8:
                # C_r in int8, zero-padded to the card's GEMM multiples and
                # held K-major (column-major (K, N) per phase, as ``_int_mm``
                # takes it); s_k**2 folded into the mel rows in float64
                c_i8, s_k = self.fused.int8_matrix()
                r, f, n = c_i8.shape
                padded = np.zeros((r, _round_up(n, 8), _round_up(f, 8)), np.int8)
                padded[:, :n, :f] = c_i8.transpose(0, 2, 1)
                self.register_buffer("fused_c_i8", torch.from_numpy(padded).transpose(1, 2),
                                     persistent=False)
                mel_fb_i8 = (np.asarray(self.mel.mel_fb_np, np.float64)
                             * (np.asarray(s_k, np.float64)[:, None] ** 2)).astype(np.float32)
                self.register_buffer("mel_fb_i8", torch.from_numpy(mel_fb_i8), persistent=False)

    def frame_host(self, audio: np.ndarray, alloc=None) -> np.ndarray:
        """Host framing for the fused path: (B, S) or (B, 1, S) raw audio
        (float or int16) -> (B, n_ph, n_groups, frame_len), same dtype
        (``FusedFrameDFT.frame_host``; int16 takes the native framer)."""
        if self.fused is None:
            raise ValueError("fused frontend path not available for this config")
        audio = np.asarray(audio)
        if audio.ndim == 3:
            audio = audio[:, 0, :]
        return self.fused.frame_host(audio, alloc=alloc)

    def frame_host_int8(self, audio: np.ndarray, alloc=None):
        """Host framing and per-clip symmetric int8 quantization for the
        ``int8`` posture: (B, S) or (B, 1, S) raw audio -> ``(q (B, n_ph,
        n_groups, frame_len) int8, scale (B,) float32)``, ``q * scale`` the
        float frames (int16 read as x / 32768). The JAX package's numpy
        arithmetic, bit for bit. ``alloc(shape, dtype)``, when given, returns
        the array ``q`` is written into (a pinned host buffer, say)."""
        frames = self.frame_host(audio)
        if frames.dtype == np.int16:
            f = frames.astype(np.float32) * (1.0 / 32768.0)
        else:
            f = frames.astype(np.float32)
        a = np.abs(f).max(axis=(1, 2, 3))
        scale = (np.maximum(a, 1e-12) / 127.0).astype(np.float32)
        q = np.clip(np.round(f / scale[:, None, None, None]), -127, 127)
        if alloc is None:
            return q.astype(np.int8), scale
        out = alloc(q.shape, np.int8)
        out[...] = q
        return out, scale

    def _fused_int8_mel(self, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """(q int8 frames, per-clip scale) -> (B, n_ph, G, n_mels) mel power in
        phase order: the unscaled int8 power through the mel rows that carry
        ``s_k**2``, then times ``scale**2``."""
        if self.mel.power != 2.0:
            raise ValueError("frontend_precision 'int8' requires power=2")
        p = self.fused.power_int8(q, self.fused_c_i8, self.int8_spectrum_dtype)
        mel_rg = posture_matmul(p, self.mel_fb_i8, self.precision)
        return mel_rg * (scale.float()[:, None, None, None] ** 2)

    def forward(self, audio) -> torch.Tensor:
        """``audio``: (B, S) or (B, 1, S) waveform at the dataset rate,
        (B, n_ph, n_groups, frame_len) frames from :meth:`frame_host`, or in
        the ``int8`` posture the ``(q, scale)`` tuple of
        :meth:`frame_host_int8`. int16 input is dequantized as PCM16
        (x / 32768)."""
        if isinstance(audio, (tuple, list)):
            if not self.fused_int8 or self.fused is None:
                raise ValueError("(q, scale) framed-int8 input requires tpu_config."
                                 "frontend_precision: int8 and the fused path")
            mel_rg = self._fused_int8_mel(*audio)
            return self._images(self.fused.reorder_frames(mel_rg), None)
        if audio.dim() == 4:
            if self.fused is None:
                raise ValueError("framed input given but fused path unavailable")
            if self.fused_kernel is not None:
                mel_rg = self.fused_kernel(audio.contiguous())
            else:
                # project to mel in phase order, then restore time order
                mel_rg = posture_matmul(
                    self.fused(audio, self.fused_c, power=self.mel.power, reorder=False,
                               precision=self.precision,
                               storage_dtype=self.fused_storage_dtype),
                    self.mel.mel_fb, self.precision)
            return self._images(self.fused.reorder_frames(mel_rg), None)
        if audio.dim() == 3:
            audio = audio[:, 0, :]
        if self._kernel_resamples(audio):
            audio = audio.contiguous()
            k = self.mel.kernel
            mel = mel_power_staged(self.resample_stage(audio), k.ct, k.mel2t, audio.shape[0],
                                   self.resample_stage.frames(audio.shape[-1]))
            return self._images(mel[:, 0], None)
        if not audio.is_floating_point():
            audio = audio.float() * (1.0 / 32768.0)
        x = self.resampler(audio.float())
        if self.taper is not None:
            x = x * self.taper[None, :]
        return self._images(self.mel(x), x)

    def _kernel_resamples(self, audio: torch.Tensor) -> bool:
        """Whether kernel 1's staging pass resamples this (B, S) waveform:
        an int16 or float32 tensor on the card, where the configuration
        built a :class:`ResampleStage` whose rate pair the kernel takes."""
        return (self.resample_stage is not None and audio.is_cuda
                and audio.dtype in (torch.int16, torch.float32) and self.resample_stage.fits())

    def _images(self, mel_power: torch.Tensor, x: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, T, M) mel power (+ waveform for a non-shared MFCC branch) ->
        (B, M, T, 2) feature image."""
        mfcc_mel_power = mel_power if self.shared_mel else self.mfcc_mel(x)
        if self.log_mels:
            log_mel = torch.log(mfcc_mel_power + 1e-6)
        else:
            log_mel = amplitude_to_db(mfcc_mel_power, top_db=80.0)
        mfcc = torch.matmul(log_mel, self.dct_m)
        # the reference's outer AmplitudeToDB(top_db=80) runs on both
        # branches, the MFCC coefficients included (a power->dB map applied
        # a second time)
        mel_img = amplitude_to_db(mel_power, top_db=80.0)
        mfcc_img = amplitude_to_db(mfcc, top_db=80.0)
        if self.scale_input:
            mel_img = standardize_per_channel(mel_img)
            mfcc_img = standardize_per_channel(mfcc_img)
        return torch.stack([mel_img.transpose(-1, -2), mfcc_img.transpose(-1, -2)], dim=-1)

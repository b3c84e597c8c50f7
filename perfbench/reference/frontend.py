"""Plain float32 frontend: 22 050 -> 16 000 Hz windowed-sinc resampling,
real DFT power, HTK mel filterbank (Slaney norm), the 80 dB floor, the
MFCC's DCT-II and the reference repository's second dB map over both
channels, then per-channel standardisation.

Written from torchaudio's published definitions (``functional.resample``
with ``sinc_interp_hann``, ``melscale_fbanks``, ``create_dct``,
``amplitude_to_DB``), not from the measured package. Constants are built in
float64 numpy and used in float32; products run with TF32 off
(:func:`float32_posture`).

``tpu_config.frontend_precision`` states how the DFT and mel products round:
``highest`` is float32; ``default`` (the shipped serving posture) is one
bfloat16 pass, i.e. both operands of each of the two products rounded to
bfloat16 and the sums kept in float32. ``pallas_frontend: on`` with
``default`` states kernel 1's arithmetic: the squares of the real and the
imaginary parts each rounded to bfloat16 and each taken through the
bfloat16 filterbank, the two sums added in float32. The resampler and the
DCT stay float32 throughout.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def float32_posture() -> None:
    """Full float32 matrix products and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sinc_kernel(orig: int, new: int, width_zc: int = 6, rolloff: float = 0.99):
    """torchaudio's ``_get_sinc_resample_kernel`` (hann window) in float64:
    ``(kernel (new', 1, 2*width + orig'), width, orig', new')``."""
    g = math.gcd(orig, new)
    orig, new = orig // g, new // g
    base = min(orig, new) * rolloff
    width = int(math.ceil(width_zc * orig / base))
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = (-np.arange(new, dtype=np.float64)[:, None] / new + idx) * base
    t = np.clip(t, -width_zc, width_zc)
    window = np.cos(t * math.pi / width_zc / 2) ** 2
    t = t * math.pi
    safe = np.where(t == 0, 1.0, t)
    k = np.where(t == 0, 1.0, np.sin(safe) / safe) * window * (base / orig)
    return k[:, None, :], width, orig, new


def resample(x: torch.Tensor, orig: int, new: int) -> torch.Tensor:
    """(B, L) float32 -> (B, ceil(new * L / orig)), as torchaudio resamples."""
    if orig == new:
        return x
    k, width, o, n = sinc_kernel(orig, new)
    kern = torch.from_numpy(k.astype(np.float32)).to(x.device)
    length = x.shape[-1]
    y = F.conv1d(F.pad(x[:, None, :], (width, width + o)), kern, stride=o)
    y = y.transpose(1, 2).reshape(x.shape[0], -1)
    return y[:, : int(math.ceil(new * length / orig))]


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_fbanks(n_freqs: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """torchaudio ``melscale_fbanks`` (htk, norm "slaney", f 0 .. sr/2):
    (n_freqs, n_mels)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2.0), n_mels + 2)
    f_pts = _mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb * (2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels]))[None, :]


def dct_ortho(n_mfcc: int, n_mels: int) -> np.ndarray:
    """torchaudio ``create_dct(n_mfcc, n_mels, "ortho")``: (n_mels, n_mfcc)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[:, None]
    d = np.cos(math.pi / n_mels * (n + 0.5) * k)
    d[0] *= 1.0 / math.sqrt(2.0)
    d *= math.sqrt(2.0 / n_mels)
    return d.T


def to_db(x: torch.Tensor, top_db: float = 80.0) -> torch.Tensor:
    """Power to dB (amin 1e-10, ref 1), floored ``top_db`` below each
    sample's maximum over all its other axes."""
    db = 10.0 * torch.log10(torch.clamp_min(x, 1e-10))
    peak = db.reshape(db.shape[0], -1).amax(dim=1)
    return torch.maximum(db, (peak - top_db).view((-1,) + (1,) * (db.dim() - 1)))


def standardise(x: torch.Tensor) -> torch.Tensor:
    """Zero mean, unbiased unit std over the last two axes, + 1e-5 on the std."""
    mu = x.mean(dim=(-2, -1), keepdim=True)
    sd = x.std(dim=(-2, -1), keepdim=True, unbiased=True)
    return (x - mu) / (sd + 1e-5)


def n_frames(cfg: dict) -> int:
    """Frames of one window after resampling (960 for the shipped config)."""
    mel = cfg["melspectrogram_config"]
    n_fft = int(mel["n_fft"])
    hop = int(mel.get("hop_length") or n_fft)
    clip = int(round(float(cfg["sample_duration"]) * int(cfg["sample_rate"])))
    samples = int(math.ceil(int(cfg["new_sample_rate"]) * clip / int(cfg["sample_rate"])))
    return 1 + (samples - n_fft) // hop


class Frontend:
    """Waveform at ``sample_rate`` -> (B, 2, n_mels, frames) NCHW image."""

    def __init__(self, cfg: dict, device):
        mel = cfg["melspectrogram_config"]
        self.n_fft = int(mel["n_fft"])
        self.hop = int(mel.get("hop_length") or self.n_fft)
        if mel.get("center", True) or mel.get("win_length") not in (None, self.n_fft):
            raise ValueError("the reference frontend covers uncentred frames, win = n_fft")
        self.sr, self.sr_model = int(cfg["sample_rate"]), int(cfg["new_sample_rate"])
        n_freq = self.n_fft // 2 + 1
        n = np.arange(self.n_fft, dtype=np.float64)
        window = 0.5 - 0.5 * np.cos(2.0 * math.pi * n / self.n_fft)  # periodic hann
        ang = 2.0 * math.pi * n[:, None] * np.arange(n_freq)[None, :] / self.n_fft
        self.cos = torch.from_numpy((np.cos(ang) * window[:, None]).astype(np.float32)).to(device)
        self.sin = torch.from_numpy((np.sin(ang) * window[:, None]).astype(np.float32)).to(device)
        self.fb = torch.from_numpy(mel_fbanks(n_freq, int(mel["n_mels"]), self.sr_model)
                                   .astype(np.float32)).to(device)
        self.dct = torch.from_numpy(dct_ortho(int(cfg["mfcc_config"]["n_mfcc"]),
                                              int(mel["n_mels"])).astype(np.float32)).to(device)
        self.scale = bool(cfg.get("scale_input", True))
        tc = cfg.get("tpu_config") or {}
        self.precision = str(tc.get("frontend_precision", "highest"))
        if self.precision not in ("highest", "default"):
            raise ValueError(f"reference frontend: precision {self.precision!r} not covered")
        self.split_power = (self.precision == "default"
                            and str(tc.get("pallas_frontend", "off")) == "on"
                            and float(mel.get("power", 2.0)) == 2.0)

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "default":
            a, b = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
        return a @ b

    def __call__(self, wave: torch.Tensor) -> torch.Tensor:
        x = resample(wave.float(), self.sr, self.sr_model)
        frames = x.unfold(-1, self.n_fft, self.hop)              # (B, T, n_fft)
        re2, im2 = self._mm(frames, self.cos) ** 2, self._mm(frames, self.sin) ** 2
        if self.split_power:
            mel = self._mm(re2, self.fb) + self._mm(im2, self.fb)
        else:
            mel = self._mm(re2 + im2, self.fb)                                    # (B, T, n_mels)
        mfcc = to_db(mel) @ self.dct                              # (B, T, n_mfcc)
        img = [to_db(mel), to_db(mfcc)]
        if self.scale:
            img = [standardise(c) for c in img]
        return torch.stack([c.transpose(1, 2) for c in img], dim=1)

"""Kernel 1: phase-grouped DFT -> power -> mel without the spectrum in memory.

Port of ``audioyolo_tpu/ops/pallas_frontend.py`` (``fused_mel_power`` and the
host constants of ``PallasMelFrontend``). The kernel is hand-written CUDA for
Hopper (``csrc/fused_mel_power.cu``) in two passes, each with its plain
PyTorch version beside it:

    xs   = bf16(x), phase-major (R, B*G, Fp), zero-padded      stage_frames
    spec = xs @ C_r^T                    fp32 accumulation     mel_power_staged
    mel  = bf16(spec * spec) @ [M; M]^T  fp32 accumulation

The constants are K-major: ``ct`` = C_r^T (R, Np, Fp) and ``mel2t`` =
[M; M]^T (32, Np), bf16, zero-padded. ``fused_mel_power`` runs both passes
(the kernels for a CUDA tensor, the plain versions only for a CPU tensor),
each pass a registered torch op; ``fused_mel_power.launches`` counts the
main pass's launches, one per run of kernel 1.

On the waveform path the staging pass can take the waveform at the dataset
rate and resample it too (``stage_frames_resample``, held by
:class:`ResampleStage`): each output is the float32 FMA chain of its
phase's taps of the resampler's bank (``ops/resample.py``) over the input,
rounded to bf16 into the same scratch, for non-overlapping frames.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import build
from .resample import polyphase_taps, window_bank

N_MELS = 32    # the kernel's output width (NMEL in csrc/fused_mel_power.cu)
K_TILE = 64    # frames and C^T are zero-padded along K (samples) to a multiple of this
N_TILE = 256   # C^T and [M; M]^T are zero-padded along N (spectrum) to a multiple of this
MAX_NP = 1024  # the kernel holds [M; M]^T whole in shared memory


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def resampled_frames(s: int, q: int, p: int, n_fft: int) -> int:
    """Frames of ``n_fft`` samples, ``hop == n_fft``, in the ``ceil(p*s/q)``
    samples that resampling ``s`` input samples by ``p/q`` gives."""
    return (-(-p * s // q)) // n_fft


def stage_frames_plain(framed: torch.Tensor, fp: int) -> torch.Tensor:
    """(B, R, G, F) float32/int16 frames -> (R, B*G, fp) bf16, rounded as
    ``x.astype(bf16)``, phase-major, zero-padded from F to ``fp``."""
    b, r, g, f = framed.shape
    xs = framed.float().to(torch.bfloat16).permute(1, 0, 2, 3).reshape(r, b * g, f)
    return F.pad(xs, (0, fp - f))


def mel_power_staged_plain(xs: torch.Tensor, ct: torch.Tensor, mel2t: torch.Tensor,
                           b: int, g: int) -> torch.Tensor:
    """Plain version of the main pass: ``xs`` (R, b*g, Fp) bf16, ``ct`` (R,
    Np, Fp) bf16, ``mel2t`` (n_mels, Np) bf16 -> (b, R, g, n_mels) fp32."""
    spec = torch.matmul(xs.float(), ct.float().transpose(1, 2))
    sq = (spec * spec).to(torch.bfloat16).float()
    mel = torch.matmul(sq, mel2t.float().t())
    return mel.reshape(xs.shape[0], b, g, -1).permute(1, 0, 2, 3).contiguous()


def fused_mel_power_plain(framed: torch.Tensor, ct: torch.Tensor,
                          mel2t: torch.Tensor) -> torch.Tensor:
    """Plain version: bf16-rounded operands, fp32 products and sums.

    ``framed`` (B, R, G, F) float32 or int16; ``ct`` (R, Np, Fp) bf16 with
    ``Fp >= F``; ``mel2t`` (n_mels, Np) bf16. Returns (B, R, G, n_mels) fp32.
    """
    b, _, g, _ = framed.shape
    return mel_power_staged_plain(stage_frames_plain(framed, ct.shape[-1]), ct, mel2t, b, g)


def resample_frames_plain(wave: torch.Tensor, wbank: torch.Tensor, wstart: torch.Tensor,
                          q: int, p: int, width: int, n_fft: int) -> torch.Tensor:
    """Plain version of the resampling staging pass before its rounding:
    ``wave`` (B, S) or (B, 1, S) int16 or float32 at the input rate,
    ``wbank`` (R, 8, U) float32 and ``wstart`` (R,) int32 from
    ``ops/resample.py::window_bank`` -> (B, G, n_fft) float32, the resampled
    signal's non-overlapping frames. int16 samples enter as integers: the
    bank for them is scaled by 2^-15 (``ResampleStage.wbank_i16``), which
    gives x / 32768 times the taps exactly. Each run of 8 outputs is the
    kernel's float32 FMA chain over its window, in the kernel's order: the
    product is exact in float64 and the float64 sum is rounded to float32
    each step."""
    b, s = wave.shape[0], wave.shape[-1]
    x = wave.reshape(b, s).float()
    runs, _, window = wbank.shape
    row = 8 * runs
    g = resampled_frames(s, q, p, n_fft)
    n0 = torch.arange(0, g * n_fft, 8, device=x.device)
    run = (n0 % row) // 8
    start = (n0 // row) * (row // p * q) + wstart.to(x.device).long()[run]  # padded by width
    right = max(0, int(start.max()) + window - s - width) if n0.numel() else 0
    xp = F.pad(x, (width, right))
    acc = torch.zeros((b, n0.numel(), 8), dtype=torch.float32, device=x.device)
    w64 = wbank.to(x.device).double()
    for u in range(window):
        prod = w64[run, :, u][None] * xp[:, start + u].double()[..., None]
        acc = (acc.double() + prod).float()
    return acc.reshape(b, -1)[:, : g * n_fft].reshape(b, g, n_fft)


def stage_frames_resample_plain(wave: torch.Tensor, wbank: torch.Tensor, wstart: torch.Tensor,
                                q: int, p: int, width: int, n_fft: int, fp: int) -> torch.Tensor:
    """Plain version of the resampling staging pass: arguments as in
    :func:`resample_frames_plain` -> (1, B*G, fp) bf16, the scratch that
    :func:`stage_frames_plain` makes of the resampled frames."""
    return stage_frames_plain(resample_frames_plain(wave, wbank, wstart, q, p, width,
                                                    n_fft)[:, None], fp)


def _check_cuda(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor on {device}")


def _check_frames(framed: torch.Tensor, fp: int) -> None:
    if framed.dim() != 4 or framed.dtype not in (torch.float32, torch.int16):
        raise ValueError(f"framed must be (B, R, G, F) float32/int16, got "
                         f"{tuple(framed.shape)} {framed.dtype}")
    if fp % K_TILE or framed.shape[-1] > fp:
        raise ValueError(f"Fp={fp} must be a multiple of {K_TILE} and >= F={framed.shape[-1]}")
    _check_cuda("framed", framed, framed.device)


def _check_constants(ct: torch.Tensor, mel2t: torch.Tensor, r: int, device: torch.device) -> None:
    if ct.dim() != 3 or ct.shape[0] != r or ct.dtype != torch.bfloat16:
        raise ValueError(f"ct must be ({r}, Np, Fp) bf16, got {tuple(ct.shape)} {ct.dtype}")
    np_, fp = ct.shape[1], ct.shape[2]
    if fp % K_TILE or np_ % N_TILE or np_ > MAX_NP:
        raise ValueError(f"ct must be zero-padded to Fp % {K_TILE} == 0 and Np % {N_TILE} == 0 "
                         f"with Np <= {MAX_NP}, got {tuple(ct.shape)}")
    if tuple(mel2t.shape) != (N_MELS, np_) or mel2t.dtype != torch.bfloat16:
        raise ValueError(f"mel2t must be ({N_MELS}, {np_}) bf16, got "
                         f"{tuple(mel2t.shape)} {mel2t.dtype}")
    _check_cuda("ct", ct, device)
    _check_cuda("mel2t", mel2t, device)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# Both passes are registered torch ops (``torch.ops.audioyolo_tpu_torch.*``):
# ``torch.export`` keeps each as one node of its graph (its fake registration
# gives the output's shape and type), a CUDA graph captures its launch, and
# the dispatcher sends a CPU tensor to the plain version, a CUDA tensor to the
# kernel, which launches or raises. ``chip_smoke.py`` calls the ``*_cuda``
# registrations directly to time what the dispatcher adds to a call.


@torch.library.custom_op("audioyolo_tpu_torch::stage_frames", mutates_args=(),
                         device_types="cpu")
def _stage_frames_op(framed: torch.Tensor, fp: int) -> torch.Tensor:
    return stage_frames_plain(framed, fp)


@_stage_frames_op.register_fake
def _(framed, fp):
    b, r, g, _ = framed.shape
    return framed.new_empty((r, b * g, fp), dtype=torch.bfloat16)


@_stage_frames_op.register_kernel("cuda")
def _stage_frames_cuda(framed, fp):
    _check_frames(framed, fp)
    b, r, g, f = framed.shape
    xs = torch.empty((r, b * g, fp), device=framed.device, dtype=torch.bfloat16)
    if xs.numel() == 0:
        return xs
    fn = build.function("fused_mel_power", "ayt_stage_frames",
                        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5
                        + [ctypes.c_void_p])
    with torch.cuda.device(framed.device):
        err = fn(framed.data_ptr(), int(framed.dtype == torch.int16), xs.data_ptr(),
                 b, r, g, f, fp, _stream(framed))
    build.check_launch(err, "stage_frames")
    return xs


@torch.library.custom_op("audioyolo_tpu_torch::mel_power_staged", mutates_args=(),
                         device_types="cpu")
def _mel_power_staged_op(xs: torch.Tensor, ct: torch.Tensor, mel2t: torch.Tensor,
                         b: int, g: int) -> torch.Tensor:
    return mel_power_staged_plain(xs, ct, mel2t, b, g)


@_mel_power_staged_op.register_fake
def _(xs, ct, mel2t, b, g):
    return xs.new_empty((b, ct.shape[0], g, mel2t.shape[0]), dtype=torch.float32)


@_mel_power_staged_op.register_kernel("cuda")
def _mel_power_staged_cuda(xs, ct, mel2t, b, g):
    r = ct.shape[0] if ct.dim() == 3 else -1
    _check_constants(ct, mel2t, r, xs.device)
    np_, fp = ct.shape[1], ct.shape[2]
    if tuple(xs.shape) != (r, b * g, fp) or xs.dtype != torch.bfloat16:
        raise ValueError(f"xs must be ({r}, {b * g}, {fp}) bf16, got {tuple(xs.shape)} {xs.dtype}")
    _check_cuda("xs", xs, xs.device)
    out = torch.empty((b, r, g, N_MELS), device=xs.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    fn = build.function("fused_mel_power", "ayt_mel_power_staged",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(xs.device):
        err = fn(xs.data_ptr(), ct.data_ptr(), mel2t.data_ptr(), out.data_ptr(),
                 b, r, g, fp, np_, _stream(xs))
    build.check_launch(err, "mel_power_staged")
    fused_mel_power.launches += 1
    return out


@torch.library.custom_op("audioyolo_tpu_torch::stage_frames_resample", mutates_args=(),
                         device_types="cpu")
def _stage_frames_resample_op(wave: torch.Tensor, wbank: torch.Tensor, wstart: torch.Tensor,
                              q: int, p: int, width: int, n_fft: int, fp: int) -> torch.Tensor:
    return stage_frames_resample_plain(wave, wbank, wstart, q, p, width, n_fft, fp)


@_stage_frames_resample_op.register_fake
def _(wave, wbank, wstart, q, p, width, n_fft, fp):
    g = resampled_frames(wave.shape[-1], q, p, n_fft)
    return wave.new_empty((1, wave.shape[0] * g, fp), dtype=torch.bfloat16)


@_stage_frames_resample_op.register_kernel("cuda")
def _stage_frames_resample_cuda(wave, wbank, wstart, q, p, width, n_fft, fp):
    if (wave.dim() not in (2, 3) or (wave.dim() == 3 and wave.shape[1] != 1)
            or wave.dtype not in (torch.float32, torch.int16) or not wave.is_contiguous()):
        raise ValueError(f"wave must be a contiguous (B, S) or (B, 1, S) float32/int16 tensor, "
                         f"got {tuple(wave.shape)} {wave.dtype}")
    runs, window = wbank.shape[0], wbank.shape[-1]
    if (wbank.dim() != 3 or wbank.shape[1] != 8 or wbank.dtype != torch.float32
            or not resample_stage_fits(runs, window, q, p)):
        raise ValueError(f"wbank must be (L/8, 8, U) float32 with L a multiple of p={p}, in a "
                         f"window the kernel takes, got {tuple(wbank.shape)} {wbank.dtype}")
    if tuple(wstart.shape) != (runs,) or wstart.dtype != torch.int32:
        raise ValueError(f"wstart must be ({runs},) int32, got {tuple(wstart.shape)} {wstart.dtype}")
    if fp % 8 or n_fft > fp:
        raise ValueError(f"fp={fp} must be a multiple of 8 and >= n_fft={n_fft}")
    _check_cuda("wbank", wbank, wave.device)
    _check_cuda("wstart", wstart, wave.device)
    b, s = wave.shape[0], wave.shape[-1]
    xs = torch.empty((1, b * resampled_frames(s, q, p, n_fft), fp), device=wave.device,
                     dtype=torch.bfloat16)
    if xs.numel() == 0:
        return xs
    fn = build.function("fused_mel_power", "ayt_stage_frames_resample",
                        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                        + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    with torch.cuda.device(wave.device):
        err = fn(wave.data_ptr(), int(wave.dtype == torch.int16), wbank.data_ptr(),
                 wstart.data_ptr(), xs.data_ptr(), b, s, q, p, width, runs, window, n_fft, fp,
                 _stream(wave))
    build.check_launch(err, "stage_frames_resample")
    stage_frames_resample.launches += 1
    return xs


def resample_stage_fits(runs: int, window: int, q: int, p: int) -> bool:
    """Whether the resampling staging pass takes a window bank of ``runs``
    runs of ``window`` samples for the rate pair ``q:p`` (its window bound
    and shared memory; the kernel's launcher decides, and the kernel builds
    on the first call)."""
    fn = build.function("fused_mel_power", "ayt_stage_frames_resample_fits", [ctypes.c_int] * 4)
    return bool(fn(runs, window, q, p))


def stage_frames_resample(wave: torch.Tensor, wbank: torch.Tensor, wstart: torch.Tensor,
                          q: int, p: int, width: int, n_fft: int, fp: int) -> torch.Tensor:
    """The resampling staging pass: the kernel for a CUDA tensor (each launch
    counts one in ``stage_frames_resample.launches``), the plain version for
    a CPU tensor. Arguments as in :func:`stage_frames_resample_plain`."""
    return _stage_frames_resample_op(wave, wbank, wstart, q, p, width, n_fft, fp)


stage_frames_resample.launches = 0


def stage_frames(framed: torch.Tensor, fp: int) -> torch.Tensor:
    """The staging pass: the kernel for a CUDA tensor, the plain version for
    a CPU tensor. Arguments as in :func:`stage_frames_plain`."""
    return _stage_frames_op(framed, fp)


def mel_power_staged(xs: torch.Tensor, ct: torch.Tensor, mel2t: torch.Tensor,
                     b: int, g: int) -> torch.Tensor:
    """The main pass (TMA + wgmma) on the staging pass's output: the kernel
    for a CUDA tensor, the plain version for a CPU tensor. Arguments as in
    :func:`mel_power_staged_plain`. Each launch of the kernel ends a run of
    kernel 1 and counts one in ``fused_mel_power.launches``."""
    return _mel_power_staged_op(xs, ct, mel2t, b, g)


def fused_mel_power(framed: torch.Tensor, ct: torch.Tensor,
                    mel2t: torch.Tensor) -> torch.Tensor:
    """(B, R, G, F) frames -> (B, R, G, 32) mel power in phase order.

    The two passes' ops: CUDA tensors launch the two kernels (or raise) and
    count one launch; CPU tensors take the plain versions, which compose
    :func:`fused_mel_power_plain`, whose arguments these are.
    """
    if framed.dim() != 4:
        raise ValueError(f"framed must be (B, R, G, F), got {tuple(framed.shape)}")
    b, _, g, _ = framed.shape
    return mel_power_staged(stage_frames(framed, ct.shape[-1]), ct, mel2t, b, g)


fused_mel_power.launches = 0


class MelKernelFrontend(nn.Module):
    """The bf16 constants of kernel 1, K-major, held as (non-persistent)
    buffers: ``ct`` (R, Np, Fp) = C_r^T and ``mel2t`` (32, Np) = [M; M]^T.

    Built from a combined matrix ``c`` (R, F, 2F') float32 (a
    ``FusedFrameDFT.c``, or a window-folded DFT matrix with R = 1) and a mel
    filterbank (F', n_mels). int16 frames read ``ct_i16 = bf16(c / 32768)^T``,
    the PCM dequant folded into the constant as the Pallas frontend does.
    """

    def __init__(self, c: np.ndarray, mel_fb: np.ndarray):
        super().__init__()
        c32 = np.asarray(c, np.float32)
        r, f, k2 = c32.shape
        fb = np.asarray(mel_fb, np.float32)
        if fb.shape[0] * 2 != k2:
            raise ValueError(f"mel filterbank {fb.shape} does not match 2F'={k2}")
        if fb.shape[1] != N_MELS:
            raise ValueError(f"kernel 1 computes {N_MELS} mel bands, the config asks "
                             f"for {fb.shape[1]}")
        self.n_mels = fb.shape[1]
        self.frame_len, self.n_spec = f, k2  # F and 2F' before padding
        fp, np_ = _round_up(f, K_TILE), _round_up(k2, N_TILE)
        if np_ > MAX_NP:
            raise ValueError(f"kernel 1 holds at most {MAX_NP // 2} frequency bins, the config "
                             f"gives {k2 // 2}")

        def pad_ct(a: np.ndarray) -> torch.Tensor:
            out = torch.zeros((r, np_, fp), dtype=torch.bfloat16)
            out[:, :k2, :f] = torch.from_numpy(a).to(torch.bfloat16).transpose(1, 2)
            return out

        mel2t = torch.zeros((self.n_mels, np_), dtype=torch.bfloat16)
        mel2t[:, :k2] = torch.from_numpy(np.concatenate([fb, fb], axis=0)).to(torch.bfloat16).t()
        self.register_buffer("ct", pad_ct(c32), persistent=False)
        self.register_buffer("ct_i16", pad_ct(c32 * np.float32(1.0 / 32768.0)), persistent=False)
        self.register_buffer("mel2t", mel2t, persistent=False)

    def forward(self, framed: torch.Tensor) -> torch.Tensor:
        """(B, R, G, F) float32/int16 frames -> (B, R, G, n_mels) mel power."""
        ct = self.ct_i16 if framed.dtype == torch.int16 else self.ct
        return fused_mel_power(framed, ct, self.mel2t)


class ResampleStage(nn.Module):
    """Kernel 1's staging pass with the resampler in it, for non-overlapping
    frames of ``n_fft`` samples at the output rate: the window bank of the
    resampler's float32 bank (``kernel`` (P, K), the rate pair ``q:p``, half
    width ``width``) held as (non-persistent) buffers ``wbank``
    (``wbank_i16``, scaled by 2^-15, for int16 input) and ``wstart``.
    :meth:`fits` asks the kernel's launcher, once, whether it takes the
    rate pair (its window bound and shared memory)."""

    def __init__(self, kernel: np.ndarray, width: int, q: int, p: int, n_fft: int, fp: int):
        super().__init__()
        wbank, wstart = window_bank(*polyphase_taps(kernel), q, p)
        self.q, self.p, self.width, self.n_fft, self.fp = q, p, width, n_fft, fp
        self.register_buffer("wbank", torch.from_numpy(wbank), persistent=False)
        self.register_buffer("wbank_i16", torch.from_numpy(wbank * np.float32(1.0 / 32768.0)),
                             persistent=False)
        self.register_buffer("wstart", torch.from_numpy(wstart), persistent=False)
        self._fits: Optional[bool] = None

    def fits(self) -> bool:
        """Whether the kernel takes this rate pair (asked on the first call;
        builds the kernel's library there, so call it only on the card)."""
        if self._fits is None:
            runs, _, window = self.wbank.shape
            self._fits = resample_stage_fits(runs, window, self.q, self.p)
        return self._fits

    def frames(self, s: int) -> int:
        return resampled_frames(s, self.q, self.p, self.n_fft)

    def bank(self, dtype: torch.dtype) -> torch.Tensor:
        """The window bank for input of ``dtype``."""
        return self.wbank_i16 if dtype == torch.int16 else self.wbank

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        """(B, S) or (B, 1, S) int16/float32 waveform at the input rate ->
        (1, B*G, fp) bf16 scratch for the main pass."""
        return stage_frames_resample(wave, self.bank(wave.dtype), self.wstart, self.q, self.p,
                                     self.width, self.n_fft, self.fp)

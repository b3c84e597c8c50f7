"""Kernel 1: phase-grouped DFT -> power -> mel without the spectrum in memory.

Port of ``audioyolo_tpu/ops/pallas_frontend.py`` (``fused_mel_power`` and the
host constants of ``PallasMelFrontend``). The kernel is hand-written CUDA for
Hopper (``csrc/fused_mel_power.cu``); its plain PyTorch version sits beside
it with the same two bf16 rounding points:

    spec = bf16(x) @ bf16(C_r)          fp32 accumulation
    mel  = bf16(spec * spec) @ bf16([M; M])

``fused_mel_power`` launches the kernel for a CUDA tensor and runs the plain
version only for a CPU tensor. ``fused_mel_power.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from . import build

N_MELS = 32  # the kernel's output width (NMEL in csrc/fused_mel_power.cu)
TILE = 64    # C and [M; M] are zero-padded to multiples of this


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def fused_mel_power_plain(framed: torch.Tensor, c: torch.Tensor,
                          mel2: torch.Tensor) -> torch.Tensor:
    """Plain version: bf16-rounded operands, fp32 products and sums.

    ``framed`` (B, R, G, F) float32 or int16; ``c`` (R, Fp, Np) bf16 with
    ``Fp >= F``; ``mel2`` (Np, n_mels) bf16. Returns (B, R, G, n_mels) fp32.
    """
    f = framed.shape[-1]
    x = framed.float().to(torch.bfloat16).float()
    spec = torch.matmul(x, c[:, :f].float().unsqueeze(0))
    sq = (spec * spec).to(torch.bfloat16).float()
    return torch.matmul(sq, mel2.float())


def fused_mel_power(framed: torch.Tensor, c: torch.Tensor,
                    mel2: torch.Tensor) -> torch.Tensor:
    """(B, R, G, F) frames -> (B, R, G, 32) mel power in phase order.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. Arguments as in :func:`fused_mel_power_plain`.
    """
    if not framed.is_cuda:
        return fused_mel_power_plain(framed, c, mel2)
    if framed.dim() != 4 or framed.dtype not in (torch.float32, torch.int16):
        raise ValueError(f"framed must be (B, R, G, F) float32/int16, got "
                         f"{tuple(framed.shape)} {framed.dtype}")
    b, r, g, f = framed.shape
    if c.dim() != 3 or c.shape[0] != r or c.dtype != torch.bfloat16:
        raise ValueError(f"c must be ({r}, Fp, Np) bf16, got {tuple(c.shape)} {c.dtype}")
    fp, np_ = c.shape[1], c.shape[2]
    if fp % TILE or np_ % TILE or f > fp:
        raise ValueError(f"c must be zero-padded to multiples of {TILE} with Fp >= F")
    if tuple(mel2.shape) != (np_, N_MELS) or mel2.dtype != torch.bfloat16:
        raise ValueError(f"mel2 must be ({np_}, {N_MELS}) bf16, got "
                         f"{tuple(mel2.shape)} {mel2.dtype}")
    for name, t in (("framed", framed), ("c", c), ("mel2", mel2)):
        if t.device != framed.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor "
                             f"on {framed.device}")
    out = torch.empty((b, r, g, N_MELS), device=framed.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    fn = build.function("fused_mel_power", "ayt_fused_mel_power",
                        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    with torch.cuda.device(framed.device):
        err = fn(
            framed.data_ptr(), int(framed.dtype == torch.int16), c.data_ptr(),
            mel2.data_ptr(), out.data_ptr(), b, r, g, f, fp, np_,
            torch.cuda.current_stream(framed.device).cuda_stream,
        )
    build.check_launch(err, "fused_mel_power")
    fused_mel_power.launches += 1
    return out


fused_mel_power.launches = 0


class MelKernelFrontend(nn.Module):
    """The bf16 constants of kernel 1, held as (non-persistent) buffers.

    Built from a combined matrix ``c`` (R, F, 2F') float32 (a
    ``FusedFrameDFT.c``, or a window-folded DFT matrix with R = 1) and a mel
    filterbank (F', n_mels). int16 frames read ``c_i16 = bf16(c / 32768)``,
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
        fp, np_ = _round_up(f, TILE), _round_up(k2, TILE)

        def pad_c(a: np.ndarray) -> torch.Tensor:
            out = torch.zeros((r, fp, np_), dtype=torch.bfloat16)
            out[:, :f, :k2] = torch.from_numpy(a).to(torch.bfloat16)
            return out

        mel2 = torch.zeros((np_, self.n_mels), dtype=torch.bfloat16)
        mel2[:k2] = torch.from_numpy(np.concatenate([fb, fb], axis=0)).to(torch.bfloat16)
        self.register_buffer("c", pad_c(c32), persistent=False)
        self.register_buffer("c_i16", pad_c(c32 * np.float32(1.0 / 32768.0)), persistent=False)
        self.register_buffer("mel2", mel2, persistent=False)

    def forward(self, framed: torch.Tensor) -> torch.Tensor:
        """(B, R, G, F) float32/int16 frames -> (B, R, G, n_mels) mel power."""
        c = self.c_i16 if framed.dtype == torch.int16 else self.c
        return fused_mel_power(framed, c, self.mel2)

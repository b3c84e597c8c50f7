"""int8 x int8 -> int32 GEMM, the product both int8 postures run.

In the JAX package this product is XLA's (``jnp.einsum`` and
``lax.conv_general_dilated`` with ``preferred_element_type=int32``), not a
Pallas kernel, so the port runs PyTorch's own: ``torch._int_mm``, cuBLASLt's
int8 tensor-core GEMM on the card and an exact integer product on the CPU.

On the card ``_int_mm`` takes M above 16 and K and N in multiples of 8, the
right operand column-major. Zero rows and columns change no integer sum, so
:func:`int8_mm` pads what does not fit and slices the result: the DFT's
K = 1782 becomes 1784 and N = 1002 becomes 1008; a neck convolution at B=1
has M = 10, and the 15-wide prediction convolutions K = 45, N = 15.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def int8_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The int64 product, cast to int32: what :func:`int8_mm` must equal."""
    return torch.matmul(a.long(), b.long()).int()


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact (``|sum| < 2^31``
    for K < 133 000)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"int8_mm takes 2-D int8 operands, got {a.dtype} {tuple(a.shape)} "
                         f"and {b.dtype} {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"int8_mm: inner sizes {k} and {b.shape[0]} differ")
    if not a.is_cuda:
        return torch._int_mm(a, b)
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k) or not a.is_contiguous():
        a = F.pad(a, (0, kp - k, 0, mp - m)).contiguous()
    if (kp, np_) != (k, n) or not b.t().is_contiguous():
        b = F.pad(b.t(), (0, kp - k, 0, np_ - n)).contiguous().t()
    out = torch._int_mm(a, b)
    return out if (mp, np_) == (m, n) else out[:m, :n]

"""Kernels 2 and 3: greedy 1-D interval NMS keep flags.

Port of ``audioyolo_tpu/ops/pallas_nms.py``: ``greedy_suppress_pallas_blocked``
(chunks of 16 rows, kernel 2, the one the serving path runs) and
``greedy_suppress_pallas`` (one row at a time, kernel 3), both instances of
one hand-written CUDA template (``csrc/interval_nms.cu``). The plain version
beside them is the row-by-row algorithm of
``audioyolo_tpu/ops/nms.py::_greedy_suppress_rows``; all three give
bit-identical keep flags.

The Pallas kernels took a ``valid`` mask, all true on the serving path; these
start every proposal alive. Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build


def greedy_suppress_rows(x1s: torch.Tensor, x2s: torch.Tensor,
                         iou_threshold: float) -> torch.Tensor:
    """Plain greedy NMS over score-sorted (B, K) interval bounds -> (B, K) bool.

    Row i, while alive, suppresses every later column whose IoU with it is
    strictly greater than the threshold; the IoU is
    ``inter / max(wi + w - inter, 1e-12)`` in float32.
    """
    b, k = x1s.shape
    zero = torch.zeros((), dtype=torch.float32, device=x1s.device)
    eps = torch.full((), 1e-12, dtype=torch.float32, device=x1s.device)
    thr = torch.full((), iou_threshold, dtype=torch.float32, device=x1s.device)
    w = torch.maximum(x2s - x1s, zero)
    col = torch.arange(k, device=x1s.device)[None, :]
    alive = torch.ones((b, k), dtype=torch.bool, device=x1s.device)
    for i in range(k):
        x1i, x2i = x1s[:, i:i + 1], x2s[:, i:i + 1]
        wi = torch.maximum(x2i - x1i, zero)
        inter = torch.maximum(torch.minimum(x2i, x2s) - torch.maximum(x1i, x1s), zero)
        iou = inter / torch.maximum(wi + w - inter, eps)
        suppress = alive[:, i:i + 1] & (iou > thr) & (col > i)
        alive = alive & ~suppress
    return alive


def _launch(x1s: torch.Tensor, x2s: torch.Tensor, iou_threshold: float,
            wrapper) -> torch.Tensor:
    """Launch the ``wrapper.block`` instance on CUDA tensors and count the
    launch in ``wrapper.launches``."""
    if x1s.dim() != 2 or x1s.shape != x2s.shape:
        raise ValueError(f"x1s, x2s must be matching (B, K), got "
                         f"{tuple(x1s.shape)} and {tuple(x2s.shape)}")
    for name, t in (("x1s", x1s), ("x2s", x2s)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x1s.device:
            raise ValueError(f"{name} must be contiguous float32 on {x1s.device}")
    b, k = x1s.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=x1s.device)
    if keep.numel() == 0:
        return keep
    fn = build.function("interval_nms", "ayt_greedy_suppress",
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(x1s.device):
        err = fn(x1s.data_ptr(), x2s.data_ptr(), keep.data_ptr(), b, k,
                 float(iou_threshold), wrapper.block,
                 torch.cuda.current_stream(x1s.device).cuda_stream)
    build.check_launch(err, f"greedy_suppress (block={wrapper.block})")
    wrapper.launches += 1
    return keep


def greedy_suppress_blocked(x1s: torch.Tensor, x2s: torch.Tensor,
                            iou_threshold: float) -> torch.Tensor:
    """Kernel 2 (chunks of 16 rows) on CUDA tensors; the plain version on CPU."""
    if not x1s.is_cuda:
        return greedy_suppress_rows(x1s, x2s, iou_threshold)
    return _launch(x1s, x2s, iou_threshold, greedy_suppress_blocked)


def greedy_suppress_unblocked(x1s: torch.Tensor, x2s: torch.Tensor,
                              iou_threshold: float) -> torch.Tensor:
    """Kernel 3 (one row per step) on CUDA tensors; the plain version on CPU."""
    if not x1s.is_cuda:
        return greedy_suppress_rows(x1s, x2s, iou_threshold)
    return _launch(x1s, x2s, iou_threshold, greedy_suppress_unblocked)


greedy_suppress_blocked.block, greedy_suppress_blocked.launches = 16, 0
greedy_suppress_unblocked.block, greedy_suppress_unblocked.launches = 1, 0

"""Kernels 2 and 3: greedy 1-D interval NMS keep flags.

Port of ``audioyolo_tpu/ops/pallas_nms.py``: ``greedy_suppress_pallas_blocked``
(kernel 2, the one the serving path runs) and ``greedy_suppress_pallas``
(kernel 3), both instances of one hand-written CUDA template
(``csrc/interval_nms.cu``). A mask phase spread over a thread-block cluster
writes each row's suppression words (``suppression_words_plain`` is its plain
mirror); one warp then resolves the greedy order on those bits, over chunks of
32 rows (kernel 2) or row by row (kernel 3) (``resolve_words_plain``). The
plain version beside them is the row-by-row algorithm of
``audioyolo_tpu/ops/nms.py::_greedy_suppress_rows``; all give bit-identical
keep flags. The kernels take K up to ``K_MAX`` proposals per clip.

The Pallas kernels took a ``valid`` mask, all true on the serving path; these
start every proposal alive. Both instances are one registered torch op
(``torch.ops.audioyolo_tpu_torch.greedy_suppress``); each wrapper counts its
kernel's launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

K_MAX = 2048  # the kernels' limit on proposals per clip (csrc/interval_nms.cu)


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


def suppression_words_plain(x1s: torch.Tensor, x2s: torch.Tensor,
                            iou_threshold: float) -> torch.Tensor:
    """The kernels' mask phase: (B, K) bounds -> (B, K, W) int32 words, W = ceil(K/32).

    Bit t of word w of row i is set iff j = 32w + t satisfies j > i, j < K and
    IoU(i, j) > thr, with the IoU of ``greedy_suppress_rows``. Pad columns
    (j >= K) stay unset.
    """
    b, k = x1s.shape
    nw = -(-k // 32)
    zero = torch.zeros((), dtype=torch.float32, device=x1s.device)
    eps = torch.full((), 1e-12, dtype=torch.float32, device=x1s.device)
    thr = torch.full((), iou_threshold, dtype=torch.float32, device=x1s.device)
    w = torch.maximum(x2s - x1s, zero)
    x1i, x2i, wi = x1s[:, :, None], x2s[:, :, None], w[:, :, None]
    inter = torch.maximum(torch.minimum(x2i, x2s[:, None, :]) - torch.maximum(x1i, x1s[:, None, :]),
                          zero)
    iou = inter / torch.maximum(wi + w[:, None, :] - inter, eps)
    later = torch.arange(k, device=x1s.device)[None, :] > torch.arange(k, device=x1s.device)[:, None]
    bits = (iou > thr) & later
    bits = torch.nn.functional.pad(bits, (0, 32 * nw - k)).reshape(b, k, nw, 32)
    weights = 2 ** torch.arange(32, dtype=torch.int64, device=x1s.device)
    words = (bits.to(torch.int64) * weights).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def resolve_words_plain(words: torch.Tensor, k: int, chunked: bool) -> torch.Tensor:
    """The kernels' resolve phase: (B, K, W) suppression words -> (B, K) keep flags.

    ``chunked`` (kernel 2): per chunk of 32 rows, the rows not yet removed are
    candidates; the lowest candidate is kept, its in-chunk word clears its
    victims from the candidates, and at the chunk's end every kept row's words
    join ``removed``. Otherwise (kernel 3) row by row: a row not removed is kept
    and its words join ``removed`` at once. ``keep[i] = not removed bit i``.
    """
    wn = words.cpu().numpy().astype(np.uint32)
    b, nw = wn.shape[0], wn.shape[2]
    keep = np.zeros((b, k), dtype=bool)
    for n in range(b):
        removed = np.zeros(nw, dtype=np.uint32)
        if chunked:
            for c in range(nw):
                nrows = min(32, k - 32 * c)
                cand = ~int(removed[c]) & ((1 << nrows) - 1)
                kept = []
                while cand:
                    r = (cand & -cand).bit_length() - 1
                    kept.append(32 * c + r)
                    cand &= ~(1 << r) & ~int(wn[n, 32 * c + r, c])
                for i in kept:
                    removed |= wn[n, i]
        else:
            for i in range(k):
                if not (int(removed[i >> 5]) >> (i & 31)) & 1:
                    removed |= wn[n, i]
        bits = (removed[:, None] >> np.arange(32, dtype=np.uint32)) & 1
        keep[n] = bits.reshape(-1)[:k] == 0
    return torch.from_numpy(keep).to(words.device)


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
    if k > K_MAX:
        raise ValueError(f"greedy_suppress kernels take at most K_MAX={K_MAX} proposals "
                         f"per clip, got {k}")
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


# One registered torch op for both instances (``torch.export`` keeps it as one
# node instead of unrolling the plain version's loop over K rows; a CUDA graph
# captures its launch): the plain version for a CPU tensor, the kernel of
# ``block`` rows per step for a CUDA tensor, which launches or raises.
# ``chip_smoke.py`` calls ``_greedy_suppress_cuda`` directly to time what the
# dispatcher adds to a call.
@torch.library.custom_op("audioyolo_tpu_torch::greedy_suppress", mutates_args=(),
                         device_types="cpu")
def _greedy_suppress_op(x1s: torch.Tensor, x2s: torch.Tensor, iou_threshold: float,
                        block: int) -> torch.Tensor:
    return greedy_suppress_rows(x1s, x2s, iou_threshold)


@_greedy_suppress_op.register_fake
def _(x1s, x2s, iou_threshold, block):
    return torch.empty_like(x1s, dtype=torch.bool)


@_greedy_suppress_op.register_kernel("cuda")
def _greedy_suppress_cuda(x1s, x2s, iou_threshold, block):
    wrapper = {1: greedy_suppress_unblocked, 32: greedy_suppress_blocked}.get(block)
    if wrapper is None:
        raise ValueError(f"greedy_suppress has instances of block 1 and 32, not {block}")
    return _launch(x1s, x2s, iou_threshold, wrapper)


def greedy_suppress_blocked(x1s: torch.Tensor, x2s: torch.Tensor,
                            iou_threshold: float) -> torch.Tensor:
    """Kernel 2 (chunks of 32 rows) on CUDA tensors; the plain version on CPU."""
    return _greedy_suppress_op(x1s, x2s, float(iou_threshold), greedy_suppress_blocked.block)


def greedy_suppress_unblocked(x1s: torch.Tensor, x2s: torch.Tensor,
                              iou_threshold: float) -> torch.Tensor:
    """Kernel 3 (one row per step) on CUDA tensors; the plain version on CPU."""
    return _greedy_suppress_op(x1s, x2s, float(iou_threshold), greedy_suppress_unblocked.block)


greedy_suppress_blocked.block, greedy_suppress_blocked.launches = 32, 0
greedy_suppress_unblocked.block, greedy_suppress_unblocked.launches = 1, 0

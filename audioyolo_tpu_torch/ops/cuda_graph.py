"""What the port's CUDA graphs share: static input buffers, the warm-up
and capture, and the kernels' launch counts.

:func:`warm_then_capture` runs a signature's first call eagerly on a side
stream (which warms every lazy allocation) and then captures the graph. A
captured graph launches its kernels on each replay without running the
wrappers' Python, so the capture records how many launches of each kernel
it saw (and takes them back: a capture launches nothing), and
:func:`count_replay` adds them to the counters on each replay. Used by the
trainer's ``steps_per_dispatch`` and ``infer/decode.py::
make_multi_inference_fn``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .mel_kernel import fused_mel_power, stage_frames_resample
from .nms_kernel import greedy_suppress_blocked, greedy_suppress_unblocked

COUNTERS = (fused_mel_power, greedy_suppress_blocked, greedy_suppress_unblocked,
            stage_frames_resample)


def copy_into(dst, src) -> None:
    """Fill a static buffer (a tensor or a tuple of them) from ``src``."""
    if isinstance(dst, tuple):
        for d, s_ in zip(dst, src):
            d.copy_(s_, non_blocking=True)
    else:
        dst.copy_(src, non_blocking=True)


def clone(x):
    """A tensor, a tuple or a dict of tensors, copied."""
    if isinstance(x, tuple):
        return tuple(t.clone() for t in x)
    if isinstance(x, dict):
        return {k: t.clone() for k, t in x.items()}
    return x.clone()


def signature(x) -> Tuple:
    """(shape, dtype) of a tensor, or of each tensor of a tuple: a graph's key."""
    if isinstance(x, (tuple, list)):
        return tuple(signature(a) for a in x)
    return tuple(x.shape), x.dtype


def warm_then_capture(device: torch.device, graph: "torch.cuda.CUDAGraph",
                      eager: Callable, captured: Callable):
    """Run ``eager()`` on a side stream, then capture ``captured()`` (the
    same work on the graph's static inputs) into ``graph``: ``(eager's
    output, the graph's static output, the launches of each of ``COUNTERS``
    per replay)``. The counters keep the eager run's launches only. A
    failing capture raises."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = eager()
    current.wait_stream(side)
    before = [c.launches for c in COUNTERS]
    with torch.cuda.graph(graph):
        static = captured()
    launches = tuple(c.launches - b for c, b in zip(COUNTERS, before))
    for c, b in zip(COUNTERS, before):
        c.launches = b
    return out, static, launches


def count_replay(launches: Tuple[int, ...]) -> None:
    for c, n in zip(COUNTERS, launches):
        c.launches += n

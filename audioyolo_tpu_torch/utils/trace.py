"""Named spans of the port's work, recorded only while a
``torch.profiler`` records in the process.

``with span("ayt.stream.read"): ...`` costs one read of the profiler's
enabled flag when no profiler records. While one records, the span enters
``torch.profiler.record_function(name)``, which places it in the profiler's
trace on the same clock as the device's kernels and copies (on the thread
that started the profiler; other threads' ranges reach it only when the
profiler profiles all threads), and adds its time to an aggregate per name:
the count, the total seconds and the self seconds (the total less the time
of spans nested in it on the same thread). The aggregate is kept for every
thread, so the work of a producer thread that the trace leaves out is still
counted.

The aggregate is process-wide, as the profiler is: ``totals()`` reads it and
``reset()`` clears it, so one profiled window holds exactly that window's
spans when it is reset at the window's start, or is the process's first.

A span may enclose launches (``ayt.model.*`` encloses a forward's): a range
that encloses a kernel launch or a copy on the profiled thread gets a twin
on the device's timeline under the span's name, spanning the device work
launched inside it. The twin is an annotation, not device work:
``perfbench/trace.py`` keeps it out of kernel and busy time, and reads the
device's busy time inside each span's twins (``device_spans``). The host
time counted here is the time to enqueue, not the device's.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List

import torch
import torch.autograd.profiler as _profiler

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_totals: Dict[str, List[float]] = {}
_local = threading.local()


class _Span:
    __slots__ = ("name", "t0", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(0.0)  # time of the spans nested in this one
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.record.__exit__(*exc)
        stack = _local.stack
        child = stack.pop()
        if stack:
            stack[-1] += dt
        with _lock:
            agg = _totals.setdefault(self.name, [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += dt
            agg[2] += dt - child
        return False


def span(name: str):
    """A context manager that records ``name`` while a profiler records,
    and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def totals() -> Dict[str, Dict[str, float]]:
    """``{name: {"count", "total_s", "self_s"}}`` of the spans recorded
    since the last ``reset()``: a copy."""
    with _lock:
        return {name: {"count": int(c), "total_s": t, "self_s": s}
                for name, (c, t, s) in _totals.items()}


def reset() -> None:
    with _lock:
        _totals.clear()

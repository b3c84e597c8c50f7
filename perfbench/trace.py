"""Reduction of a ``torch.profiler`` slice to device busy time, kernel time
by name, the longest idle gaps (named by what the host was doing), the
harness's spans and the device time inside the program's spans. Spans are
the harness's own ``record_function`` ranges, named ``pb.<driver>.<what>``,
around the calls it makes into the program, and the program's, named
``ayt.<...>`` (``audioyolo_tpu_torch/utils/trace.py``). A span that
encloses a launch also has a twin on the device's timeline: an annotation,
never device activity."""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Optional

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "pb.slice"
SPAN_PREFIXES = ("pb.", "ayt.")


def _union(intervals):
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _kind(e) -> str:
    """The event's activity: ``kernel`` (any device operation),
    ``user_annotation`` (a harness span on the host), ``cpu_op`` (the
    program's spans on the host among them), or ``gpu_user_annotation`` (a
    harness or program span's twin on the device's timeline)."""
    import torch

    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return "gpu_user_annotation" if e.name().startswith(SPAN_PREFIXES) else "kernel"
    return "user_annotation" if e.name().startswith("pb.") else "cpu_op"


def _inside(busy: List[List[int]], s: int, t: int) -> int:
    """Nanoseconds of the sorted, disjoint ``busy`` intervals within [s, t)."""
    i = max(bisect.bisect_right(busy, [s, s]) - 1, 0)
    got = 0
    while i < len(busy) and busy[i][0] < t:
        got += max(0, min(t, busy[i][1]) - max(s, busy[i][0]))
        i += 1
    return got


def reduce(events) -> Optional[Dict]:
    """``events``: the profiler's kineto events. None if the slice span is
    missing. Times in seconds. ``device_spans``: {program span: [seconds of
    device activity inside its device twins, twins]}, the union of the
    device's operations clipped to each twin, so idle time inside a span
    counts for nothing."""
    kinds = [_kind(e) for e in events]
    sl = [e for e, k in zip(events, kinds) if e.name() == SLICE and k == "user_annotation"]
    if not sl:
        return None
    t0, t1 = sl[0].start_ns(), sl[0].end_ns()
    dev, host, spans, twins = [], [], {}, []
    for e, kind in zip(events, kinds):
        s, t = max(e.start_ns(), t0), min(e.end_ns(), t1)
        if t <= s:
            continue
        if kind in DEVICE_ACTIVITIES:
            dev.append((s, t, e.name()))
        elif kind == "user_annotation" and e.name().startswith("pb.") and e.name() != SLICE:
            host.append((s, t, e.name(), 0))
            agg = spans.setdefault(e.name(), [0.0, 0])
            agg[0] += (t - s) * 1e-9
            agg[1] += 1
        elif kind == "cpu_op":
            host.append((s, t, e.name(), e.start_thread_id()))
        elif kind == "gpu_user_annotation" and e.name().startswith("ayt."):
            twins.append((s, t, e.name()))
    busy = _union([(s, t) for s, t, _ in dev])
    device_spans: Dict[str, List[float]] = {}
    for s, t, name in twins:
        agg = device_spans.setdefault(name, [0.0, 0])
        agg[0] += _inside(busy, s, t) * 1e-9
        agg[1] += 1
    kernels: Dict[str, List[float]] = {}
    for s, t, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (t - s) * 1e-9
        k[1] += 1
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "window_s": (t1 - t0) * 1e-9,
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "kernels": kernels,
        "spans": spans,
        "device_spans": device_spans,
        "idle_gaps": [[_label(host, (s + e) // 2), (e - s) * 1e-9] for s, e in gaps[:10]],
    }


def card(events) -> Dict:
    """The device's part of a profile of the card alone (``Tracer.card``):
    ``busy_s``, the union of its operations, and ``counts``, each
    operation's launches by name. Span twins are annotations, not work."""
    ops, counts = [], {}
    for e in events:
        if _kind(e) == "kernel":
            ops.append((e.start_ns(), e.end_ns()))
            counts[e.name()] = counts.get(e.name(), 0) + 1
    return {"busy_s": sum(t - s for s, t in _union(ops)) * 1e-9, "counts": counts}


def _label(host, t: int) -> str:
    """The innermost harness span and the outermost op of each thread that
    were running at ``t``."""
    covering = [h for h in host if h[0] <= t < h[1]]
    span = min((h for h in covering if h[2].startswith("pb.")), default=None,
               key=lambda h: h[1] - h[0])
    ops: Dict[int, tuple] = {}
    for h in covering:
        if not h[2].startswith("pb.") and (h[3] not in ops or h[0] < ops[h[3]][0]):
            ops[h[3]] = h
    parts = [span[2] if span else "pb.none"] + sorted({h[2] for h in ops.values()})
    return " | ".join(parts[:4])


def breakdown(summary: Dict) -> Dict:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[name[:160], v[0]] for name, v in ops],
            "idle_gaps": summary["idle_gaps"]}


class Tracer:
    """``slice()`` profiles its body when tracing is on (once per run);
    ``span(name)`` marks a harness span in the trace; ``card(device)``
    profiles the card alone over its body when tracing is off."""

    def __init__(self, on: bool):
        self.on = on
        self.summary: Optional[Dict] = None
        self.card_summary: Optional[Dict] = None

    @contextlib.contextmanager
    def card(self, device):
        """The device's operations over the body (``card``), read from a
        profile of the CUDA activity alone, which takes no host op; on a
        CUDA device in a run that is not traced, else nothing."""
        if self.on or device.type != "cuda":
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            yield
            torch.cuda.synchronize()
        self.card_summary = card(prof.profiler.kineto_results.events())

    @contextlib.contextmanager
    def slice(self):
        if not self.on or self.summary is not None:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            with record_function(SLICE):
                yield
                torch.cuda.synchronize()
        self.summary = reduce(prof.profiler.kineto_results.events())

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

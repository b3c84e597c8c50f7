"""Reduction of a ``torch.profiler`` slice to device busy time, kernel time
by name, the longest idle gaps (named by what the host was doing) and the
harness's spans. Spans are the harness's own ``record_function`` ranges,
named ``pb.<driver>.<what>``, around the calls it makes into the program."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "pb.slice"


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
    ``user_annotation`` (a harness span on the host), ``cpu_op``, or
    ``gpu_user_annotation`` (a harness span on the device's timeline)."""
    import torch

    span = e.name().startswith("pb.")
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return "gpu_user_annotation" if span else "kernel"
    return "user_annotation" if span else "cpu_op"


def reduce(events) -> Optional[Dict]:
    """``events``: the profiler's kineto events. None if the slice span is
    missing. Times in seconds."""
    kinds = [_kind(e) for e in events]
    sl = [e for e, k in zip(events, kinds) if e.name() == SLICE and k == "user_annotation"]
    if not sl:
        return None
    t0, t1 = sl[0].start_ns(), sl[0].end_ns()
    dev, host, spans = [], [], {}
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
    busy = _union([(s, t) for s, t, _ in dev])
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
        "idle_gaps": [[_label(host, (s + e) // 2), (e - s) * 1e-9] for s, e in gaps[:10]],
    }


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
    ``span(name)`` marks a harness span in the trace."""

    def __init__(self, on: bool):
        self.on = on
        self.summary: Optional[Dict] = None

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

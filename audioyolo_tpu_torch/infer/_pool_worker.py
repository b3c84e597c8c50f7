"""Worker entry point of :mod:`audioyolo_tpu_torch.infer.pool` (port of
``audioyolo_tpu/infer/_pool_worker.py``), run as ``python -m
audioyolo_tpu_torch.infer._pool_worker`` (a module of its own, so that runpy
does not run the pool module the parent already imported).

Protocol: the first stdin line is the pool spec (the factory and the shared
``evaluate_audio`` arguments); every later line is one job, answered by one
JSON line on stdout. A factory that raises is reported in the reply to every
job, so the parent's first call raises with its message.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import time
import traceback


def _launches() -> dict:
    from ..ops.cuda_graph import COUNTERS

    return {c.__name__: c.launches for c in COUNTERS}


def _staged(mb: float):
    """``mb`` MB of random bytes (incompressible) as a numpy array."""
    import numpy as np

    return np.frombuffer(bytearray(os.urandom(int(mb * 1e6))), np.uint8)


def _copy_to(buf, device) -> None:
    """The probe's host -> device copy of ``buf``, waited for."""
    import torch

    torch.from_numpy(buf).to(device, copy=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _worker_main() -> int:
    # stdout carries the protocol; whatever else prints goes to stderr
    replies, sys.stdout = sys.stdout, sys.stderr
    spec = json.loads(sys.stdin.readline())
    sys.path.insert(0, spec["cwd"])
    try:
        mod_name, fn_name = spec["factory"].split(":")
        factory = getattr(importlib.import_module(mod_name), fn_name)
        infer_fn, frame_fn = factory(**spec["factory_kwargs"])
        failed = None
    except Exception as e:  # reported to the parent in every reply
        traceback.print_exc(file=sys.stderr)
        failed = f"factory {spec['factory']} failed: {type(e).__name__}: {e}"
    if failed is None:
        from .pool import save_rows
        from .streaming import evaluate_audio

        ek = dict(spec["eval_kwargs"])
        ek["idx2class_map"] = {int(k): v for k, v in spec["idx2class_map"].items()}
        ek["frame_fn"] = frame_fn
        device = infer_fn.device

    resampler_cache: dict = {}
    probe_buf = {}  # staged by probe_prep for probe_go
    for line in sys.stdin:
        job = json.loads(line)
        try:
            if failed is not None:
                out = {"ok": False, "error": failed}
            elif job["op"] == "ping":
                out = {"ok": True, "launches": _launches()}
            elif job["op"] == "probe":
                # time a host -> device copy of ``mb`` MB
                # (pool.py::detect_regime); a tiny copy first sets up the link
                mb = float(job.get("mb", 32.0))
                buf = _staged(mb)
                _copy_to(buf[:4], device)
                t0 = time.perf_counter()
                _copy_to(buf, device)
                out = {"ok": True, "seconds": time.perf_counter() - t0, "mb": mb}
            elif job["op"] == "probe_prep":
                # stage the buffer now, so that probe_go times only the copy
                # and the workers' copies overlap
                mb = float(job.get("mb", 32.0))
                probe_buf["mb"], probe_buf["buf"] = mb, _staged(mb)
                _copy_to(probe_buf["buf"][:4], device)
                out = {"ok": True}
            elif job["op"] == "probe_go":
                # time.time epochs compare across the pool's processes on one
                # host: the parent takes the union span [min t0, max t1]
                t0 = time.time()
                _copy_to(probe_buf.pop("buf"), device)
                t1 = time.time()
                out = {"ok": True, "t0": t0, "t1": t1, "seconds": t1 - t0,
                       "mb": probe_buf["mb"]}
            elif job["op"] == "span":
                rows = evaluate_audio(infer_fn, job["path"], "", return_rows=True,
                                      chunk_range=(job["c0"], job["c1"]),
                                      _resampler_cache=resampler_cache, **ek)
                save_rows(job["rows_out"], rows)
                out = {"ok": True, "rows_out": job["rows_out"]}
            elif job["op"] == "files":
                # one bad file does not stop the shard: its error is reported
                # after the others are written
                n_ok, errors = 0, []
                for p in job["paths"]:
                    try:
                        evaluate_audio(infer_fn, p, job["output_dir"],
                                       _resampler_cache=resampler_cache, **ek)
                        n_ok += 1
                    except Exception as e:
                        traceback.print_exc(file=sys.stderr)
                        errors.append({"path": p, "error": f"{type(e).__name__}: {e}"})
                out = {"ok": True, "n": n_ok, "errors": errors}
            else:
                out = {"ok": False, "error": f"unknown op {job['op']!r}"}
        except Exception as e:  # report, keep serving
            traceback.print_exc(file=sys.stderr)
            out = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        replies.write(json.dumps(out) + "\n")
        replies.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(_worker_main())

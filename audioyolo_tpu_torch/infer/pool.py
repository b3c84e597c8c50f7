"""Multi-process streaming pool (port of ``audioyolo_tpu/infer/pool.py``).

A pool of persistent worker processes, each with its own model and its own
device context, behind ``inference_cli --workers N``:

- a *directory* is sharded by files (each worker streams whole files through
  ``evaluate_audio`` and writes their CSVs), longest first onto the least
  loaded worker by the WAV headers;
- a *single long file* is sharded by chunk ranges
  (``evaluate_audio(chunk_range=...)``): each worker streams a disjoint span
  of ``batch_size`` windows per chunk with global clip offsets, and the parent
  concatenates the row lists and runs the global sort + RLE merge once, so
  the CSV is the single-process CSV.

The JAX package built the pool around a TPU host link that capped each
process's host -> device copies; whether N workers help on a card is what
:meth:`StreamWorkerPool.detect_regime` measures, and nothing here assumes
it.

Workers speak a JSON-lines protocol on stdin/stdout and are started as
``python -m audioyolo_tpu_torch.infer._pool_worker`` (a fresh interpreter,
never a fork of a process that may hold a CUDA context). Each rebuilds its
model from a ``factory`` spec: a ``"module:function"`` reference resolved in
the worker (with the parent's working directory on ``sys.path``), called
with ``factory_kwargs`` and returning ``(infer_fn, frame_fn_or_None)``; the
worker's device is the factory's ``device`` keyword. A worker's ``ping``
reply carries its kernels' launch counts.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Sequence

import numpy as np

_ROW_FIELDS = ("confidence", "objectness", "class_idx", "start", "end")
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def save_rows(path: str, rows: List[dict]) -> None:
    arr = {f: np.asarray([r[f] for r in rows], np.float64) for f in _ROW_FIELDS}
    np.savez(path, **arr)


def load_rows(path: str) -> List[dict]:
    z = np.load(path)
    n = len(z["start"])
    return [
        {
            "confidence": float(z["confidence"][i]),
            "objectness": float(z["objectness"][i]),
            "class_idx": int(z["class_idx"][i]),
            "start": float(z["start"][i]),
            "end": float(z["end"][i]),
        }
        for i in range(n)
    ]


class StreamWorkerPool:
    """Persistent pool of streaming-inference worker processes.

    ``factory``: ``"module:function"`` resolved inside each worker, called as
    ``factory(**factory_kwargs)`` and returning ``(infer_fn, frame_fn)``.
    ``eval_kwargs`` are the :func:`evaluate_audio` keyword arguments shared
    by all jobs (``input_sample_rate``, ``sample_duration``, ``batch_size``,
    ``idx2class_map``, optionally ``transfer``). A worker's device is the
    factory's ``device`` keyword.
    """

    def __init__(
        self,
        factory: str,
        factory_kwargs: dict,
        workers: int,
        eval_kwargs: dict,
    ):
        self.workers = int(workers)
        self.eval_kwargs = dict(eval_kwargs)
        self.regime = None  # set by detect_regime()
        spec = {
            "factory": factory,
            "factory_kwargs": factory_kwargs,
            "eval_kwargs": {k: v for k, v in eval_kwargs.items() if k != "idx2class_map"},
            # JSON keys are strings; the worker restores int keys
            "idx2class_map": {str(k): v for k, v in eval_kwargs["idx2class_map"].items()},
            "cwd": os.getcwd(),
        }
        # the package is importable in the worker wherever the parent runs
        wenv = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (_PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if p))
        self._procs = []
        for _ in range(self.workers):
            p = subprocess.Popen(
                [sys.executable, "-m", "audioyolo_tpu_torch.infer._pool_worker"],
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=sys.stderr,
                text=True,
                env=wenv,
                cwd=os.getcwd(),
            )
            p.stdin.write(json.dumps(spec) + "\n")
            p.stdin.flush()
            self._procs.append(p)

    # -- low-level protocol -------------------------------------------------

    def _submit(self, wi: int, job: dict) -> None:
        p = self._procs[wi]
        try:
            p.stdin.write(json.dumps(job) + "\n")
            p.stdin.flush()
        except BrokenPipeError as e:
            raise RuntimeError(f"stream worker {wi} died (see stderr above)") from e

    def _recv(self, wi: int) -> dict:
        line = self._procs[wi].stdout.readline()
        if not line:
            raise RuntimeError(f"stream worker {wi} died (see stderr above)")
        msg = json.loads(line)
        if not msg.get("ok"):
            raise RuntimeError(f"stream worker {wi} failed: {msg.get('error')}")
        return msg

    def _recv_all(self, live: Sequence[int]) -> List[dict]:
        """One reply per listed worker, every pending reply drained before
        raising: the protocol has no job ids, so a reply left queued would
        answer the next job on a reused pool."""
        msgs, first_err = [], None
        for wi in live:
            try:
                msgs.append(self._recv(wi))
            except Exception as e:
                msgs.append(None)
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return msgs

    def warmup(self) -> List[Dict[str, int]]:
        """Block until every worker has built its model (a ``ping`` each);
        returns each worker's kernel launch counts so far
        (``{wrapper name: launches}``)."""
        for wi in range(self.workers):
            self._submit(wi, {"op": "ping"})
        return [m["launches"] for m in self._recv_all(range(self.workers))]

    def detect_regime(self, mb: float = 32.0) -> dict:
        """Measure whether the host -> device copy rate is per process or
        shared *right now*, and size the active worker set to match.

        One worker copies ``mb`` MB alone, then all workers copy at once
        (each first stages its buffer, ``probe_prep``, so that the copies
        of ``probe_go`` overlap); the aggregate rate over the solo rate
        estimates how many workers the link feeds, and ``evaluate_file``
        shards over that many. Returns (and stores on ``self.regime``)
        ``solo_mbps``, ``aggregate_mbps``, ``active_workers`` and ``regime``
        ("per-process" | "global" | "partial" | "single").
        """
        if self.workers == 1:
            self.regime = {
                "regime": "single", "active_workers": 1,
                "solo_mbps": None, "aggregate_mbps": None,
            }
            return self.regime
        self._submit(0, {"op": "probe", "mb": mb})
        solo = mb / max(self._recv(0)["seconds"], 1e-9)
        for wi in range(self.workers):
            self._submit(wi, {"op": "probe_prep", "mb": mb})
        self._recv_all(range(self.workers))
        for wi in range(self.workers):
            self._submit(wi, {"op": "probe_go"})
        msgs = self._recv_all(range(self.workers))
        # the aggregate rate over the union span of the copies (time.time
        # epochs compare across the processes of one host); stagger only
        # makes the estimate more conservative
        span = max(m["t1"] for m in msgs) - min(m["t0"] for m in msgs)
        agg = self.workers * mb / max(span, 1e-9)
        effective = max(1, min(self.workers, int(round(agg / max(solo, 1e-9)))))
        regime = ("per-process" if effective >= self.workers
                  else "global" if effective <= 1 else "partial")
        # a shared link keeps 2 workers: host decode still overlaps the copies
        self.regime = {
            "regime": regime,
            "active_workers": effective if effective > 1 else min(2, self.workers),
            "solo_mbps": round(solo, 1),
            "aggregate_mbps": round(agg, 1),
        }
        return self.regime

    # -- high-level API -----------------------------------------------------

    def evaluate_file(self, audio_filepath: str, output_dir: str) -> str:
        """Shard one long file across the pool by chunk ranges; returns the
        CSV path. The rows and the CSV are the single-process
        :func:`evaluate_audio`'s (global sort + RLE merge, once, here)."""
        from ..data.wavio import read_wav_info
        from .streaming import write_rows_csv

        ek = self.eval_kwargs
        # evaluate_audio counts chunks at the file's native rate; counting
        # them at the model rate would drop a resampled file's tail
        og_rate, total_frames, _ = read_wav_info(audio_filepath)
        sample_size = int(ek["sample_duration"] * og_rate)
        n_chunks = max(1, -(-total_frames // (ek["batch_size"] * sample_size)))
        n_active = self.regime["active_workers"] if self.regime else self.workers
        n_w = min(n_active, n_chunks)
        # contiguous spans, the remainder spread over the first workers
        base, extra = divmod(n_chunks, n_w)
        spans, c = [], 0
        for i in range(n_w):
            n = base + (1 if i < extra else 0)
            spans.append((c, c + n))
            c += n
        tmp = tempfile.mkdtemp(prefix="ayt_pool_")
        for wi, (c0, c1) in enumerate(spans):
            self._submit(wi, {"op": "span", "path": audio_filepath, "c0": c0, "c1": c1,
                              "rows_out": os.path.join(tmp, f"rows{wi}.npz")})
        rows: List[dict] = []
        try:
            for msg in self._recv_all(range(n_w)):
                rows.extend(load_rows(msg["rows_out"]))
        finally:
            for wi in range(n_w):
                try:
                    os.unlink(os.path.join(tmp, f"rows{wi}.npz"))
                except OSError:
                    pass
            try:
                os.rmdir(tmp)
            except OSError:
                pass
        os.makedirs(output_dir, exist_ok=True)
        return write_rows_csv(rows, ek["idx2class_map"], audio_filepath, output_dir)

    def evaluate_dir(self, paths: Sequence[str], output_dir: str) -> int:
        """Shard ``paths`` across the workers; each streams whole files and
        writes their CSVs. Returns the number of files written.

        Shards are balanced by duration (longest first onto the least loaded
        worker, from the WAV headers; an unreadable header counts 0 frames
        and its worker reports the file's error). A file that fails does not
        stop its shard: the others are written first, then ``RuntimeError``
        names every failure."""
        from ..data.wavio import read_wav_info

        def _frames(p: str) -> int:
            try:
                return read_wav_info(p)[1]
            except Exception:  # any header fault; the worker reports it for this file
                return 0

        frames = {p: _frames(p) for p in paths}
        order = sorted(paths, key=frames.__getitem__, reverse=True)
        shards: List[List[str]] = [[] for _ in range(self.workers)]
        load = [0] * self.workers
        for p in order:
            wi = load.index(min(load))
            shards[wi].append(p)
            load[wi] += frames[p]
        live = []
        for wi, shard in enumerate(shards):
            if shard:
                self._submit(wi, {"op": "files", "paths": shard, "output_dir": output_dir})
                live.append(wi)
        msgs = self._recv_all(live)
        done = sum(int(m["n"]) for m in msgs)
        errors = [e for m in msgs for e in m.get("errors", [])]
        if errors:
            detail = "; ".join(f"{e['path']}: {e['error']}" for e in errors)
            raise RuntimeError(f"{len(errors)} file(s) failed ({done} succeeded): {detail}")
        return done

    def close(self) -> None:
        for p in self._procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in self._procs:
            # a worker mid-job finishes it before it reads EOF; kill rather
            # than raise out of close() (masking the exception in flight) or
            # leave a process holding a device context behind
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

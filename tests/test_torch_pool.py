"""The port's streaming process pool (``infer/pool.py``) on the CPU: sharded
results equal the single process's, byte for byte, as the JAX package's
``tests/test_stream_pool.py`` holds its own pool.

One module-scoped pool of two workers builds its models through
``inference_cli:build_worker`` from a saved tiny ``.pt`` on ``device="cpu"``
(the factory the inference CLI's ``--workers`` uses); the single-process
reference is the same factory called in this process. A file sharded by
chunk ranges (whole, with an uneven tail, at another rate) writes the CSV of
``evaluate_audio``; a directory sharded by files writes the per-file CSVs; a
corrupt file fails after the others are written; the framed int8 posture
(``(q, scale)`` frames into the int8 DFT) writes the single process's CSV;
``detect_regime`` returns its keys; a dead worker raises.
"""

import contextlib
import copy
import json
import os
import subprocess
import threading
from unittest import mock

import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from audioyolo_tpu.config import Config as JConfig
from audioyolo_tpu.models import AudioDetectionModel as JModel

from audioyolo_tpu_torch.data.wavio import write_wav
from audioyolo_tpu_torch.inference_cli import build_worker
from audioyolo_tpu_torch.infer.pool import StreamWorkerPool, load_rows, save_rows
from audioyolo_tpu_torch.infer.streaming import evaluate_audio, write_rows_csv
from audioyolo_tpu_torch.models import state_dict_from_jax

from synth import synth_clip
from test_torch_model import _randomize

FACTORY = "audioyolo_tpu_torch.inference_cli:build_worker"
CLASSES = {0: "tone", 1: "beep"}
EVAL_KWARGS = dict(input_sample_rate=8000, sample_duration=4.0, batch_size=2,
                   idx2class_map=CLASSES)


WORKER_TIMEOUT_S = 120
_MODULE_WORKERS = []  # the module pool's processes, watched by every test


@contextlib.contextmanager
def workers_killed_after(seconds=WORKER_TIMEOUT_S, watched=()):
    """Kill the processes started inside the block, and ``watched``, once
    it has run ``seconds``: a hung worker then reads as a dead one and its
    pool raises, so no test waits on a worker for longer."""
    started = list(watched)
    real = subprocess.Popen

    def popen(*args, **kwargs):
        proc = real(*args, **kwargs)
        started.append(proc)
        return proc

    timer = threading.Timer(seconds, lambda: [p.kill() for p in started])
    timer.start()
    try:
        with mock.patch.object(subprocess, "Popen", popen):
            yield
    finally:
        timer.cancel()


@pytest.fixture(autouse=True)
def _watchdog():
    with workers_killed_after(watched=_MODULE_WORKERS):
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny config (and its ``frontend_precision: int8`` twin), a class
    map and one seeded ``.pt``: the factory's arguments."""
    from conftest import TINY_CFG

    base = tmp_path_factory.mktemp("pool")
    raw = copy.deepcopy(TINY_CFG)
    jm = JModel.from_config(raw, num_classes=2)
    v = _randomize(jax.jit(lambda r, x: jm.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(5), jnp.zeros((1, 1, JConfig(raw).clip_samples))), seed=6)
    torch.save(state_dict_from_jax(v), base / "m.pt")
    (base / "class_map.json").write_text(json.dumps({str(k): c for k, c in CLASSES.items()}))
    (base / "cfg.yaml").write_text(yaml.safe_dump(raw))
    raw["tpu_config"]["frontend_precision"] = "int8"
    (base / "int8.yaml").write_text(yaml.safe_dump(raw))
    kw = dict(config=str(base / "cfg.yaml"), model_path=str(base / "m.pt"),
              class_map_path=str(base / "class_map.json"), iou_threshold=0.1,
              conf_threshold=0.05, device="cpu")
    return base, kw


@pytest.fixture(scope="module")
def pool(files):
    _, kw = files
    with workers_killed_after():
        p = StreamWorkerPool(FACTORY, kw, workers=2, eval_kwargs=EVAL_KWARGS)
        launches = p.warmup()
    _MODULE_WORKERS.extend(p._procs)
    assert launches == [{"fused_mel_power": 0, "greedy_suppress_blocked": 0,
                         "greedy_suppress_unblocked": 0, "stage_frames_resample": 0}] * 2
    yield p
    p.close()


def _long_wav(path, seconds, seed, rate=8000):
    events = [(2.0 + 6 * i, 4.5 + 6 * i, ["tone", "beep"][i % 2])
              for i in range(int(seconds // 6) - 1)]
    write_wav(path, synth_clip(rate, seconds, events, seed=seed), rate)


def _read(path):
    with open(path) as f:
        return f.read()


def _single_csv(kw, wav, out_dir, **eval_kw):
    infer_fn, frame_fn = build_worker(**kw)
    rows = evaluate_audio(infer_fn, wav, "", return_rows=True, frame_fn=frame_fn,
                          **{**EVAL_KWARGS, **eval_kw})
    assert rows
    return write_rows_csv(rows, CLASSES, wav, out_dir)


@pytest.mark.parametrize("case", ["whole", "uneven_tail", "other_rate"])
def test_pool_single_file_matches_single_process(case, pool, files, tmp_path):
    """40 s (10 windows, 5 chunks of 2), 27 s (7 windows, the last padded, 4
    chunks) and 40 s at 4 kHz (chunks counted at the file's rate and
    resampled on the device): the CSV of the in-process ``evaluate_audio``."""
    _, kw = files
    wav = str(tmp_path / f"{case}.wav")
    _long_wav(wav, 27.0 if case == "uneven_tail" else 40.0, seed=5,
              rate=4000 if case == "other_rate" else 8000)
    ref = _single_csv(kw, wav, str(tmp_path / "single"))
    got = pool.evaluate_file(wav, str(tmp_path / "pooled"))
    assert _read(got) == _read(ref)


def test_pool_directory_matches_per_file(pool, files, tmp_path):
    _, kw = files
    adir = tmp_path / "clips"
    adir.mkdir()
    paths = []
    for i, dur in enumerate([10.0, 14.0, 9.0]):
        p = str(adir / f"f{i}.wav")
        _long_wav(p, dur, seed=20 + i)
        paths.append(p)
    refs = [_single_csv(kw, p, str(tmp_path / "single")) for p in paths]
    assert pool.evaluate_dir(paths, str(tmp_path / "pooled")) == 3
    for i, ref in enumerate(refs):
        assert _read(os.path.join(tmp_path, "pooled", "clips", f"f{i}_results.csv")) == _read(ref)


def test_pool_directory_corrupt_file_isolated(pool, tmp_path):
    """One unreadable file does not stop its worker's shard: the readable
    files are written first, then the failure is raised."""
    adir = tmp_path / "mixed"
    adir.mkdir()
    good = []
    for i in range(3):
        p = str(adir / f"g{i}.wav")
        _long_wav(p, 9.0 + i, seed=40 + i)
        good.append(p)
    bad = str(adir / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"RIFFgarbage-not-a-wav")
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="1 file\\(s\\) failed \\(3 succeeded\\).*bad.wav"):
        pool.evaluate_dir(good + [bad], out)
    for i in range(3):
        assert os.path.isfile(os.path.join(out, "mixed", f"g{i}_results.csv"))


def test_pool_framed_int8_matches_single_process(files, tmp_path):
    """``--framed_input --transfer int8`` under ``frontend_precision: int8``:
    the quantizing framer's ``(q, scale)`` frames; the pooled chunk-sharded
    CSV is the in-process one."""
    base, kw = files
    kw = dict(kw, config=str(base / "int8.yaml"), framed_input=True, transfer="int8")
    wav = str(tmp_path / "long.wav")
    _long_wav(wav, 40.0, seed=31)
    ref = _single_csv(kw, wav, str(tmp_path / "single"), transfer="int8")
    with StreamWorkerPool(FACTORY, kw, workers=2,
                          eval_kwargs=dict(EVAL_KWARGS, transfer="int8")) as p:
        got = p.evaluate_file(wav, str(tmp_path / "pooled"))
    assert _read(got) == _read(ref)


def test_pool_detect_regime(pool):
    regime = pool.detect_regime(mb=2.0)
    assert regime is pool.regime
    assert set(regime) == {"regime", "active_workers", "solo_mbps", "aggregate_mbps"}
    assert regime["regime"] in ("per-process", "global", "partial")
    assert 1 <= regime["active_workers"] <= pool.workers
    assert regime["solo_mbps"] > 0 and regime["aggregate_mbps"] > 0
    pool.regime = None  # the later tests shard over every worker


def test_rows_round_trip(tmp_path):
    rows = [{"confidence": 0.5, "objectness": 0.25, "class_idx": 1, "start": 1.5, "end": 2.0},
            {"confidence": 0.75, "objectness": 0.5, "class_idx": 0, "start": 0.0, "end": 0.5}]
    save_rows(str(tmp_path / "r.npz"), rows)
    assert load_rows(str(tmp_path / "r.npz")) == rows
    save_rows(str(tmp_path / "e.npz"), [])
    assert load_rows(str(tmp_path / "e.npz")) == []


def test_pool_dead_worker_raises(pool, tmp_path):
    """A worker that is gone raises ``RuntimeError``, whether the job is
    written to it or its reply is awaited (the module's last test: the pool
    is not used after it)."""
    wav = str(tmp_path / "w.wav")
    _long_wav(wav, 20.0, seed=7)
    pool._procs[1].kill()
    pool._procs[1].wait(timeout=30)
    with pytest.raises(RuntimeError, match="stream worker 1 died"):
        pool.evaluate_file(wav, str(tmp_path / "out"))

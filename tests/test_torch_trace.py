"""The port's spans (``utils/trace.py``) in the streaming path, on the CPU:
recorded only under a profiler, counted per batch and per chunk, the
dispatching thread's three side by side in the profiler's trace, and the
CSVs the same with and without a profiler."""

import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from audioyolo_tpu_torch.data.wavio import write_wav
from audioyolo_tpu_torch.infer.streaming import evaluate_audio, evaluate_files_batched
from audioyolo_tpu_torch.utils import trace

RATE, DUR, BATCH = 8000, 1.0, 4
SECONDS = (4.0, 6.0, 8.5)  # 4 + 6 + 9 windows: 19, in 5 batches, the last of 3
KW = dict(input_sample_rate=RATE, sample_duration=DUR, batch_size=BATCH,
          idx2class_map={0: "tone", 1: "beep"})
CALLER = ("ayt.stream.wait_input", "ayt.stream.wait_device", "ayt.stream.drain")


def _stub_infer(x):
    """(B, 128, 6) packed rows from the clips: one row per clip whose class
    and centre follow the clip's audio, so the CSVs hold rows."""
    x = x.float().reshape(x.shape[0], -1)
    out = torch.zeros(x.shape[0], 128, 6)
    out[:, 0, 0] = out[:, 0, 1] = 0.9
    out[:, 0, 2] = (x.mean(dim=1) > 0).float()
    out[:, 0, 3] = 0.25 + 0.5 * (x.abs().mean(dim=1) / 32768.0)
    out[:, 0, 4] = 0.2
    out[:, 0, 5] = 1.0
    return out


_stub_infer.device = torch.device("cpu")


@pytest.fixture
def wavs(tmp_path):
    rng = np.random.default_rng(7)
    paths = []
    for i, s in enumerate(SECONDS):
        p = str(tmp_path / "audio" / f"f{i}.wav")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        write_wav(p, (rng.standard_normal((1, int(s * RATE))) * 0.1 + 0.05 * (-1) ** i)
                  .astype(np.float32), RATE)
        paths.append(p)
    return paths


def _csvs(out_dir):
    found = {}
    for root, _, names in os.walk(out_dir):
        for n in names:
            with open(os.path.join(root, n), "rb") as f:
                found[n] = f.read()
    return found


def test_no_profiler_records_nothing(wavs, tmp_path):
    trace.reset()
    evaluate_files_batched(_stub_infer, wavs, str(tmp_path / "out"), **KW)
    assert trace.totals() == {}


def test_counts_nesting_and_csvs_under_a_profiler(wavs, tmp_path):
    evaluate_files_batched(_stub_infer, wavs, str(tmp_path / "plain"), **KW)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.caller"):
            torch.zeros(1) + 1  # an op that marks the calling thread
        evaluate_files_batched(_stub_infer, wavs, str(tmp_path / "traced"), **KW)
    got = trace.totals()
    counts = {k: v["count"] for k, v in got.items()}
    # mono PCM16 files: one native read (a direct one), stack, wait and
    # drain a batch; the producer's end-of-stream marker takes one more wait
    # for input; no pinned block on the CPU
    assert counts == {"ayt.stream.read": 5, "ayt.stream.read_direct": 5,
                      "ayt.stream.stack": 5, "ayt.stream.wait_input": 6,
                      "ayt.stream.wait_device": 5, "ayt.stream.drain": 5}
    for v in got.values():
        assert 0.0 <= v["self_s"] <= v["total_s"]

    events = prof.profiler.kineto_results.events()
    caller_tid = {e.start_thread_id() for e in events if e.name() == "test.caller"}
    mine = [e for e in events if e.name() in CALLER]
    assert {e.name() for e in mine} == set(CALLER)
    assert {e.start_thread_id() for e in mine} == caller_tid
    spans = sorted((e.start_ns(), e.end_ns()) for e in mine)
    assert len(spans) == 16
    for (s0, e0), (s1, e1) in zip(spans, spans[1:]):
        assert e0 <= s1  # side by side: none encloses another

    assert _csvs(tmp_path / "traced") == _csvs(tmp_path / "plain")
    assert any(b.count(b"\n") > 1 for b in _csvs(tmp_path / "plain").values())

    trace.reset()
    assert trace.totals() == {}


def test_one_file_path_counts_chunks(wavs, tmp_path):
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        rows = evaluate_audio(_stub_infer, wavs[2], str(tmp_path), return_rows=True, **KW)
    counts = {k: v["count"] for k, v in trace.totals().items()}
    trace.reset()
    assert len(rows) == 9  # one row a window of the 8.5 s file
    # 9 windows in chunks of 4: 3 chunks, each read, stacked and drained once
    assert counts == {"ayt.stream.read": 3, "ayt.stream.stack": 3,
                      "ayt.stream.wait_input": 4, "ayt.stream.wait_device": 3,
                      "ayt.stream.drain": 3}


def test_self_time_leaves_out_nested_spans_of_its_own_thread():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer"):
            with trace.span("inner"):
                time.sleep(0.02)
            other = threading.Thread(target=lambda: trace.span("elsewhere").__enter__()
                                     .__exit__(None, None, None))
            other.start()
            other.join(timeout=5.0)
    assert not other.is_alive()
    got = trace.totals()
    trace.reset()
    assert got["inner"]["total_s"] >= 0.02
    assert got["outer"]["self_s"] == pytest.approx(
        got["outer"]["total_s"] - got["inner"]["total_s"], abs=1e-9)
    assert got["elsewhere"]["count"] == 1  # another thread's span nests in nothing
    assert got["elsewhere"]["self_s"] == got["elsewhere"]["total_s"]

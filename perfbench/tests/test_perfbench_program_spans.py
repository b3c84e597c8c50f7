"""The readers of the program's spans on a synthetic aggregate, against
hand-worked values; None where a span is missing."""

import os
import subprocess
import sys

import pytest

from perfbench import harness, program_spans

ROOT = os.path.dirname(harness.HERE)

TRACE = {"window_s": 2.0}
SPANS = {
    "ayt.stream.wait_input": {"count": 9, "total_s": 1.2, "self_s": 1.2},
    "ayt.stream.wait_device": {"count": 8, "total_s": 0.1, "self_s": 0.1},
    "ayt.stream.read": {"count": 256, "total_s": 0.32, "self_s": 0.32},
    "ayt.stream.stack": {"count": 8, "total_s": 0.16, "self_s": 0.16},
    "ayt.stream.pin": {"count": 8, "total_s": 0.24, "self_s": 0.24},
    "ayt.stream.drain": {"count": 8, "total_s": 0.06, "self_s": 0.04},
}
EXPECTED = {  # 8 batches in a 2 s slice
    "input_wait_pct.batch": ("ayt.stream.wait_input", 60.0),
    "device_wait_pct.batch": ("ayt.stream.wait_device", 5.0),
    "read_ms_per_batch.batch": ("ayt.stream.read", 40.0),
    "stack_ms_per_batch.batch": ("ayt.stream.stack", 20.0),
    "pin_ms_per_batch.batch": ("ayt.stream.pin", 30.0),
    "drain_ms_per_batch.batch": ("ayt.stream.drain", 5.0),  # self time
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_a_synthetic_aggregate(metric, monkeypatch):
    monkeypatch.setattr(program_spans, "program_totals", lambda: dict(SPANS))
    assert harness.metric_reader(metric).read(TRACE, {}) == pytest.approx(EXPECTED[metric][1])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_without_its_span(metric, monkeypatch):
    span = EXPECTED[metric][0]
    monkeypatch.setattr(program_spans, "program_totals",
                        lambda: {k: v for k, v in SPANS.items() if k != span})
    assert harness.metric_reader(metric).read(TRACE, {}) is None


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_of_a_program_without_spans(metric, monkeypatch):
    monkeypatch.setattr(program_spans, "program_totals", dict)
    assert harness.metric_reader(metric).read(TRACE, {}) is None


def test_program_totals_reads_the_program():
    from audioyolo_tpu_torch.utils import trace

    trace.reset()
    assert program_spans.program_totals() == {}


def test_a_program_without_the_span_module_reads_nothing(tmp_path):
    """A port whose ``utils`` package has no ``trace`` module, as before the
    spans: every reader gives None and none raises."""
    os.makedirs(tmp_path / "audioyolo_tpu_torch" / "utils")
    for init in ("audioyolo_tpu_torch/__init__.py", "audioyolo_tpu_torch/utils/__init__.py"):
        (tmp_path / init).write_text("")
    code = ("from perfbench import harness\n"
            f"for m in {sorted(EXPECTED)!r}:\n"
            "    assert harness.metric_reader(m).read({'window_s': 2.0}, {}) is None, m\n"
            "print('none')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "none"

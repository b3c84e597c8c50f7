"""``direct_read_pct.batch`` on synthetic aggregates: the direct reads over
the batches, and None where the program records no direct read or no
batch, or has no span module."""

import os
import subprocess
import sys

import pytest

from perfbench import harness, program_spans

ROOT = os.path.dirname(harness.HERE)
METRIC = "direct_read_pct.batch"
DRAIN = {"ayt.stream.drain": {"count": 8, "total_s": 0.06, "self_s": 0.04}}


@pytest.mark.parametrize("direct, want", [(8, 100.0), (6, 75.0), (None, None)])
def test_direct_reads_over_batches(direct, want, monkeypatch):
    spans = dict(DRAIN)
    if direct is not None:
        spans["ayt.stream.read_direct"] = {"count": direct, "total_s": 0.1, "self_s": 0.1}
    monkeypatch.setattr(program_spans, "program_totals", lambda: spans)
    got = harness.metric_reader(METRIC).read({"window_s": 2.0}, {})
    assert got == (None if want is None else pytest.approx(want))


def test_no_batch_reads_nothing(monkeypatch):
    monkeypatch.setattr(program_spans, "program_totals", lambda: {
        "ayt.stream.read_direct": {"count": 3, "total_s": 0.1, "self_s": 0.1}})
    assert harness.metric_reader(METRIC).read({"window_s": 2.0}, {}) is None


def test_a_program_without_the_span_module_reads_nothing(tmp_path):
    os.makedirs(tmp_path / "audioyolo_tpu_torch" / "utils")
    for init in ("audioyolo_tpu_torch/__init__.py", "audioyolo_tpu_torch/utils/__init__.py"):
        (tmp_path / init).write_text("")
    code = ("from perfbench import harness\n"
            f"print(harness.metric_reader({METRIC!r}).read({{'window_s': 2.0}}, {{}}))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None"

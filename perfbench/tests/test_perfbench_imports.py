"""Nothing the benchmark loads is JAX, flax or the JAX package: top-level
module names compared whole (``audioyolo_tpu_torch`` begins with
``audioyolo_tpu``), in a fresh process after a CPU set-up of each driver."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCRIPT = r"""
import sys, time, types, torch
sys.path.insert(0, {tests!r})
import conftest
from perfbench import harness, run
torch.set_num_threads(1)
for cell in ("r18-batch-mixed", "r50-batch-mixed"):
    args = types.SimpleNamespace(workload=cell, seed=3, seconds=0.0, trace=0)
    mix = conftest.tiny_mix(cell)
    ctx = harness.Context(args, mix, {{}}, conftest.tiny_config(conftest.cell_entry(cell)["config"]),
                          torch.device("cpu"), 0.0)
    harness.driver(mix["driver"]).Setup(ctx)
print(sorted(m for m in sys.modules if m.split(".")[0].startswith("audioyolo"))[:3])
print("FOUND", run.forbidden_modules())
"""


def test_no_jax_after_driver_setup():
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(
        tests=os.path.join(ROOT, "perfbench", "tests"))], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "audioyolo_tpu_torch" in out.stdout
    assert "FOUND []" in out.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    from perfbench import run

    monkeypatch.setitem(sys.modules, "audioyolo_tpu_torch_fake", sys)
    assert "audioyolo_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in run.forbidden_modules()

"""The port's int8 transfer gate (``audioyolo_tpu_torch/gate_int8_cli.py``)
on the CPU against the JAX package's ``tools/gate_int8_transfer.py`` (its
``run_split``, ``summarize`` and ``row_diff`` on ``inference.build_inference``),
on one tiny dataset (``tiny_cfg``, 4 eval clips of 4 s at 8 kHz) and one
seeded JAX checkpoint written as the JAX trainer's ``.msgpack``.

The annotated spans are stretched to the whole clip, as in
``tests/test_torch_cli.py``: the dataset reads the annotated span, and over
a zero-padded tail the MFCC pixels are rounding noise that any two
implementations read differently. The mAPs are held within 0.02, the bound
of ``test_torch_cli.py::test_evaluate_cli_int8_json_matches_jax``; the
detection counts and ``row_diff_unmatched`` are equal.
"""

import copy
import json
import os
import sys

import pytest
import yaml

import jax
import jax.numpy as jnp
from flax import serialization

from audioyolo_tpu.config import Config as JConfig
from audioyolo_tpu.models import AudioDetectionModel as JModel

from audioyolo_tpu_torch import gate_int8_cli

from synth import make_flat_dataset, save_reference_layout
from test_torch_model import _randomize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP_BOUND = 0.02


@pytest.fixture(scope="module")
def gate_setup(tmp_path_factory):
    from conftest import TINY_CFG

    base = tmp_path_factory.mktemp("gate")
    raw = copy.deepcopy(TINY_CFG)
    raw["train_config"]["annotator"] = "annotator_a"
    cfg_path = base / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    (base / "class_map.json").write_text(json.dumps({"0": "tone", "1": "beep"}))

    jm = JModel.from_config(raw, num_classes=2)
    v = _randomize(jax.jit(lambda r, x: jm.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(4), jnp.zeros((1, 1, JConfig(raw).clip_samples))), seed=17)
    model = base / "model.msgpack"
    model.write_bytes(serialization.msgpack_serialize({
        "params": serialization.to_state_dict(v["params"]),
        "batch_stats": serialization.to_state_dict(v["batch_stats"])}))

    root = base / "ds"
    ann = make_flat_dataset(str(root / "eval"), n_files=4, seed=31)
    for segs in ann.values():
        keys = sorted(segs)
        segs[keys[0]]["start"], segs[keys[-1]]["end"] = 0.0, 4.0
    save_reference_layout(str(root), ann)
    return ["--config", str(cfg_path), "--dataset_path", str(root), "--model_path", str(model),
            "--class_map", str(base / "class_map.json")]


def test_gate_json_matches_jax(gate_setup, capsys, monkeypatch):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import gate_int8_transfer
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    monkeypatch.setattr(sys, "argv", ["gate_int8_transfer.py", *gate_setup])
    gate_int8_transfer.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = gate_int8_cli.main(gate_setup + ["--device", "cpu"])
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    print("port", ours, "\njax ", ref)
    assert ours == json.loads(json.dumps(out, default=float))
    assert list(ours) == list(ref) == ["results", "row_diff_unmatched"]
    assert ours["row_diff_unmatched"] == ref["row_diff_unmatched"]
    assert [r["entry"] for r in ours["results"]] == ["int16", "int8"]
    for a, b in zip(ours["results"], ref["results"]):
        assert list(a) == list(b)
        assert a["num_detections"] == b["num_detections"] > 0
        for k in b:
            if k.startswith(("mAP", "AP50")):
                assert abs(a[k] - b[k]) <= MAP_BOUND, (a["entry"], k, a[k], b[k])


def test_gate_on_the_cpu_imports_no_jax(gate_setup, tmp_path):
    """The gate run as a module with ``--device cpu`` in a fresh process,
    with ``jax`` and ``flax`` made unimportable: it raises nothing and prints
    its JSON."""
    import subprocess

    block = tmp_path / "block"
    block.mkdir()
    for name in ("jax", "flax", "audioyolo_tpu"):
        (block / f"{name}.py").write_text(f"raise ImportError('{name} is blocked')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = f"{block}{os.pathsep}{ROOT}"
    r = subprocess.run([sys.executable, "-m", "audioyolo_tpu_torch.gate_int8_cli",
                        *gate_setup, "--device", "cpu"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert [x["entry"] for x in out["results"]] == ["int16", "int8"]
    assert all(x["num_detections"] > 0 for x in out["results"])

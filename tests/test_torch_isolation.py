"""The PyTorch port stands alone: no JAX, no flax, nothing of the JAX
package, its own native library, and no quiet fall back to the CPU."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "audioyolo_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "audioyolo_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _forbidden(module):
    return module is not None and module.split(".")[0] in FORBIDDEN


def test_no_forbidden_imports_in_sources():
    files = _port_files()
    assert len(files) > 15 and all(os.path.isfile(f) for f in files)
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and _forbidden(node.module):
                bad.append((path, node.module))
            elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
                  in ("import_module", "__import__") and node.args
                  and isinstance(node.args[0], ast.Constant) and _forbidden(str(node.args[0].value))):
                bad.append((path, node.args[0].value))
    assert not bad, bad


def test_native_library_is_the_ports_own():
    """The port's native library is built from ``audioyolo_tpu_torch/csrc/``
    into its own build directory; no port module names the root ``native/``
    directory or the JAX package's ``libayt_audio.so``."""
    import re

    from audioyolo_tpu_torch.data import native
    from audioyolo_tpu_torch.ops import build

    pkg = os.path.join(ROOT, "audioyolo_tpu_torch")
    assert build.CSRC == os.path.join(pkg, "csrc") and build.host_sources() == ["audio_io"]
    assert build.command("audio_io", "x.so")[-1] == os.path.join(pkg, "csrc", "audio_io.cpp")
    assert os.path.dirname(native.library()._name) == os.path.join(pkg, "build")
    pattern = re.compile(r"libayt_audio|[\"'/]native/|join\([^)]*[\"']native[\"']")
    bad = []
    for path in _port_files():
        with open(path) as f:
            bad += [(path, i + 1) for i, line in enumerate(f) if pattern.search(line)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import audioyolo_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'audioyolo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in set(sys.modules) - before if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(' '.join(m for m in sys.modules if m.startswith('audioyolo_tpu_torch')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    loaded = set(r.stdout.splitlines()[0].split())
    assert len(loaded) > 15
    assert {"audioyolo_tpu_torch.utils.logging", "audioyolo_tpu_torch.get_dataset_cli",
            "audioyolo_tpu_torch.gate_int8_cli", "audioyolo_tpu_torch.serve"} <= loaded


def test_entry_points_need_the_card_unless_asked(tiny_cfg):
    """Without ``device=`` every entry point means the CUDA card; with no
    card present each raises instead of running on the CPU."""
    import numpy as np
    import torch

    from audioyolo_tpu_torch import (evaluate_cli, export_cli, gate_int8_cli, get_dataset_cli,
                                     inference_cli, serve)
    from audioyolo_tpu_torch.config import Config
    from audioyolo_tpu_torch.device import resolve_device
    from audioyolo_tpu_torch.infer import make_inference_fn
    from audioyolo_tpu_torch.infer.decode import make_multi_inference_fn
    from audioyolo_tpu_torch.infer.export import build_serving_exported, load_serving_artifact
    from audioyolo_tpu_torch.models import AudioDetectionModel
    from test_torch_pool import workers_killed_after

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = Config(tiny_cfg.to_dict())
    model = AudioDetectionModel.from_config(cfg, 2, deploy=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_inference_fn(model, model.state_dict())
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_app_state(cfg, state_dict={})
    with pytest.raises(RuntimeError, match="CUDA"):
        inference_cli.build_inference(cfg, 2, "model.pt", 0.1, 0.2)
    calib = np.zeros((1, 1, cfg.clip_samples), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):  # the int8 body and the int8 transfer
        inference_cli.build_inference(cfg, 2, "model.pt", 0.1, 0.2, int8_calib=calib,
                                      int8_input=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_inference_fn(model, model.state_dict(), int8_input=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_app_state(cfg, state_dict={}, int8_calib="calib.wav")
    with pytest.raises(RuntimeError, match="CUDA"):
        inference_cli.main(["--model_path", "model.pt", "--audio_dir", ".", "--int8",
                            "--transfer", "int8"])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_cli.main(["--dataset_path", ".", "--model_path", "model.pt", "--int8"])
    with pytest.raises(RuntimeError, match="CUDA"):
        inference_cli.main(["--model_path", "model.pt", "--audio_dir", "."])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_cli.main(["--dataset_path", ".", "--model_path", "model.pt"])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_serving_exported(model, model.state_dict(), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_serving_artifact("model.aytx")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_multi_inference_fn(model, model.state_dict(), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        export_cli.main(["--model_path", "model.pt", "--output", "model.aytx"])
    with pytest.raises(RuntimeError, match="CUDA"):
        gate_int8_cli.main(["--dataset_path", ".", "--model_path", "model.pt",
                            "--class_map", "class_map.json"])
    with pytest.raises(RuntimeError, match="CUDA"):
        get_dataset_cli.main(["--format_only", "--root", "."])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.app_state_from_args(serve.make_parser().parse_args([]))
    # the pool's workers build their models on the card and report why they cannot
    with workers_killed_after(), pytest.raises(RuntimeError, match="stream worker 0 failed.*CUDA"):
        inference_cli.main(["--workers", "2", "--model_path", "model.pt", "--audio_dir", "."])
    assert resolve_device("cpu").type == "cpu"

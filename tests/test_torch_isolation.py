"""The PyTorch port stands alone: no JAX, no flax, nothing of the JAX
package, and no quiet fall back to the CPU."""

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


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import audioyolo_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'audioyolo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in set(sys.modules) - before if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len([m for m in sys.modules if m.startswith('audioyolo_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) > 15


def test_entry_points_need_the_card_unless_asked(tiny_cfg):
    """Without ``device=`` every entry point means the CUDA card; with no
    card present each raises instead of running on the CPU."""
    import torch

    from audioyolo_tpu_torch import evaluate_cli, inference_cli, serve
    from audioyolo_tpu_torch.config import Config
    from audioyolo_tpu_torch.device import resolve_device
    from audioyolo_tpu_torch.infer import make_inference_fn
    from audioyolo_tpu_torch.models import AudioDetectionModel

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
    with pytest.raises(RuntimeError, match="CUDA"):
        inference_cli.main(["--model_path", "model.pt", "--audio_dir", "."])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_cli.main(["--dataset_path", ".", "--model_path", "model.pt"])
    assert resolve_device("cpu").type == "cpu"

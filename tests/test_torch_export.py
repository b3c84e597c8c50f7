"""The port's serving artifact (``infer/export.py``, ``export_cli.py``) and
``make_multi_inference_fn`` on the CPU.

- A program exported with ``torch.export``, saved and loaded on the CPU gives
  the live ``make_inference_fn``'s output on the same model and inputs for
  the float32 and int16 waveform entries, the framed entry, the framed int8
  ``(q, scale)`` entry and a calibrated int8 body baked in: class and valid
  equal, every other field within 1e-6 (observed: bit for bit), and it
  dispatches the live function's ATen ops, name for name.
- Against the JAX package's artifact (``build_serving_exported`` /
  ``load_serving_artifact``) on the same weights, float32 waveform entry,
  CPU: the valid rows and their classes equal, confidences within 1e-4,
  centers and widths within 1e-3, as ``test_torch_slice.py`` reads the live
  functions; ``meta.json`` has JAX's keys and layouts.
- The loader checks shapes and dtypes before the program runs, refuses a JAX
  artifact and another version, and a fresh process loads and runs an
  artifact without importing any module of ``audioyolo_tpu_torch.models``.
- ``make_multi_inference_fn``: N=3 batches in one call give what three
  single calls give (on the CPU a loop of them; on the card one CUDA graph,
  which ``chip_smoke.py`` phase 13 holds to eager calls).
"""

import copy
import json
import os
import subprocess
import sys
import zipfile
from collections import Counter

import numpy as np
import pytest
import torch
import yaml
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from audioyolo_tpu.config import Config as JConfig
from audioyolo_tpu.infer.export import build_serving_exported as j_build
from audioyolo_tpu.infer.export import load_serving_artifact as j_load
from audioyolo_tpu.infer.export import save_serving_artifact as j_save
from audioyolo_tpu.models import AudioDetectionModel as JModel
from audioyolo_tpu.models import fold_repvgg as j_fold

from audioyolo_tpu_torch import export_cli
from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.infer.decode import (make_inference_fn, make_multi_inference_fn,
                                              unpack_detections)
from audioyolo_tpu_torch.infer.export import (build_serving_exported, load_serving_artifact,
                                              save_serving_artifact)
from audioyolo_tpu_torch.models import AudioDetectionModel, fold_repvgg, state_dict_from_jax
from audioyolo_tpu_torch.models.quant import calibrate_quant, set_quant
from audioyolo_tpu_torch.ops.frontend import SpectralFrontend

from test_torch_model import _randomize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF, KEEP = 0.2, 32
CLASSES = {0: "tone", 1: "beep"}
KERNEL_POSTURE = dict(frontend_precision="default", pallas_frontend="on")


@pytest.fixture(scope="module")
def weights():
    """The tiny config and one JAX initialisation (randomised BatchNorm
    statistics): its variables and the port's train-form state dict."""
    from conftest import TINY_CFG

    raw = copy.deepcopy(TINY_CFG)
    jm = JModel.from_config(raw, num_classes=2)
    x0 = jnp.zeros((1, 1, JConfig(raw).clip_samples))
    v = jax.jit(lambda r, x: jm.init({"params": r}, x, train=False))(jax.random.PRNGKey(2), x0)
    v = _randomize(v, seed=4)
    return raw, v, state_dict_from_jax(v)


def _deploy(raw, posture):
    raw = copy.deepcopy(raw)
    raw["tpu_config"].update(posture)
    cfg = Config(raw)
    return cfg, AudioDetectionModel.from_config(cfg, 2, deploy=True)


def _wave(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, cfg.clip_samples)) * 3000).astype(np.int16)


def _export(tmp_path, model, sd, name, **kw):
    exported = build_serving_exported(model, sd, 2, conf_threshold=CONF, keep_k=KEEP,
                                      platforms=("cpu",), **kw)
    path = str(tmp_path / f"{name}.aytx")
    save_serving_artifact(path, exported, idx2class_map=CLASSES,
                          sample_duration=model.cfg.sample_duration, input_sample_rate=8000)
    return path


def _aten_ops(fn):
    """The ATen ops one call of ``fn`` dispatches, counted by name."""
    seen = Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen[str(func)] += 1
            return func(*args, **(kwargs or {}))

    with Count(), torch.inference_mode():
        fn()
    return seen


def _assert_equal_detections(got, ref):
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["class_idx"], ref["class_idx"])
    for k in ("confidence", "objectness", "center", "width"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=0, err_msg=k)
    return all(np.array_equal(got[k], ref[k]) for k in ref)


@pytest.mark.parametrize("entry", ["float32", "int16", "framed", "framed_int8", "int8_body"])
def test_artifact_equals_the_live_function(entry, weights, tmp_path):
    """Each entry exported on the CPU, saved, loaded and run against
    ``make_inference_fn`` on the same model and inputs. The loaded program
    runs the live function's ATen ops, name for name: the loader drops the
    metadata checks ``torch.export`` puts before each dtype conversion (host
    calls that launch nothing)."""
    raw, _, sd = weights
    posture = dict(KERNEL_POSTURE, frontend_precision="int8") if entry == "framed_int8" \
        else KERNEL_POSTURE
    cfg, model = _deploy(raw, posture)
    folded = fold_repvgg(sd)
    fe = SpectralFrontend(cfg)
    wav = _wave(cfg, 2, seed=31)
    kw = {}
    if entry == "float32":
        x = (wav.astype(np.float32) / 32768.0)[:, None, :]
    elif entry == "int16":
        x, kw = wav[:, None, :], dict(input_dtype="int16")
    elif entry == "framed_int8":
        x = fe.frame_host_int8(wav)
        kw = dict(input_dtype="int8", framed=True, frame_shape=tuple(x[0].shape[1:]))
    else:
        x = fe.frame_host(wav)
        kw = dict(input_dtype="int16", framed=True, frame_shape=tuple(x.shape[1:]))
    parts = x if isinstance(x, tuple) else (x,)
    if entry == "int8_body":
        model.load_state_dict(folded)
        model.eval()
        calib = torch.from_numpy(fe.frame_host(_wave(cfg, 2, 5)))
        set_quant(model, calibrate_quant(model, [calib]))
    path = _export(tmp_path, model, folded, entry, **kw)
    fn, meta = load_serving_artifact(path, device="cpu")
    live = make_inference_fn(model, folded, 0.1, CONF, keep_k=KEEP, device="cpu")
    arg = tuple(torch.from_numpy(p) for p in parts)
    ref = unpack_detections(live(arg if len(arg) > 1 else arg[0]).numpy())
    bit_equal = _assert_equal_detections(fn(x), ref)
    loaded_ops = _aten_ops(lambda: fn.program(*arg))
    assert loaded_ops == _aten_ops(lambda: live(arg if len(arg) > 1 else arg[0]))
    assert sum(loaded_ops.values()) > 100
    print(f"{entry}: artifact = live bit for bit: {bit_equal}")
    if entry == "framed_int8":
        assert meta["input_shape"] == [list(p.shape) for p in parts]
        assert meta["input_dtype"] == ["int8", "float32"]
    else:
        assert meta["input_shape"] == list(parts[0].shape)
        assert meta["input_dtype"] == str(parts[0].dtype)
    assert meta["platforms"] == ["cpu"] and meta["idx2class_map"] == CLASSES


@pytest.fixture(scope="module")
def jax_and_port(weights, tmp_path_factory):
    """The float32 waveform artifact of both packages on the same weights."""
    raw, v, sd = weights
    base = tmp_path_factory.mktemp("artifacts")
    jm = JModel.from_config(raw, num_classes=2, deploy=True)
    j_path = str(base / "jax.aytx")
    j_save(j_path, j_build(jm, j_fold(v), 2, conf_threshold=CONF, keep_k=KEEP,
                           platforms=("cpu",)),
           idx2class_map=CLASSES, sample_duration=4.0, input_sample_rate=8000)
    _, model = _deploy(raw, {})
    return j_path, _export(base, model, fold_repvgg(sd), "port")


def test_artifact_matches_the_jax_artifact(weights, jax_and_port):
    raw, _, _ = weights
    j_path, path = jax_and_port
    x = (_wave(JConfig(raw), 2, seed=41).astype(np.float32) / 32768.0)[:, None, :]
    j_fn, _ = j_load(j_path)
    fn, _ = load_serving_artifact(path, device="cpu")
    ref, out = j_fn(x), fn(x)
    v = ref["valid"]
    np.testing.assert_array_equal(out["valid"], v)
    assert v.sum() > 2
    np.testing.assert_array_equal(out["class_idx"][v], ref["class_idx"][v])
    np.testing.assert_allclose(out["confidence"][v], ref["confidence"][v], atol=1e-4)
    for k in ("center", "width"):
        np.testing.assert_allclose(out[k][v], ref[k][v], atol=1e-3, err_msg=k)


def test_meta_has_the_jax_keys_and_layouts(jax_and_port):
    j_path, path = jax_and_port
    with zipfile.ZipFile(j_path) as z:
        j_meta = json.loads(z.read("meta.json"))
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        meta = json.loads(z.read("meta.json"))
    assert names == {"meta.json", "model.cpu.pt2"}
    assert meta.pop("platforms") == ["cpu"] and j_meta.pop("platforms") == ["cpu"]
    assert meta == j_meta


def test_loader_checks_inputs_and_refuses_other_artifacts(jax_and_port, tmp_path):
    """A wrong batch size or dtype raises ``ValueError`` before the
    program's own guard; a JAX artifact, another version and a platform the
    artifact lacks are refused."""
    j_path, path = jax_and_port
    fn, meta = load_serving_artifact(path, device="cpu")
    shape = meta["input_shape"]
    with pytest.raises(ValueError, match=r"input 0 must be \[2, 1, 32000\] float32"):
        fn(np.zeros((3, *shape[1:]), np.float32))
    with pytest.raises(ValueError, match="float32, got"):
        fn(np.zeros(shape, np.int16))
    with pytest.raises(ValueError, match="takes 1 input"):
        fn((np.zeros(shape, np.float32), np.zeros(2, np.float32)))
    with pytest.raises(ValueError, match="JAX package's artifact"):
        load_serving_artifact(j_path, device="cpu")
    other = str(tmp_path / "v2.aytx")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(other, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "meta.json":
                data = json.dumps(dict(json.loads(data), artifact_version=2))
            dst.writestr(name, data)
    with pytest.raises(ValueError, match="unsupported artifact version 2"):
        load_serving_artifact(other, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_serving_artifact(path)


def test_export_entry_rules(weights):
    """JAX's rules: the int8 entry is the framed ``(q, scale)`` pair, a
    framed entry needs ``frame_shape``, platforms are cuda and cpu."""
    raw, _, sd = weights
    _, model = _deploy(raw, {})
    folded = fold_repvgg(sd)
    with pytest.raises(ValueError, match="framed=True and frame_shape"):
        build_serving_exported(model, folded, 2, input_dtype="int8", platforms=("cpu",))
    with pytest.raises(ValueError, match="framed=True and frame_shape"):
        build_serving_exported(model, folded, 2, input_dtype="int8", framed=True,
                               platforms=("cpu",))
    with pytest.raises(ValueError, match="framed export needs frame_shape"):
        build_serving_exported(model, folded, 2, framed=True, platforms=("cpu",))
    with pytest.raises(ValueError, match="platforms must be among"):
        build_serving_exported(model, folded, 2, platforms=("tpu",))


def test_fresh_process_loads_without_model_code(jax_and_port):
    """Loading and running an artifact imports the kernels' op registrations
    and no module of ``audioyolo_tpu_torch.models``."""
    _, path = jax_and_port
    code = (
        "import sys, numpy as np\n"
        "from audioyolo_tpu_torch.infer.export import load_serving_artifact\n"
        f"fn, meta = load_serving_artifact({path!r}, device='cpu')\n"
        "dets = fn(np.zeros(meta['input_shape'], np.float32))\n"
        "models = [m for m in sys.modules if m.startswith('audioyolo_tpu_torch.models')]\n"
        "print(dets['valid'].shape, models)\n"
        "sys.exit(1 if models or 'audioyolo_tpu_torch.ops.mel_kernel' not in sys.modules "
        "else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().startswith(f"(2, {KEEP}) []"), r.stdout


def test_export_cli_writes_an_artifact_that_loads(weights, tmp_path):
    """``export_cli.main`` with the JAX tool's flags: a ``.pt`` checkpoint,
    the framed int16 entry at batch 2 on the CPU; the artifact's detections
    equal the live function's on the same folded weights."""
    raw, _, sd = weights
    raw = copy.deepcopy(raw)
    raw["tpu_config"].update(KERNEL_POSTURE)
    (tmp_path / "map").mkdir()
    (tmp_path / "map" / "class_map.json").write_text(json.dumps({"0": "tone", "1": "beep"}))
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    torch.save(sd, tmp_path / "m.pt")
    out = str(tmp_path / "m.aytx")
    export_cli.main(["--config", str(cfg_path), "--model_path", str(tmp_path / "m.pt"),
                     "--class_map_path", str(tmp_path / "map" / "class_map.json"),
                     "--output", out, "--batch_size", "2", "--int16", "--framed",
                     "--conf_threshold", str(CONF), "--platforms", "cpu"])
    fn, meta = load_serving_artifact(out, device="cpu")
    assert meta["framed"] and meta["body_dtype"] == "float32" and not meta["int8_body"]
    cfg, model = _deploy(raw, {})
    frames = SpectralFrontend(cfg).frame_host(_wave(cfg, 2, seed=51))
    keep_k = raw["tpu_config"]["nms_keep"]
    live = make_inference_fn(model, fold_repvgg(sd), 0.1, CONF, keep_k=keep_k, device="cpu")
    _assert_equal_detections(fn(frames), unpack_detections(live(torch.from_numpy(frames)).numpy()))


def test_multi_inference_matches_single(weights):
    """Three batches per call give exactly what three single calls give."""
    raw, _, sd = weights
    cfg, model = _deploy(raw, KERNEL_POSTURE)
    folded = fold_repvgg(sd)
    single = make_inference_fn(copy.deepcopy(model), folded, 0.1, CONF, keep_k=KEEP,
                               device="cpu")
    multi = make_multi_inference_fn(model, folded, 3, 0.1, CONF, keep_k=KEEP, device="cpu")
    fe = SpectralFrontend(cfg)
    batches = [torch.from_numpy(fe.frame_host(_wave(cfg, 2, seed=60 + i))) for i in range(3)]
    outs = multi(batches)
    assert len(outs) == 3
    for b, o in zip(batches, outs):
        assert torch.equal(single(b), o)
    assert sum(int(o[..., 5].sum()) for o in outs) > 0
    dicts = make_multi_inference_fn(model, folded, 3, 0.1, CONF, keep_k=KEEP, packed=False,
                                    device="cpu")(batches)
    assert set(dicts[0]) == {"confidence", "objectness", "class_idx", "center", "width", "valid"}


def test_multi_inference_wrong_count_raises(weights):
    raw, _, sd = weights
    cfg, model = _deploy(raw, {})
    multi = make_multi_inference_fn(model, fold_repvgg(sd), 3, device="cpu")
    x = torch.zeros((2, 1, cfg.clip_samples))
    with pytest.raises(ValueError, match="built for 3 batches per dispatch, got 2"):
        multi([x, x])

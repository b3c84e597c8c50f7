"""The port's train CLI on the CPU, on the 8-clip dataset of
``tests/test_torch_train_loop.py`` (its ``dataset_root`` and ``_cli_raw``):
``python -m audioyolo_tpu_torch.train_cli`` end to end (the metric CSVs and
plots, ``--resume``), and each of the JAX package's training settings for
one epoch of ``train_cli.run`` (``train_prng`` with the names JAX takes;
another name raises JAX's ``ValueError``). The trainer's epochs, the
config's compute dtype and the int8 posture are in
``tests/test_torch_train_epochs.py``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

import jax

from audioyolo_tpu_torch import train_cli
from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.models import AudioDetectionModel
from audioyolo_tpu_torch.train import METRIC_KEYS, AudioDetectionLoss, TrainerPipeline

from test_torch_train_loop import LOSS_KW, SGD, _cli_raw, dataset_root  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_train_cli_end_to_end_on_the_cpu(tmp_path, dataset_root):
    """``python -m audioyolo_tpu_torch.train_cli --device cpu``: two epochs,
    then ``--resume`` to a third."""
    raw = _cli_raw(tmp_path, dataset_root, epochs=2)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    cmd = [sys.executable, "-m", "audioyolo_tpu_torch.train_cli", "--config", str(cfg_path),
           "--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Epoch 1" in r.stdout and "Model saved at epoch" in r.stdout
    model_dir = tmp_path / "model"
    assert (model_dir / "AudioDetectionModel.pt").is_file() and (model_dir / "checkpoint.pt").is_file()
    assert json.loads((tmp_path / "class_map" / "class_map.json").read_text()) == {
        "0": "beep", "1": "tone"}
    with open(tmp_path / "metrics" / "train_metrics.csv") as f:
        lines = f.read().splitlines()
    assert lines[0].split(",") == list(METRIC_KEYS) and len(lines) == 3
    for mode in ("train", "eval"):
        assert (tmp_path / "metrics" / f"{mode}_metrics_plot.jpg").stat().st_size > 0

    raw["train_config"]["epochs"] = 3
    cfg_path.write_text(yaml.safe_dump(raw))
    r = subprocess.run(cmd + ["--resume"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Resumed from epoch 2" in r.stdout and "Epoch 2" in r.stdout and "Epoch 1" not in r.stdout
    with open(tmp_path / "metrics" / "train_metrics.csv") as f:
        assert len(f.read().splitlines()) == 4


@pytest.mark.parametrize("knob", ["steps_per_dispatch", "train_remat", "train_prng",
                                  "device_cache_dataset", "data_parallel"])
def test_tpu_only_settings_raise(knob, tmp_path, dataset_root, capsys):
    """The JAX package's training settings run one epoch through
    ``train_cli.run`` on the CPU: ``steps_per_dispatch: 2`` (3 batches: one
    dispatch of 2 and one single step), ``train_remat``, ``train_prng: rbg``
    (the trainer holds the name; the masks come from its seeded generator),
    ``device_cache_dataset: on`` (both splits cached) and ``--data_parallel``
    without a ``torchrun`` environment (a world of one: no process group, the
    pad policy, rank 0 writes)."""
    raw = _cli_raw(tmp_path, dataset_root, epochs=1)
    value = {"steps_per_dispatch": 2, "train_remat": True, "train_prng": "rbg",
             "device_cache_dataset": "on"}.get(knob)
    if value is not None:
        raw["tpu_config"][knob] = value
    trainer = train_cli.run(Config(raw), device="cpu", data_parallel=knob == "data_parallel")
    out = capsys.readouterr().out
    assert trainer.step == 3 and len(trainer.train_metrics) == len(trainer.eval_metrics) == 1
    assert all(np.isfinite(m["aggregate_loss"]) for m in trainer.train_metrics + trainer.eval_metrics)
    assert os.path.isfile(trainer.saved_model_path) and os.path.isfile(
        trainer.resume_checkpoint_path)
    cached = [line for line in out.splitlines() if line.startswith("[device-cache]")]
    if knob == "steps_per_dispatch":
        assert trainer.steps_per_dispatch == 2
    elif knob == "train_remat":
        assert trainer.remat
    elif knob == "train_prng":
        assert trainer.prng_impl == "rbg"
    elif knob == "device_cache_dataset":
        assert [c.split()[1] for c in cached] == ["train", "eval"], cached
    else:
        assert trainer.group is None and trainer.world == 1
    if knob != "device_cache_dataset":  # 6 + 2 clips of 4 s at 8 kHz: auto caches both too
        assert len(cached) == 2, cached


def test_train_prng_takes_the_jax_names(tiny_cfg):
    """``threefry2x32``, ``rbg`` and ``unsafe_rbg`` are taken; another name
    raises the ``ValueError`` of ``jax.random.key``, word for word up to
    the list of names, where JAX goes on with the PRNG implementations that
    its Pallas modules register once they are imported."""
    raw = tiny_cfg.to_dict()
    model = AudioDetectionModel.from_config(Config(raw), 2)
    loss = AudioDetectionLoss(raw["anchors"], **LOSS_KW)
    for name in ("threefry2x32", "rbg", "unsafe_rbg", None):
        assert TrainerPipeline(model, loss, SGD, device="cpu", prng_impl=name).prng_impl == name
    with pytest.raises(ValueError) as ref:
        jax.random.key(0, impl="foo")
    with pytest.raises(ValueError) as ours:
        TrainerPipeline(model, loss, SGD, device="cpu", prng_impl="foo")
    ours, ref = str(ours.value), str(ref.value)
    assert ours.endswith('"threefry2x32", "rbg", "unsafe_rbg"?')
    assert ref.startswith(ours[:-1]) and ref.endswith("?")

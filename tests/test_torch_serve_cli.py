"""The port's server (``audioyolo_tpu_torch/serve.py``) on the JAX server's
command line and checkpoints, on the CPU at ``tiny_cfg``.

- ``serve.make_parser`` takes every flag of the root ``serve.py`` with its
  default and type, and adds only ``--device``.
- ``build_app_state`` answers ``/detect`` (``detect_wav_bytes``) with the
  rows of JAX ``serve.build_app_state`` for the port's ``.pt``, the JAX
  trainer's ``.msgpack`` and a reference ``.pth.tar``, with and without
  ``framed_input`` (the JAX side reads the ``.msgpack`` of the same weights
  where the port reads its ``.pt``). The rows each server passes to its
  rounding are held with the tolerances of ``tests/test_torch_slice.py::
  test_evaluate_audio_rows_match_jax`` (confidence 1e-4, start and end
  1e-3), and the rounded rows within one rounding step (0.01 s, 1e-4).
  The file is 12 s at 8 kHz, three whole 4 s windows.
- ``--model_path`` defaults to ``<train_config.model_path>/AudioDetectionModel.pt``.
"""

import argparse
import copy
import json
import sys
from types import SimpleNamespace

import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax import serialization

import serve as j_serve
from audioyolo_tpu.config import Config as JConfig
from audioyolo_tpu.models import AudioDetectionModel as JModel

from audioyolo_tpu_torch import serve
from audioyolo_tpu_torch.data.wavio import write_wav
from audioyolo_tpu_torch.models import state_dict_from_jax

from synth import synth_clip
from test_torch_model import _randomize
from torch_ref import TorchAudioDetectionNetwork, randomize_

CONF = 0.2


def _jax_parser(monkeypatch):
    """The parser the root ``serve.main`` builds (it stops before loading)."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def record(self, *a, **k):
        seen["parser"] = self
        return real(self, *a, **k)

    class Stop(Exception):
        pass

    def stop(args):
        raise Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", record)
    monkeypatch.setattr(j_serve, "build_app_state", stop)
    monkeypatch.setattr(sys, "argv", ["serve.py"])
    with pytest.raises(Stop):
        j_serve.main()
    return seen["parser"]


def _flags(parser):
    return {a.option_strings[-1]: (a.default, a.type, a.nargs, a.const)
            for a in parser._actions if a.option_strings[-1] != "--help"}


def test_parser_takes_the_jax_flags(monkeypatch):
    ref = _flags(_jax_parser(monkeypatch))
    ours = _flags(serve.make_parser())
    assert set(ours) - set(ref) == {"--device"} and ours.pop("--device")[0] == "cuda"
    assert ours == ref
    args = serve.make_parser().parse_args([])
    assert not args.framed_input and args.model_path == ""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny config file whose ``model_path`` holds the port's
    ``AudioDetectionModel.pt``; the same JAX initialisation as a ``.msgpack``;
    a reference ``.pth.tar``; a class map; a 12 s WAV at 8 kHz."""
    from conftest import TINY_CFG

    base = tmp_path_factory.mktemp("serve_cli")
    raw = copy.deepcopy(TINY_CFG)
    (base / "map").mkdir()
    (base / "map" / "class_map.json").write_text(json.dumps({"0": "tone", "1": "beep"}))
    (base / "model").mkdir()
    raw["train_config"].update(class_map_path=str(base / "map"), model_path=str(base / "model"))
    cfg = base / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(raw))

    jm = JModel.from_config(raw, num_classes=2)
    v = _randomize(jax.jit(lambda r, x: jm.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(2), jnp.zeros((1, 1, JConfig(raw).clip_samples))), seed=4)
    paths = {"msgpack": str(base / "jax.msgpack"), "pth.tar": str(base / "ref.pth.tar"),
             "pt": str(base / "model" / "AudioDetectionModel.pt")}
    with open(paths["msgpack"], "wb") as f:
        f.write(serialization.msgpack_serialize({
            "params": serialization.to_state_dict(v["params"]),
            "batch_stats": serialization.to_state_dict(v["batch_stats"])}))
    torch.save(state_dict_from_jax(v), paths["pt"])
    tmodel = TorchAudioDetectionNetwork(2, raw)
    randomize_(tmodel, seed=14)
    torch.save({"network_params": tmodel.state_dict()}, paths["pth.tar"])
    wav = base / "long.wav"
    write_wav(str(wav), synth_clip(8000, 12.0, [(1.0, 2.0, "tone"), (5.0, 6.5, "beep"),
                                                (9.0, 10.0, "tone")], seed=5), 8000)
    return dict(cfg=str(cfg), paths=paths, wav=wav.read_bytes(),
                classmap=str(base / "map" / "class_map.json"))


def _detect(module, state, body, monkeypatch):
    """``module.detect_wav_bytes``'s response and the rows it rounded."""
    seen = []
    real = module.evaluate_audio

    def record(*a, **k):
        rows = real(*a, **k)
        seen.extend(rows)
        return rows

    monkeypatch.setattr(module, "evaluate_audio", record)
    out = module.detect_wav_bytes(state, body)
    monkeypatch.setattr(module, "evaluate_audio", real)
    return out, seen


@pytest.fixture(scope="module")
def jax_responses():
    """The JAX server's answers, one state per checkpoint and posture."""
    return {}


@pytest.mark.parametrize("framed", [False, True], ids=["waveform", "framed"])
@pytest.mark.parametrize("fmt", ["pt", "msgpack", "pth.tar"])
def test_detect_rows_match_jax(fmt, framed, setup, jax_responses, monkeypatch):
    key = ("msgpack" if fmt == "pt" else fmt, framed)
    if key not in jax_responses:
        j_state = j_serve.build_app_state(SimpleNamespace(
            config=setup["cfg"], class_map_path="", model_path=setup["paths"][key[0]],
            framed_input=framed, int8_calib="", iou_threshold=0.1, conf_threshold=CONF,
            bf16=False, batch_size=2))
        jax_responses[key] = (j_state["frame_fn"] is None,
                              *_detect(j_serve, j_state, setup["wav"], monkeypatch))
    j_unframed, ref, ref_rows = jax_responses[key]
    state = serve.build_app_state(
        setup["cfg"], model_path=None if fmt == "pt" else setup["paths"][fmt], batch_size=2,
        conf_threshold=CONF, device="cpu", framed_input=framed)
    assert (state["frame_fn"] is None) == j_unframed == (not framed)
    out, rows = _detect(serve, state, setup["wav"], monkeypatch)
    assert len(rows) == len(ref_rows) > 0
    for a, b in zip(rows, ref_rows):
        assert a["class_idx"] == b["class_idx"]
        assert a["confidence"] == pytest.approx(b["confidence"], abs=1e-4)
        assert a["start"] == pytest.approx(b["start"], abs=1e-3)
        assert a["end"] == pytest.approx(b["end"], abs=1e-3)
    assert set(out) == set(ref) == {"events", "rows"}
    assert [r["class"] for r in out["rows"]] == [r["class"] for r in ref["rows"]]
    for a, b in zip(out["rows"], ref["rows"]):
        assert abs(a["start"] - b["start"]) <= 0.01 + 1e-9
        assert abs(a["end"] - b["end"]) <= 0.01 + 1e-9
        assert abs(a["confidence"] - b["confidence"]) <= 1e-4 + 1e-9
    assert [e["class"] for e in out["events"]] == [e["class"] for e in ref["events"]]


def test_model_path_defaults_to_the_trained_model(setup, tmp_path):
    state = serve.build_app_state(setup["cfg"], batch_size=2, conf_threshold=CONF,
                                  device="cpu")
    assert state["frame_fn"] is None and state["infer_fn"] is not None
    raw = yaml.safe_load(open(setup["cfg"]))
    raw["train_config"]["model_path"] = str(tmp_path / "empty")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    with pytest.raises(FileNotFoundError, match="AudioDetectionModel.pt"):
        serve.build_app_state(str(cfg), device="cpu")

"""The port's inference, evaluation and anchor CLIs on the CPU against the JAX
package's root ``inference.py``, ``evaluate_model.py`` and
``compute_anchors.py``, on the same checkpoints and inputs.

- ``inference_cli.main --device cpu`` over a directory and over one file,
  with the port's ``.pt``, a reference ``.pth.tar`` (``--ref_exact``) and the
  JAX trainer's ``.msgpack``, writes the CSVs of JAX ``inference.main`` (the
  JAX side reads the ``.msgpack`` of the same weights where the port reads
  its ``.pt``); times may round to the neighbouring 10 ms only where the rows
  agree to 1e-3 s (``tests/test_torch_infer_dir.py``).
- ``evaluate_cli.main`` prints the JSON of JAX ``evaluate_model.main``, the
  mAPs equal to 1e-6; ``event_map`` and ``event_average_precision`` are
  equal to the JAX ones on seeded detections.
- ``kmeans_1d`` equals the JAX one bit for bit, and the anchor CLI writes the
  anchors ``compute_anchors.main`` writes.
"""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax import serialization

from audioyolo_tpu.config import Config as JConfig
from audioyolo_tpu.infer.eval_map import event_average_precision as j_event_ap
from audioyolo_tpu.infer.eval_map import event_map as j_event_map
from audioyolo_tpu.models import AudioDetectionModel as JModel
from audioyolo_tpu.ops import kmeans_1d as j_kmeans_1d

from audioyolo_tpu_torch import anchors_cli, evaluate_cli, inference_cli
from audioyolo_tpu_torch.data.wavio import write_wav
from audioyolo_tpu_torch.infer.eval_map import event_average_precision, event_map
from audioyolo_tpu_torch.models import state_dict_from_jax
from audioyolo_tpu_torch.ops.kmeans import kmeans_1d

from synth import make_flat_dataset, save_reference_layout, synth_clip
from test_torch_infer_dir import _seconds
from test_torch_model import _randomize
from torch_ref import TorchAudioDetectionNetwork, randomize_


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny config file and class map; one JAX initialisation saved as the
    JAX trainer's ``.msgpack`` and as the port's ``.pt``; a reference
    ``.pth.tar``; a directory of three 8 kHz files and one 11 025 Hz file."""
    from conftest import TINY_CFG

    base = tmp_path_factory.mktemp("cli")
    raw = copy.deepcopy(TINY_CFG)
    (base / "map").mkdir()
    (base / "map" / "class_map.json").write_text(json.dumps({"0": "tone", "1": "beep"}))
    raw["train_config"].update(class_map_path=str(base / "map"), model_path=str(base / "model"))
    cfg_path = base / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))

    jm = JModel.from_config(raw, num_classes=2)
    v = _randomize(jax.jit(lambda r, x: jm.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(3), jnp.zeros((1, 1, JConfig(raw).clip_samples))), seed=12)
    msgpack_path = str(base / "jax.msgpack")
    with open(msgpack_path, "wb") as f:
        f.write(serialization.msgpack_serialize({
            "params": serialization.to_state_dict(v["params"]),
            "batch_stats": serialization.to_state_dict(v["batch_stats"]), "step": 5}))
    pt_path = str(base / "port.pt")
    torch.save(state_dict_from_jax(v), pt_path)
    tmodel = TorchAudioDetectionNetwork(2, raw)
    randomize_(tmodel, seed=14)
    pth_path = str(base / "ref.pth.tar")
    torch.save({"network_params": tmodel.state_dict()}, pth_path)

    audio = base / "audio"
    audio.mkdir()
    for i, (dur, segs) in enumerate([(4.0, [(0.5, 2.0, "tone")]), (8.0, [(1.0, 3.0, "beep")]),
                                     (12.0, [(2.0, 3.5, "tone"), (6.0, 9.0, "beep")])]):
        write_wav(str(audio / f"n{i}.wav"), synth_clip(8000, dur, segs, seed=50 + i), 8000)
    write_wav(str(audio / "other.wav"), synth_clip(11025, 8.0, [(1.0, 2.5, "beep")], seed=55),
              11025)
    return dict(cfg=str(cfg_path), raw=raw, msgpack=msgpack_path, pt=pt_path, pth=pth_path,
                audio=str(audio), classmap=str(base / "map" / "class_map.json"))


def _csvs(out_dir):
    found = {}
    for d, _, names in os.walk(out_dir):
        for n in names:
            with open(os.path.join(d, n)) as f:
                found[os.path.relpath(os.path.join(d, n), out_dir)] = f.read().splitlines()
    return found


def _assert_same_csvs(ours, ref, n_files):
    assert sorted(ours) == sorted(ref) and len(ref) == n_files
    rows = 0
    for name in ref:
        assert len(ours[name]) == len(ref[name]) and ours[name][0] == ref[name][0], name
        for a, b in zip(ours[name][1:], ref[name][1:]):
            (a0, a1, ac), (b0, b1, bc) = a.split(","), b.split(",")
            assert ac == bc, name
            for x, y in ((a0, b0), (a1, b1)):
                assert x == y or abs(_seconds(x) - _seconds(y)) == pytest.approx(0.01), name
            rows += 1
    assert rows > n_files


def _jax_main(monkeypatch, *args):
    import inference

    monkeypatch.setattr(sys, "argv", ["inference.py", *args])
    inference.main()


@pytest.mark.parametrize("case", ["dir_pt", "file_msgpack_framed", "file_pth_ref_exact"])
def test_inference_cli_writes_the_jax_csvs(case, setup, tmp_path, monkeypatch):
    common = ["--config", setup["cfg"], "--batch_size", "2"]
    if case == "dir_pt":
        where = ["--audio_dir", setup["audio"], "--num_concurrency", "2"]
        ours, theirs, n = ["--model_path", setup["pt"]], ["--model_path", setup["msgpack"]], 4
    elif case == "file_msgpack_framed":
        where = ["--audio_filepath", os.path.join(setup["audio"], "n2.wav"), "--framed_input"]
        ours = theirs = ["--model_path", setup["msgpack"]]
        n = 1
    else:
        where = ["--audio_filepath", os.path.join(setup["audio"], "n1.wav"), "--ref_exact"]
        ours = theirs = ["--model_path", setup["pth"]]
        n = 1
    _jax_main(monkeypatch, *common, *where, *theirs, "--output_dir", str(tmp_path / "jax"))
    inference_cli.main(common + where + ours + ["--output_dir", str(tmp_path / "port"),
                                                "--device", "cpu"])
    _assert_same_csvs(_csvs(tmp_path / "port"), _csvs(tmp_path / "jax"), n)


@pytest.mark.parametrize("flags,item", [(["--bf16"], "A10"), (["--int8"], "A10"),
                                        (["--transfer", "int8"], "A10"),
                                        (["--workers", "2"], "A11")])
def test_inference_cli_refuses_unported_flags(flags, item, setup):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        inference_cli.main(["--config", setup["cfg"], "--model_path", setup["pt"],
                            "--audio_dir", setup["audio"], "--device", "cpu", *flags])


def test_framed_input_raises_without_a_framer(setup, tmp_path):
    """Overlapping frames (hop < n_fft) leave the frontend without a fused
    framer: ``--framed_input`` raises instead of quietly shipping waveforms."""
    raw = copy.deepcopy(setup["raw"])
    raw["melspectrogram_config"]["hop_length"] = 100
    raw["mfcc_config"]["melkwargs"]["hop_length"] = 100
    cfg = tmp_path / "overlap.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    args = ["--config", str(cfg), "--model_path", setup["pt"], "--device", "cpu",
            "--framed_input"]
    with pytest.raises(ValueError, match="framed_input"):
        inference_cli.main(args + ["--audio_dir", setup["audio"]])
    with pytest.raises(ValueError, match="framed_input"):
        evaluate_cli.main(args + ["--dataset_path", setup["audio"]])
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        evaluate_cli.main(["--config", setup["cfg"], "--dataset_path", setup["audio"],
                           "--device", "cpu", "--int8"])


# ---- evaluation -------------------------------------------------------------


def test_event_map_equals_jax():
    rng = np.random.default_rng(5)
    gt = [(int(f), int(c), float(s), float(s) + float(w))
          for f, c, s, w in zip(rng.integers(0, 6, 40), rng.integers(0, 3, 40),
                                rng.uniform(0, 50, 40), rng.uniform(0.5, 8, 40))]
    dets = [(f, c, float(rng.uniform()), s + float(rng.normal(0, 0.4)), e + float(rng.normal(0, 0.4)))
            for f, c, s, e in gt for _ in range(2)]
    dets += [(int(f), int(c), float(p), float(s), float(s) + 2.0)
             for f, c, p, s in zip(rng.integers(0, 6, 30), rng.integers(0, 3, 30),
                                   rng.uniform(size=30), rng.uniform(0, 50, 30))]
    thr = [round(t, 2) for t in np.arange(0.5, 0.96, 0.05)]
    assert event_map(dets, gt, 4, iou_thresholds=thr) == j_event_map(dets, gt, 4, iou_thresholds=thr)
    for c in range(4):
        for t in (0.3, 0.5, 0.75):
            a, b = event_average_precision(dets, gt, c, t), j_event_ap(dets, gt, c, t)
            assert a == b or (np.isnan(a) and np.isnan(b))


def test_evaluate_cli_prints_the_jax_json(setup, tmp_path, capsys, monkeypatch):
    """Five 4 s clips whose annotated spans are stretched to the whole clip:
    the dataset reads the annotated span, and over a zero-padded tail the
    MFCC pixels are rounding noise that differs between implementations."""
    import evaluate_model

    root = str(tmp_path / "ds")
    ann = make_flat_dataset(os.path.join(root, "eval"), n_files=5, seed=21)
    for segs in ann.values():
        keys = sorted(segs)
        segs[keys[0]]["start"], segs[keys[-1]]["end"] = 0.0, 4.0
    save_reference_layout(root, ann)
    args = ["--config", setup["cfg"], "--dataset_path", root, "--model_path", setup["msgpack"],
            "--class_map_path", setup["classmap"], "--batch_size", "2"]
    monkeypatch.setattr(sys, "argv", ["evaluate_model.py", *args])
    evaluate_model.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    result = evaluate_cli.main(args + ["--device", "cpu"])
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours == json.loads(json.dumps(result, default=float))
    print(ours)
    assert list(ours) == list(ref)
    assert ours["num_ground_truth"] == ref["num_ground_truth"] > 0
    assert ours["num_detections"] == ref["num_detections"] > 0
    assert ours["AP50_per_class"] == ref["AP50_per_class"]
    for k in ref:
        if k.startswith("mAP"):
            assert ours[k] == pytest.approx(ref[k], abs=1e-6), k


# ---- anchors ------------------------------------------------------------------


@pytest.mark.parametrize("init", ["k-means++", "random"])
def test_kmeans_equals_jax_bit_for_bit(init):
    x = np.random.default_rng(3).gamma(2.0, 3.0, 500)
    a, ia = kmeans_1d(x, 9, init=init, seed=42)
    b, ib = j_kmeans_1d(x, 9, init=init, seed=42)
    assert np.array_equal(a, b) and ia == ib


def test_anchor_cli_writes_the_jax_anchors(setup, tmp_path, monkeypatch):
    import compute_anchors

    rng = np.random.default_rng(8)
    ann = {f"clip{i}": {f"seg-{j}": {"start": s, "end": s + float(rng.uniform(0.3, 9.0)),
                                     "class": "tone"}
                        for j, s in enumerate(rng.uniform(0, 50, 6))} for i in range(10)}
    ann_path = tmp_path / "annotation.json"
    ann_path.write_text(json.dumps({"annotations": {"annotator_a": ann}}))
    cfgs = {}
    for side in ("jax", "port"):
        p = tmp_path / f"{side}.yaml"
        p.write_text(yaml.safe_dump(setup["raw"]))
        cfgs[side] = str(p)
    monkeypatch.setattr(sys, "argv", ["compute_anchors.py", "--annotations_path", str(ann_path),
                                      "--config", cfgs["jax"]])
    compute_anchors.main()
    anchors_cli.main(["--annotations_path", str(ann_path), "--config", cfgs["port"]])
    ref, ours = (yaml.safe_load(open(cfgs[s]))["anchors"] for s in ("jax", "port"))
    assert ours == ref and ref != setup["raw"]["anchors"]
    assert all(len(ref[k]) == 3 for k in ("sm", "md", "lg"))
    flat = ref["sm"] + ref["md"] + ref["lg"]
    assert flat == sorted(flat)

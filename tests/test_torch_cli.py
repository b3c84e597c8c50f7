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
import shutil
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
from test_torch_pool import workers_killed_after
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


class _Rows:
    """Records the unrounded detection rows (confidence, class, start, end)
    each CSV is written from, per output file, on both packages' streaming
    modules while it is entered."""

    def __init__(self, monkeypatch):
        from audioyolo_tpu.infer import streaming as jstreaming

        from audioyolo_tpu_torch.infer import streaming

        self.rows, self.run = {}, None
        for mod in (jstreaming, streaming):
            monkeypatch.setattr(mod, "write_rows_csv", self._recorder(mod.write_rows_csv))

    def _recorder(self, write):
        def record(all_rows, idx2class_map, audio_filepath, output_dir):
            self.rows.setdefault(self.run, {})[os.path.basename(audio_filepath)] = [
                dict(r) for r in all_rows]
            return write(all_rows, idx2class_map, audio_filepath, output_dir)

        return record


def _iou(a, b):
    inter = max(0.0, min(a["end"], b["end"]) - max(a["start"], b["start"]))
    union = (a["end"] - a["start"]) + (b["end"] - b["start"]) - inter
    return inter / union if union > 0 else 0.0


GAP_FACTOR = 2.0  # the port's bf16 against JAX's own bf16-vs-float32 gap


def _flip_compare(ours, ref, conf_thr=0.2, iou_thr=0.1, tol=0.05, flip_tol=0.02):
    """Two recorded runs, file by file, as ``chip_smoke.py::_compare_rows``
    reads the card against the CPU: a row of either side is matched to an
    unmatched row of the other with its class and start and end within
    ``tol`` s. A row left unmatched is explained by a flip that a confidence
    or IoU difference of ``flip_tol`` can make: its confidence within
    ``flip_tol`` of the confidence filter's threshold, its IoU with another
    row within ``flip_tol`` of the NMS threshold, or an overlapping row of
    the other side of its class with a confidence within ``flip_tol`` (the
    NMS took the two in the other order); or by the greedy NMS's cascade: it
    overlaps an explained row of its class past the NMS threshold, which
    then suppressed it on one side and not on the other. Returns (rows,
    matched, unexplained rows, largest confidence gap of a matched pair)."""
    assert sorted(ours) == sorted(ref)
    total, matched, unexplained, dc = 0, 0, [], 0.0
    for name in ref:
        a, b = ours[name], list(ref[name])
        total += max(len(a), len(b))
        missed = []
        for r in a:
            hit = next((q for q in b if q["class_idx"] == r["class_idx"]
                        and abs(q["start"] - r["start"]) <= tol
                        and abs(q["end"] - r["end"]) <= tol), None)
            if hit is None:
                missed.append((r, ref[name]))
                continue
            b.remove(hit)
            matched += 1
            dc = max(dc, abs(hit["confidence"] - r["confidence"]))
        missed += [(r, a) for r in b]
        everyone = list(a) + list(ref[name])
        flips = [r for r, other in missed
                 if abs(r["confidence"] - conf_thr) <= flip_tol
                 or any(q is not r and abs(_iou(q, r) - iou_thr) <= flip_tol for q in everyone)
                 or any(q["class_idx"] == r["class_idx"] and _iou(q, r) > iou_thr
                        and abs(q["confidence"] - r["confidence"]) <= flip_tol for q in other)]
        rest = [r for r, _ in missed if not any(r is f for f in flips)]
        grown = True
        while grown:  # the cascade: rows that an explained row suppresses or frees
            cascade = [r for r in rest if any(f["class_idx"] == r["class_idx"]
                                              and _iou(f, r) > iou_thr for f in flips)]
            flips += cascade
            rest = [r for r in rest if not any(r is f for f in cascade)]
            grown = bool(cascade)
        unexplained += [(name, r) for r in rest]
    return total, matched, unexplained, dc


def test_inference_cli_bf16_rows_match_jax(setup, tmp_path, monkeypatch):
    """``--bf16`` serves a bfloat16 body over the directory, as JAX's
    ``inference.main --bf16`` does. The two bf16 bodies accumulate in other
    orders (a single bf16 conv of this CPU differs from JAX's in 1e-4 to
    8e-4 of its outputs by one ulp, as oneDNN, PyTorch's own kernel and a
    float32 conv of the rounded operands differ from each other: every one
    rounds once), so a confidence near the threshold or an IoU near the NMS
    threshold may flip, and the RLE merge then joins other rows: a count of
    matched CSV rows moves with the CPU (7 or 8 of 8 on two CPUs). The
    reading is the rows each CSV is written from, before the merge: every
    row of either side either finds a row of the other side with its class
    and start and end within 0.05 s, or is explained by a flip within
    ``flip_tol`` (``_flip_compare``, which also follows the NMS's cascade).
    ``flip_tol`` is 3x twice the largest confidence gap of a matched pair
    between JAX's own bf16 and float32 rows: the port's bf16
    confidences may move by ``d``, twice that gap (the bound of every bf16
    reading, ``tests/test_torch_bf16.py``), and two rows that the NMS took
    in the other order then differ by at most ``3 d`` across the sides. At
    most 5% of the rows may stay unexplained, as ``chip_smoke.py`` phase 7
    allows for the card's ``--bf16`` rows, and at least 75% must match, the
    share ``chip_smoke.py`` phase 9 asks of bf16 rows against float32 rows
    (a cascade can explain a whole chain of overlapping rows, so the share
    keeps a body that is wrong everywhere from passing). Observed on an AMX
    CPU: 43 of 48 rows matched, the 5 others one NMS swap (confidences
    9.4e-3 apart across the sides) and its cascade."""
    rec = _Rows(monkeypatch)
    args = ["--config", setup["cfg"], "--batch_size", "2", "--audio_dir", setup["audio"],
            "--num_concurrency", "2"]
    for run, flags in (("jax_bf16", ["--bf16"]), ("jax_f32", [])):
        rec.run = run
        _jax_main(monkeypatch, *args, *flags, "--model_path", setup["msgpack"],
                  "--output_dir", str(tmp_path / run))
    rec.run = "port_bf16"
    inference_cli.main(args + ["--bf16", "--model_path", setup["pt"], "--output_dir",
                               str(tmp_path / "port"), "--device", "cpu"])
    assert sorted(_csvs(tmp_path / "port")) == sorted(_csvs(tmp_path / "jax_bf16"))
    _, _, _, jax_gap = _flip_compare(rec.rows["jax_bf16"], rec.rows["jax_f32"], flip_tol=0.0)
    flip_tol = 3 * GAP_FACTOR * jax_gap
    n, hit, bad, dc = _flip_compare(rec.rows["port_bf16"], rec.rows["jax_bf16"],
                                    flip_tol=flip_tol)
    print(f"--bf16 rows: {hit}/{n} matched, {len(bad)} unexplained by a flip within "
          f"{flip_tol:.3e}; matched confidences within {dc:.3e} (JAX bf16 vs f32 {jax_gap:.3e})")
    assert len(rec.rows["jax_bf16"]) == 4 and n > 8 and 0 < jax_gap
    assert hit >= 0.75 * n and len(bad) <= 0.05 * n, bad


def _int8_cfg(setup, tmp_path):
    """The CLI config with ``frontend_precision: int8`` (the int8 DFT)."""
    raw = copy.deepcopy(setup["raw"])
    raw["tpu_config"]["frontend_precision"] = "int8"
    path = tmp_path / "int8.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.mark.parametrize("flags,item", [(["--int8"], "A10"), (["--transfer", "int8"], "A10"),
                                        (["--workers", "2"], "A11")])
def test_inference_cli_refuses_unported_flags(flags, item, setup, tmp_path, monkeypatch):
    """The A10 and A11 flags were ported: the A10 flags write the JAX
    ``inference.main`` rows with the same flags, and ``--workers 2`` (the
    streaming pool) writes the CSVs of ``--workers 1`` byte for byte.

    - ``--int8``: both packages calibrate the int8 body on the directory's
      first file and serve it. Their scales agree to 1e-5
      (``tests/test_torch_int8.py``), and an activation a float32 ulp from
      a rounding boundary takes the other int8 level, so the rows are held
      as the ``--bf16`` rows are (``_flip_compare``, at least 75% matched,
      at most 5% unexplained), with ``flip_tol`` 3x twice the largest
      confidence gap of a matched pair between JAX's own int8 rows and its
      float32 rows.
    - ``--transfer int8`` on a native-rate file: both dequantize the same
      int8 codes (``quantize_clips_int8`` is bit-equal) and run the float32
      body, so the CSVs are the float32 CSVs' (``_assert_same_csvs``); on a
      directory with a file at another rate both raise.
    - ``--framed_input --transfer int8`` under ``frontend_precision: int8``
      (the ``(q, scale)`` frames into the int8 DFT): the port rounds the mel
      product's operands to bf16 where JAX's CPU multiplies in float32
      (``tests/test_torch_frontend.py`` bounds the images), so the rows are
      held at ``_flip_compare``'s default ``flip_tol`` of 0.02, the bound
      ``chip_smoke.py`` phase 7 gives bf16 roundings. Without the int8
      posture both raise.
    - ``--workers 2`` over a directory of two native-rate files (the single
      process batches them across files, the pool's workers file by file)
      and over the 12 s file, three windows at ``--batch_size 2`` (two chunk
      ranges, one per worker); the CSVs are compared byte for byte."""
    if item == "A11":
        two = tmp_path / "two"
        two.mkdir()
        for name in ("n0.wav", "n1.wav"):
            shutil.copy(os.path.join(setup["audio"], name), two / name)
        for where in (["--audio_dir", str(two)],
                      ["--audio_filepath", os.path.join(setup["audio"], "n2.wav")]):
            out = {}
            for workers in ("1", "2"):
                out[workers] = tmp_path / f"{where[0][2:]}_{workers}"
                with workers_killed_after():
                    inference_cli.main(["--config", setup["cfg"], "--model_path", setup["pt"],
                                        "--batch_size", "2", *where, "--output_dir",
                                        str(out[workers]), "--device", "cpu", "--workers",
                                        workers])
            one, two_ = _csvs(out["1"]), _csvs(out["2"])
            assert one == two_ and len(one) == (2 if where[0] == "--audio_dir" else 1)
            assert sum(len(rows) - 1 for rows in one.values()) > 0
        return
    rec = _Rows(monkeypatch)
    common = ["--config", setup["cfg"], "--batch_size", "2"]
    one = ["--audio_filepath", os.path.join(setup["audio"], "n2.wav")]

    def both(run, args, ours=None):
        rec.run = f"jax_{run}"
        _jax_main(monkeypatch, *args, "--model_path", setup["msgpack"],
                  "--output_dir", str(tmp_path / f"jax_{run}"))
        rec.run = f"port_{run}"
        inference_cli.main((ours or args) + ["--model_path", setup["pt"], "--output_dir",
                                             str(tmp_path / f"port_{run}"), "--device", "cpu"])

    if flags == ["--int8"]:
        where = common + ["--audio_dir", setup["audio"], "--num_concurrency", "2"]
        both("int8", where + flags)
        rec.run = "jax_f32"
        _jax_main(monkeypatch, *where, "--model_path", setup["msgpack"],
                  "--output_dir", str(tmp_path / "jax_f32"))
        _, _, _, jax_gap = _flip_compare(rec.rows["jax_int8"], rec.rows["jax_f32"],
                                         flip_tol=0.0)
        flip_tol = 3 * GAP_FACTOR * jax_gap
        n, hit, bad, dc = _flip_compare(rec.rows["port_int8"], rec.rows["jax_int8"],
                                        flip_tol=flip_tol)
        print(f"--int8 rows: {hit}/{n} matched, {len(bad)} unexplained by a flip within "
              f"{flip_tol:.3e}; matched confidences within {dc:.3e} (JAX int8 vs f32 "
              f"{jax_gap:.3e})")
        assert len(rec.rows["jax_int8"]) == 4 and n > 8 and jax_gap > 0
        assert hit >= 0.75 * n and len(bad) <= 0.05 * n, bad
        return
    both("wave", common + one + flags)
    _assert_same_csvs(_csvs(tmp_path / "port_wave"), _csvs(tmp_path / "jax_wave"), 1)
    cfg8 = _int8_cfg(setup, tmp_path)
    framed = ["--config", cfg8, "--batch_size", "2", *one, "--framed_input", *flags]
    both("framed", framed)
    n, hit, bad, dc = _flip_compare(rec.rows["port_framed"], rec.rows["jax_framed"])
    print(f"--framed_input --transfer int8 rows: {hit}/{n} matched, {len(bad)} unexplained; "
          f"matched confidences within {dc:.3e}")
    assert n > 4 and hit >= 0.75 * n and len(bad) <= 0.05 * n, bad
    with pytest.raises(ValueError, match="native-rate"):
        inference_cli.main(common + ["--audio_dir", setup["audio"], "--model_path",
                                     setup["pt"], "--device", "cpu", "--output_dir",
                                     str(tmp_path / "dir"), *flags])
    with pytest.raises(ValueError, match="frontend_precision: int8"):
        inference_cli.main(common + one + ["--framed_input", "--model_path", setup["pt"],
                                           "--device", "cpu", *flags])


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
    with pytest.raises(ValueError, match="framed_input"):
        evaluate_cli.main(args + ["--dataset_path", setup["audio"], "--int8"])


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


def test_evaluate_cli_int8_json_matches_jax(setup, tmp_path, capsys, monkeypatch):
    """``--int8``, calibrated on the split's first four files in both
    packages, and the same with ``--framed_input`` under ``frontend_precision:
    int8`` (the int8 DFT's ``(q, scale)`` frames): the JSON of
    ``evaluate_model.main`` with the same flags, the ground truth equal and
    every mAP within 0.02 (``chip_smoke.py``'s MAP_GAP_BOUND: the int8 body's
    level flips and the bf16 mel product move a detection now and then)."""
    import evaluate_model

    root = str(tmp_path / "ds")
    ann = make_flat_dataset(os.path.join(root, "eval"), n_files=5, seed=21)
    for segs in ann.values():
        keys = sorted(segs)
        segs[keys[0]]["start"], segs[keys[-1]]["end"] = 0.0, 4.0
    save_reference_layout(root, ann)
    for cfg, extra in ((setup["cfg"], []), (_int8_cfg(setup, tmp_path), ["--framed_input"])):
        args = ["--config", cfg, "--dataset_path", root, "--model_path", setup["msgpack"],
                "--class_map_path", setup["classmap"], "--batch_size", "2", "--int8", *extra]
        monkeypatch.setattr(sys, "argv", ["evaluate_model.py", *args])
        evaluate_model.main()
        ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        evaluate_cli.main(args + ["--device", "cpu"])
        ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        print(extra, ours, ref)
        assert list(ours) == list(ref)
        assert ours["num_ground_truth"] == ref["num_ground_truth"] > 0
        assert ours["num_detections"] > 0
        for k in ref:
            if k.startswith("mAP"):
                assert abs(ours[k] - ref[k]) <= 0.02, (k, ours[k], ref[k])


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

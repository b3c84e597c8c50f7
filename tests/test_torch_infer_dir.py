"""Directory inference on the CPU: the PyTorch port's ``evaluate_dir``,
``evaluate_files_batched``, ``chunk_range`` and ``_prefetch_iter`` against the
JAX package's and against the port's own per-file path, with one JAX
initialisation carried across (``state_dict_from_jax``).

The CSVs are compared as text, file by file: times rounded to 10 ms and the
RLE-merged classes must come out the same, which holds while the rows agree
within the slice's tolerances (class equal, confidence 1e-4, times 1e-3 s,
``tests/test_torch_slice.py``).
"""

import copy
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioyolo_tpu.config import Config as JConfig
from audioyolo_tpu.infer import evaluate_dir as j_evaluate_dir
from audioyolo_tpu.infer import make_inference_fn as j_make_inference_fn
from audioyolo_tpu.models import AudioDetectionModel as JModel
from audioyolo_tpu.models import fold_repvgg as j_fold
from audioyolo_tpu.ops.frontend import SpectralFrontend as JFrontend

from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.data.wavio import write_wav
from audioyolo_tpu_torch.infer import (evaluate_audio, evaluate_dir, evaluate_files_batched,
                                       make_inference_fn)
from audioyolo_tpu_torch.infer.streaming import _prefetch_iter
from audioyolo_tpu_torch.models import AudioDetectionModel, fold_repvgg, state_dict_from_jax

from synth import synth_clip
from test_torch_model import _randomize

CONF = 0.2
IDX2CLASS = {0: "tone", 1: "beep"}
KW = dict(input_sample_rate=8000, sample_duration=4.0, batch_size=2, idx2class_map=IDX2CLASS)


def _raw(posture):
    from conftest import TINY_CFG

    raw = copy.deepcopy(TINY_CFG)
    if posture == "kernel":
        raw["tpu_config"].update(frontend_precision="default", pallas_frontend="on")
    return raw


def _pair(posture):
    """(raw config, JAX deploy infer fn, port deploy infer fn) on one JAX init.

    In the kernel posture the JAX function is the JAX package's folded body,
    decode, NMS and packing on the port's feature image (kernel 1's plain
    version): on the CPU the JAX frontend runs its float32 XLA path, not its
    bf16 Pallas kernel, and the frontend's second dB map over the MFCC
    coefficients turns that rounding gap into O(1) pixels now and then
    (``tests/test_torch_train_loop.py`` shares the feature image likewise)."""
    raw = _raw(posture)
    jm = JModel.from_config(raw, num_classes=2)
    x0 = jnp.zeros((1, 1, JConfig(raw).clip_samples))
    v = _randomize(jax.jit(lambda r, x: jm.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(2), x0), seed=4)
    deploy = JModel.from_config(raw, num_classes=2, deploy=True)
    t_fn = make_inference_fn(AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2,
                                                             deploy=True),
                             fold_repvgg(state_dict_from_jax(v)), 0.1, CONF, keep_k=32,
                             device="cpu")
    if posture == "highest":
        return raw, j_make_inference_fn(deploy, j_fold(v), 0.1, CONF, keep_k=32, packed=True), t_fn
    from audioyolo_tpu.infer.decode import detection_postprocess_graph, pack_detections

    dur = JConfig(raw).sample_duration
    body = jax.jit(lambda fv, f: pack_detections(detection_postprocess_graph(
        deploy.apply(fv, features=f, train=False, combine_scales=True), 0.1, CONF, dur, 32)))
    folded, frontend = j_fold(v), t_fn.model.frontend

    def j_fn(x):
        with torch.no_grad():
            feats = frontend(torch.from_numpy(np.array(x))).numpy()
        return body(folded, jnp.asarray(feats))

    return raw, j_fn, t_fn


@pytest.fixture(scope="module")
def highest():
    return _pair("highest")


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    """Five short 8 kHz files (one of them stereo, so its windows are float32
    and the batches that hold it are promoted; one crosses a batch boundary),
    one 12 s file (three windows, longer than one chunk of two) and one 8 s
    file at 11 025 Hz (the threaded path, resampled). Every file is a whole
    number of 4 s windows: over a zero-padded tail the MFCC coefficients of
    the -80 dB floor are rounding noise, which the second dB map turns into
    pixels that differ between any two implementations."""
    root = tmp_path_factory.mktemp("dir") / "clips"
    root.mkdir()
    shorts = [(4.0, [(0.5, 1.8, "tone")]), (4.0, [(1.0, 2.5, "beep")]),
              (8.0, [(0.4, 1.2, "beep"), (2.0, 4.6, "tone")]), (4.0, [(3.0, 3.8, "tone")]),
              (8.0, [(0.3, 1.5, "beep"), (5.0, 6.5, "tone")])]
    for i, (dur, segs) in enumerate(shorts):
        x = synth_clip(8000, dur, segs, seed=30 + i)
        if i == 2:
            x = np.stack([x, synth_clip(8000, dur, segs, seed=40)])
        write_wav(str(root / f"short{i}.wav"), x, 8000)
    write_wav(str(root / "long.wav"),
              synth_clip(8000, 12.0, [(1.0, 2.0, "tone"), (5.0, 6.5, "beep"), (9.0, 10.0, "tone")],
                         seed=5), 8000)
    write_wav(str(root / "other_rate.wav"),
              synth_clip(11025, 8.0, [(1.0, 2.5, "tone"), (3.5, 5.0, "beep")], seed=6), 11025)
    return str(root)


def _csvs(out_dir):
    found = {}
    for d, _, names in os.walk(out_dir):
        for n in names:
            with open(os.path.join(d, n)) as f:
                found[os.path.relpath(os.path.join(d, n), out_dir)] = f.read()
    return found


def _recording(monkeypatch, module):
    """Record the unrounded rows each file's CSV is written from."""
    rows, write = {}, module.write_rows_csv

    def record(all_rows, idx2class_map, audio_filepath, output_dir):
        rows[os.path.basename(audio_filepath)] = sorted(all_rows, key=lambda r: (r["start"], r["end"]))
        return write(all_rows, idx2class_map, audio_filepath, output_dir)

    monkeypatch.setattr(module, "write_rows_csv", record)
    return rows


def _seconds(field):
    """``0 days 00:01:02.500000`` -> 62.5."""
    h, m, s = field.split(" ")[-1].split(":")
    return int(h) * 3600 + int(m) * 60 + float(s)


@pytest.mark.parametrize("posture", ["highest", "kernel"])
def test_evaluate_dir_csvs_match_jax(posture, highest, audio_dir, tmp_path, monkeypatch):
    """Each file's rows match the JAX package's within the slice's tolerances,
    and its CSV text is the same. A time within float32 noise of a 5 ms
    rounding boundary may round the other way: such a field may differ by
    one 10 ms unit, and only where the rows agree to 1e-3 s."""
    import audioyolo_tpu.infer.streaming as j_streaming
    import audioyolo_tpu_torch.infer.streaming as t_streaming

    raw, j_fn, t_fn = highest if posture == "highest" else _pair(posture)
    j_rows, t_rows = _recording(monkeypatch, j_streaming), _recording(monkeypatch, t_streaming)
    j_frame = JFrontend(JConfig(copy.deepcopy(raw))).frame_host
    t_frame = t_fn.model.frontend.frame_host
    n_j = j_evaluate_dir(j_fn, audio_dir, str(tmp_path / "jax"), num_concurrency=2,
                         verbose=False, frame_fn=j_frame, **KW)
    n_t = evaluate_dir(t_fn, audio_dir, str(tmp_path / "port"), num_concurrency=2,
                       verbose=False, frame_fn=t_frame, **KW)
    assert n_j == n_t == 7
    assert sorted(t_rows) == sorted(j_rows) and len(j_rows) == 7
    for name, ref in j_rows.items():
        assert len(t_rows[name]) == len(ref), name
        for a, b in zip(t_rows[name], ref):
            assert a["class_idx"] == b["class_idx"], name
            assert a["confidence"] == pytest.approx(b["confidence"], abs=1e-4), name
            assert a["start"] == pytest.approx(b["start"], abs=1e-3), name
            assert a["end"] == pytest.approx(b["end"], abs=1e-3), name
    assert sum(map(len, j_rows.values())) > 7

    ref, ours = _csvs(tmp_path / "jax"), _csvs(tmp_path / "port")
    assert sorted(ours) == sorted(ref) and len(ref) == 7
    flipped = 0
    for name in ref:
        a_lines, b_lines = ours[name].splitlines(), ref[name].splitlines()
        assert len(a_lines) == len(b_lines) and a_lines[0] == b_lines[0], name
        for a, b in zip(a_lines[1:], b_lines[1:]):
            (a0, a1, ac), (b0, b1, bc) = a.split(","), b.split(",")
            assert ac == bc, name
            for x, y in ((a0, b0), (a1, b1)):
                if x != y:
                    assert abs(_seconds(x) - _seconds(y)) == pytest.approx(0.01, abs=1e-9), name
                    flipped += 1
    print(f"[{posture}] {sum(map(len, j_rows.values()))} rows in 7 CSVs; {flipped} time "
          f"fields rounded to the neighbouring 10 ms")
    assert flipped <= 2


def test_batched_files_match_the_per_file_path(highest, audio_dir, tmp_path):
    """Windows of many files in one batch (the stereo file's promoted to
    float32 beside int16 ones) give the CSVs of one file at a time."""
    _, _, t_fn = highest
    paths = sorted(os.path.join(audio_dir, f) for f in os.listdir(audio_dir)
                   if f != "other_rate.wav")
    frame_fn = t_fn.model.frontend.frame_host
    assert evaluate_files_batched(t_fn, paths, str(tmp_path / "b"), frame_fn=frame_fn, **KW) == 6
    for p in paths:
        evaluate_audio(t_fn, p, str(tmp_path / "p"), frame_fn=frame_fn, **KW)
    batched, per_file = _csvs(tmp_path / "b"), _csvs(tmp_path / "p")
    assert sorted(batched) == sorted(per_file) and len(batched) == 6
    for name in per_file:
        assert batched[name] == per_file[name], name


def test_chunk_ranges_concatenate_to_the_whole_file(highest, tmp_path):
    """20 s, 4 s windows, batch 2: chunks [0, 8), [8, 16), [16, 20) s. The
    ranges (0, 1) and (1, 3) keep global clip offsets."""
    _, _, t_fn = highest
    path = str(tmp_path / "twenty.wav")
    write_wav(path, synth_clip(8000, 20.0, [(1.0, 3.0, "tone"), (7.0, 9.5, "beep"),
                                           (13.0, 14.0, "tone"), (17.0, 19.0, "beep")], seed=8),
              8000)
    kw = dict(KW, return_rows=True, frame_fn=t_fn.model.frontend.frame_host)
    whole = evaluate_audio(t_fn, path, "", **kw)
    parts = [evaluate_audio(t_fn, path, "", chunk_range=r, **kw) for r in ((0, 1), (1, 3))]
    assert parts[0] and parts[1] and min(r["start"] for r in parts[1]) >= 8.0
    assert parts[0] + parts[1] == whole
    assert evaluate_audio(t_fn, path, "", chunk_range=(3, 5), **kw) == []


def test_int8_transfer_is_refused(highest, tmp_path):
    _, _, t_fn = highest
    path = str(tmp_path / "a.wav")
    write_wav(path, synth_clip(8000, 4.0, [], seed=1), 8000)
    with pytest.raises(NotImplementedError, match="A10"):
        evaluate_audio(t_fn, path, "", transfer="int8", **KW)
    with pytest.raises(NotImplementedError, match="A10"):
        evaluate_files_batched(t_fn, [path], str(tmp_path), transfer="int8", **KW)
    with pytest.raises(ValueError, match="transfer"):
        evaluate_audio(t_fn, path, "", transfer="int4", **KW)


def _new_threads(before):
    return [t for t in threading.enumerate() if t not in before and t.is_alive()]


def test_prefetch_surfaces_the_producer_error():
    before = set(threading.enumerate())

    def gen():
        yield 1
        yield 2
        raise RuntimeError("decode failed")

    got = []
    with pytest.raises(RuntimeError, match="decode failed"):
        for item in _prefetch_iter(gen()):
            got.append(item)
    assert got == [1, 2] and not _new_threads(before)


def test_prefetch_consumer_stopping_early_leaves_no_thread():
    """The consumer takes one item and stops; the producer, blocked on a full
    queue with items left, is stopped, its generator closed and joined."""
    before = set(threading.enumerate())
    closed = threading.Event()

    def gen():
        try:
            for i in range(1000):
                yield i
        finally:
            closed.set()

    it = _prefetch_iter(gen(), depth=2)
    assert next(it) == 0
    it.close()
    assert closed.is_set() and not _new_threads(before)

    def failing_consumer():
        for _ in _prefetch_iter(gen()):
            raise ValueError("infer_fn failed")

    closed.clear()
    with pytest.raises(ValueError, match="infer_fn failed"):
        failing_consumer()
    assert closed.is_set() and not _new_threads(before)


def test_prefetch_yields_every_item_in_order():
    assert list(_prefetch_iter((i for i in range(50)), depth=3)) == list(range(50))
    assert list(_prefetch_iter(i for i in [])) == []


def test_evaluate_dir_raises_after_the_readable_files(highest, tmp_path):
    """An unreadable header goes to the per-file path and raises there, after
    the native-rate files are written."""
    _, _, t_fn = highest
    d = tmp_path / "bad"
    d.mkdir()
    for i in range(2):
        write_wav(str(d / f"ok{i}.wav"), synth_clip(8000, 4.0, [(1.0, 2.0, "tone")], seed=i), 8000)
    (d / "broken.wav").write_bytes(b"not a wav at all")
    with pytest.raises(ValueError, match="RIFF"):
        evaluate_dir(t_fn, str(d), str(tmp_path / "out"), verbose=False, **KW)
    assert sorted(_csvs(tmp_path / "out")) == [os.path.join("bad", f"ok{i}_results.csv")
                                               for i in range(2)]

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
import struct
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax
import jax.numpy as jnp

from audioyolo_tpu.config import Config as JConfig
from audioyolo_tpu.infer import evaluate_dir as j_evaluate_dir
from audioyolo_tpu.infer import make_inference_fn as j_make_inference_fn
from audioyolo_tpu.models import AudioDetectionModel as JModel
from audioyolo_tpu.models import fold_repvgg as j_fold
from audioyolo_tpu.ops.frontend import SpectralFrontend as JFrontend

from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.data.wavio import (read_wav, read_wav_info, read_wav_pcm16_mono,
                                             write_wav)
from audioyolo_tpu_torch.infer import (evaluate_audio, evaluate_dir, evaluate_files_batched,
                                       make_inference_fn)
from audioyolo_tpu_torch.infer.streaming import _prefetch_iter
from audioyolo_tpu_torch.models import AudioDetectionModel, fold_repvgg, state_dict_from_jax
from audioyolo_tpu_torch.utils import trace

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


@pytest.mark.parametrize("posture", ["highest", "kernel", "waveform"])
def test_evaluate_dir_csvs_match_jax(posture, highest, audio_dir, tmp_path, monkeypatch):
    """Each file's rows match the JAX package's within the slice's tolerances,
    and its CSV text is the same. A time within float32 noise of a 5 ms
    rounding boundary may round the other way: such a field may differ by
    one 10 ms unit, and only where the rows agree to 1e-3 s. ``waveform``:
    the ``highest`` pair without a host framer, so the batches of mono PCM16
    windows are read straight into their host tensor and the batches that
    hold the stereo file's windows are promoted."""
    import audioyolo_tpu.infer.streaming as j_streaming
    import audioyolo_tpu_torch.infer.streaming as t_streaming

    raw, j_fn, t_fn = highest if posture in ("highest", "waveform") else _pair(posture)
    j_rows, t_rows = _recording(monkeypatch, j_streaming), _recording(monkeypatch, t_streaming)
    j_frame = JFrontend(JConfig(copy.deepcopy(raw))).frame_host
    t_frame = t_fn.model.frontend.frame_host
    if posture == "waveform":
        j_frame = t_frame = None
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


def test_int8_transfer_is_refused(highest, audio_dir, tmp_path, monkeypatch):
    """``transfer="int8"`` was ported: per-clip int8 waveforms
    (``quantize_clips_int8``, bit-equal to JAX's) dequantized on the device
    by ``make_inference_fn(int8_input=True)``, through ``evaluate_audio``
    and the cross-file ``evaluate_files_batched``, give the JAX package's
    rows with the same transfer within the slice's tolerances (the same
    float32 body on the same dequantized samples); a file at another rate,
    a framer that does not quantize and an unknown transfer raise, as in the
    JAX package."""
    import audioyolo_tpu.infer.streaming as j_streaming
    import audioyolo_tpu_torch.infer.streaming as t_streaming
    from audioyolo_tpu.infer import evaluate_files_batched as j_batched

    raw, _, t_fn = highest
    jm = JModel.from_config(raw, num_classes=2)
    v = _randomize(jax.jit(lambda r, x: jm.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(2), jnp.zeros((1, 1, JConfig(raw).clip_samples))), seed=4)
    j_fn = j_make_inference_fn(JModel.from_config(raw, num_classes=2, deploy=True), j_fold(v),
                               0.1, CONF, keep_k=32, packed=True, int8_input=True)
    t8 = make_inference_fn(t_fn.model, t_fn.model.state_dict(), 0.1, CONF, keep_k=32,
                           device="cpu", int8_input=True)
    paths = sorted(os.path.join(audio_dir, f) for f in os.listdir(audio_dir)
                   if f != "other_rate.wav")
    j_rows, t_rows = _recording(monkeypatch, j_streaming), _recording(monkeypatch, t_streaming)
    assert j_batched(j_fn, paths, str(tmp_path / "jax"), transfer="int8", **KW) == 6
    assert evaluate_files_batched(t8, paths, str(tmp_path / "port"), transfer="int8", **KW) == 6
    one = os.path.join(audio_dir, "long.wav")
    j_one = j_streaming.evaluate_audio(j_fn, one, "", transfer="int8", return_rows=True, **KW)
    t_one = evaluate_audio(t8, one, "", transfer="int8", return_rows=True, **KW)
    pairs = [(t_rows[n], j_rows[n]) for n in j_rows] + [(t_one, j_one)]
    assert sorted(t_rows) == sorted(j_rows) and sum(len(b) for _, b in pairs) > 7
    for ours, ref in pairs:
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            assert a["class_idx"] == b["class_idx"]
            assert a["confidence"] == pytest.approx(b["confidence"], abs=1e-4)
            assert a["start"] == pytest.approx(b["start"], abs=1e-3)
            assert a["end"] == pytest.approx(b["end"], abs=1e-3)
    other = os.path.join(audio_dir, "other_rate.wav")
    with pytest.raises(ValueError, match="native-rate"):
        evaluate_audio(t8, other, "", transfer="int8", **KW)
    with pytest.raises(ValueError, match="quantizing framer"):
        evaluate_files_batched(t_fn, paths[:2], str(tmp_path / "x"), transfer="int8",
                               frame_fn=t_fn.model.frontend.frame_host, **KW)
    with pytest.raises(ValueError, match="transfer"):
        evaluate_audio(t_fn, one, "", transfer="int4", **KW)


def _window_batches(paths, batch, size):
    """The batches ``evaluate_files_batched`` sends, read the plain way:
    each file's windows by its header's frame count, ``read_wav_pcm16_mono``
    for mono PCM16 and ``read_wav``'s channel mean otherwise, tails
    zero-padded, stacked (promoted to float32 as the readers scale, where a
    batch mixes), padded to ``batch`` with zero rows, as (B, 1, size)."""
    wins = []
    for p in paths:
        total = read_wav_info(p)[1]
        for start in range(0, total, size):
            n = min(size, total - start)
            w = read_wav_pcm16_mono(p, frame_offset=start, num_frames=n)
            if w is None:
                w = read_wav(p, frame_offset=start, num_frames=n)[0].mean(axis=0)
            wins.append(np.pad(w, (0, size - w.shape[0])))
    out = []
    for i in range(0, len(wins), batch):
        group = wins[i:i + batch]
        if any(w.dtype != np.int16 for w in group):
            group = [w.astype(np.float32) / np.float32(32768.0) if w.dtype == np.int16
                     else w.astype(np.float32) for w in group]
        arr = np.stack(group)
        out.append(np.concatenate([arr, np.zeros((batch - len(group), size), arr.dtype)])[:, None])
    return out


def _recorded_run(paths, out_dir, monkeypatch, **kw):
    """``evaluate_files_batched`` with a stub inference function that keeps
    each batch it is given, every direct batch's host tensor pre-filled with
    a non-zero value (a reused pinned block holds an earlier batch), under a
    profiler: (batches, span counts)."""
    import audioyolo_tpu_torch.infer.streaming as t_streaming

    host_batch = t_streaming._host_batch
    monkeypatch.setattr(t_streaming, "_host_batch",
                        lambda shape, device: host_batch(shape, device).fill_(0x2A2A))
    seen = []

    def stub(x):
        x = x[0] if isinstance(x, tuple) else x  # int8 transfer: (q, scale)
        seen.append(x.numpy().copy())
        out = torch.zeros(x.shape[0], 8, 6)
        out[:, 0, :5] = torch.tensor([0.9, 0.9, 0.0, 0.5, 0.2])
        out[:, 0, 5] = 1.0
        return out

    stub.device = torch.device("cpu")
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        assert evaluate_files_batched(stub, paths, out_dir, **kw) == len(paths)
    counts = {k: v["count"] for k, v in trace.totals().items()}
    trace.reset()
    return seen, counts


def _assert_batches_equal(seen, want):
    assert len(seen) == len(want)
    for got, ref in zip(seen, want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert got.tobytes() == ref.tobytes()


def test_direct_read_batches_equal_the_stacked_windows(tmp_path, monkeypatch):
    """Mono PCM16 files at the model rate of mixed lengths (three end in a
    zero-padded tail window), 10 windows in batches of 4: every batch the device gets is, byte
    for byte, the stack of the windows read one by one, the partial last
    batch's pad rows zero though its host tensor held other data; one
    native read a batch, each of them direct."""
    kw = dict(input_sample_rate=8000, sample_duration=1.0, batch_size=4, idx2class_map=IDX2CLASS)
    rng = np.random.default_rng(11)
    paths = []
    for i, sec in enumerate((2.5, 1.0, 4.3, 0.2)):  # 3 + 1 + 5 + 1 windows
        paths.append(str(tmp_path / "audio" / f"m{i}.wav"))
        os.makedirs(os.path.dirname(paths[-1]), exist_ok=True)
        write_wav(paths[-1], (0.3 * rng.standard_normal(int(sec * 8000))).astype(np.float32),
                  8000)
    seen, counts = _recorded_run(paths, str(tmp_path / "out"), monkeypatch, **kw)
    want = _window_batches(paths, 4, 8000)
    assert len(want) == 3 and not want[-1][2:].any()  # 4 + 4 + 2 windows
    _assert_batches_equal(seen, want)
    assert counts["ayt.stream.read"] == counts["ayt.stream.read_direct"] == 3
    assert counts["ayt.stream.stack"] == counts["ayt.stream.drain"] == 3
    assert len(_csvs(tmp_path / "out")) == 4


def test_fallback_batches_are_read_as_before(tmp_path, monkeypatch):
    """Among mono PCM16 files, a stereo PCM16 file, an IEEE float32 file and
    a mono PCM16 file whose data chunk is shorter than its header says: the
    batches that hold their windows are read window by window (promoted to
    float32 where a batch mixes, the short file zero-padded), the rest
    straight into their host tensor; the batches equal the plain reading in
    both; ``ayt.stream.read_direct`` counts the all-mono-PCM16 batches, and
    a framer or the int8 transfer keeps every batch on the old path."""
    kw = dict(input_sample_rate=8000, sample_duration=1.0, batch_size=2, idx2class_map=IDX2CLASS)
    rng = np.random.default_rng(12)
    d = tmp_path / "audio"
    d.mkdir()

    def noise(*shape):
        return (0.3 * rng.standard_normal(shape)).astype(np.float32)

    write_wav(str(d / "a.wav"), noise(16000), 8000)  # batch 1: a0 a1, direct
    write_wav(str(d / "b.wav"), noise(2, 12000), 8000)  # batch 2: b0 b1, float32
    write_wav(str(d / "c.wav"), noise(8000), 8000)  # batch 3: c0 d0, float32
    data = noise(8000).astype("<f4").tobytes()
    with open(d / "d.wav", "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, 8000, 32000, 4, 32))
        f.write(b"data" + struct.pack("<I", len(data)) + data)
    write_wav(str(d / "e.wav"), noise(20000), 8000)  # batch 4: e0 e1, direct
    write_wav(str(d / "f.wav"), noise(9600), 8000)  # batch 5: e2 f0, int16; 6: f1 g0
    with open(d / "f.wav", "r+b") as f:
        f.truncate(44 + 2 * 7000)  # the header still counts 9600 frames
    write_wav(str(d / "g.wav"), noise(4000), 8000)
    write_wav(str(d / "h.wav"), noise(5000), 8000)  # batch 7: h0 and a zero row, direct
    paths = sorted(str(p) for p in d.iterdir())
    want = _window_batches(paths, 2, 8000)
    assert [w.dtype for w in want] == [np.int16, np.float32, np.float32] + [np.int16] * 4
    seen, counts = _recorded_run(paths, str(tmp_path / "out"), monkeypatch, **kw)
    _assert_batches_equal(seen, want)
    assert counts["ayt.stream.read_direct"] == 3  # batches 1, 4 and 7
    assert counts["ayt.stream.read"] == 3 + 2 * 4  # and a read a window in the other four
    assert counts["ayt.stream.drain"] == 7

    for extra in (dict(transfer="int8"), dict(frame_fn=lambda clips: clips)):
        _, counts = _recorded_run(paths[:1], str(tmp_path / "x"), monkeypatch, **kw, **extra)
        assert "ayt.stream.read_direct" not in counts and counts["ayt.stream.read"] == 2


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

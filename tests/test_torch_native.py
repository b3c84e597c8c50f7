"""The port's native audio library (``csrc/audio_io.cpp`` through
``data/native.py``) on the CPU: built by ``ops/build.py`` with the host
compiler, every binding bit-equal to the numpy path it replaces and to the
JAX package's ``audioyolo_tpu.data.native`` on the same inputs; the loader's
batches bit-equal whichever path reads them; broken input and a failed build
raise.

The JAX package builds its own library on first use with ``make`` straight
at its final path (``audioyolo_tpu/data/native.py::_load``), and gives up
for the life of the process when a load fails. Every xdist worker calls it
while it collects ``tests/test_native.py``, so on a fresh tree up to six
``make`` runs race, and a worker that loads a file another linker is still
writing keeps ``None``: this module's comparisons with the JAX library then
failed with "native ... unavailable". ``jax_native`` repairs that worker.
"""

import fcntl
import os
import subprocess

import numpy as np
import pytest

from audioyolo_tpu.data import native as jnative
from audioyolo_tpu.ops.fused_frontend import FusedFrameDFT as JFramer

from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.data import native
from audioyolo_tpu_torch.data.dataset import AudioConcatDataset, AudioDataset
from audioyolo_tpu_torch.data.loader import BatchLoader
from audioyolo_tpu_torch.data.wavio import read_wav, write_wav
from audioyolo_tpu_torch.ops import build
from audioyolo_tpu_torch.ops.frontend import SpectralFrontend
from audioyolo_tpu_torch.ops.fused_frontend import FusedFrameDFT

from synth import make_flat_dataset

FRAMERS = {"22050->16000": (22050, 16000), "16000->16000": (16000, 16000)}


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's library, loaded. When its loader gave up in this
    process, build the library with ``native/Makefile``'s command under a
    file lock into a temporary name, move it into place with one
    ``os.replace`` (a reader never sees a partial file), and let the loader
    try again; a second failure is a real one and raises."""
    if jnative._load() is not None:
        return
    lib_dir = os.path.dirname(jnative._LIB_PATH)
    tmp = os.path.join(lib_dir, f".libayt_audio.{os.getpid()}.tmp.so")
    os.makedirs(build.BUILD, exist_ok=True)
    with open(os.path.join(build.BUILD, "jax_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            subprocess.run([os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17", "-Wall",
                            "-Wextra", "-march=native", "audio_io.cpp", "-o", tmp, "-shared",
                            "-pthread"], cwd=lib_dir, check=True, capture_output=True)
            os.replace(tmp, jnative._LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_tried", False)
        assert jnative._load() is not None, "the JAX package's native library does not load"


def _framers(rates, seconds=4):
    args = (*rates, 1000, 1000, 1000, 16 * seconds)
    return FusedFrameDFT(*args), JFramer(*args)


def _clips(b, n, seed):
    x = np.random.default_rng(seed).standard_normal((b, n)) * 9000
    x = np.clip(x, -32768, 32767).astype(np.int16)
    x[0, :2] = (-32768, 32767)
    return x


@pytest.mark.parametrize("rates", list(FRAMERS), ids=list(FRAMERS))
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("extra", [-333, 7])
def test_frame_i16_bit_equal(rates, b, extra):
    """Odd clip lengths a little short of and past 4 s, B=1 and B=3, with
    and without the resampler's phases: native == numpy == the JAX
    package's native framer; ``frame_host`` takes the native form for a 2-D
    int16 batch and writes into a caller's buffer."""
    ours, theirs = _framers(FRAMERS[rates])
    x = _clips(b, 4 * FRAMERS[rates][0] + extra, seed=b)
    got = native.frame_i16(x, ours)
    np.testing.assert_array_equal(got, ours.frame_numpy(x))
    np.testing.assert_array_equal(got, jnative.frame_i16(x, theirs))
    assert got.shape == (b, ours.n_ph, ours.n_groups, ours.frame_len) and got.dtype == np.int16
    buf = []
    out = ours.frame_host(x, alloc=lambda shape, dt: buf.append(np.full(shape, 7, dt)) or buf[0])
    assert out is buf[0]
    np.testing.assert_array_equal(out, got)
    with pytest.raises(ValueError, match="int16"):
        native.frame_i16(x.astype(np.float32), ours)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Three 22 050 Hz PCM16 files: mono longer than the 4 s window, mono
    shorter than it, and stereo."""
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(4)
    paths = []
    for name, shape in (("long", (4 * 22050 + 900,)), ("short", (3 * 22050 + 11,)),
                        ("stereo", (2, 4 * 22050 + 300))):
        p = str(d / f"{name}.wav")
        write_wav(p, (0.3 * rng.standard_normal(shape)).astype(np.float32), 22050)
        paths.append(p)
    return paths


def _numpy_span(path, offset, count, out_len):
    audio, _ = read_wav(path, frame_offset=offset, num_frames=count)
    mono = audio.mean(axis=0) if audio.shape[0] != 1 else audio[0]
    return np.pad(mono, (0, out_len - mono.shape[0]))


def test_wav_info_and_read_mono(wavs):
    for p, frames, ch in zip(wavs, (4 * 22050 + 900, 3 * 22050 + 11, 4 * 22050 + 300), (1, 1, 2)):
        assert native.wav_info(p) == jnative.wav_info(p) == (22050, frames, ch)
        got = native.read_mono(p, 123, 5000, 6000)
        np.testing.assert_array_equal(got, _numpy_span(p, 123, 5000, 6000))
        np.testing.assert_array_equal(got, jnative.read_mono(p, 123, 5000, 6000))


def test_load_batches_bit_equal(wavs):
    """Offsets, a file shorter than its window and a stereo file: float32,
    int16 and framed int16 batches equal the numpy decode (quantized and
    framed as the loader does) and the JAX package's native loaders."""
    clip = 4 * 22050
    offs, counts = [250, 17, 0], [clip, clip, clip]
    ref = np.stack([_numpy_span(p, o, c, clip) for p, o, c in zip(wavs, offs, counts)])
    f32 = native.load_batch(wavs, offs, counts, clip, n_threads=2)
    np.testing.assert_array_equal(f32, ref)
    np.testing.assert_array_equal(f32, jnative.load_batch(wavs, offs, counts, clip, n_threads=2))

    ref16 = np.clip(np.round(ref * 32768.0), -32768, 32767).astype(np.int16)
    i16 = native.load_batch_i16(wavs, offs, counts, clip, n_threads=3)
    np.testing.assert_array_equal(i16, ref16)
    np.testing.assert_array_equal(i16, jnative.load_batch_i16(wavs, offs, counts, clip))

    ours, theirs = _framers(FRAMERS["22050->16000"])
    framed = native.load_batch_framed_i16(wavs, offs, counts, clip, ours)
    np.testing.assert_array_equal(framed, ours.frame_numpy(ref16))
    np.testing.assert_array_equal(framed, jnative.load_batch_framed_i16(wavs, offs, counts, clip,
                                                                        theirs))
    out = np.empty_like(framed)
    assert native.frame_i16(ref16, ours, out=out) is out
    np.testing.assert_array_equal(out, framed)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.frame_i16(ref16, ours, out=out.astype(np.float32))


def test_load_batch_i16_into_a_caller_buffer(wavs):
    """``out=`` gives the allocating form's bytes in the caller's array (a
    row slice of a larger one too) and refuses a wrong shape, dtype, a
    non-contiguous or a read-only array."""
    clip = 4 * 22050
    offs, counts = [250, 17, 0], [clip, clip, clip]
    want = native.load_batch_i16(wavs, offs, counts, clip)
    big = np.full((5, clip), 7, np.int16)
    got = native.load_batch_i16(wavs, offs, counts, clip, out=big[1:4])
    assert np.shares_memory(got, big)
    np.testing.assert_array_equal(big[1:4], want)
    assert (big[0] == 7).all() and (big[4] == 7).all()
    readonly = np.empty((3, clip), np.int16)
    readonly.flags.writeable = False
    for bad in (np.empty((2, clip), np.int16), np.empty((3, clip - 1), np.int16),
                np.empty((3, clip), np.float32), np.empty((3, 2 * clip), np.int16)[:, ::2],
                readonly):
        with pytest.raises(ValueError, match="C-contiguous int16"):
            native.load_batch_i16(wavs, offs, counts, clip, out=bad)


def test_quant_i8_bit_equal():
    """Steps and codes equal the numpy form of the same arithmetic
    (float32 reciprocal, multiply, round half to even) and the JAX
    package's native quantizer."""
    x = _clips(3, 5001, seed=9).reshape(3, 1, 5001)
    x[2] = 0  # a silent clip: step 1/127
    q, step = native.quant_i8(x)
    amax = np.abs(x.astype(np.int32)).reshape(3, -1).max(1)
    ref_step = np.maximum(amax, 1).astype(np.float32) / np.float32(127.0)
    inv = np.float32(1.0) / ref_step
    ref_q = np.clip(np.round(x.astype(np.float32) * inv[:, None, None]), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(step, ref_step)
    np.testing.assert_array_equal(q, ref_q)
    jq, jstep = jnative.quant_i8(x)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(step, jstep)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ds") / "train")
    ann = make_flat_dataset(root, n_files=5, seed=3)
    return AudioDataset(root, ann, sample_duration=4, sample_rate=8000, max_targets=8)


@pytest.mark.parametrize("transfer", ["int16", "float32"])
@pytest.mark.parametrize("last_batch", ["pad", "partial"])
def test_loader_batches_bit_equal_with_and_without_framer(dataset, tiny_cfg, transfer,
                                                          last_batch):
    """Native framed decode (``framer``), native decode then ``frame_fn``,
    and item-by-item decode (a dataset without the native decoders): the
    same batches, bit for bit, the repeat-padded last one included."""
    fe = SpectralFrontend(Config(tiny_cfg.to_dict()))
    kw = dict(shuffle=False, prefetch=0, last_batch=last_batch, transfer_dtype=transfer)
    runs = {
        "framer": BatchLoader(dataset, 2, framer=fe.fused, **kw),
        "frame_fn": BatchLoader(dataset, 2, frame_fn=fe.frame_host, **kw),
        "per item": BatchLoader(AudioConcatDataset([dataset]), 2, frame_fn=fe.frame_host, **kw),
    }
    batches = {k: list(v) for k, v in runs.items()}
    assert len(batches["framer"]) == 3
    for name in ("frame_fn", "per item"):
        for a, b in zip(batches["framer"], batches[name]):
            assert set(a) == set(b)
            assert a["audio"].dtype == np.dtype(transfer) and a["audio"].ndim == 4
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}: {k}")
    waveform = list(BatchLoader(dataset, 2, **kw))
    for a, b in zip(waveform, BatchLoader(AudioConcatDataset([dataset]), 2, **kw)):
        assert a["audio"].shape == (b["audio"].shape[0], 1, 32000)
        np.testing.assert_array_equal(a["audio"], b["audio"])


def test_broken_wav_raises(tmp_path, dataset):
    bad = tmp_path / "broken.wav"
    bad.write_bytes(b"RIFF\x24\x00\x00\x00WAVEjunk")
    missing = str(tmp_path / "missing.wav")
    with pytest.raises(IOError, match="wav_info"):
        native.wav_info(str(bad))
    for paths in ([str(bad)], [missing]):
        with pytest.raises(IOError, match="batch load"):
            native.load_batch(paths, [0], [100], 100)
        with pytest.raises(IOError, match="framed batch load"):
            native.load_batch_framed_i16(paths, [0], [100], 32000, dataset_framer())
    # a dataset whose file went bad after indexing: the loader raises, never skips
    ds = AudioDataset(dataset.audios_path, {}, sample_duration=4, sample_rate=8000)
    ds._samples = [dict(dataset._samples[0], filename="../" + os.path.splitext(bad.name)[0])]
    ds.audios_path = str(tmp_path / "x")
    ds.class2idx = dataset.class2idx
    with pytest.raises(IOError):
        list(BatchLoader(ds, 1, transfer_dtype="int16", framer=dataset_framer()))


def dataset_framer():
    return FusedFrameDFT(8000, 8000, 200, 200, 200, 160)


def test_library_is_built_from_the_port_and_a_failed_build_raises(tmp_path, monkeypatch):
    lib = native.library()
    assert os.path.dirname(lib._name) == build.BUILD
    assert os.path.basename(lib._name).startswith("libaudio_io-")
    cmd = build.command("audio_io", "out.so")
    assert cmd[-1] == os.path.join(build.CSRC, "audio_io.cpp")
    assert tuple(cmd[1:-3]) == build.CXX_FLAGS and "audio_io" not in build.sources()
    monkeypatch.setattr(build, "BUILD", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="audio_io.cpp failed"):
        build._finish("audio_io", *build._start("audio_io"))
    assert os.listdir(tmp_path) == []

"""The port's dataset preparation (``audioyolo_tpu_torch/get_dataset_cli.py``)
against the JAX package's root ``get_dataset.py`` on the CPU.

The raw directory of ``tests/test_get_dataset.py::_make_raw_dataset`` (ten
1 s PCM16 clips at 16 kHz and two annotation JSONs, here with one ``.mp3``
beside them) is copied twice and prepared by each: the 80/20 split, the
moves, the clean-up and the directory listing are identical; every WAV is
resampled in place to 22 050 Hz with the same rate and length, its PCM16
samples within 1 LSB, and the float samples before PCM16 within the
resampler's tolerance (``tests/test_torch_frontend.py::
test_resampler_matches_jax``: atol 2e-6, rtol 1e-5). The ``.mp3`` is skipped
with the same warning where ffmpeg is missing. ``--format_only`` and the
missing ``kaggle`` package behave as in JAX.
"""

import logging
import os
import shutil

import numpy as np
import pytest

import jax.numpy as jnp

import get_dataset
from audioyolo_tpu.ops.resample import Resampler as JResampler

from audioyolo_tpu_torch import get_dataset_cli
from audioyolo_tpu_torch.data.wavio import read_wav, write_wav

from test_get_dataset import _make_raw_dataset

RATE = 22050


def _listing(ddir):
    return sorted(os.path.relpath(os.path.join(d, n), ddir)
                  for d, subs, names in os.walk(ddir) for n in subs + names)


@pytest.fixture()
def two_raw(tmp_path):
    """The same raw dataset under ``jax/`` and ``port/``."""
    src, _ = _make_raw_dataset(str(tmp_path / "raw"), n=10, sr=16000)
    with open(os.path.join(src, "song.mp3"), "wb") as f:
        f.write(b"ID3 not decoded here")
    roots = {}
    for side in ("jax", "port"):
        shutil.copytree(tmp_path / "raw", tmp_path / side)
        roots[side] = str(tmp_path / side)
    return roots


def test_split_moves_and_resample_match_jax(two_raw, monkeypatch, caplog):
    monkeypatch.setattr(get_dataset, "_have_ffmpeg", lambda: False)
    monkeypatch.setattr(get_dataset_cli, "_have_ffmpeg", lambda: False)
    args = ["--name", "openbmat", "--num_concurrency", "2", "--seed", "3"]
    originals = {}
    raw_audio = os.path.join(two_raw["jax"], "openbmat", "raw", "audio")
    for name in sorted(os.listdir(raw_audio)):
        if name.endswith(".wav"):
            originals[name] = read_wav(os.path.join(raw_audio, name))
    with caplog.at_level(logging.WARNING):
        get_dataset.main(["--root", two_raw["jax"], *args])
        jax_warnings = [r.getMessage().replace(two_raw["jax"], "") for r in caplog.records]
        caplog.clear()
        get_dataset_cli.main(["--root", two_raw["port"], *args, "--device", "cpu"])
        port_warnings = [r.getMessage().replace(two_raw["port"], "") for r in caplog.records]
    assert port_warnings == jax_warnings and len(jax_warnings) == 1
    assert "skipping" in jax_warnings[0] and "song.mp3" in jax_warnings[0]

    jdir, pdir = (os.path.join(two_raw[s], "openbmat") for s in ("jax", "port"))
    assert _listing(pdir) == _listing(jdir)
    assert sorted(os.listdir(pdir)) == ["annotations", "eval", "train"]
    assert len(os.listdir(os.path.join(pdir, "train"))) == 9  # ceil(0.8 * 11)
    assert len(os.listdir(os.path.join(pdir, "annotations"))) == 2
    n_wav = 0
    for rel in _listing(jdir):
        if not rel.endswith(".wav"):
            continue
        a, sa = read_wav(os.path.join(pdir, rel))
        b, sb = read_wav(os.path.join(jdir, rel))
        assert sa == sb == RATE and a.shape == b.shape, rel
        assert np.abs(np.round(a * 32768) - np.round(b * 32768)).max() <= 1, rel
        n_wav += 1
    assert n_wav == 10

    audio, sr = originals["clip0.wav"]
    ref = np.asarray(JResampler(sr, RATE)(jnp.asarray(audio)))
    out = get_dataset_cli.resample(audio, sr, RATE, device="cpu")
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=1e-5)


def test_format_only_matches_jax(tmp_path):
    """``--format_only``: no split and no clean-up; the WAV resampled."""
    for side, run in (("jax", get_dataset.main),
                      ("port", lambda a: get_dataset_cli.main(a + ["--device", "cpu"]))):
        ddir = tmp_path / side / "openbmat"
        os.makedirs(ddir / "train")
        write_wav(str(ddir / "train" / "a.wav"), np.zeros(4000, np.float32), 4000)
        run(["--root", str(tmp_path / side), "--name", "openbmat", "--format_only",
             "--target_sample_rate", "8000"])
        audio, sr = read_wav(str(ddir / "train" / "a.wav"))
        assert sr == 8000 and audio.shape == (1, 8000)
        assert os.listdir(ddir) == ["train"]


def test_missing_kaggle_exits_as_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "kaggle", None)
    args = ["--root", str(tmp_path), "--name", "nope",
            "--url", "https://www.kaggle.com/datasets/user/thing"]
    with pytest.raises(SystemExit) as ref:
        get_dataset.main(args)
    with pytest.raises(SystemExit) as ours:
        get_dataset_cli.main(args + ["--device", "cpu"])
    assert str(ours.value) == str(ref.value) and "kaggle" in str(ref.value)
    assert not os.path.exists(tmp_path / "nope")

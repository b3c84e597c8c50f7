"""The serving slice end to end on the CPU: the PyTorch port's
``make_inference_fn``, ``evaluate_audio`` and HTTP server against the JAX
package's, with the same weights (JAX variables through the bridge)."""

import copy
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioyolo_tpu.config import Config as JConfig
from audioyolo_tpu.infer import evaluate_audio as j_evaluate_audio
from audioyolo_tpu.infer import make_inference_fn as j_make_inference_fn
from audioyolo_tpu.models import AudioDetectionModel as JModel
from audioyolo_tpu.models import fold_repvgg as j_fold
from audioyolo_tpu.ops.frontend import SpectralFrontend as JFrontend

from audioyolo_tpu_torch import serve as t_serve
from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.data.wavio import write_wav
from audioyolo_tpu_torch.infer import evaluate_audio, make_inference_fn
from audioyolo_tpu_torch.models import AudioDetectionModel, fold_repvgg, state_dict_from_jax

from synth import synth_clip
from test_torch_model import _randomize

CONF = 0.2


@pytest.fixture(scope="module")
def pair():
    """(raw config, JAX deploy infer fn, port deploy infer fn, train-form state dict)."""
    from conftest import TINY_CFG

    raw = copy.deepcopy(TINY_CFG)
    jm = JModel.from_config(raw, num_classes=2)
    x0 = jnp.zeros((1, 1, JConfig(raw).clip_samples))
    v = jax.jit(lambda r, x: jm.init({"params": r}, x, train=False))(jax.random.PRNGKey(2), x0)
    v = _randomize(v, seed=4)
    j_fn = j_make_inference_fn(JModel.from_config(raw, num_classes=2, deploy=True), j_fold(v),
                               0.1, CONF, keep_k=32, packed=True)
    sd = state_dict_from_jax(v)
    t_fn = make_inference_fn(AudioDetectionModel.from_config(Config(raw), 2, deploy=True),
                             fold_repvgg(sd), 0.1, CONF, keep_k=32, device="cpu")
    return raw, j_fn, t_fn, sd


def test_inference_fn_matches_jax(pair):
    raw, j_fn, t_fn, _ = pair
    rng = np.random.default_rng(21)
    wav = (rng.standard_normal((2, JConfig(raw).clip_samples)) * 3000).astype(np.int16)
    framed = JFrontend(JConfig(copy.deepcopy(raw))).frame_host(wav)
    assert framed.dtype == np.int16
    ref = np.asarray(j_fn(jnp.asarray(framed)))
    out = t_fn(torch.from_numpy(framed)).numpy()
    assert out.shape == ref.shape == (2, 32, 6)
    v = ref[..., 5] > 0.5
    np.testing.assert_array_equal(out[..., 5] > 0.5, v)
    assert v.sum() > 2
    np.testing.assert_array_equal(out[v][:, 2], ref[v][:, 2])  # class
    np.testing.assert_allclose(out[v][:, 0], ref[v][:, 0], atol=1e-4)  # confidence
    np.testing.assert_allclose(out[v][:, 3:5], ref[v][:, 3:5], atol=1e-3)  # center, width


def test_unpacked_output_matches_packed(pair, tmp_path):
    """``packed=False`` returns the detection dict that packs to the same
    tensor, and ``evaluate_audio`` reads either form to the same rows."""
    from audioyolo_tpu_torch.infer.decode import pack_detections

    _, _, t_fn, _ = pair
    d_fn = make_inference_fn(t_fn.model, t_fn.model.state_dict(), 0.1, CONF, keep_k=32,
                             packed=False, device="cpu")
    fe = t_fn.model.frontend
    wav = (np.random.default_rng(22).standard_normal((2, fe.cfg.clip_samples)) * 3000).astype(np.int16)
    x = torch.from_numpy(fe.frame_host(wav))
    dets = d_fn(x)
    assert set(dets) == {"confidence", "objectness", "class_idx", "center", "width", "valid"}
    assert torch.equal(pack_detections(dets), t_fn(x))
    path = _long_wav(tmp_path, 8000)
    kw = dict(input_sample_rate=8000, sample_duration=4.0, batch_size=2,
              idx2class_map={0: "tone", 1: "beep"}, return_rows=True, frame_fn=fe.frame_host)
    assert evaluate_audio(d_fn, path, str(tmp_path), **kw) == evaluate_audio(t_fn, path, str(tmp_path), **kw)


def _long_wav(tmp_path, sr, name="long.wav"):
    path = str(tmp_path / name)
    events = [(1.0, 2.0, "tone"), (5.0, 6.5, "beep"), (9.0, 10.0, "tone")]
    write_wav(path, synth_clip(sr, 12.0, events, seed=5), sr)
    return path


@pytest.mark.parametrize("file_rate", [8000, 11025])
def test_evaluate_audio_rows_match_jax(pair, tmp_path, file_rate):
    """12 s file, 4 s clips, batch 2: two chunks, the second with one padded
    clip. At 8 kHz the framed path; at 11 025 Hz the on-device resampler."""
    raw, j_fn, t_fn, _ = pair
    path = _long_wav(tmp_path, file_rate)
    kw = dict(input_sample_rate=8000, sample_duration=4.0, batch_size=2,
              idx2class_map={0: "tone", 1: "beep"}, return_rows=True)
    ref = j_evaluate_audio(j_fn, path, str(tmp_path), frame_fn=JFrontend(JConfig(copy.deepcopy(raw))).frame_host, **kw)
    fe = t_fn.model.frontend
    rows = evaluate_audio(t_fn, path, str(tmp_path), frame_fn=fe.frame_host, **kw)
    assert len(rows) == len(ref) > 0
    for a, b in zip(rows, ref):
        assert a["class_idx"] == b["class_idx"]
        assert a["confidence"] == pytest.approx(b["confidence"], abs=1e-4)
        assert a["start"] == pytest.approx(b["start"], abs=1e-3)
        assert a["end"] == pytest.approx(b["end"], abs=1e-3)


def test_evaluate_audio_csv_matches_jax(pair, tmp_path):
    raw, j_fn, t_fn, _ = pair
    path = _long_wav(tmp_path, 8000, "clipdir_long.wav")
    kw = dict(input_sample_rate=8000, sample_duration=4.0, batch_size=2,
              idx2class_map={0: "tone", 1: "beep"})
    j_evaluate_audio(j_fn, path, str(tmp_path / "jax"), **kw)
    evaluate_audio(t_fn, path, str(tmp_path / "port"), **kw)
    sub = tmp_path.name
    with open(tmp_path / "jax" / sub / "clipdir_long_results.csv") as f:
        ref = f.read()
    with open(tmp_path / "port" / sub / "clipdir_long_results.csv") as f:
        assert f.read() == ref
    assert ref.count("\n") > 1


def test_http_server_on_cpu(pair, tmp_path):
    raw, _, _, sd = pair
    cmap = tmp_path / "class_map.json"
    cmap.write_text(json.dumps({"0": "tone", "1": "beep"}))
    state = t_serve.build_app_state(Config(copy.deepcopy(raw)), state_dict=sd,
                                    class_map_path=str(cmap), batch_size=2,
                                    conf_threshold=CONF, device="cpu")
    httpd = t_serve.serve(state, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            assert r.status == 200 and json.loads(r.read()) == {"status": "ok"}
        with urllib.request.urlopen(url + "/meta", timeout=60) as r:
            assert json.loads(r.read())["input_sample_rate"] == 8000
        with open(_long_wav(tmp_path, 8000), "rb") as f:
            body = f.read()
        req = urllib.request.Request(url + "/detect", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            out = json.loads(r.read())
        assert set(out) == {"events", "rows"} and out["rows"]
        starts = [r["start"] for r in out["rows"]]
        assert starts == sorted(starts)
        for a, b in zip(out["events"], out["events"][1:]):
            assert a["class"] != b["class"]
        bad = urllib.request.Request(url + "/detect", data=b"not a wav", method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=60)
        assert ei.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    assert not t.is_alive()

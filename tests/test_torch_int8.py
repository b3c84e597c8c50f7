"""The port's int8 postures against the JAX package's, on the CPU at
``tiny_cfg`` widths (and the shipped frontend at B=1):

- bit for bit: the int8 GEMM (``ops/int8.py``) against the int64 product, on
  the card's awkward shapes too; ``int8_matrix``, ``frame_host_int8`` and
  ``quantize_clips_int8`` (int16 and float32); the int8 DFT's accumulators
  (``power_int8``) and the int8 conv's (``_int8_conv``, the neck's H=1 and
  15-wide convs included);
- the int8 mel stage against JAX's power with the roundings the port's
  ``default`` posture adds (bf16 power and mel rows) to 1e-5;
- calibration: the conv names, the scales (1e-5 relative), a max over
  batches, inert without scales, the default exclusions, and both errors;
- the int8 body with JAX's scales carried across against JAX's int8 body,
  median and 99th percentile of |diff| / max|value| within 2x JAX's own
  int8-vs-float32 gap (int8 rounding of an activation a float32 ulp from a
  .5 boundary flips one level, as bf16 rounding flips in the bf16 tests);
- ``make_inference_fn(int8_input=True)``, the serving and train CLIs under
  the int8 postures.
"""

import copy
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from audioyolo_tpu.config import Config as JConfig, load_config as jload_config
from audioyolo_tpu.infer.streaming import quantize_clips_int8 as j_quantize
from audioyolo_tpu.models import AudioDetectionModel as JModel
from audioyolo_tpu.models import fold_repvgg as jfold
from audioyolo_tpu.models.layers import _int8_conv as j_int8_conv
from audioyolo_tpu.models.quant import calibrate_quant as j_calibrate
from audioyolo_tpu.ops import frontend as jfe

from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.data.wavio import write_wav
from audioyolo_tpu_torch.infer.decode import make_inference_fn
from audioyolo_tpu_torch.infer.streaming import quantize_clips_int8
from audioyolo_tpu_torch.models import (AudioDetectionModel, fold_repvgg, quant_scales_from_jax,
                                        state_dict_from_jax)
from audioyolo_tpu_torch.models.layers import Conv2d, _int8_conv, int8_conv_acc
from audioyolo_tpu_torch.models.quant import (DEFAULT_EXCLUDE, calibrate_quant,
                                              quantized_paths, set_quant)
from audioyolo_tpu_torch.ops import frontend as tfe
from audioyolo_tpu_torch.ops.int8 import int8_mm, int8_mm_plain

from synth import synth_clip
from test_torch_model import _randomize

GAP_FACTOR = 2.0


def _raw(posture="highest", backbone="resnet"):
    from conftest import TINY_CFG

    raw = copy.deepcopy(TINY_CFG)
    raw["backbone"] = backbone
    raw["tpu_config"]["frontend_precision"] = posture
    return raw


def _int16(b, n, seed):
    x = np.random.default_rng(seed).standard_normal((b, n)) * 6000
    x = np.clip(x, -32768, 32767).astype(np.int16)
    x[0, :2] = (-32768, 32767)
    return x


@pytest.mark.parametrize("m,k,n", [(10, 45, 15), (17, 1782, 1002), (300, 576, 64), (1, 8, 8),
                                   (33, 7, 9)])
def test_int8_mm_is_the_integer_product(m, k, n):
    """Odd M, K and N (the neck's 15-wide convs, the DFT's 1782 x 1002, a
    B=1 neck conv's small M) and the extremes -127 and 127."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    a[0, :] = 127
    b[:, 0] = 127
    out = int8_mm(a, b)
    assert out.dtype == torch.int32 and out.shape == (m, n)
    assert torch.equal(out, int8_mm_plain(a, b))
    assert torch.equal(int8_mm(a, b.t().contiguous().t()), out)  # a column-major b
    with pytest.raises(ValueError, match="int8"):
        int8_mm(a.float(), b)


@pytest.mark.parametrize("which", ["tiny", "full"])
def test_int8_matrix_and_frames_bit_equal(which):
    """``int8_matrix`` (codes and scales) and ``frame_host_int8`` (codes and
    clip scales, from int16 and float32 audio, and written into a caller's
    buffer) equal the JAX package's."""
    raw = _raw("int8") if which == "tiny" else dict(
        jload_config("config/config.yaml").to_dict(),
        tpu_config={"frontend_precision": "int8"})
    jf = jfe.SpectralFrontend(JConfig(copy.deepcopy(raw)))
    tf = tfe.SpectralFrontend(Config(copy.deepcopy(raw)))
    for a, b in zip(tf.fused.int8_matrix(), jf.fused.int8_matrix()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    b = 1 if which == "full" else 2
    x16 = _int16(b, jf.cfg.clip_samples, seed=3)
    x32 = (x16 / 32768.0 * 0.7).astype(np.float32)
    for x in (x16, x32, x16[:, None, :]):
        (q, s), (jq, js) = tf.frame_host_int8(x), jf.frame_host_int8(x)
        assert q.dtype == np.int8 and s.dtype == np.float32
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(s, js)
    buf = []
    q2, s2 = tf.frame_host_int8(x16, alloc=lambda shape, dt: buf.append(np.zeros(shape, dt))
                                or buf[0])
    assert q2 is buf[0]
    np.testing.assert_array_equal(q2, jf.frame_host_int8(x16)[0])


def test_quantize_clips_int8_bit_equal():
    """The native int16 quantizer and the numpy float32 one against the JAX
    package's (int16 through its native library), a silent clip included;
    ``out=`` writes the codes in place."""
    x16 = _int16(3, 5003, seed=7).reshape(3, 1, 5003)
    x16[2] = 0
    x32 = (x16.astype(np.float32) / 32768.0 * 1.3).astype(np.float32)
    for x in (x16, x32):
        (q, s), (jq, js) = quantize_clips_int8(x), j_quantize(x)
        assert q.dtype == np.int8 and s.dtype == np.float32
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(s, js)
        out = np.empty(x.shape, np.int8)
        q2, s2 = quantize_clips_int8(x, out=out)
        assert q2 is out
        np.testing.assert_array_equal(out, jq)
        np.testing.assert_array_equal(s2, js)


@pytest.mark.parametrize("which", ["tiny", "full"])
def test_int8_dft_bit_equal_and_mel_against_its_oracle(which):
    """``power_int8``: the int32 accumulators and the power equal JAX's bit
    for bit (JAX's power is float32 squares of the same integers); with
    ``int8_spectrum: bf16`` the accumulators rounded to bf16 equal JAX's
    too. The mel stage (``_fused_int8_mel``): JAX's power and JAX's folded
    mel rows (``s_k**2`` in float64), both rounded to bf16 as the port's
    ``default`` posture rounds its GEMM operands, multiplied in float64 and
    scaled by ``scale**2``, is the oracle; 1e-5 relative to each frame's
    largest band (the float32 sum's order)."""
    raw = _raw("int8") if which == "tiny" else dict(
        jload_config("config/config.yaml").to_dict(),
        tpu_config={"frontend_precision": "int8"})
    jf = jfe.SpectralFrontend(JConfig(copy.deepcopy(raw)))
    tf = tfe.SpectralFrontend(Config(copy.deepcopy(raw)))
    q, s = jf.frame_host_int8(_int16(1 if which == "full" else 2, jf.cfg.clip_samples, seed=5))
    c_i8, s_k = jf.fused.int8_matrix()
    jacc = np.asarray(jnp.einsum("brgf,rfk->brgk", jnp.asarray(q), jnp.asarray(c_i8),
                                 preferred_element_type=jnp.int32))
    tq = torch.from_numpy(q)
    kp = tf.fused_c_i8.shape[1]
    acc = torch.stack([int8_mm(F.pad(tq[:, r], (0, kp - q.shape[-1])).reshape(-1, kp),
                               tf.fused_c_i8[r]).reshape(q.shape[0], q.shape[2], -1)
                       for r in range(q.shape[1])], dim=1)
    np.testing.assert_array_equal(acc[..., :jacc.shape[-1]].numpy(), jacc)
    for dt, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        p = tf.fused.power_int8(tq, tf.fused_c_i8, storage_dtype=dt).numpy()
        np.testing.assert_array_equal(p, np.asarray(jf.fused.power_int8(jnp.asarray(q), jdt)))
    jp = np.asarray(jf.fused.power_int8(jnp.asarray(q)))
    fb = (np.asarray(jf.mel.mel_fb_np, np.float64)
          * np.asarray(s_k, np.float64)[:, None] ** 2).astype(np.float32)
    np.testing.assert_array_equal(tf.mel_fb_i8.numpy(), fb)

    def r(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).double().numpy()

    oracle = (r(jp) @ r(fb)) * (s.astype(np.float64)[:, None, None, None] ** 2)
    with torch.no_grad():
        ours = tf._fused_int8_mel(tq, torch.from_numpy(s)).numpy()
    rel = np.abs(ours - oracle) / oracle.max(axis=-1, keepdims=True)
    assert rel.max() < 1e-5, rel.max()


CONV_CASES = {  # (B, C, H, W, O, kernel, stride, padding)
    "3x3": (2, 16, 8, 20, 24, (3, 3), (1, 1), (1, 1)),
    "3x3 stride 2": (2, 16, 8, 20, 32, (3, 3), (2, 2), (1, 1)),
    "1x1": (2, 24, 4, 10, 16, (1, 1), (1, 1), (0, 0)),
    "H=1, C=15": (2, 15, 1, 20, 15, (3, 3), (1, 2), (1, 1)),
    "H=1 wide": (1, 64, 1, 10, 64, (3, 3), (1, 1), (1, 1)),
    "W=1": (2, 8, 6, 1, 8, (3, 3), (1, 1), (1, 1)),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_int8_conv_accumulator_bit_equal(case):
    """For the same ``x``, ``s_x`` and kernel the port's ``_int8_conv`` gives
    JAX's output bit for bit (an equal int32 accumulator times the same
    float32 scales plus the same bias), float32 and bf16 inputs; the
    accumulator alone equals XLA's int8 conv on the same codes."""
    b, c, h, w, o, k, stride, pad = CONV_CASES[case]
    rng = np.random.default_rng(sum(CONV_CASES[case][:5]))
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    kern = (rng.standard_normal((o, c, *k)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(o) * 0.1).astype(np.float32)
    s_x = np.float32(np.abs(x).max() / 127.0)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(dt)
        ours = _int8_conv(xt, torch.from_numpy(kern), torch.from_numpy(bias),
                          torch.tensor(s_x), stride, pad)
        ref = j_int8_conv(jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt),
                          jnp.asarray(kern.transpose(2, 3, 1, 0)), jnp.asarray(bias),
                          jnp.asarray(s_x), stride, pad)
        assert ours.dtype == dt
        np.testing.assert_array_equal(ours.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2))
    xq = rng.integers(-127, 128, (b, c, h, w), dtype=np.int8)
    wq = rng.integers(-127, 128, (o, c, *k), dtype=np.int8)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(xq.transpose(0, 2, 3, 1)), jnp.asarray(wq.transpose(2, 3, 1, 0)), stride,
        [(pad[0], pad[0]), (pad[1], pad[1])], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    acc = int8_conv_acc(torch.from_numpy(xq), torch.from_numpy(wq), stride, pad)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref).transpose(0, 3, 1, 2))


def _models(backbone="resnet", seed=12):
    """One randomised JAX initialisation as a JAX deploy model and variables
    and the port's deploy model on the same weights, and two batches."""
    raw = _raw("highest", backbone)
    rng = np.random.default_rng(seed)
    segs = [[(0.5, 1.7, "tone")], [(1.0, 3.2, "beep")], [(0.2, 3.9, "tone")]]
    wav = [np.stack([synth_clip(8000, 4.0, segs[(i + j) % 3], seed=seed + 2 * i + j)
                     for j in range(2)])[:, None].astype(np.float32) for i in range(2)]
    wav[1] = (wav[1] * rng.uniform(0.5, 1.5)).astype(np.float32)
    jm = JModel.from_config(raw, num_classes=2)
    v = _randomize(jax.jit(lambda r, x: jm.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(3), jnp.asarray(wav[0])), seed=seed)
    jv = jfold(v)
    jd = JModel.from_config(raw, num_classes=2, deploy=True)
    model = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2, deploy=True)
    model.load_state_dict(fold_repvgg(state_dict_from_jax(v)))
    return jd, jv, model.eval(), wav


def test_calibration_matches_jax_and_is_inert_without_scales():
    """The port's calibration quantizes the convs JAX's does (names mapped)
    at its scales to 1e-5 relative, and is the max over batches. A scale is
    the absmax of a float32 activation, and the two packages reach it
    through float32 sums taken in other orders (the JAX stem runs its
    space-to-depth rewrite of the same conv): observed 3.4e-6 relative on
    the first conv after the stem, where the 1e-6 the float32 outputs agree
    to (``tests/test_torch_model.py``) grows through a max. The float
    body is bit for bit the same before calibration, after it, and after
    ``set_quant(model, {})``; every conv without ``s_x`` is the float conv."""
    jd, jv, model, wav = _models()
    x = [torch.from_numpy(w) for w in wav]
    with torch.no_grad():
        before = model(x[0], combine_scales=True)
    scales = calibrate_quant(model, x)
    assert all(m.s_x is None for m in model.modules() if isinstance(m, Conv2d))
    with torch.no_grad():
        assert torch.equal(model(x[0], combine_scales=True), before)
    ref = quant_scales_from_jax(j_calibrate(jd, jv, wav))
    assert quantized_paths(scales) == sorted(ref) and len(scales) > 20
    for name in ref:
        assert scales[name].item() == pytest.approx(ref[name].item(), rel=1e-5), name
    one = [calibrate_quant(model, [b]) for b in x]
    for name in scales:
        assert scales[name] == torch.maximum(one[0][name], one[1][name]), name
    set_quant(model, scales)
    with torch.no_grad():
        assert not torch.equal(model(x[0], combine_scales=True), before)
    set_quant(model, {})
    with torch.no_grad():
        assert torch.equal(model(x[0], combine_scales=True), before)


@pytest.mark.parametrize("backbone", ["resnet", "custom"])
def test_default_exclusions_and_errors(backbone):
    """The stem convs and the neck's prediction emitters stay float, every
    other conv is quantized; ``include_only`` picks; a calibration that saw
    no conv and a selection that leaves none raise, as in the JAX package;
    an unknown name raises."""
    _, _, model, wav = _models(backbone)
    x = torch.from_numpy(wav[0])
    names = [n for n, m in model.named_modules() if isinstance(m, Conv2d)]
    scales = calibrate_quant(model, [x])
    floats = sorted(set(names) - set(scales))
    assert floats and all(any(e in n + "." for e in DEFAULT_EXCLUDE) for n in floats)
    stems = ["feature_extractor.conv1", "feature_extractor.conv2"] if backbone == "resnet" \
        else ["feature_extractor.first_conv"]
    assert set(stems) <= set(floats)
    assert {n for n in floats if "rep_block" in n} == {
        n for n in names if any(f"rep_block{k}." in n for k in ("2_1", "3_2", "4_1"))}
    only = calibrate_quant(model, [x], include_only=["layer1_0", "entry_block"])
    assert only and all(("layer1_0" in n or "entry_block" in n) for n in only)
    with pytest.raises(ValueError, match="saw no Conv2d"):
        calibrate_quant(model, [])
    with pytest.raises(ValueError, match="no convs selected"):
        calibrate_quant(model, [x], include_only=["nothing"])
    with pytest.raises(ValueError, match="no Conv2d named"):
        set_quant(model, {"nothing": torch.tensor(1.0)})


def _gap(a, ref):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(ref, np.float64)).ravel()
    d /= np.abs(np.asarray(ref, np.float64)).max()
    return float(np.median(d)), float(np.percentile(d, 99))


@pytest.mark.parametrize("backbone,dtype", [("resnet", None), ("custom", None),
                                            ("resnet", "bf16")])
def test_int8_body_with_jax_scales_matches_jax(backbone, dtype):
    """JAX's calibration carried across (``quant_scales_from_jax``): the
    port's int8 body against JAX's on the same clips, median and 99th
    percentile within 2x JAX's own int8-vs-float32 gap (observed 0.4x on
    the ResNet body); with a bf16 body both bodies are bf16 and the gap is
    JAX's int8-bf16 against its bf16."""
    jd, jv, model, wav = _models(backbone, seed=21)
    raw = _raw("highest", backbone)
    jdt = jnp.bfloat16 if dtype else None
    if dtype:
        jd = JModel.from_config(raw, num_classes=2, deploy=True, dtype=jdt)
        sd = model.state_dict()
        model = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2, deploy=True,
                                                dtype=torch.bfloat16)
        model.load_state_dict(sd)
        model.eval()
    jq = j_calibrate(jd, jv, wav)
    x = jnp.asarray(wav[0])
    apply = jax.jit(lambda v, x: jd.apply(v, x, train=False, combine_scales=True))
    ref, ref_f = np.asarray(apply({**jv, "quant": jq}, x)), np.asarray(apply(jv, x))
    set_quant(model, quant_scales_from_jax(jq))
    with torch.no_grad():
        out = model(torch.from_numpy(wav[0]), combine_scales=True).numpy()
    ours, jax_gap = _gap(out, ref), _gap(ref, ref_f)
    print(f"[{backbone} {dtype}] port int8 vs JAX int8 median {ours[0]:.3e} p99 {ours[1]:.3e}; "
          f"JAX int8 vs float median {jax_gap[0]:.3e} p99 {jax_gap[1]:.3e}")
    assert np.isfinite(out).all() and jax_gap[1] > 1e-4
    assert ours[0] <= GAP_FACTOR * jax_gap[0] and ours[1] <= GAP_FACTOR * jax_gap[1]


def test_int8_input_dequantizes_on_the_device():
    """``make_inference_fn(int8_input=True)`` on ``(q, scale)`` gives what
    the plain function gives on ``q * scale`` (the same float32 product);
    a tuple on another device raises."""
    _, _, model, wav = _models()
    sd = model.state_dict()
    fn = make_inference_fn(model, sd, 0.1, 0.2, keep_k=32, device="cpu", int8_input=True)
    q, s = quantize_clips_int8(np.concatenate(wav))
    packed = fn((torch.from_numpy(q), torch.from_numpy(s)))
    plain = make_inference_fn(model, sd, 0.1, 0.2, keep_k=32, device="cpu")
    assert torch.equal(packed, plain(torch.from_numpy(q).float() * torch.from_numpy(s)[:, None,
                                                                                       None]))
    with pytest.raises(ValueError, match="input is on"):
        fn((torch.from_numpy(q).to("meta"), torch.from_numpy(s)))


def test_serve_int8_calib_answers_a_request(tmp_path):
    """``serve.build_app_state(int8_calib=...)`` (``serve --int8_calib``)
    calibrates the int8 body on a WAV and answers one request over HTTP."""
    import threading
    import urllib.request

    import yaml

    from audioyolo_tpu_torch import serve

    raw = _raw("int8")
    (tmp_path / "map").mkdir()
    (tmp_path / "map" / "class_map.json").write_text(json.dumps({"0": "tone", "1": "beep"}))
    raw["train_config"]["class_map_path"] = str(tmp_path / "map")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    _, _, model, _ = _models()
    wav = str(tmp_path / "a.wav")
    write_wav(wav, synth_clip(8000, 9.0, [(1.0, 3.0, "tone"), (5.0, 7.5, "beep")], seed=2), 8000)
    state = serve.build_app_state(str(cfg), state_dict=_train_form(model), device="cpu",
                                  int8_calib=wav, framed_input=True)
    convs = [m for m in state["infer_fn"].model.modules() if isinstance(m, Conv2d)]
    assert sum(m.s_x is not None for m in convs) > 20
    assert state["frame_fn"].__name__ == "frame_host_int8"
    httpd = serve.serve(state, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with open(wav, "rb") as f:
            req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/detect",
                                         data=f.read(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
    finally:
        httpd.shutdown()
        t.join(5)
    assert "events" in body and "rows" in body and body["rows"]
    assert all(0.0 <= row["start"] <= row["end"] <= 12.0 for row in body["rows"])  # 3 windows


def _train_form(deploy_model):
    """A train-form state dict whose fold is ``deploy_model``'s weights: the
    JAX initialisation of ``_models`` again (``build_app_state`` folds)."""
    raw = _raw("highest")
    jm = JModel.from_config(raw, num_classes=2)
    v = _randomize(jax.jit(lambda r, x: jm.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(3), jnp.zeros((1, 1, 32000))), seed=12)
    sd = state_dict_from_jax(v)
    folded = fold_repvgg(sd)
    assert all(torch.equal(folded[k], t) for k, t in deploy_model.state_dict().items())
    return sd

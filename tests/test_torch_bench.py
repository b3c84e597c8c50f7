"""The port's bench (``audioyolo_tpu_torch/bench_cli.py``) on the CPU at
``tiny_cfg`` widths, against the JAX package where the two compute the same
thing (JAX's weights carried across by ``state_dict_from_jax``):

- (a) ``synth_event_clips`` equals the JAX package's bit for bit;
- (b) ``_build_infer``'s composed posture (Bottleneck [1,1,1,1], the int8
  body calibrated on the int8 DFT's ``(q, scale)`` frames, a bf16 deploy
  model, 2 batches per dispatch): its calibration scales against JAX's
  ``calibrate_quant``, its dense predictions against JAX's body, its
  outputs against JAX's decode of its own predictions, and its packed
  detections against JAX's ``make_multi_inference_fn``;
- (c) the FLOP formulas: ``torch._int_mm``, kernel 1's main pass, an int8
  body's dispatch against its convs' MACs;
- (d) the weight file: one per posture, a new key for new model code;
- (e) every ``bench_*`` function through ``run(full=True)`` at B=2, S=2,
  2 batches a dispatch, 1-minute streaming files and one pool worker (the
  pool's sharding is ``test_torch_pool.py``'s): seven lines with the JAX
  bench's metric names, units and keys in its order (``hbm_pct`` left
  out), every value finite; and no card means no run without ``--device cpu``.
"""

import copy
import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioyolo_tpu.config import Config as JConfig
from audioyolo_tpu.infer.decode import detection_postprocess_graph as j_decode
from audioyolo_tpu.infer.decode import make_multi_inference_fn as j_make_multi
from audioyolo_tpu.infer.decode import pack_detections as j_pack
from audioyolo_tpu.models import AudioDetectionModel as JModel
from audioyolo_tpu.models import fold_repvgg as jfold
from audioyolo_tpu.models.quant import calibrate_quant as j_calibrate
from audioyolo_tpu.ops.frontend import SpectralFrontend as JFrontend
from audioyolo_tpu.utils.synth_audio import synth_event_clips as j_synth

from audioyolo_tpu_torch import bench_cli
from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.models import fold_repvgg, quant_scales_from_jax, state_dict_from_jax
from audioyolo_tpu_torch.models.layers import Conv2d
from audioyolo_tpu_torch.ops.mel_kernel import MelKernelFrontend
from audioyolo_tpu_torch.utils.synth_audio import synth_event_clips

from test_torch_model import _randomize

# (b): the port's int8 composed posture against JAX's. The calibration
# scales are the absmax of bf16 activations: where the two bf16 bodies land
# an activation on neighbouring bf16 values the scales differ by one bf16
# step (2^-8 to 2^-7 relative), so each scale is held within 2^-7 relative, and the
# median over the scales within test_torch_int8.py's 1e-5. The dense
# predictions take test_torch_int8.py's bound for an int8 body: the median
# and 99th percentile of |diff| / max|value| within GAP_FACTOR x JAX's own
# int8-vs-bf16 gap on the same inputs. The port's detections are JAX's
# decode of the port's own predictions (0 classes or flags apart, DECODE_ATOL
# on the floats: float32 rounding). Against JAX's detections, rows match by
# class, center within ROW_TOL_S and width within WIDTH_REL (chip_smoke.py's
# BF16_ROW_TOL_S and BF16_WIDTH_REL); on these random weights many rows sit
# near a tie that the int8 rounding breaks either way, so the share matched
# both ways must reach JAX's own int8-vs-bf16 share / GAP_FACTOR, and the
# matched rows' confidence gap stay within GAP_FACTOR x JAX's own.
SCALE_REL, SCALE_MEDIAN_REL = 2.0 ** -7, 1e-5
GAP_FACTOR = 2.0
DECODE_ATOL = 1e-6
ROW_TOL_S, WIDTH_REL = 0.05, 0.05
KEEP = 32
IOU, CONF = 0.1, 0.2  # bench.py's thresholds

# the JAX bench's lines (bench.py:586-643): metric, unit and keys in order,
# less hbm_pct
BASE = ["metric", "value", "unit", "vs_baseline"]
COST = ["tflops_per_dispatch", "mfu_pct"]
EXPECTED = [
    ("audio_seconds_per_sec_per_chip", "audio-s/s", BASE + ["body", "frontend"] + COST),
    ("single_clip_latency", "ms/60s-clip", BASE),
    ("streaming_audio_seconds_per_sec", "audio-s/s",
     BASE + ["transfer", "regime", "active_workers", "solo_mbps", "aggregate_mbps"]),
    ("streaming_single_process_audio_seconds_per_sec", "audio-s/s", BASE + ["transfer"]),
    ("train_audio_seconds_per_sec", "audio-s/s",
     BASE + ["batch", "steps_per_dispatch", "frontend"] + COST),
    ("train_b32_audio_seconds_per_sec", "audio-s/s",
     BASE + ["batch", "steps_per_dispatch", "frontend"] + COST),
    ("scaled_backbone_audio_seconds_per_sec", "audio-s/s", BASE + ["body", "frontend"] + COST),
]


def _tiny():
    from conftest import TINY_CFG

    return copy.deepcopy(TINY_CFG)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: at these shapes more threads only wait on one
    another, and while the suite's other workers load the cores each
    wait costs a descheduled thread's time slice (two threads took 3x
    one thread's time under that load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def home(tmp_path, monkeypatch):
    """The weight cache and the streaming files under ``tmp_path``."""
    import tempfile

    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("seed", [7, 11])
def test_synth_event_clips_bit_equal(seed):
    """The bench's calibration clips (8 kHz x 8 s and the shipped 22 050 Hz
    x 60 s) equal the JAX package's bit for bit."""
    for n, sr, dur in ((3, 8000, 8.0), (2, 22050, 60.0)):
        ours, ref = synth_event_clips(n, sr, dur, seed=seed), j_synth(n, sr, dur, seed=seed)
        assert ours.dtype == ref.dtype == np.float32 and ours.shape == (n, 1, int(sr * dur))
        np.testing.assert_array_equal(ours, ref)
        assert np.abs(ours).max() > 0.2  # events over the noise floor


def _composed_pair(monkeypatch):
    """JAX's composed posture and the port's ``_build_infer`` on the same
    weights: (JAX calibration, JAX multi fn, JAX forward ``apply(variables,
    x)``, JAX variables, port infer fn, port frame_fn, JAX frontend)."""
    raw = _tiny()
    raw["resnet_config"] = {"block": "Bottleneck"}
    raw["block_layers"] = [1, 1, 1, 1]
    jm = JModel.from_config(raw, num_classes=2)
    v = _randomize(jax.jit(lambda r, x: jm.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(3), jnp.zeros((1, 1, JConfig(raw).clip_samples))), seed=5)
    jv = jfold(v)
    monkeypatch.setattr(bench_cli, "_bench_variables",
                        lambda *a, **k: fold_repvgg(state_dict_from_jax(v)))
    fn, frame_fn, _ = bench_cli._build_infer(Config(_tiny()), block="Bottleneck",
                                             layers=[1, 1, 1, 1], keep_k=KEEP, packed=True,
                                             n_dispatch=2, int8=True, frontend="int8",
                                             device="cpu")
    raw["tpu_config"]["frontend_precision"] = "int8"
    jd = JModel.from_config(raw, num_classes=2, deploy=True, dtype=jnp.bfloat16)
    jfe = JFrontend(JConfig(copy.deepcopy(raw)))
    calib = jfe.frame_host_int8(j_synth(8, 8000, 4.0)[:, 0, :])
    jq = j_calibrate(jd, jv, [calib])
    j_multi = j_make_multi(jd, {**jv, "quant": jq}, 2, IOU, CONF, KEEP, packed=True)
    apply = jax.jit(lambda w, x: jd.apply(w, x, train=False, combine_scales=True))
    return jq, j_multi, apply, jv, fn, frame_fn, jfe


def _gap(a, ref):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(ref, np.float64)).ravel()
    d /= np.abs(np.asarray(ref, np.float64)).max()
    return float(np.median(d)), float(np.percentile(d, 99))


def _rows(packed):
    """Valid rows of a packed (B, K, 6) array: per clip (conf, cls, center, width)."""
    return [[(r[0], int(r[2]), r[3], r[4]) for r in clip if r[5] > 0.5] for clip in packed]


def _matched(ref_rows, rows):
    """(matched, of, largest confidence gap): ``ref_rows``' detections with
    one of their class in ``rows``, center within ROW_TOL_S, width within
    WIDTH_REL."""
    hit, n, gap = 0, 0, 0.0
    for a, b in zip(ref_rows, rows):
        for conf, cls, c, w in a:
            n += 1
            m = [r for r in b if r[1] == cls and abs(r[2] - c) <= ROW_TOL_S
                 and abs(r[3] - w) <= WIDTH_REL * w]
            if m:
                hit += 1
                gap = max(gap, min(abs(r[0] - conf) for r in m))
    return hit, n, gap


def _agreement(a, b):
    """(share matched both ways, largest confidence gap) of two packed outputs."""
    h1, n1, g1 = _matched(_rows(a), _rows(b))
    h2, n2, g2 = _matched(_rows(b), _rows(a))
    return (h1 + h2) / max(n1 + n2, 1), max(g1, g2)


def test_composed_posture_matches_jax(monkeypatch):
    """``_build_infer``'s int8 body + int8 DFT + bf16 deploy model, 2 batches
    per dispatch at B=2: the calibration quantizes JAX's convs at JAX's
    scales; the dense predictions sit within twice JAX's own int8-vs-bf16
    gap of JAX's; each output is JAX's decode (bench.py's thresholds,
    ``keep_k``, packing) of the port's predictions on that input; and the
    detections agree with JAX's at least half as well as JAX's int8 agrees
    with its bf16."""
    jq, j_multi, apply, jv, fn, frame_fn, jfe = _composed_pair(monkeypatch)
    assert frame_fn.__name__ == "frame_host_int8"
    model = fn.single.model
    scales = {n: m.s_x for n, m in model.named_modules() if isinstance(m, Conv2d)
              and m.s_x is not None}
    ref = quant_scales_from_jax(jq)
    assert sorted(scales) == sorted(ref) and len(scales) > 20
    rel = np.array([abs(scales[n].item() / ref[n].item() - 1.0) for n in ref])
    print(f"scales: median rel {np.median(rel):.3e}, max {rel.max():.3e}")
    assert rel.max() <= SCALE_REL and np.median(rel) <= SCALE_MEDIAN_REL

    rng = np.random.default_rng(17)
    clips = [(rng.standard_normal((2, 32000)) * 0.1).astype(np.float32) for _ in range(2)]
    framed = [jfe.frame_host_int8(c) for c in clips]
    for (q, s), c in zip(framed, clips):  # the port's framer gives the same bytes
        tq, ts = frame_fn(c)
        np.testing.assert_array_equal(tq, q)
        np.testing.assert_array_equal(ts, s)
    xs = [(torch.from_numpy(q), torch.from_numpy(s)) for q, s in framed]
    jxs = [(jnp.asarray(q), jnp.asarray(s)) for q, s in framed]
    ours, theirs = fn(xs), j_multi(jxs)
    assert len(ours) == len(theirs) == 2
    with torch.inference_mode():
        dense = np.stack([model(x, combine_scales=True).float().numpy() for x in xs])
    j_int8 = np.stack([np.asarray(apply({**jv, "quant": jq}, x), np.float32) for x in jxs])
    j_bf16 = np.stack([np.asarray(apply(jv, x), np.float32) for x in jxs])
    g, jgap = _gap(dense, j_int8), _gap(j_int8, j_bf16)
    print(f"dense: port vs JAX median {g[0]:.3e} p99 {g[1]:.3e}; JAX int8 vs bf16 median "
          f"{jgap[0]:.3e} p99 {jgap[1]:.3e}")
    assert np.isfinite(dense).all() and jgap[1] > 1e-4
    assert g[0] <= GAP_FACTOR * jgap[0] and g[1] <= GAP_FACTOR * jgap[1]

    decode = jax.jit(lambda p: j_pack(j_decode(p, IOU, CONF, JConfig(_tiny()).sample_duration,
                                               KEEP)))
    share, conf_gap, j_share, j_conf_gap = [], 0.0, [], 0.0
    for o, t, p, pb in zip(ours, theirs, dense, j_bf16):
        o, t = o.numpy(), np.asarray(t)
        assert o.shape == t.shape == (2, KEEP, 6) and np.isfinite(o).all()
        r = np.asarray(decode(jnp.asarray(p)))
        np.testing.assert_array_equal(o[..., [2, 5]], r[..., [2, 5]])
        np.testing.assert_allclose(o, r, rtol=0, atol=DECODE_ATOL)
        assert (o[..., 5] > 0.5).sum() > 2 and (o[..., 0][o[..., 5] > 0.5] >= CONF).all()
        s, cg = _agreement(o, t)
        js, jcg = _agreement(t, np.asarray(decode(jnp.asarray(pb))))
        share.append(s)
        j_share.append(js)
        conf_gap, j_conf_gap = max(conf_gap, cg), max(j_conf_gap, jcg)
    share, j_share = float(np.mean(share)), float(np.mean(j_share))
    print(f"detections: port vs JAX matched {share:.3f}, confidence gap {conf_gap:.3e}; JAX "
          f"int8 vs bf16 matched {j_share:.3f}, confidence gap {j_conf_gap:.3e}")
    assert share >= j_share / GAP_FACTOR and conf_gap <= GAP_FACTOR * j_conf_gap


def test_flop_formulas():
    """``_int_mm`` counts 2MKN; kernel 1's main pass counts what
    ``chip_smoke.py``'s bound counts; an int8 body's dispatch counts its
    convs' MACs x 2 (within 5%: ``_int_mm`` and cuDNN's convolutions
    are all it runs), and the whole dispatch adds the frontend's products."""
    a = torch.randint(-127, 128, (40, 72), dtype=torch.int8)
    b = torch.randint(-127, 128, (72, 24), dtype=torch.int8)
    assert bench_cli.count_flops(lambda x: torch._int_mm(*x), (a, b), torch.nn.Module()) \
        == 2 * 40 * 72 * 24

    r, f, k2, bsz, g = 2, 100, 60, 3, 5
    rng = np.random.default_rng(0)
    mk = MelKernelFrontend(rng.standard_normal((r, f, k2)).astype(np.float32),
                           np.abs(rng.standard_normal((k2 // 2, 32))).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((bsz, r, g, f)).astype(np.float32))
    assert bench_cli.count_flops(mk, x, mk) == 2 * bsz * r * g * (f * k2 + k2 * 32)

    raw = _tiny()
    raw["tpu_config"]["frontend_precision"] = "int8"
    fn, frame_fn, _ = bench_cli._build_infer(Config(raw), n_dispatch=2, int8=True,
                                             frontend="int8", device="cpu")
    model = fn.single.model
    macs = []

    def record(mod, args, out):
        w = mod.conv.weight
        kh, kw = w.shape[2], w.shape[3]
        if mod.s_x is not None:  # _int8_conv keeps the middle row of an H=1 input
            kh = 1 if args[0].shape[2] == 1 and kh == 2 * mod.padding[0] + 1 else kh
            kw = 1 if args[0].shape[3] == 1 and kw == 2 * mod.padding[1] + 1 else kw
        macs.append(out.numel() * w.shape[1] * kh * kw)

    hooks = [m.register_forward_hook(record) for m in model.modules() if isinstance(m, Conv2d)]
    x = [bench_cli._bench_input(Config(raw), frame_fn, 2, i, torch.device("cpu"))
         for i in range(2)]
    with torch.inference_mode():
        feats = [model.frontend(a) for a in x]
    try:
        body = sum(bench_cli.count_flops(lambda t: model(features=t, combine_scales=True),
                                         t, model) for t in feats)
    finally:
        for h in hooks:
            h.remove()
    assert any(m.s_x is not None for m in model.modules() if isinstance(m, Conv2d))
    assert body > 0 and abs(body / (2 * sum(macs)) - 1.0) <= 0.05, (body, 2 * sum(macs))
    whole = bench_cli.count_flops(lambda xs: [fn.single(a) for a in xs], x, model)
    fe = model.frontend
    dft = 2 * 2 * 2 * fe.fused_c_i8.shape[0] * x[0][0].shape[2] * fe.fused.c.shape[1] \
        * fe.fused.c.shape[2]
    assert whole >= body + dft, (whole, body, dft)
    with pytest.raises(RuntimeError, match="read 0"):
        bench_cli._cost_fields(0, 1.0)
    with pytest.raises(RuntimeError, match="noise"):
        bench_cli._differenced(lambda n: 0.12 if n == 1 else 0.10, 10)
    stalls = iter([2.0, 0.15, 0.16])  # one stall among the single dispatches
    assert bench_cli._differenced(lambda n: next(stalls) if n == 1 else 0.1 * n + 0.05,
                                  10) == pytest.approx(0.1)


def test_weight_file_per_posture_and_source(home):
    """One weight file per posture, reused; another source hash gives
    another key; the file holds the folded (deploy) state."""
    raw = _tiny()
    p1, p2 = bench_cli._weights_path(raw), bench_cli._weights_path(copy.deepcopy(raw))
    assert p1 == p2 and p1.startswith(str(home / "home"))
    assert bench_cli._weights_path(raw, code="a") != bench_cli._weights_path(raw, code="b")
    assert bench_cli._weights_path(raw, "Bottleneck", [1, 1, 1, 1]) != p1
    s1 = bench_cli._bench_variables(raw)
    mtime = os.stat(p1).st_mtime_ns
    s2 = bench_cli._bench_variables(raw)
    assert os.listdir(os.path.dirname(p1)) == [os.path.basename(p1)]
    assert os.stat(p1).st_mtime_ns == mtime
    assert s1.keys() == s2.keys() and all(torch.equal(s1[k], s2[k]) for k in s1)
    assert any(".reparam." in k for k in s1) and not any(".conv1x1." in k for k in s1)


def test_every_bench_line_on_the_cpu(home, monkeypatch, capfd):
    """``run(full=True)`` at the smallest sizes: seven JSON lines on stdout,
    the JAX bench's metric names, units and keys in its order, every value
    finite, non-zero FLOPs and MFU at most 100. ``main`` without
    ``--device cpu`` raises where no card is present."""
    import yaml

    path = home / "tiny.yaml"
    path.write_text(yaml.safe_dump(_tiny()))
    for name, value in (("BATCH_INFER", 2), ("BATCH", 2), ("TRAIN_B_REF", 2), ("WARMUP", 1),
                        ("ITERS", 2), ("TRAIN_ITERS", 2), ("STREAM_MINUTES", 1),
                        ("POOL_MINUTES", 1), ("POOL_WORKERS", 1), ("N_DISPATCH", 2),
                        ("SCALED_LAYERS", (1, 1, 1, 1))):
        monkeypatch.setattr(bench_cli, name, value)
    monkeypatch.setenv("BENCH_TRAIN_B", "2")
    monkeypatch.setenv("BENCH_TRAIN_S", "2")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the pool's worker, as the fixture above
    lines = bench_cli.run(str(path), full=True, device="cpu")
    printed = [json.loads(s) for s in capfd.readouterr().out.splitlines()]
    assert printed == lines and len(lines) == len(EXPECTED)
    for line, (metric, unit, keys) in zip(lines, EXPECTED):
        assert line["metric"] == metric and line["unit"] == unit
        assert list(line) == keys, (metric, list(line))
        nums = [v for v in line.values() if isinstance(v, (int, float)) and v is not None]
        assert all(math.isfinite(v) for v in nums), line
        assert line["value"] > 0
        if "mfu_pct" in line:
            assert line["tflops_per_dispatch"] > 0 and 0 <= line["mfu_pct"] <= 100
    assert lines[0]["body"] == "int8" and lines[0]["frontend"] == "int8"
    assert lines[1]["vs_baseline"] == 0.0
    assert lines[2]["transfer"] == "int8" and lines[2]["active_workers"] == 1
    assert [ln["batch"] for ln in lines[4:6]] == [2, 2]
    assert lines[4]["steps_per_dispatch"] == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_cli.main([])

"""``backbone: convnext`` (ConvNeXt, arXiv:2201.03545) in the port, on the CPU
at tiny widths (dims 16/32/64/128, ``block_layers`` [1, 1, 2, 1], 4 s
windows at 8 kHz), features fed in directly where the frontend is not under
test.

- The float32 backbone against ``tests/convnext_ref.py`` (the official
  ``Block`` in NHWC with ``Linear`` layers, written apart from the port):
  each map to 1e-5 of its largest value (float32 sums of at most 4C terms in
  another order and layout: observed about 1e-6), and the detector's dense
  predictions, with the reference's maps taken through the benchmark's
  plain neck and decode, to 1e-4 in confidence and 1e-3 s in time;
- the bf16 body against the float32 reference: each map within 3x either
  way of the benchmark's bf16 yardstick, which rounds every value where the
  configuration's ``compute_dtype`` stores it (the port rounds where the
  yardstick does, so the two depart alike; a block left out or a wrong
  layer scale departs by 10x or more);
- the layout: the port's ``state_dict`` names and shapes are the benchmark
  reference's ``shapes(cfg)``, and the two references agree;
- train mode: at ``drop_path_rate`` 0 the backbone is its eval form; above
  0 the per-sample masks are the generator's, block after block, on one
  device and on each rank of a sharded draw; remat gives the plain step;
- int8: depthwise convs and the stem stay float, pointwise and downsampling
  convs are quantised, and the int8 body runs; the ResNet and custom
  bodies' convs are ungrouped and unchanged;
- spans: under a profiler each ``ayt.model.*`` span is counted once per
  forward, and without one nothing is.
"""

import copy
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.models import AudioDetectionModel
from audioyolo_tpu_torch.models.backbone import (ConvNeXtBackbone, ConvNeXtBlock, ShardedRng)
from audioyolo_tpu_torch.models.layers import BatchNorm, Conv2d, LayerNorm2d
from audioyolo_tpu_torch.models.quant import calibrate_quant, set_quant
from audioyolo_tpu_torch.train import AudioDetectionLoss, TrainerPipeline
from audioyolo_tpu_torch.utils import trace

from convnext_ref import ConvNeXtRef
from perfbench.reference.detector import Detector, backbone_module, checkpoint_shapes

DIMS = [16, 32, 64, 128]
DEPTHS = [1, 1, 2, 1]
LOSS_KW = dict(num_classes=2, anchor_t=5.0, edge_t=0.5, sample_duration=4.0, box_w=0.1,
               conf_w=1.0, class_w=0.3, multi_label=True, label_smoothing=0.08)


def _raw(depths=DEPTHS, rate=0.0, dims=DIMS):
    from conftest import TINY_CFG

    raw = copy.deepcopy(TINY_CFG)
    raw.update(backbone="convnext", block_layers=list(depths),
               convnext_config=dict(dims=list(dims), layer_scale_init=1e-6,
                                    drop_path_rate=rate))
    raw["tpu_config"]["frontend_precision"] = "highest"
    return raw


def _model(raw, dtype=None, seed=0):
    model = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2, dtype=dtype)
    model.load_state_dict(_random_state(model, seed))
    return model.eval()


def _random_state(model, seed):
    """Every leaf far from its initial value: layer scales U(0.1, 0.5) (at
    1e-6 each block is the identity), LayerNorm and BatchNorm affines
    U(0.8, 1.2) and U(-0.1, 0.1), conv kernels at unit gain over their fan
    in, biases U(-0.1, 0.1)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in model.state_dict().items():
        u = torch.rand(v.shape, generator=g)
        if k.endswith("gamma"):
            out[k] = 0.1 + 0.4 * u
        elif v.dim() == 4:
            out[k] = (2 * u - 1) * math.sqrt(3.0 / (v.shape[1] * v.shape[2] * v.shape[3]))
        elif k.endswith("running_var"):
            out[k] = 0.8 + 0.4 * u
        elif k.endswith("weight"):
            out[k] = 0.8 + 0.4 * u
        elif k.endswith(("bias", "running_mean")):
            out[k] = (2 * u - 1) * 0.1
        else:
            out[k] = v
    return out


def _features(seed=1, b=2):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((b, 32, 160, 2))
                            .astype(np.float32))


def _image(feats):
    return feats.permute(0, 3, 1, 2).contiguous()


def _ref(model, depths=DEPTHS, dims=DIMS, rate=0.0):
    ref = ConvNeXtRef(depths, dims, drop_path_rate=rate)
    ref.load_port_state_dict(model.state_dict())
    return ref.eval()


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@pytest.mark.parametrize("seed", [0, 1])
def test_float32_maps_match_the_reference(seed):
    raw = _raw()
    model = _model(raw, seed=seed)
    x = _image(_features(seed))
    with torch.no_grad():
        port = model.feature_extractor(x)
        ref = _ref(model)(x)
    assert [tuple(m.shape) for m in port] == [(2, 16, 8, 40), (2, 32, 4, 20), (2, 64, 2, 10),
                                              (2, 128, 1, 5)]
    for p, r in zip(port, ref):
        assert _rel(p, r) < 1e-5


def test_dense_predictions_match_the_reference():
    """The whole detector in float32 against the reference's maps through
    the benchmark's plain neck (RepVGG folded from the unfolded weights) and
    decode."""
    raw = _raw()
    model = _model(raw)
    feats = _features(2)
    with torch.no_grad():
        port = model(features=feats, combine_scales=True)
        maps = _ref(model)(_image(feats))
        det = Detector(raw, model.state_dict(), "cpu")
        outs = det.neck(*maps)
        ref = torch.cat([det.decode(o, k, 160) for o, k in zip(outs, ("sm", "md", "lg"))], 1)
    conf = torch.sigmoid(port[..., :1]) * torch.sigmoid(port[..., 1:3])
    conf_ref = torch.sigmoid(ref[..., :1]) * torch.sigmoid(ref[..., 1:3])
    assert float((conf - conf_ref).abs().max()) < 1e-4
    assert float((port[..., -2:] - ref[..., -2:]).abs().max()) < 1e-3


def test_bf16_body_departs_like_the_yardstick():
    raw = _raw()
    model = _model(raw)
    bf16 = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2, dtype=torch.bfloat16)
    bf16.load_state_dict(model.state_dict())
    bf16.eval()
    x = _image(_features(3))
    sd = model.state_dict()
    with torch.no_grad():
        ref = _ref(model)(x)
        port = bf16.feature_extractor(x.to(torch.bfloat16))
        yard_det = Detector(raw, sd, "cpu", body_bf16=True)
        yard = backbone_module(raw).forward(yard_det, yard_det.r(x))
        # a fault: the deepest stage's layer scales off
        bad_sd = {k: (torch.zeros_like(v) if k.startswith("feature_extractor.stage3_1.")
                      and k.endswith("gamma") else v) for k, v in sd.items()}
        bad_det = Detector(raw, bad_sd, "cpu", body_bf16=True)
        bad = backbone_module(raw).forward(bad_det, bad_det.r(x))
    for p, y, r, f in zip(port, yard, ref, bad):
        gp, gy = _rel(p, r), _rel(y, r)
        assert p.dtype == torch.bfloat16
        assert gy / 3 < gp < 3 * gy, (gp, gy)
        assert gp < 0.05
    assert _rel(bad[2], ref[2]) > 10 * _rel(port[2], ref[2])


@pytest.mark.parametrize("depths", [DEPTHS, [3, 3, 27, 3]], ids=["tiny", "convnext_b_depths"])
def test_state_dict_is_the_benchmark_references_layout(depths):
    raw = _raw(depths)
    model = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2)
    sd = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    mine = checkpoint_shapes(raw, 2)
    assert sd == mine
    backbone = [k for k in sd if k.startswith("feature_extractor.")]
    assert backbone == list(backbone_module(raw).shapes(raw)[0])
    assert len(backbone) == 4 + 4 * 3 + 9 * sum(depths)
    assert model.feature_extractor.fmap_channels == tuple(DIMS)


def test_the_two_references_agree():
    raw = _raw()
    model = _model(raw, seed=4)
    x = _image(_features(4))
    with torch.no_grad():
        mine = _ref(model)(x)
        det = Detector(raw, model.state_dict(), "cpu")
        theirs = backbone_module(raw).forward(det, x)
    for a, b in zip(mine, theirs):
        assert _rel(a, b) < 1e-5


def test_initialisation_is_the_papers():
    raw = _raw()
    model = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2)
    fe = model.feature_extractor
    convs = [m for m in fe.modules() if isinstance(m, Conv2d)]
    w = torch.cat([m.conv.weight.flatten() for m in convs])
    w = w.detach()
    assert abs(float(w.std()) - 0.02) < 0.002 and float(w.abs().max()) <= 2.0
    assert all(float(m.conv.bias.detach().abs().max()) == 0.0 for m in convs)
    for m in fe.modules():
        if isinstance(m, LayerNorm2d):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert torch.equal(m.bias, torch.zeros_like(m.bias))
        if isinstance(m, ConvNeXtBlock):
            assert torch.equal(m.gamma, torch.full_like(m.gamma, 1e-6))
    # the neck keeps its glorot kernels and 0.01 biases
    neck_bias = model.multiscale_module.cspsppf.conv1.conv.conv.bias
    assert torch.equal(neck_bias, torch.full_like(neck_bias, 0.01))
    rates = [m.drop_rate for m in fe.modules() if isinstance(m, ConvNeXtBlock)]
    assert rates == [0.0] * 5
    fe5 = ConvNeXtBackbone([1, 1, 2, 1], DIMS, drop_path_rate=0.5)
    got = [m.drop_rate for m in fe5.modules() if isinstance(m, ConvNeXtBlock)]
    assert got == pytest.approx([0.0, 0.125, 0.25, 0.375, 0.5])


def test_train_mode_at_rate_0_is_eval_mode():
    model = _model(_raw(rate=0.0))
    x = _image(_features(5))
    fe = model.feature_extractor
    with torch.no_grad():
        fe.eval()
        a = fe(x)
        fe.train()
        b = fe(x, torch.Generator().manual_seed(3))
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def _keeps(rates, b, g, rank=0, world=1):
    """The per-block keep masks the port draws: one (world * b, 1, 1, 1)
    Bernoulli draw per block whose rate is above 0, in block order, the
    rank's rows kept."""
    out = []
    for p in rates:
        if p <= 0:
            out.append(None)
            continue
        m = torch.bernoulli(torch.empty(world * b, 1, 1, 1), 1.0 - p, generator=g)
        out.append(m[rank * b: (rank + 1) * b])
    return out


def test_stochastic_depth_masks_come_from_the_generator():
    raw = _raw(rate=0.6)
    model = _model(raw)
    fe = model.feature_extractor.train()
    x = _image(_features(6, b=8))
    rates = [m.drop_rate for m in fe.modules() if isinstance(m, ConvNeXtBlock)]
    with torch.no_grad():
        a = fe(x, torch.Generator().manual_seed(11))
        b = fe(x, torch.Generator().manual_seed(11))
        c = fe(x, torch.Generator().manual_seed(12))
        keeps = _keeps(rates, 8, torch.Generator().manual_seed(11))
        ref = _ref(model, rate=0.6)(x, keeps)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not all(torch.equal(p, q) for p, q in zip(a, c))
    dropped = torch.cat([k.flatten() for k in keeps if k is not None])
    assert 0 < float(dropped.sum()) < dropped.numel()  # some samples dropped, some kept
    for p, r in zip(a, ref):
        assert _rel(p, r) < 1e-5
    with pytest.raises(ValueError, match="stochastic depth needs a torch.Generator"):
        fe(x)


def test_stochastic_depth_on_a_rank_keeps_its_rows():
    """Two ranks of a data-parallel group, each with half of the batch: the
    rank's blocks drop what the single-device step drops on its rows."""
    model = _model(_raw(rate=0.6))
    fe = model.feature_extractor.train()
    x = _image(_features(7, b=8))
    rates = [m.drop_rate for m in fe.modules() if isinstance(m, ConvNeXtBlock)]
    with torch.no_grad():
        whole = fe(x, torch.Generator().manual_seed(21))
        for rank in (0, 1):
            part = fe(x[4 * rank: 4 * rank + 4],
                      ShardedRng(torch.Generator().manual_seed(21), rank, 2))
            keeps = _keeps(rates, 4, torch.Generator().manual_seed(21), rank, 2)
            ref = _ref(model, rate=0.6)(x[4 * rank: 4 * rank + 4], keeps)
            for p, w, r in zip(part, whole, ref):
                assert _rel(p, w[4 * rank: 4 * rank + 4]) < 1e-5
                assert _rel(p, r) < 1e-5


def _batch():
    from synth import synth_clip

    segs = [[(0.3, 1.4, "tone"), (2.0, 3.1, "beep")], [(0.8, 2.6, "beep")]]
    audio = np.stack([synth_clip(8000, 4.0, s, seed=30 + j) for j, s in enumerate(segs)])
    t = {"classes": torch.tensor([[1, 0, -100, 0], [0, -100, 0, 0]], dtype=torch.int32),
         "centers": torch.tensor([[0.85, 2.55, 3.55, 0], [1.7, 3.3, 0, 0]]),
         "widths": torch.tensor([[1.1, 1.1, 0.9, 0], [1.8, 1.4, 0, 0]]),
         "valid": torch.tensor([[True, True, True, False], [True, True, False, False]])}
    return torch.from_numpy(audio.astype(np.float32)), t


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["float32", "bf16"])
def test_remat_gives_the_plain_step(dtype):
    """One ``TrainerPipeline.train_step`` at drop-path rate 0.5: with
    ``remat`` each ConvNeXt block keeps its conv outputs and its
    stochastic-depth mask and recomputes the rest; the metrics, every
    gradient and every updated parameter equal the plain step's."""
    raw = _raw(rate=0.5)
    sd = _model(raw).state_dict()
    audio, t = _batch()
    steps = []
    for remat in (False, True):
        model = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2, dtype=dtype)
        model.load_state_dict(sd)
        tc = raw["train_config"]
        tr = TrainerPipeline(model, AudioDetectionLoss(raw["anchors"], **LOSS_KW),
                             tc["optimizer_config"], None, use_lr_scheduler=False, seed=5,
                             device="cpu", remat=remat)
        metrics = tr.train_step(audio, t)
        steps.append((metrics, {k: (p.grad.clone(), p.detach().clone())
                                for k, p in tr.model.named_parameters() if p.grad is not None}))
    (ma, ga), (mb, gb) = steps
    assert torch.equal(ma, mb) and bool(torch.isfinite(ma).all())
    assert set(ga) == set(gb) and any(k.endswith("gamma") for k in ga)
    for k in ga:
        assert torch.equal(ga[k][0], gb[k][0]) and torch.equal(ga[k][1], gb[k][1]), k


def test_int8_leaves_depthwise_convs_and_the_stem_float():
    model = AudioDetectionModel.from_config(Config(copy.deepcopy(_raw())), 2, deploy=True)
    model.load_state_dict(_random_state(model, 9))
    model.eval()
    audio = _batch()[0]
    with torch.no_grad():
        want = model(audio, combine_scales=True)
    scales = calibrate_quant(model, [audio])
    names = set(scales)
    fe = "feature_extractor."
    assert not any(".dwconv" in n for n in names)
    assert fe + "stem" not in names
    assert {fe + "down2", fe + "stage1_0.pwconv1", fe + "stage3_1.pwconv2"} <= names
    with pytest.raises(ValueError, match="no Conv2d named"):
        set_quant(model, {fe + "stage1_0.dwconv": torch.tensor(0.1)})
    set_quant(model, scales)
    with torch.no_grad():
        got = model(audio, combine_scales=True)
    assert torch.isfinite(got).all()
    assert all(m.s_x is None for n, m in model.named_modules()
               if isinstance(m, Conv2d) and (m.groups > 1 or n == fe + "stem"))
    assert 0 < float((got - want).abs().max()) < 0.5 * float(want.abs().max())


@pytest.mark.parametrize("backbone", ["resnet", "custom"])
def test_ungrouped_convs_are_unchanged(backbone):
    """The ResNet and custom bodies hold only ``groups=1`` convs, each the
    plain ``F.conv2d`` of its kernel, bit for bit."""
    from conftest import TINY_CFG

    raw = copy.deepcopy(TINY_CFG)
    raw["backbone"] = backbone
    model = AudioDetectionModel.from_config(Config(raw), 2)
    convs = [m for m in model.modules() if isinstance(m, Conv2d)]
    assert convs and all(m.groups == 1 for m in convs)
    m = model.feature_extractor.layer1_0.conv1 if backbone == "resnet" else \
        model.feature_extractor.first_conv
    x = torch.randn(2, m.conv.weight.shape[1], 8, 16)
    want = F.conv2d(x, m.conv.weight, m.conv.bias, m.stride, m.padding)
    assert torch.equal(m(x), want)


@pytest.mark.parametrize("backbone", ["convnext", "resnet"])
def test_model_spans_once_per_forward(backbone):
    from conftest import TINY_CFG

    raw = _raw() if backbone == "convnext" else copy.deepcopy(TINY_CFG)
    model = AudioDetectionModel.from_config(Config(raw), 2).eval()
    feats = _features(10)
    trace.reset()
    with torch.no_grad():
        model(features=feats)
    assert trace.totals() == {}
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        for _ in range(2):
            model(features=feats)
    got = {k: v["count"] for k, v in trace.totals().items()}
    want = {"ayt.model.backbone": 2, "ayt.model.neck": 2}
    if backbone == "convnext":
        want.update({f"ayt.model.stage{s}": 2 for s in range(1, 5)})
    assert got == want
    trace.reset()


def test_directory_inference_runs_the_convnext_body(tmp_path):
    """``inference_cli.build_worker`` and ``evaluate_dir``, the path of every
    benchmark cell, on a ConvNeXt checkpoint (float32, then bf16)."""
    import yaml

    from audioyolo_tpu_torch.data.wavio import write_wav
    from audioyolo_tpu_torch.infer.runner import evaluate_dir
    from audioyolo_tpu_torch.inference_cli import build_worker

    raw = _raw()
    model = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2)
    state = _random_state(model, 12)
    torch.save(state, tmp_path / "w.pt")
    (tmp_path / "cmap.json").write_text('{"0": "alarm", "1": "music"}')
    audio = tmp_path / "audio"
    os.makedirs(audio)
    rng = np.random.default_rng(12)
    for i, s in enumerate((4.0, 9.0)):
        write_wav(str(audio / f"f{i}.wav"),
                  (0.1 * rng.standard_normal((1, int(s * 8000)))).astype(np.float32), 8000)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    for bf16 in (False, True):
        infer_fn, frame_fn = build_worker(str(cfg_path), str(tmp_path / "w.pt"),
                                          str(tmp_path / "cmap.json"), 0.1, 0.2, bf16=bf16,
                                          device="cpu")
        out = tmp_path / f"out{int(bf16)}"
        evaluate_dir(infer_fn, str(audio), str(out), extension="wav", input_sample_rate=8000,
                     sample_duration=4.0, batch_size=2, idx2class_map={0: "alarm", 1: "music"},
                     frame_fn=frame_fn, verbose=False)
        csvs = sorted(n for _, _, names in os.walk(out) for n in names)
        assert csvs == ["f0_results.csv", "f1_results.csv"]

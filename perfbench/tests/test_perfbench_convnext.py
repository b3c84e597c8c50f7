"""The ConvNeXt-B configuration (``ayolo-convnext-b``, backbone
``reference/backbones/convnext.py``): its layout and FLOPs at full size, its
seeded draw, the reference against the port at a tiny size, the layer
scales' weight against the bf16 yardstick, and the readers of the model
spans' device time."""

import copy
import hashlib
import json
import math

import numpy as np
import pytest
import torch

import conftest
from perfbench import harness, model_spans, program_spans, weights
from perfbench.count.model_flops import forward_flops_per_window
from perfbench.reference import detections as D
from perfbench.reference.detector import Detector, backbone_module, checkpoint_shapes
from perfbench.traffic import synth

CONFIG = "ayolo-convnext-b"

# (tensors, values, sha256 of the ordered [[name, shape], ...] JSON, FLOPs
# of a 60 s window) at full size: 340 of the tensors and 87,562,368 of the
# values, and 18,792,591,360 of the FLOPs (86 %), are the backbone's
LAYOUT = (533, 88_418_667, "58d5d4328decc7937d852aaf09f0198bded7144c68efff93ce2d02a4688b45a1",
          21_753_277_380)

# sha256 over (name, float32 bytes) of every drawn leaf (the fitted running
# statistics left out) of ``weights.make`` at the tiny size, seed 2**31 + 12345
DRAW = "3b5df964c8e23f702c58368e9115e18d61812e662d27d16b428b70cb908d3938"


def _tiny():
    return conftest.tiny_config(CONFIG)["config"]


def _float32(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["tpu_config"].update(frontend_precision="highest", pallas_frontend="off")
    return cfg


def test_layout_and_flops_are_pinned():
    cfg = harness.load_config(CONFIG)["config"]
    shapes = checkpoint_shapes(cfg, 2)
    n, values, digest, flops = LAYOUT
    listed = json.dumps([[k, list(v)] for k, v in shapes.items()])
    assert (len(shapes), sum(math.prod(v) for v in shapes.values())) == (n, values)
    assert hashlib.sha256(listed.encode()).hexdigest() == digest
    backbone, pyramid = backbone_module(cfg).shapes(cfg)
    assert (len(backbone), sum(math.prod(v) for v in backbone.values())) == (340, 87_562_368)
    assert pyramid == (128, 256, 512, 1024)
    assert cfg["block_layers"] == [3, 3, 27, 3]
    assert forward_flops_per_window(cfg, 2) == flops


def test_seeded_draw_is_pinned():
    sd = weights.make(_tiny(), 2, 2 ** 31 + 12345, "cpu", fit_windows=1)
    h = hashlib.sha256()
    for k, v in sd.items():
        if not k.endswith(("running_mean", "running_var")):
            h.update(k.encode())
            h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == DRAW
    gammas = torch.cat([v for k, v in sd.items() if k.endswith(".gamma")])
    assert 0.1 <= float(gammas.min()) and float(gammas.max()) <= 0.5
    dw = sd["feature_extractor.stage1_0.dwconv.conv.weight"]
    assert 0.2 < float(dw.abs().max()) <= math.sqrt(6.0 / 98.0)


def test_reference_matches_the_ports_float32_model(tmp_path):
    from audioyolo_tpu_torch.inference_cli import build_inference

    torch.set_num_threads(2)
    cfg = _float32(_tiny())
    sd = weights.make(cfg, 2, 3, "cpu", fit_windows=2)
    torch.save(sd, tmp_path / "w.pt")
    clips = synth.synth_event_clips(2, 22050, 4.0, seed=1)
    x = torch.from_numpy(np.round(clips * 32767).astype(np.int16))
    f = build_inference(cfg, 2, str(tmp_path / "w.pt"), 0.1, 0.2, device="cpu")
    with torch.inference_mode():
        port = f.model(x, combine_scales=True)
    ref = Detector(cfg, sd, "cpu")(x[:, 0].float() / 32768)
    conf = (D.confidences(port) - D.confidences(ref)).abs().max()
    assert float(conf) < 1e-4, float(conf)
    assert float((port[..., -2:] - ref[..., -2:]).abs().max()) < 1e-3


def test_layer_scales_weigh_more_than_bf16_rounding():
    """Stage 3's layer scales zeroed move the reference's confidences by
    more than the bf16 yardstick does: the drawn scales make every block
    count, so a fault in one is not lost under rounding."""
    cfg = _float32(_tiny())
    sd = weights.make(cfg, 2, 4, "cpu", fit_windows=2)
    wave = torch.from_numpy(synth.synth_event_clips(2, 22050, 4.0, seed=3)[:, 0])
    ref = D.confidences(Detector(cfg, sd, "cpu")(wave))
    yard = D.confidences(Detector(cfg, sd, "cpu", body_bf16=True)(wave))
    off = {k: torch.zeros_like(v) if k.startswith("feature_extractor.stage3_")
           and k.endswith(".gamma") else v for k, v in sd.items()}
    zeroed = D.confidences(Detector(cfg, off, "cpu")(wave))
    y, z = float((yard - ref).abs().mean()), float((zeroed - ref).abs().mean())
    assert z > 3 * y > 0, (z, y)


TRACE = {"window_s": 2.0, "busy_s": 0.8,
         "device_spans": {"ayt.model.backbone": [0.001, 8], "ayt.model.stage1": [0.1, 8],
                          "ayt.model.stage2": [0.05, 8], "ayt.model.stage3": [0.3, 8],
                          "ayt.model.stage4": [0.05, 8], "ayt.model.neck": [0.1, 8]}}
DRAINS = {program_spans.DRAIN: {"count": 8, "total_s": 0.06, "self_s": 0.04}}
ALONE = {"window_s": 2.0, "busy_s": 0.8, "device_spans": {"ayt.model.backbone": [0.2, 8]}}


@pytest.mark.parametrize("metric, trace, want", [
    ("backbone_ms_per_batch.batch", TRACE, 1e3 * 0.501 / 8),
    ("backbone_busy_pct.batch", TRACE, 100 * 0.501 / 0.8),
    ("backbone_ms_per_batch.batch", ALONE, 25.0),
    ("backbone_busy_pct.batch", ALONE, 25.0)], ids=["ms_stages", "pct_stages", "ms", "pct"])
def test_backbone_readers(metric, trace, want, monkeypatch):
    """With stage spans nested in the backbone's (a kernel belongs to its
    innermost span) and without (a ResNet backbone)."""
    monkeypatch.setattr(program_spans, "program_totals", lambda: dict(DRAINS))
    monkeypatch.setattr(model_spans, "program_totals", lambda: dict(DRAINS))
    assert harness.metric_reader(metric).read(trace, {}) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["backbone_ms_per_batch.batch", "backbone_busy_pct.batch"])
def test_backbone_readers_read_nothing_without_the_span(metric, monkeypatch):
    """A program without model spans (the parent's), a trace without
    ``device_spans``, no batch, and an idle slice: None, never a raise."""
    monkeypatch.setattr(model_spans, "program_totals", lambda: dict(DRAINS))
    read = harness.metric_reader(metric).read
    assert read({"window_s": 2.0, "busy_s": 0.8, "device_spans": {}}, {}) is None
    assert read({"window_s": 2.0, "busy_s": 0.8}, {}) is None
    stages_only = {k: v for k, v in TRACE["device_spans"].items() if k != "ayt.model.backbone"}
    assert read({"window_s": 2.0, "busy_s": 0.8, "device_spans": stages_only}, {}) is None
    monkeypatch.setattr(model_spans, "program_totals", dict)
    if metric.startswith("backbone_ms"):
        assert read(TRACE, {}) is None
    else:
        assert read(dict(TRACE, busy_s=0.0), {}) is None

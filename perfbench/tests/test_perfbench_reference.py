"""The plain reference agrees with the port at a tiny size on the CPU, in
the float32 postures where the two must meet closely."""

import copy
import hashlib
import json
import math

import numpy as np
import pytest
import torch

import conftest
from perfbench import harness, weights
from perfbench.reference import detections as D
from perfbench.count.model_flops import forward_flops_per_window
from perfbench.reference.detector import Detector, checkpoint_shapes
from perfbench.traffic import synth


@pytest.mark.parametrize("config", ["ayolo-r18-shipped", "ayolo-r50"])
def test_checkpoint_shapes_are_the_ports(config):
    from audioyolo_tpu_torch.models.detector import AudioDetectionModel

    cfg = conftest.tiny_config(config)["config"]
    sd = AudioDetectionModel.from_config(cfg, 2).state_dict()
    mine = checkpoint_shapes(cfg, 2)
    assert set(sd) == set(mine)
    assert all(tuple(sd[k].shape) == mine[k] for k in sd)


# Read from the harness as it was before backbones became files of their
# own: (tensors, values, sha256 of the ordered [[name, shape], ...] JSON,
# FLOPs of a window) at the configurations' full sizes.
LAYOUTS = {
    "ayolo-r18-shipped": (294, 12_137_579,
                          "267a1379742509baa14a59ca75a16404d77eecb86f114d5d43b2c32b21bd471f",
                          5_892_111_300),
    "ayolo-r50": (459, 24_819_819,
                  "e0f2a894df1900fc66b30d56bcd3a38a4c9b529ef8539f3442ce9142c232f3e1",
                  8_711_470_020),
}

# sha256 over (name, float32 bytes) of every drawn leaf (the fitted running
# statistics left out) of ``weights.make`` at the tiny size, seed 2**31 + 12345
DRAWS = {
    "ayolo-r18-shipped": "826f45d2593a15d7367211aa70aa9b508f88dba108627505435058af7b593475",
    "ayolo-r50": "761bc65abcf2bd716db11421db5b8c7b608498ee6c0483287205d3aeb9ff1851",
}


@pytest.mark.parametrize("config", sorted(LAYOUTS))
def test_checkpoint_layout_and_flops_are_pinned(config):
    cfg = harness.load_config(config)["config"]
    shapes = checkpoint_shapes(cfg, 2)
    n, values, digest, flops = LAYOUTS[config]
    listed = json.dumps([[k, list(v)] for k, v in shapes.items()])
    assert (len(shapes), sum(math.prod(v) for v in shapes.values())) == (n, values)
    assert hashlib.sha256(listed.encode()).hexdigest() == digest
    assert list(shapes)[:5] == ["sm_anchors", "md_anchors", "lg_anchors",
                                "feature_extractor.conv1.conv.weight",
                                "feature_extractor.conv2.conv.weight"]
    assert forward_flops_per_window(cfg, 2) == flops


@pytest.mark.parametrize("config", sorted(DRAWS))
def test_seeded_draw_is_pinned(config):
    sd = weights.make(conftest.tiny_config(config)["config"], 2, 2 ** 31 + 12345, "cpu",
                      fit_windows=1)
    h = hashlib.sha256()
    for k, v in sd.items():
        if not k.endswith(("running_mean", "running_var")):
            h.update(k.encode())
            h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == DRAWS[config]


def test_unknown_backbone_names_the_file_looked_for():
    cfg = dict(harness.load_config("ayolo-r18-shipped")["config"], backbone="nonesuch")
    with pytest.raises(FileNotFoundError, match=r"reference/backbones/nonesuch\.py"):
        checkpoint_shapes(cfg, 2)


def _float32(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["tpu_config"].update(frontend_precision="highest", pallas_frontend="off")
    return cfg


@pytest.mark.parametrize("config", ["ayolo-r18-shipped", "ayolo-r50"])
def test_dense_predictions_match_the_ports_float32_model(config, tmp_path):
    from audioyolo_tpu_torch.inference_cli import build_inference

    torch.set_num_threads(2)
    cfg = _float32(conftest.tiny_config(config)["config"])
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


def test_kernel_posture_frontend_matches_the_ports_plain_kernel():
    """``default`` + ``pallas_frontend: on``: the reference's split bf16
    power against the port's plain kernel 1 on the CPU."""
    from audioyolo_tpu_torch.ops.frontend import SpectralFrontend

    cfg = conftest.tiny_config()["config"]
    clips = torch.from_numpy(synth.synth_event_clips(2, 22050, 4.0, seed=2)[:, 0])
    port = SpectralFrontend(cfg)(clips).permute(0, 3, 1, 2)
    ref = Detector(cfg, weights.make(cfg, 2, 1, "cpu", fit_windows=1), "cpu").frontend(clips)
    gap = (port - ref).abs()
    assert float(gap[:, 0].max()) < 1e-2          # log-mel channel
    assert float((gap > 0.1).float().mean()) < 1e-3  # MFCC: a few noisy pixels at most


def test_yardstick_departs_like_a_bf16_body():
    """The yardstick's bf16 body moves confidences by about what the port's
    bf16 body does on the same weights and input (within 3x either way)."""
    from audioyolo_tpu_torch.inference_cli import build_inference

    cfg = _float32(conftest.tiny_config()["config"])
    sd = weights.make(cfg, 2, 4, "cpu", fit_windows=2)
    clips = synth.synth_event_clips(2, 22050, 4.0, seed=3)
    x = torch.from_numpy(np.round(clips * 32767).astype(np.int16))
    wave = x[:, 0].float() / 32768
    ref = D.confidences(Detector(cfg, sd, "cpu")(wave))
    yard = D.confidences(Detector(cfg, sd, "cpu", body_bf16=True)(wave))
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        torch.save(sd, os.path.join(d, "w.pt"))
        f = build_inference(cfg, 2, os.path.join(d, "w.pt"), 0.1, 0.2, device="cpu",
                            dtype=torch.bfloat16)
        with torch.inference_mode():
            port = D.confidences(f.model(x, combine_scales=True).float())
    y, p = float((yard - ref).abs().mean()), float((port - ref).abs().mean())
    assert y > 0 and p / 3 < y < 3 * p, (y, p)


def test_long_rows_match_their_own_proposal():
    """A 50 s box whose edges a bf16 body moved by 0.19 s is matched to its
    own proposal, not to a decoy whose edges lie nearer and whose
    confidence is 0.17 off; a 4 s row still takes only the 0.1 s window."""
    own = [2.0, 3.0, 0.0, 30.0, 50.0]                  # edges 5, 55
    decoy = [0.6, 3.0, 0.0, 30.0, 49.7]                # edges 5.15, 54.85
    short = [2.0, 0.0, 3.0, 10.0, 4.0]                 # edges 8, 12
    near_short = [1.0, 0.0, 3.0, 10.0, 4.16]           # edges 7.92, 12.08
    preds = torch.tensor([own, decoy, short, near_short])
    conf = D.confidences(preds.double())
    rows = [(float(conf[0, 0]) + 1e-3, 0, 5.19, 54.81), (float(conf[3, 1]), 1, 7.85, 12.15)]
    idx, gaps = D.match(rows, preds, 60.0)
    assert idx.tolist() == [0, 3] and float(gaps.max()) < 2e-3
    assert abs(float(conf[1, 0] - conf[0, 0])) > 0.15


@pytest.mark.parametrize("config", ["ayolo-r18-shipped", "ayolo-r50"])
def test_checkpoint_is_the_configurations_whatever_the_run_seed(tiny_ctx, config):
    """Every run of a cell serves the checkpoint of its configuration's
    ``weights_seed``; the run seed draws only the audio."""
    from perfbench import common

    cell = {"ayolo-r18-shipped": "r18-batch-mixed", "ayolo-r50": "r50-batch-mixed"}[config]
    assert isinstance(harness.load_config(config)["weights_seed"], int)
    a = common.checkpoint(tiny_ctx(cell, seed=3))[0]
    b = common.checkpoint(tiny_ctx(cell, seed=2 ** 31 + 5))[0]
    c = common.checkpoint(tiny_ctx(cell, seed=3, weights_seed=7))[0]
    assert list(a) == list(b) == list(c)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)

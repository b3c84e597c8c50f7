"""The plain reference agrees with the port at a tiny size on the CPU, in
the float32 postures where the two must meet closely."""

import copy

import numpy as np
import pytest
import torch

import conftest
from perfbench import weights
from perfbench.reference import detections as D
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

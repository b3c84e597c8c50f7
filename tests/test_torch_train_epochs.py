"""The port's trainer over epochs on the CPU, on the 8-clip dataset of
``tests/test_torch_train_loop.py`` (its ``dataset_root`` and ``_cli_raw``):
the loss falling over three epochs, a checkpoint that resumes bit for bit,
the saved model served, and one ``train_cli.run`` epoch in the config's
compute dtype and in the int8 posture.
"""

import copy
import json
import os
import warnings

import numpy as np
import pytest
import torch

from audioyolo_tpu_torch import serve, train_cli
from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.data.loader import BatchLoader
from audioyolo_tpu_torch.models import AudioDetectionModel
from audioyolo_tpu_torch.train import TrainerPipeline

from test_torch_train_loop import _cli_raw, dataset_root  # noqa: F401


def _trainer(raw, seed=0, **kw):
    cfg = Config(copy.deepcopy(raw))
    train_ds, _ = train_cli.resolve_datasets(cfg)
    model = AudioDetectionModel.from_config(cfg, 2, generator=torch.Generator().manual_seed(seed))
    tc = raw["train_config"]
    trainer = TrainerPipeline(model, train_cli.make_loss(cfg, 2, train_ds.get_class_weights()),
                              tc["optimizer_config"], tc["lr_scheduler_config"],
                              model_path=tc["model_path"], metrics_path=tc["metrics_path"],
                              ema_config=tc["ema_config"], seed=7, device="cpu", **kw)
    loader = BatchLoader(train_ds, 2, seed=3, transfer_dtype="int16",
                         frame_fn=model.frontend.frame_host)
    return trainer, loader


def test_loss_falls_over_three_epochs(tmp_path, dataset_root):
    raw = _cli_raw(tmp_path, dataset_root)
    raw["train_config"]["optimizer_config"]["lr"] = 3e-3
    trainer, loader = _trainer(raw)
    losses = [trainer.train(loader)["aggregate_loss"] for _ in range(3)]
    print("epoch losses", losses)
    assert losses[2] < losses[0] and all(np.isfinite(losses))
    assert trainer.step == 3 * len(loader) and len(trainer.train_metrics) == 3


def test_checkpoint_resume_gives_the_same_next_step(tmp_path, dataset_root):
    """Dropout 0.4, EMA and the cosine scheduler on: a trainer restored from
    the checkpoint takes the same next step, bit for bit."""
    raw = _cli_raw(tmp_path, dataset_root)
    a, loader = _trainer(raw, use_ema=True)
    a.train(loader)
    a.evaluate(loader)
    a.save_checkpoint(0, 1.25, extra={"plateau": {"lr": 0.5}})
    x, t = a.put_batch(next(iter(BatchLoader(loader.dataset, 2, shuffle=False,
                                             transfer_dtype="int16",
                                             frame_fn=a.model.frontend.frame_host))))
    ma = a.train_step(x, t)
    b, _ = _trainer(raw, seed=5, use_ema=True)
    assert b.load_checkpoint() == (1, 1.25)
    assert b.checkpoint_extra == {"plateau": {"lr": 0.5}} and b.step == len(loader)
    assert b.train_metrics == a.train_metrics and b.eval_metrics == a.eval_metrics
    assert b.optimizer.param_groups[0]["lr"] == a.optimizer.param_groups[0]["lr"]
    mb = b.train_step(x, t)
    assert torch.equal(ma, mb)
    for (k, pa), (_, pb) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(pa, pb), k
        assert torch.equal(a.ema.params[k], b.ema.params[k]), k
    assert a.ema.num_updates == b.ema.num_updates == len(loader) + 1
    assert not [f for f in os.listdir(a.model_path) if ".tmp." in f]


def test_saved_model_serves_on_the_cpu(tmp_path, dataset_root):
    """``save_model`` writes the EMA parameters as a train-form state dict;
    the port's server loads that file as it is and detects."""
    raw = _cli_raw(tmp_path, dataset_root)
    trainer, loader = _trainer(raw, use_ema=True)
    trainer.train(loader)
    path = trainer.save_model()
    sd = torch.load(path, weights_only=True)
    assert set(sd) == set(trainer.model.state_dict())
    for k, p in trainer.ema.params.items():
        assert torch.equal(sd[k], p) and not torch.equal(sd[k], trainer.model.state_dict()[k])
    cmap = tmp_path / "class_map.json"
    cmap.write_text(json.dumps({"0": "beep", "1": "tone"}))
    state = serve.build_app_state(Config(copy.deepcopy(raw)), model_path=path,
                                  class_map_path=str(cmap), batch_size=2, conf_threshold=0.0,
                                  device="cpu")
    with open(os.path.join(dataset_root, "train", "clip000.wav"), "rb") as f:
        out = serve.detect_wav_bytes(state, f.read())
    assert set(out) == {"events", "rows"} and out["rows"]
    assert {r["class"] for r in out["rows"]} <= {"beep", "tone"}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_train_cli_warns_when_the_config_asks_for_another_dtype(dtype, tmp_path, dataset_root):
    """The config's ``compute_dtype`` picks the body's dtype (the shipped
    config asks for bfloat16), as the JAX ``train.py`` reads it, and no
    warning is raised for either: every conv and BatchNorm output of the
    trained model is in that dtype, the parameters, Adam's moments and the
    saved model stay float32, and the epoch's metrics are finite."""
    raw = _cli_raw(tmp_path, dataset_root, epochs=1)
    raw["tpu_config"].update(compute_dtype=dtype, transfer_dtype="int16")
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer = train_cli.run(Config(raw), device="cpu")
    assert not [w for w in caught if "dtype" in str(w.message)]
    model = trainer.model
    assert model.dtype == (None if dtype == "float32" else torch.bfloat16)
    seen = []
    for m in model.modules():
        if type(m).__name__ in ("Conv2d", "BatchNorm"):
            m.register_forward_hook(lambda mod, inp, out: seen.append(out.dtype))
    with torch.no_grad():
        model.eval()(features=torch.zeros(1, 32, 160, 2))
    assert seen and set(seen) == {want}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {s.dtype for st in trainer.optimizer.state.values() for s in st.values()
            if torch.is_tensor(s) and s.is_floating_point()} == {torch.float32}
    saved = torch.load(trainer.saved_model_path, weights_only=True)
    assert {t.dtype for t in saved.values()} == {torch.float32}
    assert np.isfinite(trainer.train_metrics[-1]["aggregate_loss"])


def test_train_cli_epoch_in_the_int8_posture(tmp_path, dataset_root, monkeypatch):
    """``frontend_precision: int8``: the loader ships ``frame_host_int8``'s
    ``(q, scale)`` frames (the native int16 framed decode makes no tuples,
    as in the JAX ``train.py``), the trainer moves the tuple to the device
    and every training and evaluation forward runs the int8 DFT; one epoch's
    metrics are finite and the saved model serves."""
    from audioyolo_tpu_torch.ops.frontend import SpectralFrontend

    calls = []
    real = SpectralFrontend._fused_int8_mel

    def counted(self, q, scale):
        calls.append((q.dtype, tuple(q.shape), scale.dtype))
        return real(self, q, scale)

    monkeypatch.setattr(SpectralFrontend, "_fused_int8_mel", counted)
    raw = _cli_raw(tmp_path, dataset_root, epochs=1)
    raw["tpu_config"].update(frontend_precision="int8", transfer_dtype="int16")
    trainer = train_cli.run(Config(raw), device="cpu")
    assert len(calls) == 4  # 3 train batches of 2 and 1 eval batch of 2
    assert all(c[0] == torch.int8 and c[1][0] == 2 and c[2] == torch.float32 for c in calls)
    assert np.isfinite(trainer.train_metrics[-1]["aggregate_loss"])
    assert np.isfinite(trainer.eval_metrics[-1]["aggregate_loss"])
    assert os.path.isfile(trainer.saved_model_path)

"""The training slice as a whole on the CPU: the PyTorch port's train step
against the JAX package's on ``tiny_cfg`` (one JAX initialisation carried
across with ``state_dict_from_jax``, framed int16 input, dropout 0), then the
port's trainer, checkpoints, saved model and CLI.

The port's trainer takes the framed batches through its own frontend (in the
kernel posture, ``default`` + ``pallas_frontend: on``, kernel 1's plain
version); the JAX step is given the port's feature image. The frontend's
second dB map over the MFCC coefficients turns the rounding of coefficients
near zero into O(1) pixel differences between any two implementations
(``tests/test_torch_frontend.py`` bounds their share), and the train step's
gradients follow those pixels; with one feature image on both sides the
comparison reads the body, the loss, the backward pass, BatchNorm's train form
and the optimizer. Tolerances, float32 convolutions summed in other orders
(observed on this test's inputs in the comments):

- the loss and the 10 metrics: 1e-5 relative (loss ~2e-7, metrics ~1.5e-6);
- every gradient: max |diff| / max |grad| per tensor 1e-3 (worst ~1.1e-4);
  the 15 conv biases ahead of a train-mode BatchNorm, whose gradient is 0 in
  exact arithmetic, against the largest gradient of the model 1e-6 (~3e-8);
- the updated BatchNorm statistics: 1e-5 relative, 1e-6 absolute (~4e-6);
- the parameters after 3 SGD steps at learning rate 1e-5: 1e-6 absolute
  (~1.2e-7; they move by ~2e-4). The clipped CIoU and the ReLUs make the
  gradient jump where a pair or a unit crosses its kink; at larger rates the
  first step's rounding-level differences carry some across and the jumps
  compound, for the port's own float32 and float64 trajectories as for the
  port and the JAX package.

The kernel posture's features put one pre-activation at a kink already: in
``multiscale_module.rep_block2_1.conv1`` (clip 1, channel 14, cell 15) the
branch sum -0.166388 + 0.166402 is 1.4e-5 in float64, within the float32
forward's own error (~1e-5 there). A float32 step lands on either side of the
LeakyReLU, depending on the summation order of the CPU's convolution kernels;
where it lands on the other side from float64, that element's derivative is
0.2 instead of 1 and every gradient upstream of it moves. On one CPU the port's
float32 step did so (against its own float64 step: worst tensor 8.6e-2, median
1.6e-2) while JAX's did not (against the port's float64 step: worst 4.9e-5).
So the kernel posture reads the gradients as ``chip_smoke.py`` phase 6 does,
robustly, over all tensors (observed with the crossing / without it):

- max |diff| / max |grad| per tensor, median 5e-2 (1.6e-2 / ~3e-5) and 90th
  percentile 1e-1 (3.1e-2 / ~8e-5); a relative L2 norm over all tensors at
  once 1e-1 (2.5e-2 / ~7e-5);
- the parameters after the 3 SGD steps: the relative L2 norm of their
  difference against the JAX package's move 0.25 (9.5e-2 / ~1e-4).

A fault of the port (a wrong sign, a missing term) reads O(1) on most tensors.
The other readings of the kernel posture are those of the highest posture.
"""

import copy
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from audioyolo_tpu.models import AudioDetectionModel as JModel
from audioyolo_tpu.train import AudioDetectionLoss as JLoss
from audioyolo_tpu.train.optim import make_optimizer as j_make_optimizer

from audioyolo_tpu_torch import serve, train_cli
from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.data.loader import BatchLoader
from audioyolo_tpu_torch.models import AudioDetectionModel, state_dict_from_jax
from audioyolo_tpu_torch.train import METRIC_KEYS, AudioDetectionLoss, TrainerPipeline

from synth import make_flat_dataset, save_reference_layout, synth_clip
from test_torch_model import _randomize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_KW = dict(num_classes=2, anchor_t=5.0, edge_t=0.5, sample_duration=4.0, box_w=0.1,
               conf_w=1.0, class_w=0.3, multi_label=True, label_smoothing=0.08)
SGD = {"name": "SGD", "lr": 1e-5, "momentum": 0.9}
LOSS_REL, GRAD_REL, DEAD_REL, BN_REL, PARAM_ABS = 1e-5, 1e-3, 1e-6, 1e-5, 1e-6
# the kernel posture's robust reading (see the docstring)
KINK_BOUNDS = dict(grad_median=5e-2, grad_p90=1e-1, grad_l2=1e-1, param_l2=0.25)


def _raw(posture):
    from conftest import TINY_CFG

    raw = copy.deepcopy(TINY_CFG)
    if posture == "kernel":
        raw["tpu_config"].update(frontend_precision="default", pallas_frontend="on")
    return raw


def _batches(raw, n, seed):
    """``n`` batches of 2 framed int16 clips with their targets (numpy)."""
    from audioyolo_tpu_torch.ops.frontend import SpectralFrontend

    fe = SpectralFrontend(Config(copy.deepcopy(raw)))
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        segs = [[(0.3, 1.4, "tone"), (2.0, 3.1, "beep")], [(0.8, 2.6, "beep")]]
        wav = np.stack([synth_clip(8000, 4.0, s, seed=seed + 10 * i + j) for j, s in enumerate(segs)])
        wav16 = np.clip(np.round(wav * 32768), -32768, 32767).astype(np.int16)
        t = {"classes": np.array([[1, 0, -100, 0], [0, -100, 0, 0]], np.int32),
             "centers": np.array([[0.85, 2.55, 3.55, 0], [1.7, 3.3, 0, 0]], np.float32),
             "widths": np.array([[1.1, 1.1, 0.9, 0], [1.8, 1.4, 0, 0]], np.float32),
             "valid": np.array([[True, True, True, False], [True, True, False, False]])}
        t["centers"] += rng.uniform(-0.05, 0.05, t["centers"].shape).astype(np.float32)
        out.append((fe.frame_host(wav16), t))
    return out


def _jax_state(raw, sample):
    jm = JModel.from_config(raw, num_classes=2)
    key = jax.random.PRNGKey(0)
    v = jax.jit(lambda x: jm.init({"params": key, "dropout": key}, x, train=False))(
        jnp.asarray(sample))
    return jm, _randomize(v, seed=6)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _l2_rel(a, ref):
    """||a - ref|| / ||ref|| over all tensors of two dicts at once."""
    d = np.concatenate([(a[k] - ref[k]).ravel() for k in ref])
    return float(np.linalg.norm(d) / np.linalg.norm(np.concatenate([ref[k].ravel() for k in ref])))


@pytest.mark.parametrize("posture", ["highest", "kernel"])
def test_train_step_matches_jax(posture):
    raw = _raw(posture)
    batches = _batches(raw, 3, seed=20)
    jm, v = _jax_state(raw, batches[0][0][:1])
    jloss = JLoss(raw["anchors"], **LOSS_KW)
    model = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2)
    model.load_state_dict(state_dict_from_jax(v))
    with torch.no_grad():
        feats = [jnp.asarray(model.frontend(torch.from_numpy(a)).numpy()) for a, _ in batches]

    def compute_loss(params, batch_stats, features, targets):
        preds, mut = jm.apply({"params": params, "batch_stats": batch_stats}, features=features,
                              train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(1)})
        loss, metrics = jloss(preds, targets)
        return loss, (metrics, mut["batch_stats"])

    grad_fn = jax.jit(jax.value_and_grad(compute_loss, has_aux=True))
    tx = j_make_optimizer(SGD, None, 1)
    params, stats, opt_state = v["params"], v["batch_stats"], tx.init(v["params"])
    trainer = TrainerPipeline(model, AudioDetectionLoss(raw["anchors"], **LOSS_KW), SGD,
                              device="cpu")
    for i, ((audio, t), f) in enumerate(zip(batches, feats)):
        (j_l, (j_m, stats)), j_g = grad_fn(params, stats, f, {k: jnp.asarray(x) for k, x in t.items()})
        updates, opt_state = tx.update(j_g, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        m = trainer.train_step(torch.from_numpy(audio),
                               {k: torch.from_numpy(x) for k, x in t.items()}).numpy()
        if i:
            continue
        ref_m = np.array([float(j_m[k]) for k in METRIC_KEYS], np.float32)
        print(f"[{posture}] loss {m[0]:.7f} vs {float(j_l):.7f}; metrics max rel "
              f"{np.max(np.abs(m - ref_m) / np.abs(ref_m)):.3e}")
        np.testing.assert_allclose(m, ref_m, rtol=LOSS_REL)

        grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
        ref_g = {k: t.numpy() for k, t in state_dict_from_jax({"params": j_g}).items()}
        assert set(grads) == set(ref_g) and all(np.isfinite(g).all() for g in grads.values())
        gmax = max(np.abs(g).max() for g in ref_g.values())
        dead = [k for k in ref_g if k.endswith("conv.conv.bias") and "norm" not in k
                and f"{k[:-len('conv.conv.bias')]}norm.weight" in ref_g]
        live = {k: _rel(grads[k], ref_g[k]) for k in ref_g if k not in dead}
        worst = max(live, key=live.get)
        dead_rel = max(max(np.abs(grads[k]).max(), np.abs(ref_g[k]).max()) for k in dead) / gmax
        vals = list(live.values())
        robust = dict(grad_median=float(np.median(vals)), grad_p90=float(np.percentile(vals, 90)),
                      grad_l2=_l2_rel({k: grads[k] for k in live}, {k: ref_g[k] for k in live}))
        print(f"[{posture}] gradients: worst {live[worst]:.3e} ({worst}), median "
              f"{robust['grad_median']:.3e}, p90 {robust['grad_p90']:.3e}, L2 "
              f"{robust['grad_l2']:.3e}; {len(dead)} conv biases ahead of BatchNorm: "
              f"max |g| / max |g| of the model {dead_rel:.3e}")
        assert len(dead) == 15 and dead_rel < DEAD_REL
        if posture == "highest":
            assert live[worst] < GRAD_REL
        else:
            assert all(robust[k] < KINK_BOUNDS[k] for k in robust), robust

        ref_bs = {k: t.numpy() for k, t in state_dict_from_jax({"batch_stats": stats}).items()}
        bufs = dict(model.named_buffers())
        print(f"[{posture}] BatchNorm statistics: worst rel "
              f"{max(_rel(bufs[k].numpy(), ref_bs[k]) for k in ref_bs):.3e}")
        for k in ref_bs:
            np.testing.assert_allclose(bufs[k].numpy(), ref_bs[k], rtol=BN_REL, atol=BN_REL / 10,
                                       err_msg=k)

    ref_p = state_dict_from_jax({"params": params})
    start = state_dict_from_jax(v)
    moved = max(np.abs(ref_p[k].numpy() - start[k].numpy()).max() for k in ref_p)
    diff = {k: float(np.abs(p.detach().numpy() - ref_p[k].numpy()).max())
            for k, p in model.named_parameters()}
    worst_p = max(diff, key=diff.get)
    param_l2 = _l2_rel({k: p.detach().numpy() - start[k].numpy() for k, p in model.named_parameters()},
                       {k: ref_p[k].numpy() - start[k].numpy() for k in ref_p})
    print(f"[{posture}] parameters after 3 SGD steps: worst |diff| {diff[worst_p]:.3e} "
          f"({worst_p}); L2 of the difference against the move {param_l2:.3e}; the largest "
          f"move {moved:.3e}")
    assert moved > 50 * PARAM_ABS
    if posture == "highest":
        assert diff[worst_p] < PARAM_ABS
    else:
        assert param_l2 < KINK_BOUNDS["param_l2"]


# ---- the port's trainer ----------------------------------------------------


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    """8 flat-layout clips (4 s at 8 kHz, two tone classes): 6 in ``train/``,
    2 in ``eval/``, one annotation file."""
    root = tmp_path_factory.mktemp("cli_data")
    ann = make_flat_dataset(str(root / "train"), n_files=8, seed=1)
    (root / "eval").mkdir()
    for name in ("clip006", "clip007"):
        os.rename(root / "train" / f"{name}.wav", root / "eval" / f"{name}.wav")
    save_reference_layout(str(root), ann)
    return str(root)


def _cli_raw(tmp_path, dataset_root, **train):
    from conftest import TINY_CFG

    raw = copy.deepcopy(TINY_CFG)
    raw["dropout"] = 0.4
    raw["train_config"].update(
        dataset_path=dataset_root, class_map_path=str(tmp_path / "class_map"),
        model_path=str(tmp_path / "model"), metrics_path=str(tmp_path / "metrics"), **train)
    return raw


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


def test_train_cli_end_to_end_on_the_cpu(tmp_path, dataset_root):
    """``python -m audioyolo_tpu_torch.train_cli --device cpu``: two epochs,
    then ``--resume`` to a third."""
    raw = _cli_raw(tmp_path, dataset_root, epochs=2)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    cmd = [sys.executable, "-m", "audioyolo_tpu_torch.train_cli", "--config", str(cfg_path),
           "--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Epoch 1" in r.stdout and "Model saved at epoch" in r.stdout
    model_dir = tmp_path / "model"
    assert (model_dir / "AudioDetectionModel.pt").is_file() and (model_dir / "checkpoint.pt").is_file()
    assert json.loads((tmp_path / "class_map" / "class_map.json").read_text()) == {
        "0": "beep", "1": "tone"}
    with open(tmp_path / "metrics" / "train_metrics.csv") as f:
        lines = f.read().splitlines()
    assert lines[0].split(",") == list(METRIC_KEYS) and len(lines) == 3

    raw["train_config"]["epochs"] = 3
    cfg_path.write_text(yaml.safe_dump(raw))
    r = subprocess.run(cmd + ["--resume"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Resumed from epoch 2" in r.stdout and "Epoch 2" in r.stdout and "Epoch 1" not in r.stdout
    with open(tmp_path / "metrics" / "train_metrics.csv") as f:
        assert len(f.read().splitlines()) == 4


@pytest.mark.parametrize("knob", ["steps_per_dispatch", "train_remat", "train_prng",
                                  "device_cache_dataset", "data_parallel"])
def test_tpu_only_settings_raise(knob, tmp_path, dataset_root):
    raw = _cli_raw(tmp_path, dataset_root)
    value = {"steps_per_dispatch": 2, "train_remat": True, "train_prng": "rbg",
             "device_cache_dataset": "on"}.get(knob)
    if value is not None:
        raw["tpu_config"][knob] = value
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_cli.run(Config(raw), device="cpu", data_parallel=knob == "data_parallel")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_train_cli_warns_when_the_config_asks_for_another_dtype(dtype, tmp_path, dataset_root):
    """The port trains the body in float32; a config asking for another
    ``compute_dtype`` (the shipped one asks for bfloat16) gets one warning
    naming ROADMAP A10. ``device_cache_dataset: on`` stops the run after it."""
    raw = _cli_raw(tmp_path, dataset_root)
    raw["tpu_config"].update(compute_dtype=dtype, device_cache_dataset="on")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with pytest.raises(NotImplementedError, match="device_cache_dataset"):
            train_cli.run(Config(raw), device="cpu")
    ours = [w for w in caught if "compute_dtype" in str(w.message)]
    if dtype == "float32":
        assert not ours
    else:
        assert len(ours) == 1 and ours[0].category is UserWarning
        assert "bfloat16" in str(ours[0].message) and "ROADMAP A10" in str(ours[0].message)


def test_training_needs_the_card_unless_asked(tmp_path, dataset_root):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    raw = _cli_raw(tmp_path, dataset_root)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.run(Config(raw))
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainerPipeline(AudioDetectionModel.from_config(Config(raw), 2),
                        AudioDetectionLoss(raw["anchors"], **LOSS_KW), SGD)
    assert not os.path.exists(raw["train_config"]["class_map_path"])


def test_dropout_needs_a_generator_and_follows_it(tiny_cfg):
    raw = tiny_cfg.to_dict()
    raw["dropout"] = 0.5
    model = AudioDetectionModel.from_config(Config(raw), 2).train()
    feats = torch.randn(2, 32, 160, 2, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="Generator"):
        model(features=feats)
    runs = [model(features=feats, generator=torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    model.eval()
    assert torch.equal(model(features=feats)[0], model(features=feats)[0])

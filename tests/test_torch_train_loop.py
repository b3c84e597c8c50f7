"""The training slice's step on the CPU: the PyTorch port's train step
against the JAX package's on ``tiny_cfg`` (one JAX initialisation carried
across with ``state_dict_from_jax``, framed int16 input, dropout 0), dropout's
generator, and the card that training needs unless the CPU is asked for. The
port's trainer over epochs, its checkpoints and saved model are in
``tests/test_torch_train_epochs.py`` and its CLI in
``tests/test_torch_train_cli.py``; both take this file's ``dataset_root``
and ``_cli_raw``.

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
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioyolo_tpu.models import AudioDetectionModel as JModel
from audioyolo_tpu.train import AudioDetectionLoss as JLoss
from audioyolo_tpu.train.optim import make_optimizer as j_make_optimizer

from audioyolo_tpu_torch import train_cli
from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.models import AudioDetectionModel, state_dict_from_jax
from audioyolo_tpu_torch.train import METRIC_KEYS, AudioDetectionLoss, TrainerPipeline

from synth import make_flat_dataset, save_reference_layout, synth_clip
from test_torch_model import _randomize

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

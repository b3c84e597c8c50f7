"""The training slice's parts, the PyTorch port against the JAX package on
the CPU: the same numpy inputs, made from a seed, go through both.

Tolerances (float32 on both sides, sums taken in other orders):
- assignment: equal;
- CIoU, the loss, its 10 metrics and d(loss)/d(preds): 1e-5 relative
  (gradients: max |diff| / max |grad| per scale);
- masked classification metrics: 1e-6;
- EMA: 1e-6 relative; optimizer steps 1e-5 (optax and torch round Adam's
  bias corrections at other points: ~2e-6); per-epoch learning rates 1e-5
  (the JAX schedules run in float32: ~2e-6);
- BatchNorm train form: 1e-5 against JAX on channels whose batch mean is
  near the running mean, and against float64 two-pass statistics always;
- dataset targets and loader batches: equal.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioyolo_tpu.data import AudioDataset as JDataset
from audioyolo_tpu.data import BatchLoader as JLoader
from audioyolo_tpu.models import layers as jl
from audioyolo_tpu.ops.frontend import SpectralFrontend as JFrontend
from audioyolo_tpu.ops.metrics import masked_classification_metrics as j_metrics
from audioyolo_tpu.train import optim as jopt
from audioyolo_tpu.train.assign import assign_targets_to_scale as j_assign
from audioyolo_tpu.train.ema import ema_init, ema_update
from audioyolo_tpu.train.loss import AudioDetectionLoss as JLoss
from audioyolo_tpu.train.loss import compute_ciou as j_ciou

from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.data.dataset import AudioDataset
from audioyolo_tpu_torch.data.loader import BatchLoader
from audioyolo_tpu_torch.models import layers as tl
from audioyolo_tpu_torch.models import state_dict_from_jax
from audioyolo_tpu_torch.ops.frontend import SpectralFrontend
from audioyolo_tpu_torch.ops.metrics import masked_classification_metrics
from audioyolo_tpu_torch.train import EMA, optim as topt
from audioyolo_tpu_torch.train.assign import assign_targets_to_scale
from audioyolo_tpu_torch.train.loss import METRIC_KEYS, AudioDetectionLoss, compute_ciou

from synth import make_flat_dataset, make_grouped_dataset

ANCHORS = {"sm": [2.65, 7.44, 12.87], "md": [19.55, 27.2, 35.18], "lg": [43.19, 51.0, 59.82]}
GRIDS = (120, 60, 30)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---- assignment -----------------------------------------------------------


def _assign_both(classes, centers, widths, valid, grid, anchors, anchor_t=5.0, edge_t=0.5):
    ref = j_assign(jnp.asarray(classes), jnp.asarray(centers), jnp.asarray(widths),
                   jnp.asarray(valid), grid, jnp.asarray(anchors, jnp.float32), anchor_t, edge_t,
                   60.0)
    out = assign_targets_to_scale(_t(classes), _t(centers), _t(widths), _t(valid), grid,
                                  torch.tensor(np.asarray(anchors, np.float32)), anchor_t, edge_t,
                                  60.0)
    return ({k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in out.items()})


def test_assignment_worked_example_cells_81_82():
    """center 40.89 s, width 10 s, 60 s clip, 120 cells -> cells 81 and 82."""
    ref, out = _assign_both(np.array([[0]], np.int32), np.array([[40.89]], np.float32),
                            np.array([[10.0]], np.float32), np.array([[True]]), 120, [10.0], 4.0)
    np.testing.assert_array_equal(out["pair_valid"], ref["pair_valid"])
    np.testing.assert_array_equal(out["cell"], ref["cell"])
    assert set(out["cell"][out["pair_valid"]].tolist()) == {81, 82}


@pytest.mark.parametrize("grid,scale", zip(GRIDS, ANCHORS))
def test_assignment_random_targets_equal(grid, scale):
    rng = np.random.default_rng(grid)
    b, n = 3, 16
    centers = rng.uniform(0, 60, (b, n)).astype(np.float32)
    centers[0, :4] = (0.0, 60.0, 30.0, 0.25)  # the edges and exact cell boundaries
    widths = rng.uniform(0.3, 60.0, (b, n)).astype(np.float32)
    valid = rng.random((b, n)) > 0.2
    classes = rng.integers(-1, 2, (b, n)).astype(np.int32)
    ref, out = _assign_both(classes, centers, widths, valid, grid, ANCHORS[scale])
    np.testing.assert_array_equal(out["pair_valid"], ref["pair_valid"])
    np.testing.assert_array_equal(out["cell"], ref["cell"])
    assert out["pair_valid"].sum() > 10


# ---- CIoU -----------------------------------------------------------------


def test_ciou_and_its_gradient_match():
    """Random pairs plus a perfect overlap (iou rounds to 1: the clamped
    denominator), a touching pair and a disjoint one."""
    rng = np.random.default_rng(5)
    p = np.stack([rng.uniform(0, 60, 64), rng.uniform(0.2, 40, 64)], -1).astype(np.float32)
    t = np.stack([rng.uniform(0, 60, 64), rng.uniform(0.2, 40, 64)], -1).astype(np.float32)
    p[:3] = [[10.0, 4.0], [10.0, 4.0], [10.0, 4.0]]
    t[:3] = [[10.0, 4.0], [14.0, 4.0], [50.0, 4.0]]
    ref, jg = jax.value_and_grad(lambda x: j_ciou(x, jnp.asarray(t)).sum())(jnp.asarray(p))
    ref = np.asarray(j_ciou(jnp.asarray(p), jnp.asarray(t)))
    x = _t(p).requires_grad_(True)
    out = compute_ciou(x, _t(t))
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5, atol=1e-6)
    assert out[0].item() == pytest.approx(1.0, abs=1e-6) and out[2].item() == 0.0
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


# ---- loss -----------------------------------------------------------------


def _preds(b, seed, num_classes=2):
    rng = np.random.default_rng(seed)
    out = []
    for g in GRIDS:
        p = rng.standard_normal((b, g, 3, 3 + num_classes)).astype(np.float32)
        p[..., -2] = rng.uniform(0, 60, (b, g, 3))
        p[..., -1] = rng.uniform(0.5, 50, (b, g, 3))
        out.append(p)
    return out


def _targets(b, n, seed, num_classes=2):
    rng = np.random.default_rng(seed)
    t = {
        "classes": rng.integers(0, num_classes, (b, n)).astype(np.int32),
        "centers": rng.uniform(2, 58, (b, n)).astype(np.float32),
        "widths": rng.uniform(1, 40, (b, n)).astype(np.float32),
        "valid": rng.random((b, n)) > 0.3,
    }
    t["classes"][:, -1] = -100  # a pad target over a zero-padded tail
    return t


LOSS_CASES = {
    "multi_label_smoothing": dict(kw=dict(multi_label=True, label_smoothing=0.08)),
    "single_label_class_weights": dict(kw=dict(multi_label=False,
                                               class_weights=np.array([0.7, 2.3], np.float32))),
    "focal": dict(kw=dict(multi_label=True, label_smoothing=0.08, alpha=0.25, gamma=1.5)),
    "batch_scale": dict(kw=dict(multi_label=True, batch_scale_loss=True)),
    "ignore_index_only": dict(kw=dict(multi_label=False), edit="ignore"),
    "clip_valid_padding": dict(kw=dict(multi_label=True, label_smoothing=0.08), edit="pad"),
    "no_valid_targets": dict(kw=dict(multi_label=True), edit="none"),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_metrics_and_grad_match_jax(case):
    spec = LOSS_CASES[case]
    kw = dict(anchors_dict=ANCHORS, num_classes=2, anchor_t=5.0, edge_t=0.5, sample_duration=60.0,
              box_w=0.1, conf_w=1.0, class_w=0.3, **spec["kw"])
    b = 3
    preds = _preds(b, seed=11)
    t = _targets(b, 10, seed=12)
    edit = spec.get("edit")
    if edit == "ignore":
        t["classes"][:] = -100
    elif edit == "pad":  # the last clip repeats the second, masked out
        for k in t:
            t[k][2] = t[k][1]
        t["valid"][2] = False
        t["clip_valid"] = np.array([True, True, False])
    elif edit == "none":
        t["valid"][:] = False

    def jloss(ps):
        return JLoss(**kw)(ps, {k: jnp.asarray(v) for k, v in t.items()})

    (jl_val, jm), jg = jax.value_and_grad(jloss, has_aux=True)(tuple(jnp.asarray(p) for p in preds))
    xs = [_t(p).requires_grad_(True) for p in preds]
    loss, m = AudioDetectionLoss(**kw)(xs, {k: _t(v) for k, v in t.items()})
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(jl_val), rtol=1e-5)
    ours = AudioDetectionLoss.metrics_vector(m).numpy()
    ref = np.array([float(jm[k]) for k in METRIC_KEYS], np.float32)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)  # NaN where JAX has NaN
    for x, g in zip(xs, jg):
        g = np.asarray(g)
        assert np.isfinite(x.grad.numpy()).all()
        scale = max(np.abs(g).max(), 1e-30)
        assert np.abs(x.grad.numpy() - g).max() / scale < 1e-5, case
    if edit == "none":
        assert np.isnan(ours[METRIC_KEYS.index("mean_ciou")])
    if edit == "ignore":
        assert np.isnan(ours[METRIC_KEYS.index("class_loss")])
    if edit is None:
        assert np.isfinite(ours).all()


def test_masked_classification_metrics_match():
    rng = np.random.default_rng(8)
    for n, c, p_mask in ((200, 3, 0.6), (50, 2, 0.0), (40, 4, 1.0)):
        pred = rng.integers(0, c, n).astype(np.int32)
        true = rng.integers(0, c, n).astype(np.int32)
        true[: n // 4] = pred[: n // 4]
        mask = rng.random(n) < p_mask
        ref = j_metrics(jnp.asarray(pred), jnp.asarray(true), jnp.asarray(mask), c)
        out = masked_classification_metrics(_t(pred), _t(true), _t(mask), c)
        for k in ("accuracy", "precision", "recall", "f1"):
            np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-6, err_msg=k)
        assert np.isnan(out["f1"].item()) == (not mask.any())


# ---- EMA, optimizers, schedules -------------------------------------------


def test_ema_five_updates_match():
    rng = np.random.default_rng(9)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    j_state = ema_init({k: jnp.asarray(v) for k, v in p0.items()}, num_updates=3)
    ema = EMA({k: _t(v) for k, v in p0.items()}, num_updates=3)
    for i in range(5):
        p = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
        j_state = ema_update(j_state, {k: jnp.asarray(v) for k, v in p.items()}, 0.05, 4)
        ema.update({k: _t(v) for k, v in p.items()}, 0.05, 4)
    assert ema.num_updates == int(j_state.num_updates) == 8
    for k in p0:
        np.testing.assert_allclose(ema.params[k].numpy(), np.asarray(j_state.params[k]),
                                   rtol=1e-6, atol=1e-7)


OPT_CASES = [
    {"name": "Adam", "lr": 0.05, "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 0.002},
    {"name": "AdamW", "lr": 0.05, "betas": [0.9, 0.99], "eps": 1e-8, "weight_decay": 0.01},
    {"name": "SGD", "lr": 0.05, "momentum": 0.9, "nesterov": True, "weight_decay": 0.01},
]


@pytest.mark.parametrize("cfg", OPT_CASES, ids=[c["name"] for c in OPT_CASES])
def test_optimizer_steps_match_make_optimizer(cfg):
    """Three steps of the torch optimizer the port builds against the optax
    chain of the JAX package's ``make_optimizer`` on the same gradients."""
    rng = np.random.default_rng(10)
    w0 = rng.standard_normal(6).astype(np.float32)
    tx = jopt.make_optimizer(cfg, None, 1)
    jw = jnp.asarray(w0)
    state = tx.init(jw)
    w = torch.nn.Parameter(_t(w0.copy()))
    opt = topt.make_optimizer([w], cfg)
    for _ in range(3):
        g = rng.standard_normal(6).astype(np.float32)
        updates, state = tx.update(jnp.asarray(g), state, jw)
        jw = jw + updates
        w.grad = _t(g)
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), rtol=1e-5, atol=1e-7)


SCHED_CASES = [
    {"name": "CosineAnnealingWarmRestarts", "T_0": 4, "T_mult": 1, "eta_min": 1e-6},
    {"name": "CosineAnnealingWarmRestarts", "T_0": 2, "T_mult": 2, "eta_min": 1e-5},
    {"name": "CosineAnnealingLR", "T_max": 12, "eta_min": 1e-5},
    {"name": "StepLR", "step_size": 3, "gamma": 0.5},
    {"name": "ExponentialLR", "gamma": 0.8},
    {"name": "MultiStepLR", "milestones": [6, 2], "gamma": 0.3},
    {"name": "LinearLR", "start_factor": 0.25, "total_iters": 4},
    {"name": "PolynomialLR", "total_iters": 6, "power": 2.0},
    {"name": "OneCycleLR", "total_steps": 10, "max_lr": 0.01},
    {"name": "ConstantLR"},
]


@pytest.mark.parametrize("cfg", SCHED_CASES, ids=lambda c: c["name"] + str(c.get("T_mult", "")))
def test_lr_per_epoch_matches_make_lr_schedule(cfg):
    """The torch scheduler stepped once per epoch against the JAX package's
    epoch-indexed schedule (3 steps per epoch)."""
    base, spe = 1e-3, 3
    schedule = jopt.make_lr_schedule(dict(cfg), base, spe)
    w = torch.nn.Parameter(torch.zeros(1))
    opt = topt.make_optimizer([w], {"name": "SGD", "lr": base})
    sched = topt.make_lr_scheduler(opt, cfg)
    for epoch in range(10):
        ref = float(schedule(jnp.asarray(epoch * spe + 1)))
        assert opt.param_groups[0]["lr"] == pytest.approx(ref, rel=1e-5, abs=1e-12), epoch
        opt.step()
        sched.step()


def test_plateau_controller_and_refusals_match():
    cfg = {"name": "ReduceLROnPlateau", "factor": 0.5, "patience": 1, "cooldown": 1,
           "min_lr": 1e-4, "threshold": 0.01}
    ours = topt.ReduceLROnPlateau.from_config(cfg, 1e-3)
    ref = jopt.ReduceLROnPlateau.from_config(cfg, 1e-3)
    for v in (1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0):
        assert ours.step(v) == ref.step(v)
        assert ours.state_dict() == ref.state_dict()
    restored = topt.ReduceLROnPlateau(1.0)
    restored.load_state_dict(ours.state_dict())
    assert restored.state_dict() == ours.state_dict()
    w = torch.nn.Parameter(torch.zeros(1))
    assert topt.make_lr_scheduler(topt.make_optimizer([w], {"name": "Adam"}), cfg) is None
    opt = topt.make_optimizer([w], {"name": "Adam"})
    topt.set_learning_rate(opt, 0.25)
    assert opt.param_groups[0]["lr"] == 0.25

    for bad, sched in (({"name": "LBFGS"}, None), ({"name": "SparseAdam"}, None),
                       ({"name": "Rprop", "weight_decay": 0.1}, None),
                       ({"name": "ASGD"}, cfg), ({"name": "Rprop"}, cfg)):
        with pytest.raises(ValueError) as je:
            jopt.make_optimizer(bad, sched, 1)
        with pytest.raises(ValueError) as te:
            topt.make_optimizer([w], bad, sched)
        assert str(te.value) == str(je.value)


# ---- BatchNorm, train form -------------------------------------------------


def _bn_both(x_nchw, mean, var, scale, bias):
    v = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}
    y, mut = jl.BatchNorm().apply(v, jnp.asarray(np.transpose(x_nchw, (0, 2, 3, 1))),
                                  use_running_average=False, mutable=["batch_stats"])
    bn = tl.BatchNorm(len(mean))
    bn.load_state_dict(state_dict_from_jax(v))
    bn.train()
    with torch.no_grad():
        out = bn(_t(x_nchw)).numpy()
    ref = (np.transpose(np.asarray(y), (0, 3, 1, 2)), np.asarray(mut["batch_stats"]["mean"]),
           np.asarray(mut["batch_stats"]["var"]))
    return (out, bn.running_mean.numpy(), bn.running_var.numpy()), ref


def _bn_float64(x, mean, var, scale, bias, m=0.1, eps=1e-5):
    x = x.astype(np.float64)
    mu = x.mean(axis=(0, 2, 3))
    v = ((x - mu[None, :, None, None]) ** 2).mean(axis=(0, 2, 3))
    n = x.size // x.shape[1]
    y = ((x - mu[None, :, None, None]) / np.sqrt(v + eps)[None, :, None, None]
         * scale[None, :, None, None] + bias[None, :, None, None])
    return y, (1 - m) * mean + m * mu, (1 - m) * var + m * v * n / (n - 1)


def test_batchnorm_train_form_matches_jax_and_two_pass():
    rng = np.random.default_rng(12)
    c = 6
    x = (rng.standard_normal((2, c, 5, 7)) * rng.uniform(0.5, 2.0, c)[None, :, None, None]
         + rng.uniform(-0.3, 0.3, c)[None, :, None, None]).astype(np.float32)
    mean = (rng.standard_normal(c) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    ours, ref = _bn_both(x, mean, var, scale, bias)
    exact = _bn_float64(x, mean, var, scale, bias)
    for o, r, e in zip(ours, ref, exact):
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(o, e, rtol=1e-5, atol=1e-5)


def test_batchnorm_cold_start_where_the_jax_form_cancels():
    """A known deviation of the JAX package, not of the port: its one-pass
    variance, shifted by the running mean, cancels when a channel's batch
    mean is far from the running mean (500 against 0 at step 0, std 0.05).
    The port's two-pass form keeps the float64 statistics."""
    rng = np.random.default_rng(13)
    x = (500.0 + 0.05 * rng.standard_normal((2, 2, 8, 16))).astype(np.float32)
    zeros, ones = np.zeros(2, np.float32), np.ones(2, np.float32)
    ours, ref = _bn_both(x, zeros, ones, ones, zeros)
    y64, _, var64 = _bn_float64(x, zeros, ones, ones, zeros)
    port_err = np.abs(ours[0] - y64).max()
    jax_err = np.abs(ref[0] - y64).max()
    port_var_err = np.abs(ours[2] - var64).max() / np.abs(var64 - 0.9).max()
    jax_var_err = np.abs(ref[2] - var64).max() / np.abs(var64 - 0.9).max()
    print(f"cold start, mean 500 std 0.05: max |y - y64| port {port_err:.3e}, JAX {jax_err:.3e}; "
          f"running-var update error (relative to the batch's share) port {port_var_err:.3e}, "
          f"JAX {jax_var_err:.3e}")
    assert port_err < 5e-3 and port_var_err < 1e-3
    assert jax_err > 100 * port_err


# ---- dataset and loader ----------------------------------------------------


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_data"))
    flat = make_flat_dataset(os.path.join(root, "flat"), n_files=7, seed=4)
    grouped = make_grouped_dataset(os.path.join(root, "grouped"), seed=5)
    return root, flat, grouped


@pytest.mark.parametrize("layout", ["flat", "grouped"])
def test_dataset_targets_and_audio_equal(layout, datasets):
    """Flat clips (every one zero-padded: its annotated span is shorter than
    4 s, so the ignore-index pad target appears) and grouped windows."""
    root, flat, grouped = datasets
    ann = flat if layout == "flat" else grouped
    kw = dict(sample_duration=4.0, sample_rate=8000, max_targets=8)
    ref = JDataset(os.path.join(root, layout), ann, **kw)
    ours = AudioDataset(os.path.join(root, layout), ann, **kw)
    assert len(ours) == len(ref) > 2
    assert ours.class2idx == ref.class2idx and ours.class_counts == ref.class_counts
    np.testing.assert_array_equal(ours.get_class_weights(), ref.get_class_weights())
    padded = 0
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{layout}[{i}].{k}")
        padded += int((a["classes"] == -100).any())
    assert padded > 0


@pytest.mark.parametrize("last_batch", ["partial", "pad", "drop"])
def test_loader_batches_equal(last_batch, datasets, tiny_cfg):
    """Two shuffled epochs, int16 transfer, framed on the prefetch thread: the
    batch order and every array equal to the JAX ``BatchLoader``'s."""
    root, flat, _ = datasets
    kw = dict(sample_duration=4.0, sample_rate=8000, max_targets=8)
    jfe = JFrontend(tiny_cfg.to_dict())
    tfe = SpectralFrontend(Config(tiny_cfg.to_dict()))
    lkw = dict(shuffle=True, seed=3, last_batch=last_batch, transfer_dtype="int16")
    ref = JLoader(JDataset(os.path.join(root, "flat"), flat, **kw), 3, frame_fn=jfe.frame_host,
                  **lkw)
    ours = BatchLoader(AudioDataset(os.path.join(root, "flat"), flat, **kw), 3,
                       frame_fn=tfe.frame_host, **lkw)
    assert len(ours) == len(ref) == (2 if last_batch == "drop" else 3)
    for _ in range(2):
        rb, ob = list(ref), list(ours)
        assert len(ob) == len(rb) == len(ours)
        for a, b in zip(ob, rb):
            assert set(a) == set(b)
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if last_batch == "pad":
        assert not ob[-1]["clip_valid"][1:].any() and not ob[-1]["valid"][1:].any()


def test_loader_reraises_a_worker_error(datasets):
    root, flat, _ = datasets
    ds = AudioDataset(os.path.join(root, "flat"), flat, sample_duration=4.0, sample_rate=8000,
                      max_targets=1)  # too few slots: the dataset raises on the first clip
    with pytest.raises(ValueError, match="max_targets"):
        list(BatchLoader(ds, 2))

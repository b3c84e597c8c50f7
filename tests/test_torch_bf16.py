"""The port's bfloat16 body against the JAX package's (``dtype=jnp.bfloat16``),
on the CPU at ``tiny_cfg``.

Both packages cast at the same points (the feature image into the body, a
conv's input and kernel, BatchNorm's float32 normalisation and its output,
decode back to float32), so the port's bf16 output differs from JAX's by
bf16 roundings taken in another order, and no more. Every reading is held to
twice JAX's own bf16-vs-float32 gap on the same inputs, measured in the same
test:

- the forward: the combined (B, K, 3+C) output read as median and 99th
  percentile of |diff| / max|value| (observed: port against JAX bf16 about
  0.3-1.1x JAX's bf16-vs-float32 gap, in the highest and the kernel posture,
  train and deploy forms, ResNet and custom backbone);
- the train step on one shared feature image: the gradients as the median
  and 90th percentile over tensors of max |diff| / max |grad| and the
  relative L2 norm over all tensors at once (observed about 0.4-1.2x); the
  loss and the 10 metrics against the first-order effect of JAX's own bf16
  rounding, read without cancellation (see ``_loss_scale``).

The float32 body is untouched by the dtype plumbing: its 1e-4 parity tests
(``tests/test_torch_model.py``, ``tests/test_torch_slice.py``) are unchanged.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioyolo_tpu.models import AudioDetectionModel as JModel
from audioyolo_tpu.models import fold_repvgg as jfold
from audioyolo_tpu.train import AudioDetectionLoss as JLoss

from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.models import AudioDetectionModel, fold_repvgg, state_dict_from_jax
from audioyolo_tpu_torch.ops.frontend import SpectralFrontend
from audioyolo_tpu_torch.train import METRIC_KEYS, AudioDetectionLoss

from synth import synth_clip
from test_torch_model import _randomize

GAP_FACTOR = 2.0
LOSS_KW = dict(num_classes=2, anchor_t=5.0, edge_t=0.5, sample_duration=4.0, box_w=0.1,
               conf_w=1.0, class_w=0.3, multi_label=True, label_smoothing=0.08)


def _raw(posture, backbone="resnet"):
    from conftest import TINY_CFG

    raw = copy.deepcopy(TINY_CFG)
    raw["backbone"] = backbone
    if posture == "kernel":
        raw["tpu_config"].update(frontend_precision="default", pallas_frontend="on")
    return raw


def _framed(raw, n=2, seed=0):
    """``n`` framed int16 clips of tones in noise, no zero-padded tail."""
    fe = SpectralFrontend(Config(copy.deepcopy(raw)))
    segs = [[(0.3, 1.4, "tone"), (2.0, 3.1, "beep")], [(0.8, 2.6, "beep")], [(1.0, 3.5, "tone")]]
    wav = np.stack([synth_clip(8000, 4.0, segs[i % 3], seed=seed + i) for i in range(n)])
    return fe, fe.frame_host(np.clip(np.round(wav * 32768), -32768, 32767).astype(np.int16))


def _jax_vars(raw, feats, seed):
    jm = JModel.from_config(raw, num_classes=2)
    v = jax.jit(lambda r, f: jm.init({"params": r}, features=f, train=False))(
        jax.random.PRNGKey(seed), jnp.asarray(feats))
    return _randomize(v, seed=seed)


def _gap(a, ref):
    """(median, 99th percentile) of |a - ref| / max|ref|."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(ref, np.float64)).ravel()
    d /= np.abs(np.asarray(ref, np.float64)).max()
    return float(np.median(d)), float(np.percentile(d, 99))


@pytest.mark.parametrize("posture,form,backbone", [
    ("highest", "train", "resnet"), ("highest", "deploy", "resnet"),
    ("kernel", "deploy", "resnet"), ("highest", "deploy", "custom")])
def test_bf16_forward_within_twice_the_jax_gap(posture, form, backbone):
    """Highest posture: the framed clips go through each package's own
    frontend. Kernel posture: both bodies get the port's feature image
    (kernel 1's plain version; JAX's CPU frontend runs float32)."""
    raw = _raw(posture, backbone)
    fe, framed = _framed(raw, seed=3)
    with torch.no_grad():
        feats = fe(torch.from_numpy(framed)).numpy()
    v = _jax_vars(raw, feats, seed=5)
    deploy = form == "deploy"
    jv = jfold(v) if deploy else v
    inputs = (dict(audio=jnp.asarray(framed)) if posture == "highest"
              else dict(features=jnp.asarray(feats)))
    ref = {}
    for name, dt in (("f32", None), ("bf16", jnp.bfloat16)):
        jm = JModel.from_config(raw, num_classes=2, deploy=deploy, dtype=dt)
        ref[name] = np.asarray(jm.apply(jv, train=False, combine_scales=True, **inputs))
    sd = state_dict_from_jax(v)
    model = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2, deploy=deploy,
                                            dtype=torch.bfloat16)
    model.load_state_dict(fold_repvgg(sd) if deploy else sd)
    model.eval()
    with torch.no_grad():
        x = (dict(audio=torch.from_numpy(framed)) if posture == "highest"
             else dict(features=torch.from_numpy(feats)))
        out = model(combine_scales=True, **x)
    assert out.dtype == torch.float32 and out.shape == ref["bf16"].shape
    assert np.isfinite(out.numpy()).all()
    ours, jax_gap = _gap(out.numpy(), ref["bf16"]), _gap(ref["bf16"], ref["f32"])
    print(f"[{posture} {form} {backbone}] port bf16 vs JAX bf16 median {ours[0]:.3e} p99 "
          f"{ours[1]:.3e}; JAX bf16 vs f32 median {jax_gap[0]:.3e} p99 {jax_gap[1]:.3e}")
    assert jax_gap[1] > 1e-4  # the bf16 body really ran in bf16 on the JAX side
    assert ours[0] <= GAP_FACTOR * jax_gap[0] and ours[1] <= GAP_FACTOR * jax_gap[1]


def test_bf16_body_runs_in_bf16_with_float32_parameters():
    """Every conv output is bf16, every BatchNorm normalises float32 and
    returns bf16, the parameters and statistics stay float32, and decode
    hands float32 to the NMS and the loss."""
    model = AudioDetectionModel.from_config(Config(_raw("highest")), 2, dtype=torch.bfloat16)
    seen = []
    for m in model.modules():
        if type(m).__name__ in ("Conv2d", "BatchNorm"):
            m.register_forward_hook(lambda mod, inp, out: seen.append(out.dtype))
    feats = torch.randn(2, 32, 160, 2, generator=torch.Generator().manual_seed(0))
    out = model.train()(features=feats)
    assert len(seen) > 50 and set(seen) == {torch.bfloat16}
    assert all(o.dtype == torch.float32 for o in out)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for b in model.buffers() if b.is_floating_point()} == {torch.float32}
    sum(o.sum() for o in out).backward()
    assert all(p.grad.dtype == torch.float32 for p in model.parameters() if p.grad is not None)


def _step_readings(grads, ref_g):
    live = [k for k in ref_g if not (k.endswith("conv.conv.bias")
                                     and f"{k[:-len('conv.conv.bias')]}norm.weight" in ref_g)]
    rel = [np.abs(grads[k] - ref_g[k]).max() / np.abs(ref_g[k]).max() for k in live]
    d = np.concatenate([(grads[k] - ref_g[k]).ravel() for k in live])
    r = np.concatenate([ref_g[k].ravel() for k in live])
    return dict(grad_median=float(np.median(rel)), grad_p90=float(np.percentile(rel, 90)),
                grad_l2=float(np.linalg.norm(d) / np.linalg.norm(r)))


def _loss_scale(loss_fn, p32, p16):
    """sum_i |dL/dp_i| * |p16_i - p32_i|: the most that JAX's bf16 rounding of
    the predictions (``p16`` against ``p32``, per scale) can move the loss to
    first order, with no cancellation between its terms. ``dL/dp`` is the
    port's loss at JAX's float32 predictions (the two losses are equal,
    ``tests/test_torch_train_parts.py``)."""
    p = [torch.from_numpy(np.asarray(a, np.float32)).requires_grad_() for a in p32]
    grads = torch.autograd.grad(loss_fn(p)[0], p)
    return float(sum((g.double().abs() * torch.from_numpy(
        np.abs(np.asarray(b, np.float64) - np.asarray(a, np.float64)))).sum()
        for g, a, b in zip(grads, p32, p16)))


@pytest.mark.parametrize("backbone", ["resnet", "custom"])
def test_bf16_train_step_within_twice_the_jax_gap(backbone):
    """One train-mode step (dropout 0) on the port's feature image: JAX's
    float32 and bf16 steps, and the port's bf16 step from the same weights.
    The gradients are read as the module docstring says, each within 2x
    JAX's bf16 step against its float32 step.

    The loss is a sum of many rounded terms, so its gap between two bf16
    steps is mostly cancellation: JAX's own bf16-vs-float32 loss gap read
    2.3e-3 with the ResNet body and 1.0e-4 with the custom one, and which
    CPU runs the suite moves such a single scalar across 2x. So the loss
    gap is held to 2x ``_loss_scale`` (the first-order effect of JAX's bf16
    rounding of the predictions, without cancellation), and the metrics'
    relative L2 gap, whose norm the loss terms dominate, to 2x the larger
    of JAX's own metrics gap and that scale relative to the loss."""
    raw = _raw("highest", backbone)
    fe, framed = _framed(raw, seed=11)
    with torch.no_grad():
        feats = fe(torch.from_numpy(framed)).numpy()
    v = _jax_vars(raw, feats, seed=6)
    targets = {"classes": np.array([[1, 0, -100, 0], [0, 1, 0, 0]], np.int32),
               "centers": np.array([[0.85, 2.55, 3.55, 0], [1.7, 3.3, 0, 0]], np.float32),
               "widths": np.array([[1.1, 1.1, 0.9, 0], [1.8, 1.4, 0, 0]], np.float32),
               "valid": np.array([[True, True, True, False], [True, True, False, False]])}
    jloss = JLoss(raw["anchors"], **LOSS_KW)
    ref = {}
    for name, dt in (("f32", None), ("bf16", jnp.bfloat16)):
        jm = JModel.from_config(raw, num_classes=2, dtype=dt)

        def loss_fn(params, jm=jm):
            preds, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                                features=jnp.asarray(feats), train=True,
                                mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
            loss, metrics = jloss(preds, {k: jnp.asarray(x) for k, x in targets.items()})
            return loss, (metrics, preds)

        (loss, (metrics, preds)), g = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
        ref[name] = (np.array([float(metrics[k]) for k in METRIC_KEYS]),
                     {k: t.numpy() for k, t in state_dict_from_jax({"params": g}).items()},
                     [np.asarray(p, np.float32) for p in preds])

    model = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2, dtype=torch.bfloat16)
    model.load_state_dict(state_dict_from_jax(v))
    model.train()
    preds = model(features=torch.from_numpy(feats), generator=torch.Generator())
    tloss = AudioDetectionLoss(raw["anchors"], **LOSS_KW)
    ttargets = {k: torch.from_numpy(x) for k, x in targets.items()}
    loss, metrics = tloss(preds, ttargets)
    loss.backward()
    m = AudioDetectionLoss.metrics_vector(metrics).detach().numpy().astype(np.float64)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(grads) == set(ref["bf16"][1])

    def readings(run, base):
        r = _step_readings(run[1], base[1])
        r["loss"] = abs(run[0][0] - base[0][0]) / abs(base[0][0])
        r["metrics"] = float(np.linalg.norm(run[0] - base[0]) / np.linalg.norm(base[0]))
        return r

    ours, jax_gap = readings((m, grads), ref["bf16"]), readings(ref["bf16"], ref["f32"])
    scale = _loss_scale(lambda p: tloss(p, ttargets), ref["f32"][2], ref["bf16"][2])
    scale /= abs(ref["bf16"][0][0])
    bounds = {k: jax_gap[k] for k in ("grad_median", "grad_p90", "grad_l2")}
    bounds.update(loss=scale, metrics=max(jax_gap["metrics"], scale))
    print(f"[{backbone}] port bf16 vs JAX bf16: "
          + ", ".join(f"{k} {ours[k]:.3e} (JAX bf16 vs f32 {jax_gap[k]:.3e}, bound/2 "
                      f"{bounds[k]:.3e})" for k in bounds))
    assert jax_gap["grad_l2"] > 1e-3  # the JAX step really ran a bf16 body
    for k, b in bounds.items():
        assert ours[k] <= GAP_FACTOR * b, (k, ours[k], b)

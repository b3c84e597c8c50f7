"""``backbone: custom`` (the reference's second model family) in the port,
against the JAX package's ``CustomBackbone`` on the CPU at ``tiny_cfg``.

- JAX variables through ``state_dict_from_jax``: the port's train-form and
  folded deploy-form predictions equal JAX's to 1e-4 (float32 convolutions
  summed in another order, as ``tests/test_torch_model.py`` bounds the
  ResNet), and the flax paths map onto the port's keys one to one;
- one train step (dropout 0) against JAX's: the loss and the 10 metrics to
  1e-5 relative; the gradients per tensor as max |diff| / max |grad|, by
  their median (bound 2e-3, observed 4.3e-4) and 90th percentile (5e-3,
  8.4e-4), and over all tensors at once as a relative L2 norm (5e-3,
  6.1e-4). The custom body's neck runs at height 32 and its float32 sums
  are long: the worst single tensor reads 5.2e-3, and the two packages' float32
  steps agree far better with each other than either does with the port's
  float64 step, whose pairs and units sit on other sides of their kinks (median
  1.7e-1 for both). A fault of the port reads O(1). The gradients that
  are 0 in exact arithmetic (the conv biases ahead of a train-mode
  BatchNorm, and the last ExtractorLayer's ``bn_b`` and ``res_conv`` biases,
  which reach the output only through conv -> BatchNorm) stay below 1e-6 of
  the model's largest gradient;
- dropout follows every ExtractorLayer in train mode, drawn from the
  caller's generator.

The reference checkpoint (``--ref_exact``) is in
``tests/test_torch_checkpoints.py``.
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
from audioyolo_tpu_torch.models.backbone import CustomBackbone
from audioyolo_tpu_torch.models.layers import init_weights
from audioyolo_tpu_torch.train import METRIC_KEYS, AudioDetectionLoss

from test_torch_model import _randomize

GRAD_BOUNDS = dict(median=2e-3, p90=5e-3, l2=5e-3)
LOSS_KW = dict(num_classes=2, anchor_t=5.0, edge_t=0.5, sample_duration=4.0, box_w=0.1,
               conf_w=1.0, class_w=0.3, multi_label=True, label_smoothing=0.08)


@pytest.fixture(scope="module")
def custom():
    from conftest import TINY_CFG

    raw = copy.deepcopy(TINY_CFG)
    raw.update(backbone="custom", block_layers=[2, 1, 1, 2])
    feats = np.random.default_rng(8).standard_normal((2, 32, 160, 2)).astype(np.float32)
    jm = JModel.from_config(raw, num_classes=2)
    v = jax.jit(lambda r, f: jm.init({"params": r}, features=f, train=False))(
        jax.random.PRNGKey(2), jnp.asarray(feats))
    return raw, _randomize(v, seed=4), feats


@pytest.mark.parametrize("form", ["train", "deploy"])
def test_custom_backbone_matches_jax(form, custom):
    raw, v, feats = custom
    deploy = form == "deploy"
    jv = jfold(v) if deploy else v
    jm = JModel.from_config(raw, num_classes=2, deploy=deploy)
    ref = jax.jit(lambda vv, f: jm.apply(vv, features=f, train=False))(jv, jnp.asarray(feats))
    model = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2, deploy=deploy)
    sd = state_dict_from_jax(jv)
    assert set(sd) == set(model.state_dict())
    assert isinstance(model.feature_extractor, CustomBackbone)
    model.load_state_dict(fold_repvgg(state_dict_from_jax(v)) if deploy else sd)
    model.eval()
    with torch.no_grad():
        out = model(features=torch.from_numpy(feats))
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)


def test_custom_train_step_matches_jax(custom):
    raw, v, feats = custom
    targets = {"classes": np.array([[1, 0, -100, 0], [0, 1, 0, 0]], np.int32),
               "centers": np.array([[0.85, 2.55, 3.55, 0], [1.7, 3.3, 0, 0]], np.float32),
               "widths": np.array([[1.1, 1.1, 0.9, 0], [1.8, 1.4, 0, 0]], np.float32),
               "valid": np.array([[True, True, True, False], [True, True, False, False]])}
    jm = JModel.from_config(raw, num_classes=2)
    jloss = JLoss(raw["anchors"], **LOSS_KW)

    def loss_fn(params):
        preds, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                            features=jnp.asarray(feats), train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(1)})
        return jloss(preds, {k: jnp.asarray(x) for k, x in targets.items()})

    (_, j_m), j_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    model = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2)
    model.load_state_dict(state_dict_from_jax(v))
    model.train()
    preds = model(features=torch.from_numpy(feats), generator=torch.Generator())
    loss, metrics = AudioDetectionLoss(raw["anchors"], **LOSS_KW)(
        preds, {k: torch.from_numpy(x) for k, x in targets.items()})
    loss.backward()
    m = AudioDetectionLoss.metrics_vector(metrics).detach().numpy()
    np.testing.assert_allclose(m, [float(j_m[k]) for k in METRIC_KEYS], rtol=1e-5)

    ref_g = {k: t.numpy() for k, t in state_dict_from_jax({"params": j_g}).items()}
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(grads) == set(ref_g)
    gmax = max(np.abs(g).max() for g in ref_g.values())
    # zero in exact arithmetic: the conv biases ahead of a train-mode
    # BatchNorm, and what reaches the output only through conv -> BatchNorm
    # (the last ExtractorLayer's bn_b and res_conv biases)
    dead = [k for k in ref_g if np.abs(ref_g[k]).max() < 1e-6 * gmax]
    rel = {k: np.abs(grads[k] - ref_g[k]).max() / np.abs(ref_g[k]).max()
           for k in ref_g if k not in dead}
    vals = list(rel.values())
    live = list(rel)
    l2 = (np.linalg.norm(np.concatenate([(grads[k] - ref_g[k]).ravel() for k in live]))
          / np.linalg.norm(np.concatenate([ref_g[k].ravel() for k in live])))
    worst = max(rel, key=rel.get)
    print(f"custom train step: {len(rel)} gradients, median {np.median(vals):.3e}, p90 "
          f"{np.percentile(vals, 90):.3e}, L2 {l2:.3e}, worst {rel[worst]:.3e} ({worst}); "
          f"{len(dead)} zero in exact arithmetic")
    assert len(dead) == 15 + 1 + 2 * 8 + 2
    assert max(np.abs(grads[k]).max() for k in dead) / gmax < 1e-6
    assert np.median(vals) < GRAD_BOUNDS["median"] and np.percentile(vals, 90) < GRAD_BOUNDS["p90"]
    assert l2 < GRAD_BOUNDS["l2"]


def test_custom_dropout_follows_every_layer_and_the_generator():
    backbone = CustomBackbone((1, 1, 1, 1), dropout=0.5).train()
    init_weights(backbone, torch.Generator().manual_seed(0))
    x = torch.randn(2, 2, 32, 64, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="Generator"):
        backbone(x)
    runs = [backbone(x, torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    # the convolutional half of block1's last layer output is dropped, the
    # residual half never
    out = runs[0]
    assert (out[:, :64] == 0).float().mean() > 0.3 and (out[:, 64:] == 0).float().mean() < 0.01
    assert [f.shape[1] for f in backbone.eval()(x)] == [128, 256, 512, 1024]

"""The PyTorch port's detector against the JAX package's, on the CPU.

JAX-initialised variables (BatchNorm statistics and conv biases made
non-trivial with numpy from a seed) go through ``state_dict_from_jax``; the
port's backbone + neck + decode must then match
``AudioDetectionModel.apply(features=...)`` in float32, in the train form and
in the folded deploy form."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioyolo_tpu.models import AudioDetectionModel as JModel
from audioyolo_tpu.models import fold_repvgg as jfold
from audioyolo_tpu.models import layers as jl

from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.models import AudioDetectionModel, fold_repvgg, state_dict_from_jax
from audioyolo_tpu_torch.models import layers as tl

ATOL = RTOL = 1e-4  # float32 convolutions summed in another order


def _nhwc_to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


@pytest.mark.parametrize("out_w", [3, 8, 16])
def test_resize_w_bilinear_matches(out_w):
    x = np.random.default_rng(0).standard_normal((2, 1, 8, 5)).astype(np.float32)  # NHWC
    ref = np.asarray(jl.resize_w_bilinear(jnp.asarray(x), out_w))
    out = tl.resize_w_bilinear(_nhwc_to_nchw(x), out_w).numpy()
    np.testing.assert_allclose(np.transpose(out, (0, 2, 3, 1)), ref, atol=1e-6, rtol=1e-6)


def test_max_pool_same_matches():
    x = np.random.default_rng(1).standard_normal((2, 3, 9, 4)).astype(np.float32)
    for k in (3, 5):
        ref = np.asarray(jl.max_pool_same(jnp.asarray(x), k))
        out = tl.max_pool_same(_nhwc_to_nchw(x), k).numpy()
        np.testing.assert_array_equal(np.transpose(out, (0, 2, 3, 1)), ref)


def test_batchnorm_eval_matches():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 5, 6)).astype(np.float32)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                    "bias": rng.standard_normal(6).astype(np.float32)},
         "batch_stats": {"mean": rng.standard_normal(6).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}}
    ref = np.asarray(jl.BatchNorm().apply(v, jnp.asarray(x), use_running_average=True))
    bn = tl.BatchNorm(6).eval()
    bn.load_state_dict(state_dict_from_jax(v))
    with torch.no_grad():
        out = bn(_nhwc_to_nchw(x)).numpy()
    np.testing.assert_allclose(np.transpose(out, (0, 2, 3, 1)), ref, atol=1e-6, rtol=1e-6)


def _randomize(variables, seed=0):
    """Non-trivial BN statistics, BN affine and conv biases (numpy, seeded)."""
    rng = np.random.default_rng(seed)

    def walk(p, s):
        out = {}
        for k, v in p.items():
            if isinstance(v, dict):
                out[k] = walk(v, (s or {}).get(k))
            elif k == "scale":
                out[k] = rng.uniform(0.6, 1.4, v.shape).astype(np.float32)
            elif k == "bias":
                out[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    def stats(s):
        out = {}
        for k, v in s.items():
            if isinstance(v, dict):
                out[k] = stats(v)
            elif k == "mean":
                out[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return out

    v = jax.tree_util.tree_map(np.asarray, variables)
    return {"params": walk(v["params"], None), "batch_stats": stats(v["batch_stats"])}


@pytest.fixture(scope="module")
def jax_setup():
    import copy

    from conftest import TINY_CFG

    raw = copy.deepcopy(TINY_CFG)
    jm = JModel.from_config(raw, num_classes=2)
    feats = np.random.default_rng(3).standard_normal((2, 32, 160, 2)).astype(np.float32)
    v = jax.jit(lambda r, f: jm.init({"params": r}, features=f, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(feats))
    return raw, _randomize(v), feats


def _scales_close(ours, ref):
    assert len(ours) == len(ref) == 3
    for o, r in zip(ours, ref):
        assert tuple(o.shape) == tuple(r.shape)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("form", ["train", "deploy", "branch_act"])
def test_model_matches_jax(form, jax_setup):
    """``branch_act``: the reference's per-branch RepVGG activation (train form)."""
    raw, v, feats = jax_setup
    deploy, branch_act = form == "deploy", form == "branch_act"
    jv = jfold(v) if deploy else v
    jm = JModel.from_config(raw, num_classes=2, deploy=deploy, branch_act=branch_act)
    ref = jax.jit(lambda vv, f: jm.apply(vv, features=f, train=False))(jv, jnp.asarray(feats))

    tm = AudioDetectionModel.from_config(Config(raw), num_classes=2, deploy=deploy,
                                         branch_act=branch_act)
    sd = state_dict_from_jax(jv)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    tm.eval()
    with torch.no_grad():
        out = tm(features=torch.from_numpy(feats))
    _scales_close(out, ref)


def test_fold_repvgg_matches_jax(jax_setup):
    """Port fold after the bridge == bridge after the JAX fold."""
    _, v, _ = jax_setup
    ours = fold_repvgg(state_dict_from_jax(v))
    theirs = state_dict_from_jax(jfold(v))
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(), atol=1e-7, rtol=1e-6,
                                   err_msg=k)


def test_bottleneck_backbone_matches_jax():
    """The Bottleneck block (``resnet_config.block``), backbone alone."""
    from audioyolo_tpu.models.backbone import ResNetBackbone as JBackbone

    from audioyolo_tpu_torch.models.backbone import ResNetBackbone

    x = np.random.default_rng(4).standard_normal((1, 32, 32, 2)).astype(np.float32)
    jb = JBackbone(block="Bottleneck", block_layers=(1, 1, 1, 1))
    v = _randomize(jax.jit(lambda r, f: jb.init(r, f, train=False))(
        jax.random.PRNGKey(1), jnp.asarray(x)), seed=2)
    ref = jax.jit(lambda vv, f: jb.apply(vv, f, train=False))(v, jnp.asarray(x))
    tb = ResNetBackbone("Bottleneck", (1, 1, 1, 1)).eval()
    tb.load_state_dict(state_dict_from_jax(v))
    with torch.no_grad():
        out = tb(_nhwc_to_nchw(x))
    assert tb.fmap_channels == (256, 512, 1024, 2048)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(np.transpose(o.numpy(), (0, 2, 3, 1)), np.asarray(r),
                                   atol=ATOL, rtol=RTOL)


def test_seeded_init_is_deterministic(tiny_cfg):
    cfg = Config(tiny_cfg.to_dict())
    a = AudioDetectionModel.from_config(cfg, 2, generator=torch.Generator().manual_seed(5))
    b = AudioDetectionModel.from_config(cfg, 2, generator=torch.Generator().manual_seed(5))
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    w = a.feature_extractor.conv1.conv.weight
    bound = float(np.sqrt(6.0 / ((2 + 64) * 49)))
    assert w.abs().max() <= bound and w.std() > bound / 3

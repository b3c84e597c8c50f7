"""Checkpoints from elsewhere, on the CPU: the reference's ``.pth.tar`` and the
JAX trainer's ``.msgpack`` through the PyTorch port's importers.

- A ``randomize_``d ``tests/torch_ref.py`` network (the torch re-creation of
  the reference) saved as ``{"network_params": ...}`` goes through
  ``inference_cli.load_model_state`` into the port with ``branch_act=True``:
  predictions equal the reference's on the same features to rtol 1e-4, atol
  1e-4 (``tests/test_torch_parity.py``), and the port's decode + NMS +
  compaction give ``process_model_outputs_ref``'s rows (confidence and
  objectness 2e-4, class equal, times 1e-3 s).
- The port's importer equals the JAX package's importer followed by
  ``state_dict_from_jax``, bit for bit, and its key function the JAX one on
  every flax path, the CustomBackbone's included. A reference
  ``CustomBackBone`` checkpoint serves through ``build_inference
  --ref_exact`` with the reference's predictions (1e-4).
- A ``.msgpack`` laid out as the JAX trainer's ``save_model`` writes it, made
  with ``flax.serialization.msgpack_serialize``, serves through the port with
  the JAX model's detections (``tests/test_torch_slice.py`` tolerances), and a
  hand-made MessagePack of every type the decoder reads decodes as
  ``flax.serialization.msgpack_restore`` decodes it.
"""

import copy
import os
import struct

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from audioyolo_tpu.config import Config as JConfig
from audioyolo_tpu.infer import make_inference_fn as j_make_inference_fn
from audioyolo_tpu.models import AudioDetectionModel as JModel
from audioyolo_tpu.models import fold_repvgg as j_fold
from audioyolo_tpu.models.import_torch import flax_path_to_torch_key
from audioyolo_tpu.models.import_torch import import_torch_state_dict as j_import
from audioyolo_tpu.models.import_torch import load_torch_checkpoint as j_load_ckpt
from audioyolo_tpu.ops.frontend import SpectralFrontend as JFrontend
from audioyolo_tpu.train.optim import make_optimizer as j_make_optimizer

from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.infer.decode import detection_postprocess_graph, postprocess_detections
from audioyolo_tpu_torch.inference_cli import build_inference, load_model_state
from audioyolo_tpu_torch.models import AudioDetectionModel, flax_msgpack, state_dict_from_jax
from audioyolo_tpu_torch.models.import_torch import (import_torch_state_dict,
                                                     load_torch_checkpoint,
                                                     port_key_to_torch_key)

from test_torch_model import _randomize
from torch_ref import TorchAudioDetectionNetwork, process_model_outputs_ref, randomize_

CONF = 0.2


def _raw(block="BasicBlock", backbone="resnet"):
    from conftest import TINY_CFG

    raw = copy.deepcopy(TINY_CFG)
    raw["resnet_config"] = {"block": block}
    raw["backbone"] = backbone
    return raw


def _reference_checkpoint(tmp_path, raw, seed):
    tmodel = TorchAudioDetectionNetwork(2, raw)
    randomize_(tmodel, seed=seed)
    tmodel.eval()
    path = str(tmp_path / f"ref_{seed}.pth.tar")
    torch.save({"network_params": tmodel.state_dict(), "epoch": 3}, path)
    return tmodel, path


@pytest.mark.parametrize("block,seed", [("BasicBlock", 3), ("Bottleneck", 4)])
def test_reference_checkpoint_runs_in_the_port(tmp_path, block, seed):
    raw = _raw(block)
    tmodel, path = _reference_checkpoint(tmp_path, raw, seed)
    model = AudioDetectionModel.from_config(Config(raw), 2, branch_act=True)
    model.load_state_dict(load_model_state(path, Config(raw), 2))
    model.eval()
    n_frames = Config(raw).n_frames
    feats = np.random.default_rng(seed + 100).standard_normal((3, 2, 32, n_frames)).astype(np.float32)
    with torch.no_grad():
        ref = tmodel(torch.from_numpy(feats))
        ours = model(features=torch.from_numpy(feats).permute(0, 2, 3, 1))
        ref_c = tmodel(torch.from_numpy(feats), combine_scales=True)
        preds = model(features=torch.from_numpy(feats).permute(0, 2, 3, 1), combine_scales=True)
    for name, r, o in zip(("sm", "md", "lg"), ref, ours):
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name} scale diverges")

    dur = float(raw["sample_duration"])
    ref_rows = process_model_outputs_ref(ref_c, iou_threshold=0.1, conf_threshold=0.25,
                                         sample_duration=dur)
    dets = detection_postprocess_graph(preds, 0.1, 0.25, dur, keep_k=preds.shape[1])
    rows = postprocess_detections({k: v.numpy() for k, v in dets.items()}, dur)
    assert sum(map(len, ref_rows)) > 0
    for b, (r_rows, o_rows) in enumerate(zip(ref_rows, rows)):
        assert len(o_rows) == len(r_rows), f"clip {b}"
        for r, o in zip(r_rows, o_rows):
            assert o[0] == pytest.approx(r[0], abs=2e-4)
            assert o[1] == pytest.approx(1 / (1 + np.exp(-r[1])), abs=2e-4)  # sigmoid(obj)
            assert o[2] == r[2]
            assert o[3] == pytest.approx(r[3], abs=1e-3)
            assert o[4] == pytest.approx(r[4], abs=1e-3)


@pytest.mark.parametrize("block", ["BasicBlock", "Bottleneck"])
def test_port_importer_equals_the_jax_importer(tmp_path, block):
    raw = _raw(block)
    _, path = _reference_checkpoint(tmp_path, raw, seed=9)
    template = jax.eval_shape(lambda: JModel.from_config(raw, num_classes=2).init(
        {"params": jax.random.PRNGKey(0)}, features=jnp.zeros((1, 32, 160, 2)), train=False))
    ref = state_dict_from_jax(j_import(j_load_ckpt(path), template))
    ours = import_torch_state_dict(load_torch_checkpoint(path),
                                   AudioDetectionModel.from_config(Config(raw), 2).state_dict())
    assert set(ours) == set(ref) and len(ref) > 100
    for k in ref:
        assert ours[k].dtype == torch.float32 and torch.equal(ours[k], ref[k]), k


@pytest.mark.parametrize("block,backbone", [("BasicBlock", "resnet"), ("Bottleneck", "resnet"),
                                            ("BasicBlock", "custom")])
def test_key_function_matches_the_jax_one(block, backbone):
    """Every flax path of the JAX model, written as the port names it (the
    path joined with dots, the leaf renamed as ``state_dict_from_jax`` does),
    maps to the reference key the JAX importer reads."""
    raw = _raw(block, backbone)
    variables = jax.eval_shape(lambda: JModel.from_config(raw, num_classes=2).init(
        {"params": jax.random.PRNGKey(0)}, features=jnp.zeros((1, 32, 160, 2)), train=False))
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
    n = 0
    for collection in ("params", "batch_stats"):
        for path, _ in jax.tree_util.tree_flatten_with_path(variables[collection])[0]:
            names = [p.key for p in path]
            port_key = ".".join(names[:-1] + [leaf.get(names[-1], names[-1])])
            assert port_key_to_torch_key(port_key) == flax_path_to_torch_key(collection,
                                                                             tuple(names))[0]
            n += 1
    assert n > 100


def test_import_refuses_bad_checkpoints(tmp_path):
    raw = _raw()
    tmodel, _ = _reference_checkpoint(tmp_path, raw, seed=5)
    template = AudioDetectionModel.from_config(Config(raw), 2).state_dict()
    sd = {k: v.clone() for k, v in tmodel.state_dict().items()}
    assert import_torch_state_dict(sd, template)  # the whole checkpoint imports

    missing = dict(sd)
    del missing["multiscale_module.rep_block3_2.blocks.0.conv3x3.conv.weight"]
    with pytest.raises(KeyError, match="rep_block3_2.blocks.0.conv3x3.conv.weight"):
        import_torch_state_dict(missing, template)
    with pytest.raises(ValueError, match="unconsumed.*extra_head.weight"):
        import_torch_state_dict(dict(sd, **{"extra_head.weight": torch.zeros(3)}), template)
    assert "extra_head.weight" not in import_torch_state_dict(
        dict(sd, **{"extra_head.weight": torch.zeros(3)}), template, strict=False)
    shaped = dict(sd, **{"feature_extractor.conv1.weight": torch.zeros(64, 2, 5, 5)})
    with pytest.raises(ValueError, match="shape mismatch"):
        import_torch_state_dict(shaped, template)

    # the custom backbone's reference checkpoint serves (it was refused
    # before the port had the backbone)
    raw_c = _raw(backbone="custom")
    tmodel_c, custom = _reference_checkpoint(tmp_path, raw_c, seed=6)
    fn = build_inference(Config(raw_c), 2, custom, 0.1, CONF, ref_exact=True, device="cpu")
    feats = np.random.default_rng(16).standard_normal((2, 2, 32, 160)).astype(np.float32)
    with torch.no_grad():
        ref = tmodel_c(torch.from_numpy(feats), combine_scales=True)
        ours = fn.model(features=torch.from_numpy(feats).permute(0, 2, 3, 1),
                        combine_scales=True)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)
    framed = fn.model.frontend.frame_host(np.zeros((2, Config(raw_c).clip_samples), np.int16))
    packed = fn(torch.from_numpy(framed))
    assert packed.shape == (2, 32, 6) and torch.isfinite(packed).all()


# ---- the JAX trainer's .msgpack -----------------------------------------------


def test_jax_trainer_msgpack_serves_through_the_port(tmp_path):
    """``{params, batch_stats, opt_state, step}`` as ``TrainerPipeline.save_model``
    writes it (Adam's optax state included): the port reads the file with its
    own decoder and detects what the JAX model detects."""
    raw = _raw()
    jm = JModel.from_config(raw, num_classes=2)
    x0 = jnp.zeros((1, 1, JConfig(raw).clip_samples))
    v = _randomize(jax.jit(lambda r, x: jm.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(7), x0), seed=11)
    tx = j_make_optimizer({"name": "Adam", "lr": 1e-3, "weight_decay": 0.002}, None, 1)
    payload = {"params": serialization.to_state_dict(v["params"]),
               "batch_stats": serialization.to_state_dict(v["batch_stats"]),
               "opt_state": serialization.to_state_dict(tx.init(v["params"])),
               "step": 12}
    path = str(tmp_path / "AudioDetectionModel.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(payload))

    _assert_same_tree(flax_msgpack.load(path), serialization.msgpack_restore(open(path, "rb").read()))
    t_fn = build_inference(Config(raw), 2, path, 0.1, CONF, device="cpu")
    j_fn = j_make_inference_fn(JModel.from_config(raw, num_classes=2, deploy=True), j_fold(v),
                               0.1, CONF, keep_k=32, packed=True)
    wav = (np.random.default_rng(23).standard_normal((2, JConfig(raw).clip_samples)) * 3000
           ).astype(np.int16)
    framed = JFrontend(JConfig(copy.deepcopy(raw))).frame_host(wav)
    ref = np.asarray(j_fn(jnp.asarray(framed)))
    out = t_fn(torch.from_numpy(framed)).numpy()
    valid = ref[..., 5] > 0.5
    assert valid.sum() > 2
    np.testing.assert_array_equal(out[..., 5] > 0.5, valid)
    np.testing.assert_array_equal(out[valid][:, 2], ref[valid][:, 2])
    np.testing.assert_allclose(out[valid][:, 0], ref[valid][:, 0], atol=1e-4)
    np.testing.assert_allclose(out[valid][:, 3:5], ref[valid][:, 3:5], atol=1e-3)


def _assert_same_tree(ours, ref):
    assert type(ours) is type(ref), (type(ours), type(ref))
    if isinstance(ref, dict):
        assert list(ours) == list(ref)
        for k in ref:
            _assert_same_tree(ours[k], ref[k])
    elif isinstance(ref, list):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _assert_same_tree(a, b)
    elif isinstance(ref, np.ndarray):
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)
    elif isinstance(ref, float) and np.isnan(ref):
        assert np.isnan(ours)
    else:
        assert ours == ref


def _ext(obj):
    """One object packed as flax packs it (ndarrays and numpy scalars as
    extension types 1 and 3)."""
    return msgpack.packb(obj, default=serialization._msgpack_ext_pack, strict_types=True)


def test_msgpack_decoder_reads_every_type_as_flax_does():
    ints = [0, 5, 127, -1, -32, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
            -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    parts = [_ext(i) for i in ints]
    parts += [_ext(x) for x in (None, True, False, 0.1, -1e300, float("inf"), float("nan"))]
    parts.append(msgpack.packb(1.5, use_single_float=True))  # float32
    parts += [_ext(s) for s in ("", "k", "é" * 20, "x" * 40, "y" * 300, "z" * 70000)]
    parts += [_ext(b) for b in (b"", b"\x00\xff", b"b" * 300, b"c" * 70000)]
    parts.append(_ext(list(range(20))))  # array16
    parts.append(_ext(list(range(70000))))  # array32
    parts.append(_ext({f"k{i}": i for i in range(20)}))  # map16
    parts.append(_ext({f"m{i}": i for i in range(70000)}))  # map32
    arrays = [np.arange(6, dtype=np.int8),  # a 16-byte payload: fixext 16
              np.float32([[1.5, -2.0], [0.0, 3.25]]), np.arange(24, dtype=np.int64).reshape(2, 3, 4),
              np.zeros((0, 3), np.float32), np.array(True), np.float64([np.pi]),
              np.arange(600, dtype=np.uint16),  # ext 16
              np.linspace(-1, 1, 20000, dtype=np.float32)]  # ext 32
    parts += [_ext(a) for a in arrays]
    parts += [_ext(s) for s in (np.float32(2.5), np.int64(-7), np.uint8(200), np.bool_(False))]
    parts.append(_ext({"params": {"conv": {"kernel": arrays[1]}}, "step": np.int32(3)}))
    blob = b"\xdc" + struct.pack(">H", len(parts)) + b"".join(parts)
    heads = {p[0] for p in parts}
    assert {0xca, 0xcb, 0xcc, 0xcd, 0xce, 0xcf, 0xd0, 0xd1, 0xd2, 0xd3, 0xd9, 0xda, 0xdb,
            0xc4, 0xc5, 0xc6, 0xdc, 0xdd, 0xde, 0xdf, 0xd8, 0xc7, 0xc8, 0xc9, 0xc0, 0xc2,
            0xc3} <= heads
    ours, ref = flax_msgpack.unpackb(blob), serialization.msgpack_restore(blob)
    assert len(ours) == len(parts)
    _assert_same_tree(ours, ref)
    assert type(ours[-2]) is np.bool_ and ours[-5] == np.float32(2.5)


def test_msgpack_decoder_refuses_what_it_does_not_read():
    with pytest.raises(ValueError, match="complex"):
        flax_msgpack.unpackb(_ext({"c": 1 + 2j}))
    chunked = {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2}, "chunks": {}}}
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.unpackb(_ext(chunked))
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.unpackb(_ext(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.unpackb(_ext("abcdef")[:-2])
    with pytest.raises(ValueError, match="0xc1"):
        flax_msgpack.unpackb(b"\xc1")

"""The data path of data-parallel and cached training on the CPU: the port's
``BatchLoader(shard=)`` against the JAX package's orders,
``DeviceCachedLoader`` against the port's own ``BatchLoader`` bit for bit
(float32, int16, framed int16 and ``(q, scale)`` layouts; the pad, partial
and drop policies; the ``auto`` / ``on`` / ``off`` config policy), and
``quantize_clips_int8_device`` against the JAX package's bit for bit."""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioyolo_tpu.data.loader import BatchLoader as JBatchLoader
from audioyolo_tpu.infer.streaming import quantize_clips_int8_device as j_quantize_device

from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.data.dataset import AudioDataset
from audioyolo_tpu_torch.data.loader import BatchLoader, DeviceCachedLoader
from audioyolo_tpu_torch.infer.streaming import quantize_clips_int8, quantize_clips_int8_device
from audioyolo_tpu_torch.ops.frontend import SpectralFrontend

from synth import make_flat_dataset


class _Sized:
    """A dataset of ``n`` items for the index-only paths."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("shard", [(0, 2), (1, 2), (2, 3)])
def test_shard_orders_match_jax(shard, shuffle):
    """Same spans as the JAX package's loader over three epochs, 7 items
    (wrap-padded to 8 and 9), for every last-batch policy."""
    for policy in ("partial", "pad", "drop"):
        kw = dict(batch_size=2, shuffle=shuffle, seed=5, last_batch=policy, shard=shard)
        port, ref = BatchLoader(_Sized(7), **kw), JBatchLoader(_Sized(7), **kw)
        assert len(port) == len(ref) and port._shard_len() == ref._shard_len() == -(-7 // shard[1])
        for _ in range(3):
            got, want = port.iter_spans(), ref.iter_spans()
            assert [s.tolist() for s in got] == [s.tolist() for s in want], (policy, shard)
    with pytest.raises(ValueError, match="out of range"):
        BatchLoader(_Sized(7), 2, shard=(3, 3))


@pytest.fixture(scope="module")
def flat_ds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cache") / "train")
    ann = make_flat_dataset(root, n_files=5, seed=9)
    return AudioDataset(root, ann, sample_duration=4, sample_rate=8000, max_targets=8)


def _layouts(tiny_cfg):
    """(name, BatchLoader kwargs): float32, int16, framed int16 (the native
    framed decode) and the int8 posture's (q, scale) frames."""
    fe = SpectralFrontend(Config(tiny_cfg.to_dict()))
    raw = copy.deepcopy(tiny_cfg.to_dict())
    raw["tpu_config"]["frontend_precision"] = "int8"
    fe8 = SpectralFrontend(Config(raw))
    assert fe.fused is not None and fe8.fused_int8
    return [("float32", dict(transfer_dtype="float32")),
            ("int16", dict(transfer_dtype="int16")),
            ("framed int16", dict(transfer_dtype="int16", framer=fe.fused)),
            ("q, scale", dict(frame_fn=fe8.frame_host_int8))]


def _host(x):
    if isinstance(x, tuple):
        return tuple(_host(a) for a in x)
    return x.numpy() if torch.is_tensor(x) else x


def test_cached_batches_equal_the_loaders(flat_ds, tiny_cfg):
    """Two epochs of shuffled batches, cached and not, bit for bit: every key,
    the padded clips' invalid targets and ``clip_valid`` included; the audio
    lies on the cache's device."""
    for name, kw in _layouts(tiny_cfg):
        for policy in ("partial", "pad", "drop"):
            ref = BatchLoader(flat_ds, 2, seed=7, last_batch=policy, **kw)
            cached = DeviceCachedLoader.wrap(BatchLoader(flat_ds, 2, seed=7, last_batch=policy,
                                                         **kw), device="cpu")
            assert isinstance(cached, DeviceCachedLoader), (name, policy)
            assert len(cached) == len(ref)
            for _ in range(2):
                for rb, cb in zip(list(ref), list(cached), strict=True):
                    assert set(rb) == set(cb), (name, policy)
                    leaves = cb["audio"] if isinstance(cb["audio"], tuple) else (cb["audio"],)
                    assert all(torch.is_tensor(t) and t.device.type == "cpu" for t in leaves)
                    for k in rb:
                        got, want = _host(cb[k]), rb[k]
                        if isinstance(want, tuple):
                            for g, w in zip(got, want, strict=True):
                                np.testing.assert_array_equal(g, w, err_msg=f"{name}/{policy}/{k}")
                        else:
                            assert got.dtype == want.dtype, (name, policy, k)
                            np.testing.assert_array_equal(got, want, err_msg=f"{name}/{policy}/{k}")
            one = ref._make_batch(np.arange(1))["audio"]
            per_clip = sum(x[:1].nbytes for x in (one if isinstance(one, tuple) else (one,)))
            assert cached.nbytes == per_clip * len(flat_ds), name


def test_cache_policy_from_the_config(flat_ds):
    """``auto`` caches what fits ``device_cache_max_mb`` (512 by default),
    ``on`` whatever the size, ``off`` nothing; a sharded loader and an empty
    dataset are never cached, and a sharded loader is refused outright."""
    def loader(**kw):
        return BatchLoader(flat_ds, 2, transfer_dtype="int16", **kw)

    clip_mb = flat_ds.clip_samples * 2 / 1e6
    wrap = DeviceCachedLoader.wrap_from_config
    assert isinstance(wrap(loader(), None, "cpu"), DeviceCachedLoader)
    assert isinstance(wrap(loader(), {"device_cache_dataset": "auto"}, "cpu"), DeviceCachedLoader)
    small = {"device_cache_dataset": "auto", "device_cache_max_mb": clip_mb * 4}
    assert isinstance(wrap(loader(), small, "cpu"), BatchLoader)
    small["device_cache_max_mb"] = clip_mb * 6
    assert isinstance(wrap(loader(), small, "cpu"), DeviceCachedLoader)
    for on in ("on", "true", "1", True):
        assert isinstance(wrap(loader(), {"device_cache_dataset": on, "device_cache_max_mb": 0},
                               "cpu"), DeviceCachedLoader)
    for off in ("off", "false", "0", False):
        assert isinstance(wrap(loader(), {"device_cache_dataset": off}, "cpu"), BatchLoader)
    sharded = loader(shard=(0, 2))
    assert wrap(sharded, {"device_cache_dataset": "on"}, "cpu") is sharded
    empty = BatchLoader(_Sized(0), 2)
    assert DeviceCachedLoader.wrap(empty, device="cpu") is empty
    with pytest.raises(ValueError, match="sharded"):
        DeviceCachedLoader(sharded, "cpu")


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_quantize_clips_int8_device_matches_jax(dtype):
    """Per-clip absmax int8 of (B, 1, S) clips on the device: q and scale bit
    for bit against the JAX package's jitted quantizer and the port's host
    quantizer; a silent clip and full-scale clips included."""
    rng = np.random.default_rng(3)
    if dtype == "int16":
        clips = rng.integers(-20000, 20000, (4, 1, 4001)).astype(np.int16)
        clips[1] = 0
        clips[2, 0, 7] = -32768
    else:
        clips = (rng.standard_normal((4, 1, 4001)) * 0.3).astype(np.float32)
        clips[1] = 0.0
        clips[3] *= 1e-6
    q, scale = quantize_clips_int8_device(torch.from_numpy(clips))
    jq, jscale = j_quantize_device(jnp.asarray(clips))
    hq, hscale = quantize_clips_int8(clips)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32 and scale.shape == (4,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(q.numpy(), hq)
    np.testing.assert_array_equal(scale.numpy(), hscale)

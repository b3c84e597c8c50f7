"""Host-side batch loader with a prefetch thread (port of
``audioyolo_tpu/data/loader.py::BatchLoader``).

Batches are dicts of numpy arrays of one shape: ``audio`` and the target
slots of ``data/dataset.py``. The shuffle order of epoch ``e`` is
``np.random.default_rng(seed + e)``, the JAX package's. ``last_batch``:

- ``"partial"`` (the reference's): the last short batch as it is;
- ``"pad"``: repeat-padded to the batch size, the padded clips' targets
  invalid and a ``clip_valid`` mask beside them (the loss leaves those clips
  out of every term; train-mode BatchNorm still sees them);
- ``"drop"``: the remainder is dropped.

``transfer_dtype="int16"`` ships PCM16 (bit-exact for 16-bit sources; the
frontend dequantises by 1/32768); ``frame_fn`` (``SpectralFrontend.
frame_host``) frames each batch on the prefetch thread. ``framer`` (a
``FusedFrameDFT``, ``SpectralFrontend.fused``) implies
``frame_fn=framer.frame_host`` and, with int16 transfers, decodes each batch
from disk straight into int16 frames.

A dataset with the native batch decoders (``AudioDataset``) is read in one
native call per batch, in the JAX package's order: framed int16 (``framer``
and int16), raw int16 (int16), float32; a concatenation of datasets is read
item by item. The batches are bit-identical whichever path reads them, and a
failed decode raises.

``shard=(index, count)``: the loader owns the strided slice ``index::count``
of every epoch's order (the same shuffle on every rank), wrap-padded so that
each rank sees ``ceil(n / count)`` items; each rank loads ``batch_size``
clips per step, so the global batch of a data-parallel step is ``count *
batch_size`` clips in rank order.

:class:`DeviceCachedLoader` holds a small dataset on the device in the
loader's transfer layout and gathers each epoch's batches there.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .dataset import AudioDataset


def _repeat_last(v, reps: int):
    """``v`` (an array, or the ``(q, scale)`` tuple of ``frame_host_int8``)
    with its last row repeated ``reps`` times."""
    if isinstance(v, tuple):
        return tuple(_repeat_last(a, reps) for a in v)
    return np.concatenate([v, np.repeat(v[-1:], reps, axis=0)], axis=0)


class BatchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 42,
                 last_batch: str = "partial", prefetch: int = 2,
                 transfer_dtype: str = "float32", frame_fn=None, framer=None,
                 shard: Optional[Tuple[int, int]] = None):
        if last_batch not in ("partial", "pad", "drop"):
            raise ValueError(f"unknown last_batch policy '{last_batch}'")
        if transfer_dtype not in ("float32", "int16"):
            raise ValueError(f"unknown transfer_dtype '{transfer_dtype}'")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.last_batch = last_batch
        self.prefetch = max(int(prefetch), 0)
        self.transfer_dtype = transfer_dtype
        self.framer = framer
        self.frame_fn = framer.frame_host if frame_fn is None and framer is not None else frame_fn
        if shard is not None:
            index, count = int(shard[0]), int(shard[1])
            if not 0 <= index < count:
                raise ValueError(f"shard index {index} out of range for count {count}")
            shard = (index, count)
        self.shard = shard
        self._epoch = 0

    def _shard_len(self) -> int:
        n = len(self.dataset)
        return n if self.shard is None else -(-n // self.shard[1])

    def __len__(self) -> int:
        n = self._shard_len()
        if self.last_batch == "drop":
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _targets_batch(self, indices) -> Dict[str, np.ndarray]:
        """The target slots of a natively decoded batch (the decoded length
        is the annotated span's, capped at the clip)."""
        ds = self.dataset
        items = [ds.targets(int(i), min(ds.audio_span(int(i))[2], ds.clip_samples))
                 for i in indices]
        return {k: np.stack([t[k] for t in items]) for k in items[0]}

    def _native_audio(self, indices):
        """(audio, framed) from the dataset's native batch decoders, or None
        for a dataset without them."""
        ds = self.dataset
        if not hasattr(ds, "load_audio_batch_framed"):
            return None
        if self.transfer_dtype == "int16" and self.framer is not None:
            return ds.load_audio_batch_framed(indices, self.framer), True
        if self.transfer_dtype == "int16":
            return ds.load_audio_batch_i16(indices), False
        return ds.load_audio_batch(indices), False

    def _make_batch(self, indices) -> Dict[str, np.ndarray]:
        native = self._native_audio(indices)
        if native is not None:
            batch = self._targets_batch(indices)
            batch["audio"], framed = native
        else:
            batch = AudioDataset.collate([self.dataset[int(i)] for i in indices])
            framed = False
            if self.transfer_dtype == "int16":
                batch["audio"] = np.clip(np.round(batch["audio"] * 32768.0), -32768,
                                         32767).astype(np.int16)
        if self.frame_fn is not None and not framed:
            batch["audio"] = self.frame_fn(batch["audio"][:, 0, :])
        n = len(indices)
        if self.last_batch == "pad":
            if n < self.batch_size:
                reps = self.batch_size - n
                batch = {k: _repeat_last(v, reps) for k, v in batch.items()}
                batch["valid"][n:] = False
            batch["clip_valid"] = np.arange(self.batch_size) < n
        return batch

    def iter_spans(self) -> List[np.ndarray]:
        """One epoch's batches of dataset indices (advances the epoch)."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        if self.shard is not None and len(order):
            i, c = self.shard
            order = np.resize(order, self._shard_len() * c)[i::c]
        self._epoch += 1
        spans = [order[s: s + self.batch_size] for s in range(0, len(order), self.batch_size)]
        if self.last_batch == "drop":
            spans = [s for s in spans if len(s) == self.batch_size]
        return spans

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        spans = self.iter_spans()
        if self.prefetch == 0:
            for span in spans:
                yield self._make_batch(span)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()

        def producer():
            try:
                for span in spans:
                    if stop.is_set():
                        return
                    q.put(self._make_batch(span))
            except Exception as exc:  # the consumer re-raises it
                q.put(exc)
            q.put(done)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():  # let a producer blocked on a full queue finish
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()


_TARGET_SLOTS = ("classes", "centers", "widths", "valid")


class DeviceCachedLoader:
    """A small dataset held on the device (port of the JAX package's
    ``DeviceCachedLoader``).

    The cache is built once, in index order, through the wrapped loader's own
    ``_make_batch`` (native framed int16, raw int16, float32, or the
    ``(q, scale)`` tuple of the int8 posture), so its rows and targets are the
    ones the loader makes. Each epoch takes the loader's ``iter_spans`` and
    gathers the spans' rows on the device with ``index_select``; padding,
    ``clip_valid`` and the padded clips' invalid targets follow the loader's
    ``last_batch``. Batches carry the audio as a device tensor (or a tuple of
    them) and the targets as numpy arrays, so an epoch copies only the
    targets from the host. The targets come from the build's batches (the
    JAX package reads them with ``_targets_batch``, which a concatenation of
    datasets lacks). A sharded loader is refused."""

    def __init__(self, loader: BatchLoader, device: DeviceLike = None):
        if loader.shard is not None:
            raise ValueError("DeviceCachedLoader does not support sharded loaders")
        self.loader = loader
        self.device = resolve_device(device)
        n, bs = len(loader.dataset), loader.batch_size
        audio, targets = [], {k: [] for k in _TARGET_SLOTS}
        for s in range(0, n, bs):
            span = np.arange(s, min(s + bs, n))
            batch = loader._make_batch(span)
            a = batch["audio"]
            audio.append(tuple(x[: len(span)] for x in a) if isinstance(a, tuple)
                         else a[: len(span)])
            for k in _TARGET_SLOTS:
                targets[k].append(batch[k][: len(span)])

        def put(parts):
            return torch.from_numpy(np.concatenate(parts, axis=0)).to(self.device)

        self._tuple = isinstance(audio[0], tuple)
        self._cache = (tuple(put([r[j] for r in audio]) for j in range(len(audio[0])))
                       if self._tuple else put(audio))
        self._targets = {k: np.concatenate(v, axis=0) for k, v in targets.items()}

    def __len__(self) -> int:
        return len(self.loader)

    @property
    def nbytes(self) -> int:
        leaves = self._cache if self._tuple else (self._cache,)
        return sum(t.numel() * t.element_size() for t in leaves)

    def __iter__(self) -> Iterator[Dict[str, object]]:
        loader = self.loader
        for span in loader.iter_spans():
            idx = np.asarray(span, np.int64)
            n = len(idx)
            pad = loader.batch_size - n if loader.last_batch == "pad" else 0
            if pad > 0:
                idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
            batch: Dict[str, object] = {k: v[idx] for k, v in self._targets.items()}
            index = torch.from_numpy(idx).to(self.device)
            batch["audio"] = (tuple(t.index_select(0, index) for t in self._cache)
                              if self._tuple else self._cache.index_select(0, index))
            if pad > 0:
                batch["valid"][n:] = False
            if loader.last_batch == "pad":
                batch["clip_valid"] = np.arange(len(idx)) < n
            yield batch

    @classmethod
    def wrap_from_config(cls, loader: BatchLoader, tpu_cfg: Optional[dict],
                         device: DeviceLike = None):
        """The cache policy of ``tpu_config``: ``device_cache_dataset`` is
        ``auto`` (the default: cache when the dataset fits
        ``device_cache_max_mb``, default 512; any other word reads as ``auto``,
        as in the JAX package), ``on``/``true``/``1`` (cache whatever its
        size) or ``off``/``false``/``0`` (never)."""
        tpu_cfg = tpu_cfg or {}
        mode = str(tpu_cfg.get("device_cache_dataset", "auto")).lower()
        if mode in ("false", "0", "off"):
            return loader
        if mode in ("true", "1", "on"):
            return cls.wrap(loader, max_mb=float("inf"), device=device)
        return cls.wrap(loader, max_mb=float(tpu_cfg.get("device_cache_max_mb", 512.0)),
                        device=device)

    @classmethod
    def wrap(cls, loader: BatchLoader, max_mb: float = 512.0, device: DeviceLike = None):
        """A cached view of ``loader`` when its dataset fits ``max_mb`` (the
        size estimated from a one-clip probe in the transfer layout), else
        ``loader`` itself; a sharded loader or an empty dataset is never
        cached."""
        n = len(loader.dataset)
        if loader.shard is not None or n == 0:
            return loader
        a = loader._make_batch(np.arange(1))["audio"]
        est_mb = sum(x[:1].nbytes for x in (a if isinstance(a, tuple) else (a,))) * n / 1e6
        if est_mb > max_mb:
            return loader
        return cls(loader, device)

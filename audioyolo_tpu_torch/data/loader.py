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
failed decode raises. Not ported: multi-host sharding (``shard=``) and the
device-resident cache (``DeviceCachedLoader``).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np

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
                 transfer_dtype: str = "float32", frame_fn=None, framer=None):
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
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
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

"""Host-side batch loader with a prefetch thread (port of
``audioyolo_tpu/data/loader.py::BatchLoader``, numpy only).

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
frame_host``) frames each batch on the prefetch thread. Not ported: the
native C++ decode, multi-host sharding (``shard=``) and the device-resident
cache (``DeviceCachedLoader``).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np

from .dataset import AudioDataset


class BatchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 42,
                 last_batch: str = "partial", prefetch: int = 2,
                 transfer_dtype: str = "float32", frame_fn=None):
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
        self.frame_fn = frame_fn
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.last_batch == "drop":
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, indices) -> Dict[str, np.ndarray]:
        batch = AudioDataset.collate([self.dataset[int(i)] for i in indices])
        if self.transfer_dtype == "int16":
            batch["audio"] = np.clip(np.round(batch["audio"] * 32768.0), -32768,
                                     32767).astype(np.int16)
        if self.frame_fn is not None:
            batch["audio"] = self.frame_fn(batch["audio"][:, 0, :])
        n = len(indices)
        if self.last_batch == "pad":
            if n < self.batch_size:
                reps = self.batch_size - n
                batch = {k: np.concatenate([v, np.repeat(v[-1:], reps, axis=0)], axis=0)
                         for k, v in batch.items()}
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

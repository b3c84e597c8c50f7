"""Clip dataset with fixed-capacity padded targets (port of
``audioyolo_tpu/data/dataset.py``), with the native batch decoders.

Every clip gives ``max_targets`` target slots with a validity mask, so
batches have one shape. Kept from the reference:

- the flat and the grouped (``group-N``) annotation layouts, each group a
  pseudo-file re-based to ``[0, sample_duration]``;
- files or groups longer than ``sample_duration`` are skipped with a warning;
- only the annotated span of the WAV is read;
- multi-channel audio is downmixed to mono by the mean;
- (start, end) -> (center, width);
- a short clip is zero-padded to ``sample_duration`` and an ignore-labelled
  target covering the padded tail is appended.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Iterable, List

import numpy as np

from . import native
from .wavio import read_wav

logger = logging.getLogger(__name__)

IGNORE_INDEX = -100


class AudioDataset:
    def __init__(self, audios_path: str, annotations: Dict[str, Any], sample_duration: float = 60,
                 sample_rate: int = 22_050, extension: str = "wav",
                 ignore_index: int = IGNORE_INDEX, max_targets: int = 48):
        self.audios_path = audios_path
        self.sample_duration = float(sample_duration)
        self.sample_rate = int(sample_rate)
        self.extension = extension
        self.ignore_index = int(ignore_index)
        self.max_targets = int(max_targets)

        names = {n[: -(len(extension) + 1)] for n in os.listdir(audios_path)
                 if n.endswith(f".{extension}")}
        annotations = {k: v for k, v in annotations.items() if k in names}
        index = self._index_grouped if self.is_grouped_annotations(annotations) else self._index_flat
        self._samples, self.class2idx, self.class_counts = index(annotations)

    # ---- indexing ------------------------------------------------------

    def _index_flat(self, annotations):
        samples, classes, counts = [], [], {}
        for filename, annotation in annotations.items():
            seg = self._collect_segments(annotation, classes, counts, label=filename)
            if seg is not None:
                samples.append({"filename": filename, "segments": seg, "gmin": 0.0})
        return samples, self._finalize_classes(classes), self._sorted_counts(classes, counts)

    def _index_grouped(self, annotations):
        samples, classes, counts = [], [], {}
        for filename, groups in annotations.items():
            gmin = 0.0
            for group in sorted(groups, key=lambda k: int(k.split("-")[-1])):
                seg = self._collect_segments(groups[group], classes, counts,
                                             label=f"{group} of {filename}")
                if seg is not None:
                    samples.append({"filename": filename, "segments": seg, "gmin": gmin})
                gmin += self.sample_duration
        return samples, self._finalize_classes(classes), self._sorted_counts(classes, counts)

    def _collect_segments(self, annotation, classes, counts, label):
        keys = sorted(annotation.keys())
        duration = annotation[keys[-1]]["end"] - annotation[keys[0]]["start"]
        if duration > self.sample_duration:
            logger.warning("duration of %s is more than %s and will not be included in the "
                           "processed dataset", label, self.sample_duration)
            return None
        rows = []
        for key in keys:
            cls = annotation[key]["class"].strip().replace(" ", "-")
            if cls not in classes:
                classes.append(cls)
            counts[cls] = counts.get(cls, 0) + 1
            rows.append((float(annotation[key]["start"]), float(annotation[key]["end"]), cls))
        return rows

    @staticmethod
    def _finalize_classes(classes: List[str]) -> Dict[str, int]:
        return {label: i for i, label in enumerate(sorted(classes))}

    @staticmethod
    def _sorted_counts(classes: List[str], counts: Dict[str, int]) -> Dict[str, int]:
        return {k: counts[k] for k in sorted(classes)}

    # ---- access --------------------------------------------------------

    def __len__(self) -> int:
        return len(self._samples)

    def __add__(self, other: "AudioDataset") -> "AudioConcatDataset":
        return AudioConcatDataset([self, other])

    def audio_span(self, idx: int):
        """(filepath, frame_offset, num_frames) of the annotated span."""
        sample = self._samples[idx]
        segments = sample["segments"]
        filepath = os.path.join(self.audios_path, f"{sample['filename']}.{self.extension}")
        start, end = segments[0][0], segments[-1][1]
        return filepath, int(start * self.sample_rate), int((end - start) * self.sample_rate)

    @property
    def clip_samples(self) -> int:
        return int(self.sample_duration * self.sample_rate)

    def targets(self, idx: int, span_samples: int) -> Dict[str, np.ndarray]:
        """Fixed-capacity target arrays; ``span_samples`` is the decoded
        length before padding, which decides whether the pad target over the
        zero-padded tail is appended."""
        sample = self._samples[idx]
        segments, gmin = sample["segments"], sample["gmin"]
        audio_start = segments[0][0] - gmin
        audio_end = segments[-1][1] - gmin
        n = len(segments)
        if n + 1 > self.max_targets:
            raise ValueError(f"clip has {n} events but max_targets={self.max_targets}; raise "
                             "tpu_config.max_targets")
        classes = np.zeros(self.max_targets, np.int32)
        centers = np.zeros(self.max_targets, np.float32)
        widths = np.zeros(self.max_targets, np.float32)
        valid = np.zeros(self.max_targets, bool)
        for i, (s, e, cls) in enumerate(segments):
            s, e = s - gmin, e - gmin
            classes[i] = self.class2idx[cls]
            widths[i] = e - s
            centers[i] = s + (e - s) / 2.0
            valid[i] = True
        if span_samples < self.clip_samples:
            pad_duration = (audio_start + self.sample_duration) - audio_end
            classes[n] = self.ignore_index
            centers[n] = audio_end + pad_duration / 2.0
            widths[n] = pad_duration
            valid[n] = True
        return {"classes": classes, "centers": centers, "widths": widths, "valid": valid}

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        filepath, offset, count = self.audio_span(idx)
        audio, _ = read_wav(filepath, frame_offset=offset, num_frames=count)
        if audio.shape[0] != 1:
            audio = audio.mean(axis=0, keepdims=True)
        max_samples = self.clip_samples
        if audio.shape[-1] > max_samples:
            raise ValueError(f"audio sample is longer than {self.sample_duration}s — check that "
                             f"sample_rate={self.sample_rate} matches the files")
        span_samples = audio.shape[-1]
        if span_samples < max_samples:
            audio = np.concatenate(
                [audio, np.zeros((1, max_samples - span_samples), audio.dtype)], axis=-1)
        item = {"audio": audio.astype(np.float32)}
        item.update(self.targets(idx, span_samples))
        return item

    # ---- native batch decode ------------------------------------------

    def _native_spans(self, indices):
        spans = [self.audio_span(int(i)) for i in indices]
        return [s[0] for s in spans], [s[1] for s in spans], [s[2] for s in spans]

    def load_audio_batch(self, indices, n_threads: int = 4) -> np.ndarray:
        """A batch of annotated spans decoded by the native library into
        one (B, 1, clip_samples) float32 buffer: ``__getitem__``'s audio."""
        paths, offs, counts = self._native_spans(indices)
        return native.load_batch(paths, offs, counts, out_len=self.clip_samples,
                                 n_threads=n_threads)[:, None, :]

    def load_audio_batch_i16(self, indices, n_threads: int = 4) -> np.ndarray:
        """As :meth:`load_audio_batch`, quantized to int16 as the loader's
        int16 transfer quantizes (mono PCM16 is read as it is)."""
        paths, offs, counts = self._native_spans(indices)
        counts = [min(c, self.clip_samples) for c in counts]
        return native.load_batch_i16(paths, offs, counts, out_len=self.clip_samples,
                                     n_threads=n_threads)[:, None, :]

    def load_audio_batch_framed(self, indices, framer, n_threads: int = 4) -> np.ndarray:
        """As :meth:`load_audio_batch_i16`, decoded straight into
        ``framer``'s (B, n_ph, n_groups, frame_len) int16 frames."""
        paths, offs, counts = self._native_spans(indices)
        return native.load_batch_framed_i16(paths, offs, counts, clip_len=self.clip_samples,
                                            framer=framer, n_threads=n_threads)

    # ---- utilities -----------------------------------------------------

    def get_class_weights(self) -> np.ndarray:
        w = np.asarray(list(self.class_counts.values()), np.float32)
        return w.sum() / (len(w) * w)

    @staticmethod
    def save_label_map(class2idx: Dict[str, int], _dir: str) -> None:
        os.makedirs(_dir, exist_ok=True)
        with open(os.path.join(_dir, "class_map.json"), "w") as f:
            json.dump({v: k for k, v in class2idx.items()}, f)

    @staticmethod
    def is_grouped_annotations(annotations: Dict[str, Any]) -> bool:
        if not annotations:
            return False
        keys = list(next(iter(annotations.values())).keys())
        return bool(keys) and keys[0].startswith("group")

    @staticmethod
    def collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {k: np.stack([it[k] for it in items], axis=0) for k in items[0]}


class AudioConcatDataset:
    """AudioDatasets joined under one class vocabulary: the children are
    re-keyed onto the union ``class2idx``, so targets agree across them."""

    def __init__(self, datasets: Iterable[AudioDataset]):
        flat: List[AudioDataset] = []
        for d in datasets:
            flat.extend(d.datasets if isinstance(d, AudioConcatDataset) else [d])
        self.datasets = flat
        counts: Dict[str, int] = {}
        for d in flat:
            for cls, cnt in d.class_counts.items():
                counts[cls] = counts.get(cls, 0) + cnt
        self.class2idx = {label: i for i, label in enumerate(sorted(counts))}
        self.class_counts = {k: counts[k] for k in sorted(counts)}
        for d in flat:
            d.class2idx = self.class2idx
        self._offsets = np.cumsum([0] + [len(d) for d in flat])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __add__(self, other):
        return AudioConcatDataset([self, other])

    def __getitem__(self, idx: int):
        di = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[di][idx - int(self._offsets[di])]

    def get_class_weights(self) -> np.ndarray:
        w = np.asarray(list(self.class_counts.values()), np.float32)
        return w.sum() / (len(w) * w)

    @classmethod
    def make_combo_dataset(cls, audio_paths, annotations_list, **kwargs):
        ds = None
        for path, annotations in zip(audio_paths, annotations_list):
            nxt = AudioDataset(path, annotations, **kwargs)
            ds = nxt if ds is None else ds + nxt
        return ds

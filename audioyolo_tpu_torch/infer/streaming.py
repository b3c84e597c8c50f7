"""Long-form streaming evaluation (port of ``audioyolo_tpu/infer/streaming.py``,
``rle_merge``, ``evaluate_audio`` and ``write_rows_csv``).

Reads arbitrarily long audio in ``batch_size * sample_duration`` chunks,
windows each chunk into a batch of fixed clips, runs the inference function,
re-globalizes event times by clip offset and, unless rows are asked for,
writes one ``{start, end, class}`` CSV per file after an RLE merge of
same-class neighbours. Chunks are padded to the full batch, and the rows of
padded clips are dropped.

Transfer: mono PCM16 files ship int16 to the device (dequantized there),
other formats float32. A file at the model rate ships phase-grouped frames
when a ``frame_fn`` is given; a file at another rate is resampled on the
device and takes the waveform path. Chunks are dispatched two deep: chunk
N+1 is queued on the device before chunk N's detections are copied back.
The JAX package's int8 transfer, ``chunk_range`` sharding and prefetch
thread are not ported yet.
"""

from __future__ import annotations

import csv
import math
import os
from datetime import timedelta
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.wavio import read_wav, read_wav_info, read_wav_pcm16_mono
from ..ops.resample import Resampler
from .decode import postprocess_detections, unpack_detections


def rle_merge(rows: List[dict]) -> List[dict]:
    """Merge consecutive same-class events (class adjacency only: time gaps
    do not split, as in the reference)."""
    out: List[dict] = []
    for row in rows:
        if out and out[-1]["class"] == row["class"]:
            out[-1]["end"] = row["end"]
        else:
            out.append(dict(row))
    return out


def evaluate_audio(
    infer_fn: Callable,
    audio_filepath: str,
    output_dir: str,
    input_sample_rate: int,
    sample_duration: float,
    batch_size: int,
    idx2class_map: Dict[int, str],
    return_rows: bool = False,
    frame_fn: Optional[Callable] = None,
    _resampler_cache: Optional[dict] = None,
) -> Optional[List[dict]]:
    """Stream one file through the detector; writes ``<name>_results.csv``
    under ``output_dir`` or, with ``return_rows``, returns the time-ordered
    rows. ``infer_fn`` comes from ``decode.make_inference_fn`` (its
    ``.device`` is where batches are sent); ``frame_fn`` is the host framer
    (``SpectralFrontend.frame_host``) used for files at ``input_sample_rate``.
    """
    device = infer_fn.device
    og_rate, total_frames, _ = read_wav_info(audio_filepath)
    sample_size = int(sample_duration * og_rate)
    model_sample_size = int(sample_duration * input_sample_rate)
    chunk_frames = batch_size * sample_size

    resampler = None
    if og_rate != input_sample_rate:
        cache = _resampler_cache if _resampler_cache is not None else {}
        key = (og_rate, input_sample_rate, str(device))
        if key not in cache:
            cache[key] = Resampler(og_rate, input_sample_rate).to(device)
        resampler = cache[key]

    def read_chunk_mono(start_frame: int):
        """(samples_1d, dtype): int16 for mono PCM16 files, float32 otherwise."""
        nf = min(chunk_frames, total_frames - start_frame)
        raw = read_wav_pcm16_mono(audio_filepath, frame_offset=start_frame, num_frames=nf)
        if raw is not None:
            return raw, np.int16
        audio, _ = read_wav(audio_filepath, frame_offset=start_frame, num_frames=nf)
        if audio.shape[0] != 1:
            audio = audio.mean(axis=0, keepdims=True)
        return audio[0], np.float32

    def chunk_inputs():
        start_frame = 0
        while start_frame < total_frames:
            samples, dtype = read_chunk_mono(start_frame)
            if samples.shape[-1] == 0:
                return
            n = samples.shape[-1]
            nclips = math.ceil(n / sample_size)
            pad = nclips * sample_size - n
            if pad:
                samples = np.pad(samples, (0, pad))
            clips = samples.reshape(nclips, 1, sample_size)
            if nclips < batch_size:  # one static batch shape
                clips = np.concatenate(
                    [clips, np.zeros((batch_size - nclips, 1, sample_size), dtype)], axis=0)
            start_frame += chunk_frames
            if frame_fn is not None and resampler is None:
                framed = np.require(frame_fn(clips[:, 0, :]), requirements=["C", "W"])
                yield nclips, torch.from_numpy(framed).to(device)
                continue
            x = torch.from_numpy(np.require(clips, requirements=["C", "W"])).to(device)
            if resampler is not None:
                if x.dtype == torch.int16:  # dequantize on the device, then resample
                    x = x.float() * (1.0 / 32768.0)
                x = resampler(x)
                if x.shape[-1] > model_sample_size:
                    x = x[..., :model_sample_size]
                elif x.shape[-1] < model_sample_size:
                    x = F.pad(x, (0, model_sample_size - x.shape[-1]))
            yield nclips, x

    all_rows: List[dict] = []
    clip_offset = 0

    def drain(nclips: int, out) -> None:
        nonlocal clip_offset
        if isinstance(out, dict):
            dets = {k: v.cpu().numpy() for k, v in out.items()}
        else:
            dets = unpack_detections(out.cpu().numpy())
        per_clip = postprocess_detections(dets, sample_duration, return_start_end=True)
        for ci in range(nclips):  # padded clips are dropped here
            base = (clip_offset + ci) * sample_duration
            for conf, obj, cls, start, end in per_clip[ci]:
                all_rows.append({"confidence": conf, "objectness": obj, "class_idx": cls,
                                 "start": base + start, "end": base + end})
        clip_offset += nclips

    pending = None
    for nclips, x in chunk_inputs():
        out = infer_fn(x)
        if pending is not None:
            drain(*pending)
        pending = (nclips, out)
    if pending is not None:
        drain(*pending)

    if return_rows:
        all_rows.sort(key=lambda r: (r["start"], r["end"]))
        return all_rows
    write_rows_csv(all_rows, idx2class_map, audio_filepath, output_dir)
    return None


def _format_timedelta(td: timedelta) -> str:
    """``0 days 00:01:02.500000``: the text pandas writes for a timedelta."""
    hours, rem = divmod(td.seconds, 3600)
    minutes, seconds = divmod(rem, 60)
    text = f"{td.days} days {hours:02d}:{minutes:02d}:{seconds:02d}"
    return text + (f".{td.microseconds:06d}" if td.microseconds else "")


def write_rows_csv(all_rows: List[dict], idx2class_map: Dict[int, str],
                   audio_filepath: str, output_dir: str) -> str:
    """Sort rows by time, RLE-merge, write ``<name>_results.csv`` (in a
    subfolder named after the file's parent directory)."""
    all_rows = sorted(all_rows, key=lambda r: (r["start"], r["end"]))
    rows = [
        {"start": timedelta(seconds=round(r["start"], 2)),
         "end": timedelta(seconds=round(r["end"], 2)),
         "class": idx2class_map[r["class_idx"]]}
        for r in all_rows
    ]
    merged = rle_merge(rows)

    parts = os.path.normpath(audio_filepath).split(os.sep)
    filename = ".".join(parts[-1].split(".")[:-1]) or parts[-1]
    if len(parts) >= 2 and parts[-2] not in ("", ".", os.sep):
        output_dir = os.path.join(output_dir, parts[-2])
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, f"{filename}_results.csv")
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["start", "end", "class"])
        for row in merged:
            w.writerow([_format_timedelta(row["start"]), _format_timedelta(row["end"]),
                        row["class"]])
    return out_path

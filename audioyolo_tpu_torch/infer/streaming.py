"""Long-form streaming evaluation (port of ``audioyolo_tpu/infer/streaming.py``).

Reads arbitrarily long audio in ``batch_size * sample_duration`` chunks,
windows each chunk into a batch of fixed clips, runs the inference function,
re-globalizes event times by clip offset and, unless rows are asked for,
writes one ``{start, end, class}`` CSV per file after an RLE merge of
same-class neighbours. Chunks are padded to the full batch, and the rows of
padded clips are dropped. :func:`evaluate_files_batched` fills each batch
with windows of as many files as it takes.

Transfer: mono PCM16 files ship int16 to the device (dequantized there),
other formats float32. A file at the model rate ships phase-grouped frames
when a ``frame_fn`` is given; a file at another rate is resampled on the
device and takes the waveform path. Chunks are read, framed and copied to the
device on a producer thread (:func:`_prefetch_iter`) and dispatched two deep:
chunk N+1 is queued on the device before chunk N's detections are copied
back. Each copy to the device is synchronous (from pageable memory, on the
device's default stream, which orders it before the forward that reads it),
so no host buffer is reused while a copy from it is in flight. The JAX
package's int8 transfer is not ported (ROADMAP A10).
"""

from __future__ import annotations

import csv
import math
import os
import queue
import threading
from datetime import timedelta
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.wavio import read_wav, read_wav_info, read_wav_pcm16_mono
from ..ops.resample import Resampler
from .decode import postprocess_detections, unpack_detections


def _check_transfer(transfer: str) -> None:
    if transfer == "int8":
        raise NotImplementedError(
            "transfer='int8' (per-clip int8 quantization) is not ported yet (ROADMAP A10)")
    if transfer != "int16":
        raise ValueError(f"transfer must be 'int16' or 'int8', got {transfer!r}")


def _prefetch_iter(gen: Iterator, depth: int = 2) -> Iterator:
    """Run a generator on a background thread, ``depth`` items ahead.

    The producer's WAV decode, framing and device copy then overlap the
    consumer's device work. An error in the producer is raised on the
    consumer. A consumer that stops early (an exception, ``close()``) stops
    the producer: its bounded puts check a stop flag, the generator is
    closed, and the thread is joined before this generator returns.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    err: List[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not put(item):
                    return
        except BaseException as e:  # surfaced on the consumer thread
            err.append(e)
        finally:
            try:
                gen.close()  # release file handles promptly
            except Exception as e:
                err.append(e)
            put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        try:  # unblock a producer waiting on a full queue, drop chunk refs
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)


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


def _fetch(out) -> Dict[str, np.ndarray]:
    """One device->host copy of a packed (B, K, 6) tensor or a detection dict."""
    if isinstance(out, dict):
        return {k: v.cpu().numpy() for k, v in out.items()}
    return unpack_detections(out.cpu().numpy())


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(device)


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
    chunk_range: Optional[Tuple[int, int]] = None,
    transfer: str = "int16",
) -> Optional[List[dict]]:
    """Stream one file through the detector; writes ``<name>_results.csv``
    under ``output_dir`` or, with ``return_rows``, returns the time-ordered
    rows. ``infer_fn`` comes from ``decode.make_inference_fn`` (its
    ``.device`` is where batches are sent); ``frame_fn`` is the host framer
    (``SpectralFrontend.frame_host``) used for files at ``input_sample_rate``.

    ``chunk_range``: ``(c0, c1)`` evaluates only chunks ``c0 <= c < c1``
    (a chunk is ``batch_size`` windows) with clip offsets kept global, so
    the rows of disjoint ranges concatenate to the rows of the whole file.
    ``transfer``: ``"int16"``; ``"int8"`` raises ``NotImplementedError``.
    """
    _check_transfer(transfer)
    device = infer_fn.device
    og_rate, total_frames, _ = read_wav_info(audio_filepath)
    sample_size = int(sample_duration * og_rate)
    model_sample_size = int(sample_duration * input_sample_rate)
    chunk_frames = batch_size * sample_size
    first_frame, end_frame = 0, total_frames
    if chunk_range is not None:
        c0, c1 = chunk_range
        first_frame = min(c0 * chunk_frames, total_frames)
        end_frame = min(c1 * chunk_frames, total_frames)

    resampler = None
    if og_rate != input_sample_rate:
        cache = _resampler_cache if _resampler_cache is not None else {}
        key = (og_rate, input_sample_rate, str(device))
        if key not in cache:
            cache[key] = Resampler(og_rate, input_sample_rate).to(device)
        resampler = cache[key]

    def read_chunk_mono(start_frame: int):
        """(samples_1d, dtype): int16 for mono PCM16 files, float32 otherwise."""
        nf = min(chunk_frames, end_frame - start_frame)
        raw = read_wav_pcm16_mono(audio_filepath, frame_offset=start_frame, num_frames=nf)
        if raw is not None:
            return raw, np.int16
        audio, _ = read_wav(audio_filepath, frame_offset=start_frame, num_frames=nf)
        if audio.shape[0] != 1:
            audio = audio.mean(axis=0, keepdims=True)
        return audio[0], np.float32

    @torch.no_grad()
    def chunk_inputs():
        """Host decode, windowing and framing, then the copy to the device."""
        start_frame = first_frame
        while start_frame < end_frame:
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
                yield nclips, _to_device(frame_fn(clips[:, 0, :]), device)
                continue
            x = _to_device(clips, device)
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
    clip_offset = 0 if chunk_range is None else chunk_range[0] * batch_size

    def drain(nclips: int, out) -> None:
        nonlocal clip_offset
        per_clip = postprocess_detections(_fetch(out), sample_duration, return_start_end=True)
        for ci in range(nclips):  # padded clips are dropped here
            base = (clip_offset + ci) * sample_duration
            for conf, obj, cls, start, end in per_clip[ci]:
                all_rows.append({"confidence": conf, "objectness": obj, "class_idx": cls,
                                 "start": base + start, "end": base + end})
        clip_offset += nclips

    pending = None
    for nclips, x in _prefetch_iter(chunk_inputs()):
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


def _iter_windows(path: str, sample_size: int, total_frames: int):
    """Yield (clip_idx, window) fixed-size mono windows of one file; int16
    for PCM16 mono, float32 otherwise; the tail zero-padded."""
    start, clip = 0, 0
    while start < total_frames:
        n = min(sample_size, total_frames - start)
        raw = read_wav_pcm16_mono(path, frame_offset=start, num_frames=n)
        if raw is None:
            audio, _ = read_wav(path, frame_offset=start, num_frames=n)
            if audio.shape[0] != 1:
                audio = audio.mean(axis=0, keepdims=True)
            raw = audio[0].astype(np.float32)
        if raw.shape[-1] < sample_size:
            raw = np.pad(raw, (0, sample_size - raw.shape[-1]))
        yield clip, raw
        clip += 1
        start += sample_size


def evaluate_files_batched(
    infer_fn: Callable,
    paths: List[str],
    output_dir: str,
    input_sample_rate: int,
    sample_duration: float,
    batch_size: int,
    idx2class_map: Dict[int, str],
    frame_fn: Optional[Callable] = None,
    verbose: bool = False,
    transfer: str = "int16",
) -> int:
    """Cross-file window scheduler: every device batch is filled with windows
    from as many files as it takes, so a directory of short files runs at
    full batches instead of a padded batch per file.

    All ``paths`` must be at ``input_sample_rate`` (``runner.evaluate_dir``
    sends other rates to :func:`evaluate_audio`). A file's CSV is written as
    soon as its last window drains; rows, sorting, RLE merge and CSV naming
    are those of :func:`evaluate_audio`. Returns the number of files.
    """
    _check_transfer(transfer)
    device = infer_fn.device
    sample_size = int(sample_duration * input_sample_rate)
    infos = [read_wav_info(p) for p in paths]
    per_file_rows: List[List[dict]] = [[] for _ in paths]
    # windows still in flight per file: at zero the file's CSV is written
    remaining = [-(-total // sample_size) for (_, total, _) in infos]
    os.makedirs(output_dir, exist_ok=True)
    done_count = 0

    def finish_file(fi: int):
        nonlocal done_count
        write_rows_csv(per_file_rows[fi], idx2class_map, paths[fi], output_dir)
        per_file_rows[fi] = []
        done_count += 1
        if verbose:
            print(f"[{done_count}/{len(paths)}] {os.path.basename(paths[fi])}")

    for fi, r in enumerate(remaining):
        if r == 0:  # zero-length file: no windows, write its (empty) CSV now
            finish_file(fi)

    def windows():
        for fi, (path, (_, total, _)) in enumerate(zip(paths, infos)):
            yield from ((fi, clip, w) for clip, w in _iter_windows(path, sample_size, total))

    def to_device(wins: List[np.ndarray]) -> torch.Tensor:
        if all(w.dtype == np.int16 for w in wins):
            arr = np.stack(wins)
        else:  # mixed sources: promote, scaling PCM16 exactly like the readers
            arr = np.stack([
                w.astype(np.float32) * (1.0 / 32768.0) if w.dtype == np.int16
                else w.astype(np.float32)
                for w in wins
            ])
        n = arr.shape[0]
        if n < batch_size:
            arr = np.concatenate(
                [arr, np.zeros((batch_size - n,) + arr.shape[1:], arr.dtype)], axis=0)
        if frame_fn is not None:
            return _to_device(frame_fn(arr), device)
        return _to_device(arr[:, None, :], device)

    def batches():
        metas, wins = [], []
        for fi, clip, w in windows():
            metas.append((fi, clip))
            wins.append(w)
            if len(wins) == batch_size:
                yield metas, to_device(wins)
                metas, wins = [], []
        if wins:
            yield metas, to_device(wins)

    def drain(metas, out):
        per_clip = postprocess_detections(_fetch(out), sample_duration, return_start_end=True)
        for i, (fi, clip) in enumerate(metas):
            base = clip * sample_duration
            for conf, obj, cls, start, end in per_clip[i]:
                per_file_rows[fi].append({"confidence": conf, "objectness": obj,
                                          "class_idx": cls, "start": base + start,
                                          "end": base + end})
            remaining[fi] -= 1
            if remaining[fi] == 0:
                finish_file(fi)

    pending = None
    for metas, x in _prefetch_iter(batches()):
        out = infer_fn(x)
        if pending is not None:
            drain(*pending)
        pending = (metas, out)
    if pending is not None:
        drain(*pending)
    if done_count != len(paths):
        raise RuntimeError(f"window accounting out of sync: {done_count} of {len(paths)} files")
    return len(paths)


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

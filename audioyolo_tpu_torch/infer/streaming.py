"""Long-form streaming evaluation (port of ``audioyolo_tpu/infer/streaming.py``).

Reads arbitrarily long audio in ``batch_size * sample_duration`` chunks,
windows each chunk into a batch of fixed clips, runs the inference function,
re-globalizes event times by clip offset and, unless rows are asked for,
writes one ``{start, end, class}`` CSV per file after an RLE merge of
same-class neighbours. Chunks are padded to the full batch, and the rows of
padded clips are dropped. :func:`evaluate_files_batched` fills each batch
with windows of as many files as it takes.

Transfer: mono PCM16 files ship int16 to the device (dequantized there),
other formats float32; ``transfer="int8"`` ships per-clip int8 waveforms
and their scales (:func:`quantize_clips_int8`, half the int16 bytes), or,
with the ``int8`` posture's framer, the ``(q, scale)`` frames. A file at
the model rate ships phase-grouped frames when a ``frame_fn`` is given
(int16 windows through the native framer); a file at another rate is
resampled on the device and takes the waveform path.
Chunks are read, framed and copied to the device on a producer thread
(:func:`_prefetch_iter`) and dispatched two deep: chunk N+1 is queued on the
device before chunk N's detections are copied back.

In :func:`evaluate_files_batched` the int16 waveform path (no ``frame_fn``,
``transfer="int16"``) reads a batch whose windows all come from mono PCM16
files (``wavio.is_pcm16_mono``) with one native call
(``data/native.py::load_batch_i16``, the interpreter lock released) straight
into the host tensor that is copied to the device: no per-window arrays, no
stack, no second host copy. Every other batch, and :func:`evaluate_audio`,
reads window by window or chunk by chunk, stacks, and copies into a fresh
pinned host tensor (the frames straight from the framer).

On the card host tensors are pinned blocks of PyTorch's caching host
allocator, copied with ``non_blocking=True`` on the default stream, which
orders the copy before the forward that reads it. No host buffer is reused
while its copy is in flight: the allocator hands a freed pinned block out
again only after the copies recorded on it have completed; the direct read
zero-fills the rows past a batch's last window, since the block it gets may
hold an earlier batch.

Spans (``utils/trace.py``, recorded only under a profiler): on the producer
thread ``ayt.stream.read`` (a window or chunk read; a direct batch's native
call, with ``ayt.stream.read_direct`` nested in it once per such batch),
``ayt.stream.stack`` (a batch stacked and padded; for a direct batch its
spans listed, each pad row a span of no frames that the native read
zero-fills) and ``ayt.stream.pin`` (the fresh pinned host memory filled; a
direct batch's pinned block taken; the copy's enqueue stays outside); on the
dispatching thread ``ayt.stream.wait_input`` (blocked on the producer),
``ayt.stream.wait_device`` (blocked on a batch's results) and
``ayt.stream.drain`` (rows and CSVs after the fetch). None encloses a launch
or a copy.
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

from ..data import native
from ..data.wavio import is_pcm16_mono, read_wav, read_wav_info, read_wav_pcm16_mono
from ..ops.resample import Resampler
from ..utils.trace import span
from .decode import postprocess_detections, unpack_detections


def _check_transfer(transfer: str) -> None:
    if transfer not in ("int16", "int8"):
        raise ValueError(f"transfer must be 'int16' or 'int8', got {transfer!r}")


def quantize_clips_int8(clips: np.ndarray, out: Optional[np.ndarray] = None):
    """Per-clip symmetric int8 quantization of a (B, 1, S) int16 or float32
    clip batch: ``(q int8, scale float32 (B,))`` with ``q * scale`` the float
    waveform the int16 or float path feeds the model (for int16 the readers'
    1/32768 folds into ``scale``). int16 runs the native quantizer
    (``data/native.py::quant_i8``, which raises if the library cannot be
    built), float32 numpy; both bit-equal to the JAX package's. ``q`` is
    written into ``out`` when given."""
    if clips.dtype == np.int16:
        q, step = native.quant_i8(clips, out=out)
        return q, (step / np.float32(32768.0)).astype(np.float32)
    a = np.abs(clips).max(axis=(1, 2)).astype(np.float32)
    s = np.maximum(a, np.float32(1e-12)) / 127.0
    q = np.clip(np.round(clips.astype(np.float32) / s[:, None, None]), -127, 127)
    if out is None:
        return q.astype(np.int8), s.astype(np.float32)
    out[...] = q
    return out, s.astype(np.float32)


def quantize_clips_int8_device(clips: torch.Tensor):
    """:func:`quantize_clips_int8` for clips already on the device (a
    ``DeviceCachedLoader`` batch): the same per-clip absmax arithmetic in
    float32, computed where ``clips`` lies, with no copy through the host.
    ``clips`` (B, 1, S) int16 or float32 -> ``(q int8, scale float32 (B,))``
    on ``clips``' device. (The divisor 127 is a tensor: the card divides by
    a host scalar as a product with its reciprocal, one rounding away from
    the quotient the CPU and the JAX package take.)"""
    if clips.dtype == torch.int16:
        a = clips.to(torch.int32).abs().amax(dim=(1, 2)).float()
        s = torch.clamp_min(a, 1.0) / torch.full_like(a, 127.0)
        scale = s * (1.0 / 32768.0)
    else:
        a = clips.abs().amax(dim=(1, 2)).float()
        s = torch.clamp_min(a, 1e-12) / torch.full_like(a, 127.0)
        scale = s
    q = torch.clamp(torch.round(clips.float() / s[:, None, None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def _need_int8_framer(framed) -> None:
    if not isinstance(framed, tuple):
        raise ValueError("transfer='int8' with frame_fn requires a quantizing framer "
                         "(SpectralFrontend.frame_host_int8: set tpu_config."
                         "frontend_precision: int8)")


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
            with span("ayt.stream.wait_input"):
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
    """One device->host copy of a packed (B, K, 6) tensor or a detection dict,
    after a wait for the device's stream that launches nothing (so its span
    owns no device work; the copy then finds the results ready)."""
    first = next(iter(out.values())) if isinstance(out, dict) else out
    with span("ayt.stream.wait_device"):
        if first.device.type == "cuda":
            torch.cuda.current_stream(first.device).synchronize()
    if isinstance(out, dict):
        return {k: v.cpu().numpy() for k, v in out.items()}
    return unpack_detections(out.cpu().numpy())


_TORCH_DTYPES = {np.dtype(np.int16): torch.int16, np.dtype(np.float32): torch.float32,
                 np.dtype(np.int8): torch.int8}


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``: on the card through a fresh pinned copy,
    sent ``non_blocking``."""
    t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    if device.type != "cuda":
        return t
    with span("ayt.stream.pin"):
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _pinned_fill(fill: Callable, device: torch.device):
    """``fill(alloc)`` on ``device``: on the card its big array is written
    straight into a fresh pinned host tensor (``alloc(shape, dtype)``) and
    sent ``non_blocking``, with any small arrays it returns beside it. A
    tuple result (``(q, scale)``) stays a tuple."""
    if device.type != "cuda":
        out = fill(None)
        return (tuple(torch.from_numpy(a) for a in out) if isinstance(out, tuple)
                else torch.from_numpy(out))
    pinned: List[torch.Tensor] = []

    def alloc(shape, dtype):
        pinned.append(torch.empty(shape, dtype=_TORCH_DTYPES[np.dtype(dtype)], pin_memory=True))
        return pinned[-1].numpy()

    with span("ayt.stream.pin"):
        out = fill(alloc)
    big = pinned[0].to(device, non_blocking=True)
    if isinstance(out, tuple):
        return (big,) + tuple(_to_device(a, device) for a in out[1:])
    return big


def _frames_to_device(frame_fn: Callable, clips: np.ndarray, device: torch.device,
                      transfer: str = "int16"):
    """``frame_fn(clips)`` on ``device`` (``_pinned_fill``); with ``transfer=
    "int8"`` the framer must be the quantizing one."""
    out = _pinned_fill(lambda alloc: frame_fn(clips) if alloc is None
                       else frame_fn(clips, alloc=alloc), device)
    if transfer == "int8":
        _need_int8_framer(out)
    return out


def _int8_to_device(clips: np.ndarray, device: torch.device):
    """(B, 1, S) clips -> ``(q, scale)`` on ``device`` (``quantize_clips_int8``
    into pinned memory on the card)."""
    return _pinned_fill(lambda alloc: quantize_clips_int8(
        clips, out=None if alloc is None else alloc(clips.shape, np.int8)), device)


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
    ``transfer``: ``"int16"`` (exact for PCM16 sources) or ``"int8"``
    (:func:`quantize_clips_int8`; ``infer_fn`` built with
    ``make_inference_fn(int8_input=True)``), which needs a file at
    ``input_sample_rate``. With a ``frame_fn``, ``"int8"`` needs the
    quantizing framer (``frame_host_int8``), whose ``(q, scale)`` frames go
    to the model's own framed-int8 entry.
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
    if transfer == "int8" and resampler is not None:
        raise ValueError("transfer='int8' requires native-rate files (no resampling on the "
                         f"device; file rate {og_rate} vs model rate {input_sample_rate})")

    def read_chunk_mono(start_frame: int):
        """(samples_1d, dtype): int16 for mono PCM16 files, float32 otherwise."""
        nf = min(chunk_frames, end_frame - start_frame)
        with span("ayt.stream.read"):
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
            with span("ayt.stream.stack"):
                pad = nclips * sample_size - n
                if pad:
                    samples = np.pad(samples, (0, pad))
                clips = samples.reshape(nclips, 1, sample_size)
                if nclips < batch_size:  # one static batch shape
                    clips = np.concatenate(
                        [clips, np.zeros((batch_size - nclips, 1, sample_size), dtype)], axis=0)
            start_frame += chunk_frames
            if frame_fn is not None and resampler is None:
                yield nclips, _frames_to_device(frame_fn, clips[:, 0, :], device, transfer)
                continue
            if transfer == "int8":
                yield nclips, _int8_to_device(clips, device)
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
        dets = _fetch(out)
        with span("ayt.stream.drain"):
            per_clip = postprocess_detections(dets, sample_duration, return_start_end=True)
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


def _read_window(path: str, start: int, n: int, sample_size: int) -> np.ndarray:
    """One fixed-size mono window of ``n`` frames from ``start``; int16 for
    PCM16 mono, float32 otherwise; the tail zero-padded."""
    with span("ayt.stream.read"):
        raw = read_wav_pcm16_mono(path, frame_offset=start, num_frames=n)
        if raw is None:
            audio, _ = read_wav(path, frame_offset=start, num_frames=n)
            if audio.shape[0] != 1:
                audio = audio.mean(axis=0, keepdims=True)
            raw = audio[0].astype(np.float32)
        if raw.shape[-1] < sample_size:
            raw = np.pad(raw, (0, sample_size - raw.shape[-1]))
    return raw


def _host_batch(shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """An int16 host tensor, uninitialised, for a batch bound for ``device``:
    on the card a pinned block of the caching host allocator."""
    if device.type != "cuda":
        return torch.empty(shape, dtype=torch.int16)
    with span("ayt.stream.pin"):
        return torch.empty(shape, dtype=torch.int16, pin_memory=True)


def _read_batch_direct(spans: List[Tuple[str, int, int]], batch_size: int, sample_size: int,
                       device: torch.device) -> torch.Tensor:
    """``spans`` ``(path, frame_offset, num_frames)`` of mono PCM16 files
    read by the native loader straight into one (batch_size, 1, sample_size)
    int16 host tensor (``_host_batch``), then sent ``non_blocking``: the
    bytes of ``np.stack`` of ``_read_window``'s windows padded with zero
    rows. The loader zero-fills each span past its frames, so a row past the
    last window is a span of no frames: a reused pinned block holds an
    earlier batch, and the rows are zeroed on the loader's threads with the
    interpreter lock released."""
    buf = _host_batch((batch_size, 1, sample_size), device)
    with span("ayt.stream.stack"):
        files, offsets, counts = zip(*spans, *[(spans[0][0], 0, 0)] * (batch_size - len(spans)))
    with span("ayt.stream.read"), span("ayt.stream.read_direct"):
        native.load_batch_i16(files, offsets, counts, sample_size,
                              out=buf.numpy().reshape(batch_size, sample_size))
    return buf.to(device, non_blocking=True)


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
    are those of :func:`evaluate_audio`, and so is ``transfer``. Returns the
    number of files.
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

    # the int16 waveform path reads a batch of mono PCM16 files straight
    # into its host tensor; any other batch is read window by window
    direct = ([is_pcm16_mono(p) for p in paths] if frame_fn is None and transfer == "int16"
              else [False] * len(paths))

    def windows():
        for fi, (_, total, _) in enumerate(infos):
            for clip, start in enumerate(range(0, total, sample_size)):
                yield fi, clip, start, min(sample_size, total - start)

    def to_device(spans: List[Tuple[int, int, int]]):
        if all(direct[fi] for fi, _, _ in spans):
            return _read_batch_direct([(paths[fi], start, n) for fi, start, n in spans],
                                      batch_size, sample_size, device)
        wins = [_read_window(paths[fi], start, n, sample_size) for fi, start, n in spans]
        with span("ayt.stream.stack"):
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
            return _frames_to_device(frame_fn, arr, device, transfer)
        if transfer == "int8":
            return _int8_to_device(arr[:, None, :], device)
        return _to_device(arr[:, None, :], device)

    def batches():
        metas, spans = [], []
        for fi, clip, start, n in windows():
            metas.append((fi, clip))
            spans.append((fi, start, n))
            if len(spans) == batch_size:
                yield metas, to_device(spans)
                metas, spans = [], []
        if spans:
            yield metas, to_device(spans)

    def drain(metas, out):
        dets = _fetch(out)
        with span("ayt.stream.drain"):
            per_clip = postprocess_detections(dets, sample_duration, return_start_end=True)
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

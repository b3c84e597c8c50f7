"""Minimal RIFF/WAVE reader-writer for the port (a copy of
``audioyolo_tpu/data/wavio.py``).

A numpy parser for PCM 8/16/24/32-bit and IEEE float32/64 WAV files with
seekable partial reads: only the requested frame span is read from disk,
which the long-form streaming evaluator relies on.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np

_PCM_DTYPES = {8: np.uint8, 16: np.int16, 32: np.int32}
_FLOAT_DTYPES = {32: np.float32, 64: np.float64}

WAVE_FORMAT_PCM = 1
WAVE_FORMAT_IEEE_FLOAT = 3
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _parse_header(f) -> Tuple[int, int, int, int, int, int]:
    """Returns (audio_format, channels, sample_rate, bits, data_offset, data_size)."""
    riff = f.read(12)
    if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            raise ValueError("no data chunk found")
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            payload = f.read(size + (size & 1))
            audio_format, channels, rate = struct.unpack("<HHI", payload[:8])
            bits = struct.unpack("<H", payload[14:16])[0]
            if audio_format == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                audio_format = struct.unpack("<H", payload[24:26])[0]
            fmt = (audio_format, channels, rate, bits)
        elif cid == b"data":
            if fmt is None:
                raise ValueError("data chunk before fmt chunk")
            return (*fmt, f.tell(), size)
        else:
            f.seek(size + (size & 1), os.SEEK_CUR)


def read_wav_info(path: str) -> Tuple[int, int, int]:
    """(sample_rate, num_frames, channels) without reading audio data."""
    with open(path, "rb") as f:
        audio_format, channels, rate, bits, _, data_size = _parse_header(f)
        frame_bytes = channels * (bits // 8)
        return rate, data_size // frame_bytes, channels


def is_pcm16_mono(path: str) -> bool:
    """True for a mono PCM16 file whose data chunk holds every byte its
    header states: one whose spans the native int16 loader
    (``data/native.py::load_batch_i16``) reads as :func:`read_wav_pcm16_mono`
    reads them. A shorter data chunk gives False (that loader would fail
    where this reader zero-pads)."""
    with open(path, "rb") as f:
        audio_format, channels, _, bits, data_off, data_size = _parse_header(f)
        return (audio_format == WAVE_FORMAT_PCM and bits == 16 and channels == 1
                and os.fstat(f.fileno()).st_size >= data_off + data_size)


def read_wav_pcm16_mono(
    path: str, frame_offset: int = 0, num_frames: Optional[int] = None
) -> Optional[np.ndarray]:
    """Raw int16 span read for mono PCM16 files; None if the file is any other
    format. Zero decode work on host — pairs with the frontend's in-graph
    ``x / 32768`` dequantization for 4x cheaper host->device transfers while
    staying bit-identical to the float path."""
    with open(path, "rb") as f:
        audio_format, channels, rate, bits, data_off, data_size = _parse_header(f)
        if audio_format != WAVE_FORMAT_PCM or bits != 16 or channels != 1:
            return None
        total = data_size // 2
        start = min(max(frame_offset, 0), total)
        count = total - start if num_frames is None else max(num_frames, 0)
        count = min(count, total - start)
        f.seek(data_off + start * 2)
        raw = f.read(count * 2)
    return np.frombuffer(raw, dtype="<i2", count=len(raw) // 2)


def read_wav(
    path: str,
    frame_offset: int = 0,
    num_frames: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """Read (a span of) a WAV file.

    Returns ``(audio, sample_rate)`` with ``audio`` float32 of shape
    ``(channels, frames)`` scaled to [-1, 1] (integer PCM) or passed through
    (float formats) — the same convention as torchaudio's soundfile backend.
    """
    with open(path, "rb") as f:
        audio_format, channels, rate, bits, data_off, data_size = _parse_header(f)
        frame_bytes = channels * (bits // 8)
        total_frames = data_size // frame_bytes
        start = min(max(frame_offset, 0), total_frames)
        count = total_frames - start if num_frames is None else max(num_frames, 0)
        count = min(count, total_frames - start)

        f.seek(data_off + start * frame_bytes)
        raw = f.read(count * frame_bytes)

    n = len(raw) // frame_bytes
    if audio_format == WAVE_FORMAT_IEEE_FLOAT:
        dt = _FLOAT_DTYPES.get(bits)
        if dt is None:
            raise ValueError(f"unsupported float WAV bit depth: {bits}")
        x = np.frombuffer(raw, dtype="<" + np.dtype(dt).str[1:], count=n * channels)
        audio = x.astype(np.float32)
    elif audio_format == WAVE_FORMAT_PCM:
        if bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8, count=n * channels * 3).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = (x << 8) >> 8  # sign-extend
            audio = x.astype(np.float32) / 2147483648.0 * 256.0
        else:
            dt = _PCM_DTYPES.get(bits)
            if dt is None:
                raise ValueError(f"unsupported PCM bit depth: {bits}")
            x = np.frombuffer(raw, dtype="<" + np.dtype(dt).str[1:], count=n * channels)
            if bits == 8:
                audio = (x.astype(np.float32) - 128.0) / 128.0
            else:
                audio = x.astype(np.float32) / float(2 ** (bits - 1))
    else:
        raise ValueError(f"unsupported WAV format tag: {audio_format}")

    return audio.reshape(n, channels).T.copy(), rate


def write_wav(path: str, audio: np.ndarray, sample_rate: int, bits: int = 16) -> None:
    """Write float32 audio (channels, frames) or (frames,) as PCM WAV."""
    if audio.ndim == 1:
        audio = audio[None, :]
    channels, frames = audio.shape
    if bits != 16:
        raise ValueError("only 16-bit PCM writing is supported")
    x = np.clip(np.round(audio * 32768.0), -32768, 32767)
    pcm = x.astype("<i2").T.reshape(-1)  # interleave
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, WAVE_FORMAT_PCM, channels, sample_rate,
                            sample_rate * channels * 2, channels * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)

"""ctypes bindings of the port's native audio library (port of
``audioyolo_tpu/data/native.py``).

The library is ``csrc/audio_io.cpp``, built at first use by ``ops/build.py``
with the host C++ compiler. There is no fallback: a failed build raises, and
so does a failed decode (the C code's error code in the message). Every
function is bit-identical to the numpy path it replaces (``data/wavio.py``,
``FusedFrameDFT.frame_host``) for mono and 2-channel PCM16:

- :func:`wav_info`, :func:`read_mono`: one file's header, one span decoded
  to mono float32, zero-padded;
- :func:`load_batch`, :func:`load_batch_i16`: N spans decoded on C++
  threads into one contiguous (N, out_len) float32 or int16 buffer (int16 is
  ``round(x * 32768)`` clipped, the loader's quantization; mono PCM16 is
  read as it is), int16 optionally into a caller's buffer (a pinned tensor);
- :func:`frame_i16`: an in-memory int16 batch into the fused frontend's
  phase-grouped frames, optionally into a caller's buffer (a pinned tensor);
- :func:`load_batch_framed_i16`: N spans decoded straight into those frames;
- :func:`quant_i8`: per-clip symmetric int8 quantization of int16 clips.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from ..ops import build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i16p, _i64p = ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int64)
_paths = ctypes.POINTER(ctypes.c_char_p)
_SIGNATURES = {
    "ayt_wav_info": (ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), _i64p,
                                    ctypes.POINTER(ctypes.c_int32)]),
    "ayt_read_mono": (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_float), ctypes.c_int64]),
    "ayt_load_batch": (ctypes.c_int, [_paths, ctypes.c_int32, _i64p, _i64p,
                                      ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                      ctypes.c_int32]),
    "ayt_load_batch_i16": (ctypes.c_int, [_paths, ctypes.c_int32, _i64p, _i64p, _i16p,
                                          ctypes.c_int64, ctypes.c_int32]),
    "ayt_frame_i16": (ctypes.c_int, [_i16p, ctypes.c_int32, ctypes.c_int64, _i16p,
                                     ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, _i64p, ctypes.c_int64, ctypes.c_int32]),
    "ayt_quant_i8": (ctypes.c_int, [_i16p, ctypes.c_int32, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_int8),
                                    ctypes.POINTER(ctypes.c_float), ctypes.c_int32]),
    "ayt_load_batch_framed_i16": (ctypes.c_int, [_paths, ctypes.c_int32, _i64p, _i64p, _i16p,
                                                 ctypes.c_int64, ctypes.c_int32,
                                                 ctypes.c_int64, ctypes.c_int64,
                                                 ctypes.c_int64, _i64p, ctypes.c_int64,
                                                 ctypes.c_int32]),
}


def library() -> ctypes.CDLL:
    """The built and loaded ``csrc/audio_io.cpp``, every signature set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = build.load("audio_io")
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _spans(paths: Sequence[str], frame_offsets: Sequence[int], num_frames: Sequence[int]):
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    return n, c_paths, np.asarray(frame_offsets, np.int64), np.asarray(num_frames, np.int64)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise IOError(f"native {what} failed (code {rc})")


def wav_info(path: str) -> Tuple[int, int, int]:
    """(sample_rate, num_frames, channels)."""
    rate, frames, channels = ctypes.c_int32(), ctypes.c_int64(), ctypes.c_int32()
    rc = library().ayt_wav_info(path.encode(), ctypes.byref(rate), ctypes.byref(frames),
                                ctypes.byref(channels))
    if rc != 0:
        raise IOError(f"native wav_info failed for {path} (code {rc})")
    return rate.value, frames.value, channels.value


def read_mono(path: str, frame_offset: int, num_frames: int, out_len: int) -> np.ndarray:
    """One span, mono-downmixed float32, zero-padded to ``out_len``."""
    out = np.zeros(out_len, np.float32)
    rc = library().ayt_read_mono(path.encode(), frame_offset, num_frames,
                                 _ptr(out, ctypes.c_float), out_len)
    if rc < 0:
        raise IOError(f"native read failed for {path} (code {rc})")
    return out


def load_batch(paths: Sequence[str], frame_offsets: Sequence[int], num_frames: Sequence[int],
               out_len: int, n_threads: int = 4) -> np.ndarray:
    """N spans decoded in parallel into a contiguous (N, out_len) float32 buffer."""
    n, c_paths, offs, cnts = _spans(paths, frame_offsets, num_frames)
    out = np.empty((n, out_len), np.float32)
    _check(library().ayt_load_batch(c_paths, n, _ptr(offs, ctypes.c_int64),
                                    _ptr(cnts, ctypes.c_int64), _ptr(out, ctypes.c_float),
                                    out_len, n_threads), "batch load")
    return out


def load_batch_i16(paths: Sequence[str], frame_offsets: Sequence[int],
                   num_frames: Sequence[int], out_len: int, n_threads: int = 4,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
    """N spans decoded to raw int16 waveforms (N, out_len), written into
    ``out`` when given (a pinned tensor's array)."""
    n, c_paths, offs, cnts = _spans(paths, frame_offsets, num_frames)
    if out is None:
        out = np.empty((n, out_len), np.int16)
    elif (out.shape != (n, out_len) or out.dtype != np.int16 or not out.flags.c_contiguous
          or not out.flags.writeable):
        raise ValueError(f"out must be a writeable C-contiguous int16 array of shape "
                         f"{(n, out_len)}, got {out.dtype} {out.shape}")
    _check(library().ayt_load_batch_i16(c_paths, n, _ptr(offs, ctypes.c_int64),
                                        _ptr(cnts, ctypes.c_int64), _ptr(out, ctypes.c_int16),
                                        out_len, n_threads), "int16 batch load")
    return out


def _framer_args(framer):
    """The framing geometry as the C functions take it (the pointer keeps
    its array alive)."""
    offs = np.asarray(framer.offsets, np.int64)
    return (framer.n_ph, framer.n_groups, framer.frame_len, framer.span,
            _ptr(offs, ctypes.c_int64), framer.width)


def frame_i16(clips: np.ndarray, framer, n_threads: int = 2,
              out: Optional[np.ndarray] = None) -> np.ndarray:
    """An int16 batch (B, clip_len) -> (B, n_ph, n_groups, frame_len) frames
    of ``framer`` (a ``FusedFrameDFT``), written into ``out`` when given."""
    if clips.ndim != 2 or clips.dtype != np.int16:
        raise ValueError(f"frame_i16 takes a 2-D int16 batch, got {clips.dtype} {clips.shape}")
    clips = np.ascontiguousarray(clips)
    n, clip_len = clips.shape
    shape = (n, framer.n_ph, framer.n_groups, framer.frame_len)
    if out is None:
        out = np.empty(shape, np.int16)
    elif out.shape != shape or out.dtype != np.int16 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous int16 array of shape {shape}, "
                         f"got {out.dtype} {out.shape}")
    _check(library().ayt_frame_i16(_ptr(clips, ctypes.c_int16), n, clip_len,
                                   _ptr(out, ctypes.c_int16), *_framer_args(framer),
                                   n_threads), "framing")
    return out


def quant_i8(clips: np.ndarray, n_threads: int = 2,
             out: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Per-clip symmetric int8 quantization of an int16 batch (B, ...), each
    clip flattened: ``(q int8 of the same shape, step float32 (B,))``, the
    step in int16 units (``max(absmax, 1) / 127``), codes rounded half to
    even and clipped to [-127, 127]; ``q`` written into ``out`` when given."""
    if clips.dtype != np.int16:
        raise ValueError(f"quant_i8 takes int16 clips, got {clips.dtype}")
    clips = np.ascontiguousarray(clips)
    n = clips.shape[0]
    if out is None:
        q = np.empty(clips.shape, np.int8)
    elif out.shape != clips.shape or out.dtype != np.int8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous int8 array of shape {clips.shape}, "
                         f"got {out.dtype} {out.shape}")
    else:
        q = out
    step = np.empty(n, np.float32)
    _check(library().ayt_quant_i8(_ptr(clips, ctypes.c_int16), n, int(clips.size // max(n, 1)),
                                  _ptr(q, ctypes.c_int8), _ptr(step, ctypes.c_float),
                                  n_threads), "int8 quantization")
    return q, step


def load_batch_framed_i16(paths: Sequence[str], frame_offsets: Sequence[int],
                          num_frames: Sequence[int], clip_len: int, framer,
                          n_threads: int = 4) -> np.ndarray:
    """N spans decoded straight into ``framer``'s int16 frames
    (N, n_ph, n_groups, frame_len): each span zero-padded to ``clip_len``,
    then framed as ``frame_host`` frames it."""
    n, c_paths, offs, cnts = _spans(paths, frame_offsets, num_frames)
    cnts = np.minimum(cnts, clip_len)
    out = np.empty((n, framer.n_ph, framer.n_groups, framer.frame_len), np.int16)
    _check(library().ayt_load_batch_framed_i16(
        c_paths, n, _ptr(offs, ctypes.c_int64), _ptr(cnts, ctypes.c_int64),
        _ptr(out, ctypes.c_int16), clip_len, *_framer_args(framer), n_threads),
        "framed batch load")
    return out

"""Reader for the JAX trainer's ``.msgpack`` checkpoints, with no ``msgpack``
or ``flax`` installed.

The JAX package saves ``{params, batch_stats, opt_state, step}`` through
``flax.serialization.msgpack_serialize`` (``audioyolo_tpu/train/trainer.py::
save_model``). This is a decoder for the subset of MessagePack that flax
writes: nil, bool, every int and float width, str, bin, array and map, and
flax's extension types:

- type 1, an ndarray: a nested MessagePack ``(shape, dtype name, C-order
  bytes)``;
- type 3, a numpy scalar: the same, read back as a 0-d scalar.

Type 2 (a complex number) raises, and so does flax's chunked-array form
(``__msgpack_chunked_array__``, written only for arrays over 2**30 bytes).
Arrays decode to lists and maps to dicts, as ``msgpack_restore`` returns them.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# (kind, bytes of the length field)
_SIZED = {0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4),
          0xd9: ("str", 1), 0xda: ("str", 2), 0xdb: ("str", 4),
          0xdc: ("array", 2), 0xdd: ("array", 4), 0xde: ("map", 2), 0xdf: ("map", 4),
          0xc7: ("ext", 1), 0xc8: ("ext", 2), 0xc9: ("ext", 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


def _take(buf: memoryview, pos: int, n: int) -> Tuple[memoryview, int]:
    if pos + n > len(buf):
        raise ValueError(f"truncated MessagePack data: {n} bytes wanted at offset {pos}")
    return buf[pos:pos + n], pos + n


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, raw = unpackb(data)
    try:
        dtype = np.dtype(dtype_name)
    except TypeError as e:
        raise ValueError(f"unsupported ndarray dtype '{dtype_name}' in the checkpoint") from e
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def _ext(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == EXT_COMPLEX:
        raise ValueError("complex numbers (flax extension type 2) are not supported")
    raise ValueError(f"unknown MessagePack extension type {code}")


def _decode(buf: memoryview, pos: int) -> Tuple[Any, int]:
    head, pos = _take(buf, pos, 1)
    b = head[0]
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:
        return _container("map", b & 0x0f, buf, pos)
    if 0x90 <= b <= 0x9f:
        return _container("array", b & 0x0f, buf, pos)
    if 0xa0 <= b <= 0xbf:
        raw, pos = _take(buf, pos, b & 0x1f)
        return str(raw, "utf-8"), pos
    if b == 0xc0:
        return None, pos
    if b in (0xc2, 0xc3):
        return b == 0xc3, pos
    if b in _FIXED:
        fmt = _FIXED[b]
        raw, pos = _take(buf, pos, struct.calcsize(fmt))
        return struct.unpack(fmt, raw)[0], pos
    if b in _FIXEXT:
        code, pos = _take(buf, pos, 1)
        raw, pos = _take(buf, pos, _FIXEXT[b])
        return _ext(struct.unpack(">b", code)[0], bytes(raw)), pos
    if b in _SIZED:
        kind, width = _SIZED[b]
        raw, pos = _take(buf, pos, width)
        n = struct.unpack(_LEN[width], raw)[0]
        if kind in ("array", "map"):
            return _container(kind, n, buf, pos)
        if kind == "ext":
            code, pos = _take(buf, pos, 1)
            raw, pos = _take(buf, pos, n)
            return _ext(struct.unpack(">b", code)[0], bytes(raw)), pos
        raw, pos = _take(buf, pos, n)
        return (str(raw, "utf-8") if kind == "str" else bytes(raw)), pos
    raise ValueError(f"unsupported MessagePack type byte 0x{b:02x} at offset {pos - 1}")


def _container(kind: str, n: int, buf: memoryview, pos: int) -> Tuple[Any, int]:
    if kind == "array":
        out = []
        for _ in range(n):
            item, pos = _decode(buf, pos)
            out.append(item)
        return out, pos
    d: Dict[Any, Any] = {}
    for _ in range(n):
        k, pos = _decode(buf, pos)
        d[k], pos = _decode(buf, pos)
    if "__msgpack_chunked_array__" in d:
        raise ValueError("chunked arrays (flax's form for arrays over 2**30 bytes) are not "
                         "supported")
    return d, pos


def unpackb(data: bytes) -> Any:
    """Decode one MessagePack object that fills ``data``."""
    obj, pos = _decode(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes after the MessagePack object")
    return obj


def load(path: str) -> Any:
    """The decoded contents of a ``.msgpack`` file."""
    with open(path, "rb") as f:
        return unpackb(f.read())

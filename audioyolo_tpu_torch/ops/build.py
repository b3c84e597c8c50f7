"""Builds the hand-written CUDA kernels under ``csrc/`` and loads them.

Each ``csrc/<name>.cu`` exports plain C functions. It is compiled at first use
with ``nvcc`` into ``build/lib<name>-<hash>.so`` (the hash covers the source
and the flags, so an edited source is rebuilt) and loaded with ``ctypes``.
Pointers and the stream cross as ``c_void_p``; every launch function returns
``cudaGetLastError()``. Nothing here runs at import: the CPU tests import
every module, and only a wrapper given a CUDA tensor asks for a library.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so that no multiply
and add are contracted into one rounding; the NMS kernel's keep flags must
be bit-identical to the plain PyTorch version. No ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(cand):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return cand


def sources() -> list:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _target(name: str):
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, os.path.join(BUILD, f"lib{name}-{digest}.so")


def _start(name: str):
    """Start nvcc for one source unless its library is already built."""
    src, so = _target(name)
    if os.path.isfile(so):
        return so, None
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return so, (proc, tmp)


def _finish(name: str, so: str, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, so)
    return log


def build() -> Dict[str, str]:
    """Compile every kernel source, one ``nvcc`` each, all started together.
    Returns ``{name: nvcc output}`` ("" if cached)."""
    names = sources()
    with _lock:
        jobs = {n: _start(n) for n in names}
        return {n: _finish(n, *jobs[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so, job = _start(name)
            _finish(name, so, job)
            lib = ctypes.CDLL(so)
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: Sequence) -> Callable[..., int]:
    """The C launch function ``symbol`` of ``csrc/<name>.cu``, its argument
    types set; it returns ``cudaGetLastError()`` as an ``int``."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
    return fn


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {err}")

"""Builds the hand-written sources under ``csrc/`` and loads them.

Each ``csrc/<name>.cu`` (a CUDA kernel) or ``csrc/<name>.cpp`` (host code:
the native audio library) exports plain C functions. It is compiled at first
use into ``build/lib<name>-<hash>.so`` (the hash covers the source and the
flags, so an edited source is rebuilt) and loaded with ``ctypes``. A failed
build raises. Pointers and the stream cross as ``c_void_p``; every launch
function returns ``cudaGetLastError()``. Nothing here runs at import: the
CPU tests import every module, and a library is built only when something
asks for it.

``.cu`` flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so that no
multiply and add are contracted into one rounding; the NMS kernel's keep
flags must be bit-identical to the plain PyTorch version. No
``--use_fast_math``. ``.cpp`` files take the host compiler (``$CXX``, else
``c++``) with ``-O3 -fPIC -std=c++17 -march=native -shared -pthread``;
``-march=native`` ties the library to the CPU it was built on, so that CPU's
model and features enter its hash too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, List, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-march=native", "-shared", "-pthread")

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


def cxx_path() -> str:
    found = os.environ.get("CXX") or shutil.which("c++")
    if not found:
        raise RuntimeError("no host C++ compiler found (set CXX or put c++ on PATH)")
    return found


def sources() -> list:
    """The CUDA kernel sources (``nvcc``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def host_sources() -> list:
    """The host C++ sources (the host compiler)."""
    return sorted(f[:-4] for f in os.listdir(CSRC) if f.endswith(".cpp"))


def _host_cpu() -> bytes:
    """The CPU's model name and feature flags, what ``-march=native`` reads."""
    with open("/proc/cpuinfo", "rb") as f:
        lines = f.read().split(b"\n\n")[0].splitlines()
    return b"\n".join(line for line in lines if line.startswith((b"model name", b"flags")))


def _source(name: str):
    """(path, is host code) of ``csrc/<name>.cu`` or ``csrc/<name>.cpp``."""
    cpp = os.path.join(CSRC, name + ".cpp")
    return (cpp, True) if os.path.isfile(cpp) else (os.path.join(CSRC, name + ".cu"), False)


def _target(name: str):
    src, host = _source(name)
    flags = CXX_FLAGS if host else NVCC_FLAGS
    with open(src, "rb") as f:
        key = f.read() + " ".join(flags).encode() + (_host_cpu() if host else b"")
    digest = hashlib.sha1(key).hexdigest()[:12]
    return src, os.path.join(BUILD, f"lib{name}-{digest}.so")


def command(name: str, out: Optional[str] = None) -> List[str]:
    """The compiler command line that builds ``csrc/<name>`` into ``out``
    (default: its library under ``build/``)."""
    src, host = _source(name)
    out = out or _target(name)[1]
    if host:
        return [cxx_path(), *CXX_FLAGS, "-o", out, src]
    return [nvcc_path(), *NVCC_FLAGS, "-o", out, src]


def _start(name: str):
    """Start the compiler for one source unless its library is already built."""
    src, so = _target(name)
    if os.path.isfile(so):
        return so, None
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.Popen(command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, (proc, tmp)


def _finish(name: str, so: str, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building csrc/{os.path.basename(_source(name)[0])} failed "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, so)
    return log


def build() -> Dict[str, str]:
    """Compile every source, one compiler each, all started together.
    Returns ``{name: compiler output}`` ("" if cached)."""
    names = sources() + host_sources()
    with _lock:
        jobs = {n: _start(n) for n in names}
        return {n: _finish(n, *jobs[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>``, built first if needed."""
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

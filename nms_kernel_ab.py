#!/usr/bin/env python3
"""Time kernels 2 and 3 (greedy interval NMS) against an earlier source of
them, in turns, on one CUDA card, at both portable cluster sizes.

    python3 nms_kernel_ab.py OLD.cu
    python3 nms_kernel_ab.py --probe

``OLD.cu`` exports the same C entry, ``ayt_greedy_suppress(x1, x2, keep, B,
K, thr, block, stream)``, with ``block`` 16 for kernel 2 and 1 for kernel 3:
the one-CTA-per-clip kernel that ``csrc/interval_nms.cu`` held before its
cluster redesign. The current source is built twice, with
``-DAYT_NMS_CLUSTER=4`` and ``=8``. All are built with the port's ``nvcc``
flags and held bit for bit to the plain version. Then, for each kernel, on
random intervals at (32, 630) and (1, 630) and on the 630-long chain at
(32, 630), threshold 0.1, each build's device time per launch (a
``torch.profiler`` trace of 50 launches) is taken in the order old, c4, c8,
c8, c4, old, ``ROUNDS`` times. The card's name and power limit and one JSON
line of the times follow.

``--probe`` builds variants of the current source and times them in turns
with it, at B=32 and B=1, to see what takes the time: ``clocks`` reads
``clock64()`` on rank 0's SM at each phase boundary (the cycles are
printed); ``divide_all`` decides every IoU by the IEEE divide, as the first
form of this design did; ``maxnan_select`` computes the NaN-passing max and
min by compare and select instead of PTX's ``max.NaN``/``min.NaN``;
``one_per_sm`` asks for 120 KB more shared memory, so that no two CTAs share
an SM. Their keep flags are not checked; only the times count.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 2
ORDER = ("old", "c4", "c8", "c8", "c4", "old")
# --probe variants of csrc/interval_nms.cu: ([(text, replacement), ...], extra nvcc flags)
_MAX_MIN_PTX = """  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}"""
_MAX_MIN_SELECT = """  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}"""
# clock64() on rank 0's SM at: start, columns loaded, mask phase done, first
# cluster barrier passed, first pass staged, passes resolved, removed words
# stored, keep written; clip 0 stores the eight stamps over the first 64
# bytes of its keep flags
_CLOCKS = [
    ("  const size_t base = (size_t)(blockIdx.x / CLUSTER) * K;",
     "  long long T[8] = {};\n  T[0] = clock64();\n  const size_t base = (size_t)(blockIdx.x / CLUSTER) * K;"),
    ("  __syncthreads();\n\n  // Mask phase", "  __syncthreads();\n  T[1] = clock64();\n\n  // Mask phase"),
    ("  // release this CTA's words to the cluster; every CTA has started\n  cluster.sync();",
     "  T[2] = clock64();\n  cluster.sync();\n  T[3] = clock64();"),
    ("    stage_pass(0, 0, THREADS);\n    __syncthreads();",
     "    stage_pass(0, 0, THREADS);\n    __syncthreads();\n    T[4] = clock64();"),
    ("    if (tid < 32) {\n#pragma unroll\n      for (int s = 0; s < RW; ++s)\n        if (tid + 32 * s < W)",
     "    T[5] = clock64();\n    if (tid < 32) {\n#pragma unroll\n      for (int s = 0; s < RW; ++s)\n        if (tid + 32 * s < W)"),
    ("    __syncthreads();\n  }\n  // no CTA exits", "    __syncthreads();\n  }\n  T[6] = clock64();\n  // no CTA exits"),
    ("      keep[base + i] = (uint8_t)!((s_removed[i >> 5] >> (i & 31)) & 1u);\n  }\n}",
     "      keep[base + i] = (uint8_t)!((s_removed[i >> 5] >> (i & 31)) & 1u);\n  }\n"
     "  __syncthreads();\n  T[7] = clock64();\n"
     "  if (blockIdx.x == 0 && tid == 0)\n"
     "    for (int k = 0; k < 8; ++k) reinterpret_cast<long long*>(keep)[k] = T[k];\n}"),
]
_ONE_PER_SM = ("  const size_t smem = (size_t)32 * W * sizeof(float4) +",
               "  const size_t smem = (size_t)120 * 1024 + 32 * W * sizeof(float4) +")
PROBES = {
    "clocks": (_CLOCKS, ()),
    "divide_all": ([("unsure |= (unsigned)(!(below < 0.0f) && !(above > 0.0f)) << u;",
                     "unsure |= 1u << u;")], ()),
    "maxnan_select": ([(_MAX_MIN_PTX, _MAX_MIN_SELECT)], ()),
    "one_per_sm": ([_ONE_PER_SM], ()),
}


def build_lib(src: str, tag: str, flags=()) -> ctypes.CDLL:
    """Compile a kernel source with the port's nvcc flags (and ``flags``) and
    load it, its launch function's argument types set."""
    from audioyolo_tpu_torch.ops import build

    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(flags).encode()).hexdigest()[:12]
    so = os.path.join(build.BUILD, f"libnms_ab_{tag}-{digest}.so")
    os.makedirs(build.BUILD, exist_ok=True)
    out = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", so, src], check=True,
                         capture_output=True, text=True)
    regs = [line.split("info    :")[-1].strip() for line in (out.stdout + out.stderr).splitlines()
            if "registers" in line or "spill" in line]
    print(f"[build {tag}] ptxas: " + "; ".join(regs), flush=True)
    lib = ctypes.CDLL(so)
    lib.ayt_greedy_suppress.restype = ctypes.c_int
    lib.ayt_greedy_suppress.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                                        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib


def probe(card: str) -> dict:
    """Time the current source against its ``PROBES`` variants, in turns."""
    import numpy as np
    import torch

    from audioyolo_tpu_torch.ops import build
    from chip_smoke import BATCH, _nms_cases, device_ms

    with open(os.path.join(build.CSRC, "interval_nms.cu")) as f:
        text = f.read()
    libs = {"main": build_lib(os.path.join(build.CSRC, "interval_nms.cu"), "main")}
    for tag, (edits, flags) in PROBES.items():
        variant = text
        for old, new in edits:
            assert variant.count(old) == 1, f"probe {tag}: an anchor is not in the source once"
            variant = variant.replace(old, new)
        src = os.path.join(build.BUILD, f"probe_nms_{tag}.cu")
        with open(src, "w") as f:
            f.write(variant)
        libs[tag] = build_lib(src, tag, flags)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    x1, x2 = (torch.from_numpy(a).to(dev) for a in _nms_cases(BATCH, 630, seed=1)["random"])
    result = {}
    for block in (32, 1):
        for b in (BATCH, 1):
            a, c = x1[:b].contiguous(), x2[:b].contiguous()
            keep = torch.empty(a.shape, dtype=torch.bool, device=dev)

            def run(tag):
                def fn():
                    err = libs[tag].ayt_greedy_suppress(a.data_ptr(), c.data_ptr(), keep.data_ptr(),
                                                        b, 630, 0.1, block, stream)
                    build.check_launch(err, f"probe {tag}")
                return fn

            order = list(libs) + list(libs)[::-1]
            times = {tag: [] for tag in libs}
            for tag in order:
                times[tag].append(device_ms(run(tag), "greedy_suppress_kernel"))
            run("clocks")()
            stamps = keep.view(torch.uint8)[0, :64].cpu().numpy().view(np.int64)
            cycles = dict(zip(("load", "mask", "cluster barrier", "first pass staged",
                               "passes resolved", "words stored", "barrier and output"),
                              (int(v) for v in np.diff(stamps))))
            result[f"block{block}/B{b}"] = dict(times, clocks_cycles=cycles)
            print(f"[probe block={block} {b}x630] device ms per launch: " + ", ".join(
                f"{t} {v}" for t, v in times.items()) + f"; rank 0's cycles: {cycles} [{card}]",
                flush=True)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", nargs="?", help="earlier kernel 2/3 source with the same C entry "
                                           "(block 16 or 1)")
    ap.add_argument("--probe", action="store_true", help="time the phases through variants")
    args = ap.parse_args()
    if (args.old is None) == (not args.probe):
        ap.error("give either OLD.cu or --probe")
    import torch

    if not torch.cuda.is_available():
        print("nms_kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from audioyolo_tpu_torch.ops import build
    from audioyolo_tpu_torch.ops.nms_kernel import greedy_suppress_rows
    from chip_smoke import BATCH, _nms_cases, device_ms, phase_card

    card = phase_card()
    if args.probe:
        print(json.dumps(dict(card=card, **probe(card))))
        return 0
    src = os.path.join(build.CSRC, "interval_nms.cu")
    libs = {"old": build_lib(args.old, "old"),
            "c4": build_lib(src, "c4", ("-DAYT_NMS_CLUSTER=4",)),
            "c8": build_lib(src, "c8", ("-DAYT_NMS_CLUSTER=8",))}
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cases = _nms_cases(BATCH, 630, seed=1)
    x1, x2 = (torch.from_numpy(a).to(dev) for a in cases["random"])
    c1, c2 = (torch.from_numpy(a).to(dev) for a in cases["chain"])
    data = {"random": (x1, x2), "random_b1": (x1[:1].contiguous(), x2[:1].contiguous()),
            "chain": (c1, c2)}
    result = {"card": card}
    for kernel, blocks in (("greedy_suppress_blocked", {"old": 16, "c4": 32, "c8": 32}),
                           ("greedy_suppress_unblocked", {"old": 1, "c4": 1, "c8": 1})):
        for dname, (a, b) in data.items():
            keep = torch.empty(a.shape, dtype=torch.bool, device=dev)
            ref = greedy_suppress_rows(a, b, 0.1)

            def run(tag):
                def fn():
                    err = libs[tag].ayt_greedy_suppress(a.data_ptr(), b.data_ptr(), keep.data_ptr(),
                                                        a.shape[0], a.shape[1], 0.1, blocks[tag],
                                                        stream)
                    build.check_launch(err, f"{tag} {kernel}")
                return fn

            for tag in libs:
                keep.zero_()
                run(tag)()
                torch.cuda.synchronize()
                assert torch.equal(keep, ref), f"{tag} {kernel} differs from plain ({dname})"
            times = {tag: [] for tag in libs}
            for _ in range(ROUNDS):
                for tag in ORDER:
                    times[tag].append(device_ms(run(tag), "greedy_suppress_kernel"))
            result[f"{kernel}/{dname}"] = times
            print(f"[{kernel} {dname} {tuple(a.shape)}] device ms per launch: " + ", ".join(
                f"{t} {v}" for t, v in times.items()) + f" [{card}]", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

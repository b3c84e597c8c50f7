#!/usr/bin/env python3
"""Time kernel 1 (``fused_mel_power``) against an earlier source of it, in
turns, on one CUDA card; or probe what bounds its main pass.

    python3 mel_kernel_ab.py OLD.cu
    python3 mel_kernel_ab.py --probe

``OLD.cu`` exports the first form's interface, ``ayt_fused_mel_power(x,
x_is_int16, c, mel2, out, B, R, G, F, Fp, Np, stream)`` with ``c`` (R, Fp,
Np) and ``mel2`` (Np, 32) bf16, zero-padded to multiples of 64: the WMMA
kernel that ``csrc/fused_mel_power.cu`` held before its TMA + ``wgmma``
redesign. It is built with the port's ``nvcc`` flags. At the serving shapes
(B=32, int16 and float32 frames) both kernels are held to the plain version,
then timed with CUDA events in the order old, new, new, old (``ROUNDS``
times), beside the cuBLAS bf16 pair; the card's name and power limit and one
JSON line of the times follow.

``--probe`` builds two variants of the main pass from the current source and
times them in turns with it, at B=32 on staged int16 frames: ``loads`` keeps
the TMA ring and the barriers but issues no main-loop ``wgmma`` (the time of
feeding the tiles), ``math`` loads each stage once and then only arrives on
its barrier (the time of the products and the barriers on tiles already in
shared memory). Their outputs are meaningless; only their times count.
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
ROUNDS = 2  # each round times every variant twice, in mirrored order


# main-pass variants for --probe: (text in csrc/fused_mel_power.cu, replacement)
_MAIN_LOOP_MMA = """        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma_m64n256k16(d, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
"""
_PRODUCER_LOADS = """          mbar_expect_tx(full, A_BYTES + B_BYTES);
          tma_load_3d(a_s + stage * A_BYTES, &a_map, full, k * BK, m0, r);
          tma_load_3d(b_s + stage * B_BYTES, &b_map, full, k * BK, n * BN, r);
"""
PROBES = {
    "loads": (_MAIN_LOOP_MMA, ""),
    "math": (_PRODUCER_LOADS, "          if (n == 0 && k < STAGES) {\n" + _PRODUCER_LOADS
             + "          } else {\n            mbar_arrive(full);\n          }\n"),
}


def build_lib(src: str, tag: str) -> ctypes.CDLL:
    """Compile a kernel source with the port's nvcc flags and load it."""
    from audioyolo_tpu_torch.ops import build

    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    so = os.path.join(build.BUILD, f"libmel_ab_{tag}-{digest}.so")
    os.makedirs(build.BUILD, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, src], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(so)


def build_old(src: str) -> ctypes.CDLL:
    lib = build_lib(src, "old")
    lib.ayt_fused_mel_power.restype = ctypes.c_int
    lib.ayt_fused_mel_power.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                                        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return lib


def probe(card: str) -> dict:
    """Time the main pass against its ``loads`` and ``math`` variants."""
    import numpy as np
    import torch

    from audioyolo_tpu_torch.ops import build
    from audioyolo_tpu_torch.ops.frontend import SpectralFrontend
    from audioyolo_tpu_torch.ops.mel_kernel import stage_frames
    from chip_smoke import BATCH, _serving_config, time_ms

    with open(os.path.join(build.CSRC, "fused_mel_power.cu")) as f:
        text = f.read()
    libs = {"main": build.load("fused_mel_power")}
    for tag, (old, new) in PROBES.items():
        assert text.count(old) == 1, f"probe {tag}: its anchor is not in the source once"
        src = os.path.join(build.BUILD, f"probe_{tag}.cu")
        os.makedirs(build.BUILD, exist_ok=True)
        with open(src, "w") as f:
            f.write(text.replace(old, new))
        libs[tag] = build_lib(src, tag)
    for lib in libs.values():
        lib.ayt_mel_power_staged.restype = ctypes.c_int
        lib.ayt_mel_power_staged.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    dev = torch.device("cuda")
    cfg = _serving_config()
    fe = SpectralFrontend(cfg).to(dev)
    mk = fe.fused_kernel
    rng = np.random.default_rng(0)
    wav16 = np.clip(np.round(rng.standard_normal((BATCH, cfg.clip_samples)) * 3277), -32768,
                    32767).astype(np.int16)
    x = torch.from_numpy(fe.frame_host(wav16)).to(dev)
    b, r, g, _ = x.shape
    ct = mk.ct_i16
    xs = stage_frames(x, ct.shape[-1])
    out = torch.empty((b, r, g, 32), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib):
        def fn():
            err = lib.ayt_mel_power_staged(xs.data_ptr(), ct.data_ptr(), mk.mel2t.data_ptr(),
                                           out.data_ptr(), b, r, g, ct.shape[2], ct.shape[1], stream)
            assert err == 0, f"launch failed: {err}"
        return fn

    times = {k: [] for k in libs}
    for _ in range(ROUNDS):
        for tag in ("main", "loads", "math", "math", "loads", "main"):
            times[tag].append(time_ms(run(libs[tag])))
    print(f"[kernel 1 main pass probe B={BATCH} int16] " + ", ".join(
        f"{k} {v} ms" for k, v in times.items()) + f" [{card}]", flush=True)
    return {"probe_ms": times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", nargs="?", help="earlier kernel-1 source with the first form's interface")
    ap.add_argument("--probe", action="store_true", help="time the main pass's loads and math apart")
    args = ap.parse_args()
    if (args.old is None) == (not args.probe):
        ap.error("give either OLD.cu or --probe")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mel_kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import BATCH, MEL_REL_BOUND, _serving_config, phase_card, time_ms
    from audioyolo_tpu_torch.ops.frontend import SpectralFrontend
    from audioyolo_tpu_torch.ops.mel_kernel import fused_mel_power, fused_mel_power_plain

    card = phase_card()
    if args.probe:
        print(json.dumps(dict(card=card, **probe(card))))
        return 0
    lib = build_old(args.old)
    dev = torch.device("cuda")
    cfg = _serving_config()
    fe = SpectralFrontend(cfg).to(dev)
    mk = fe.fused_kernel
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((BATCH, cfg.clip_samples)) * 0.1).astype(np.float32)
    wav16 = np.clip(np.round(wav * 32768), -32768, 32767).astype(np.int16)
    result = {"card": card}
    for name, x_np in (("int16", fe.frame_host(wav16)), ("float32", fe.frame_host(wav))):
        x = torch.from_numpy(x_np).to(dev)
        ct = mk.ct_i16 if x.dtype == torch.int16 else mk.ct
        b, r, g, f = x.shape
        fp, np_ = ct.shape[2], ct.shape[1]
        c_old = ct.transpose(1, 2).contiguous()  # (R, Fp, Np)
        mel2_old = mk.mel2t.t().contiguous()     # (Np, 32)
        out_old = torch.empty((b, r, g, 32), device=dev, dtype=torch.float32)
        stream = torch.cuda.current_stream().cuda_stream

        def old():
            err = lib.ayt_fused_mel_power(x.data_ptr(), int(x.dtype == torch.int16), c_old.data_ptr(),
                                          mel2_old.data_ptr(), out_old.data_ptr(), b, r, g, f, fp,
                                          np_, stream)
            assert err == 0, f"old kernel launch failed: {err}"

        def new():
            return fused_mel_power(x, ct, mk.mel2t)

        cb = ct[:, :, :f].transpose(1, 2).contiguous()

        def library():
            spec = torch.einsum("brgf,rfk->brgk", x.to(torch.bfloat16), cb)
            return torch.matmul(spec * spec, mel2_old)

        ref = fused_mel_power_plain(x, ct, mk.mel2t)
        old()
        out_new = new()
        torch.cuda.synchronize()
        rels = {}
        for label, out in (("old", out_old), ("new", out_new)):
            rels[label] = ((out - ref).abs() / (ref.abs() + 1e-3)).max().item()
            assert rels[label] < MEL_REL_BOUND, f"{label} kernel ({name}) rel err {rels[label]:.3e}"
        times = {"old": [], "new": [], "library": []}
        for _ in range(ROUNDS):
            for label, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
                times[label].append(time_ms(fn))
            times["library"].append(time_ms(library))
        result[name] = dict(times_ms=times, max_rel_err=rels)
        print(f"[kernel 1 A/B {name} {tuple(x.shape)}] old {times['old']} ms, new {times['new']} ms, "
              f"cuBLAS pair {times['library']} ms; max rel err old {rels['old']:.3e} new "
              f"{rels['new']:.3e} [{card}]", flush=True)
        del x, ref, out_old, out_new
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port (``audioyolo_tpu_torch``) on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. build every kernel under ``audioyolo_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together) and print the seconds taken;
2. print the card's name and power limit (``nvidia-smi``);
3. kernel 1 (``fused_mel_power``: a staging pass, then the TMA + ``wgmma``
   main pass) against its plain version on the card, at the serving batch
   (B=32) for int16 and float32 frames, a ragged B=3 and the waveform path's
   frames; the staging pass bit for bit; times of each pass and of both
   against the bound and the bf16 ``torch.matmul`` pair;
4. kernels 2 and 3 (greedy interval NMS, chunked and row by row) against
   the plain version, bit for bit, on random, near-threshold, chained and
   non-finite intervals at (32, 630), (1, 630), (3, 77), (2, 1024) and
   (2, 2048); K above the kernels' limit must raise; each kernel's device
   time from a profiler trace (``ms``) beside the wrapper call's time on
   CUDA events (``call_ms``), at B=32 and B=1 and on the chain, and the
   launch floor (an empty kernel through the same ``ctypes`` route);
5. serving: the shipped model at full width with seeded weights, folded,
   behind the port's HTTP server; three WAVs (150 s and 7 s at 22 050 Hz,
   60 s at 16 000 Hz) are POSTed, both kernels must have launched, and the
   model's predictions on the card must agree with the same model on the CPU;
   one serving batch's time is broken down (host clock, CUDA events, a
   profiler trace);
6. training: a synthetic dataset (64 train and 32 eval clips of 60 s at
   22 050 Hz, two tone classes) written with the port's WAV writer; one
   epoch of the shipped config through ``train_cli.run`` on the card and one
   through the trainer directly (kernel 1 must launch once per training and
   evaluation forward, the 10 metrics finite, the saved model must load into
   the server); the loss must fall over 10 steps on one fixed batch; the
   frontend's features on the card against the CPU; one step at B=2 and
   dropout 0 on the card against the CPU (loss, every gradient, the
   BatchNorm buffers; TF32's reading beside the bounds), for the body on
   kernel 1's features and for the whole path from frames; the train
   step's time at B=32 (CUDA events, host framing and copy on the host
   clock, audio-s/s, peak memory, the top kernels of the forward, the
   backward and the optimizer step from profiler traces);
7. inference and evaluation: the inference CLI (``inference_cli.main``) over
   a directory of 40 files of 20 s at 22 050 Hz (two cross-file batches) and
   2 of 60 s at 16 000 Hz (the threaded path, resampled on the card), over a
   150 s file and over one file, with one set of seeded weights saved as the
   port's ``.pt``, the JAX trainer's ``.msgpack`` and a reference
   ``.pth.tar`` (``--ref_exact``); kernels 1 and 2 must launch; 4 threads
   and 1 thread must give the same rows; a subset rerun on the CPU must give
   the card's rows (a difference only where a confidence or an IoU lies
   within 1e-3 of its threshold); the evaluator (``evaluate_cli.main``) on
   phase 6's eval split and saved model, card against CPU (mAP gap bound);
   the directory's wall time and audio-s/s;
8. print one JSON line of every kernel's numbers, then the device line.

Exits non-zero, printing no result, without a CUDA card or without the
package beside this file.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 32
# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, fp32 outside them, HBM3
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
MEL_REL_BOUND = 1e-2   # relative, over |plain| + 1e-3: fp32 order + odd bf16 flip of spec^2
# card vs CPU predictions, max |diff| / max |value|: the whole path (kernel 1's
# summation order moves the odd bf16 rounding of spec^2) and the model body on
# the same features (float32 only). Both sit below what TF32 convolutions read.
PREDS_REL_BOUND = 1e-4
BODY_REL_BOUND = 1e-5
# one train step at B=2, dropout 0, on the card against the CPU. The gradient
# has kinks (ReLUs, max pools, the clipped CIoU) that float32 rounding moves a
# unit across now and then, so it is read per tensor as max |diff| / max |g|
# by its median and 90th percentile over the tensors, and over all tensors at
# once as a relative L2 norm; the conv biases ahead of a train-mode BatchNorm,
# whose gradient is 0 in exact arithmetic, against the largest gradient. The
# loss and every updated BatchNorm buffer (max |diff| / max |value|) are read
# whole. Two inputs:
# - the body: kernel 1's feature image of two training clips on both sides
#   (float32 only; the card read 1.1e-6, 2.3e-3, 5.9e-3, 2.5e-3, 3.8e-9 and
#   1.3e-5 in the order of the keys below, TF32 6.7e-4, 0.20, 0.36, 0.30 and
#   6.9e-3);
# - the whole path from the frames of two unpadded clips, kernel 1 on the card
#   and its plain version on the CPU (the card read 3.8e-5, 6.7e-2, 0.11, 8.7e-2
#   and 1.1e-3, TF32 4.7e-3, 0.88, 1.33, 1.22 and 0.12): kernel 1's bf16
#   rounding moves MFCC coefficients near 0, which the frontend's second dB
#   map turns into O(1) pixels (2e-3 of them at most on unpadded audio).
# Every bound sits below what TF32 convolutions read.
TRAIN_BODY_BOUNDS = dict(loss=1e-5, grad_median=2e-2, grad_p90=5e-2, grad_l2=2e-2,
                         grad_zero=1e-6, bn=1e-4)
TRAIN_PATH_BOUNDS = dict(loss=1e-3, grad_median=0.3, grad_p90=0.5, grad_l2=0.4,
                         grad_zero=1e-6, bn=1e-2)
FEATURE_MEL_REL_BOUND = 1e-3   # log-mel channel, max |diff| / max |value|
FEATURE_MFCC_SHARE_BOUND = 2e-3  # MFCC pixels off by > 1e-3, unpadded audio
TRAIN_CLIPS, EVAL_CLIPS = 64, 32
# phase 7: the directory's short files (two cross-file batches of B=32: 32 + 8
# windows); the share of rows that may differ card vs CPU, each difference a
# flip of the confidence filter or the NMS; the evaluator's mAP gap card vs CPU
INFER_SHORT_FILES = 40
ROW_DIFFER_SHARE = 0.05
MAP_GAP_BOUND = 0.02


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, peak_ops):
    t_ops, t_bytes = flops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_build():
    from audioyolo_tpu_torch.ops import build

    t0 = time.perf_counter()
    logs = build.build()
    log(f"[build] {len(logs)} kernel libraries in {time.perf_counter() - t0:.1f} s: {sorted(logs)}")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "wgmma", "setmaxnreg", "arning")):
                log(f"[build] {name}: {line.strip()}")


def phase_card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    log(line)
    return line


def _serving_config():
    from audioyolo_tpu_torch.config import Config, load_config

    raw = load_config(os.path.join(ROOT, "config", "config.yaml")).to_dict()
    raw.setdefault("tpu_config", {}).update(frontend_precision="default", pallas_frontend="on")
    return Config(raw)


def phase_mel(dev, card):
    import numpy as np
    import torch

    from audioyolo_tpu_torch.ops.frontend import SpectralFrontend
    from audioyolo_tpu_torch.ops.mel_kernel import (fused_mel_power, fused_mel_power_plain,
                                                    mel_power_staged, stage_frames,
                                                    stage_frames_plain)

    cfg = _serving_config()
    fe = SpectralFrontend(cfg).to(dev)
    mk = fe.fused_kernel
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((BATCH, cfg.clip_samples)) * 0.1).astype(np.float32)
    wav16 = np.clip(np.round(wav * 32768), -32768, 32767).astype(np.int16)
    wav16[0, :2] = (-32768, 32767)  # the int16 extremes reach the staging pass
    res = {}
    for name, x_np in (("int16", fe.frame_host(wav16)), ("float32", fe.frame_host(wav))):
        x = torch.from_numpy(x_np).to(dev)
        ct = mk.ct_i16 if x.dtype == torch.int16 else mk.ct
        b, r, g, f = x.shape
        fp = ct.shape[-1]
        xs = stage_frames(x, fp)
        torch.cuda.synchronize()
        assert torch.equal(xs.view(torch.int16), stage_frames_plain(x, fp).view(torch.int16)), \
            f"staging pass ({name}) differs from its plain version"
        out = fused_mel_power(x, ct, mk.mel2t)
        ref = fused_mel_power_plain(x, ct, mk.mel2t)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        rel = (err / (ref.abs() + 1e-3)).max().item()
        k2 = 2 * fe.fused.n_freq
        assert out.shape == (b, r, g, 32) and torch.isfinite(out).all()
        assert rel < MEL_REL_BOUND, f"kernel 1 ({name}) rel err {rel:.3e} >= {MEL_REL_BOUND}"
        stage_ms = time_ms(lambda: stage_frames(x, fp))
        main_ms = time_ms(lambda: mel_power_staged(xs, ct, mk.mel2t, b, g))
        ms = time_ms(lambda: fused_mel_power(x, ct, mk.mel2t))
        plain_ms = time_ms(lambda: fused_mel_power_plain(x, ct, mk.mel2t), iters=5)
        # the yardstick's constants in their (R, F, Np) and (Np, 32) layouts, made before timing
        cb = ct[:, :, :f].transpose(1, 2).contiguous()
        mel2 = mk.mel2t.t().contiguous()

        def library():  # cuBLAS bf16: one (B*G, F) x (F, 2F') GEMM per phase, square, mel GEMM
            spec = torch.einsum("brgf,rfk->brgk", x.to(torch.bfloat16), cb)
            return torch.matmul(spec * spec, mel2)

        lib_ms = time_ms(library)
        flops = 2 * b * r * g * (f * k2 + k2 * 32)
        nbytes = x.numel() * x.element_size() + r * f * k2 * 2 + k2 * 32 * 2 + out.numel() * 4
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16)
        res[name] = dict(max_abs_err=err.max().item(), max_rel_err=rel, ms=ms, stage_ms=stage_ms,
                         main_ms=main_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        log(f"[kernel 1 framed {name} {tuple(x.shape)}] staging bit-equal; max_abs_err "
            f"{err.max().item():.3e} max_rel_err {rel:.3e} (bound {MEL_REL_BOUND}) kernel {ms:.4f} ms "
            f"(staging {stage_ms:.4f} + main {main_ms:.4f}), plain {plain_ms:.4f} ms, bf16 matmul "
            f"pair {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB), {flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of the "
            f"bound [{card}]")
        # a ragged batch: 3 clips = 360 rows, the last CTA's rows partly out of bounds
        x3 = x[:3].contiguous()
        assert torch.equal(stage_frames(x3, fp).view(torch.int16),
                           stage_frames_plain(x3, fp).view(torch.int16))
        out3 = fused_mel_power(x3, ct, mk.mel2t)
        ref3 = fused_mel_power_plain(x3, ct, mk.mel2t)
        rel3 = ((out3 - ref3).abs() / (ref3.abs() + 1e-3)).max().item()
        assert rel3 < MEL_REL_BOUND, f"kernel 1 ({name}, B=3) rel err {rel3:.3e}"
        log(f"[kernel 1 framed {name} B=3] staging bit-equal; max_rel_err {rel3:.3e}")
        del x, xs, out, ref

    # the waveform path's frames: one phase, window-folded DFT, F = n_fft
    from audioyolo_tpu_torch.ops.frontend import frame_signal

    xw = torch.from_numpy(wav).to(dev)
    frames = frame_signal(fe.resampler(xw), fe.mel.n_fft, fe.mel.hop, False, "reflect")
    frames = frames.contiguous()[:, None]
    wk = fe.mel.kernel
    fp = wk.ct.shape[-1]
    assert torch.equal(stage_frames(frames, fp).view(torch.int16),
                       stage_frames_plain(frames, fp).view(torch.int16))
    out = fused_mel_power(frames, wk.ct, wk.mel2t)
    ref = fused_mel_power_plain(frames, wk.ct, wk.mel2t)
    rel = ((out - ref).abs() / (ref.abs() + 1e-3)).max().item()
    assert rel < MEL_REL_BOUND, f"kernel 1 (waveform frames) rel err {rel:.3e}"
    ms = time_ms(lambda: fused_mel_power(frames, wk.ct, wk.mel2t))
    log(f"[kernel 1 waveform frames {tuple(frames.shape)}] staging bit-equal; max_rel_err "
        f"{rel:.3e} kernel {ms:.4f} ms [{card}]")
    return res


def _near_threshold(thr, n):
    """Pairs [0, 1] and [a, b] whose float32 IoU is one ulp below, on and one
    ulp above ``thr``, repeated to ``n`` intervals."""
    import numpy as np

    f32 = np.float32
    t32 = f32(thr)
    steps = np.arange(-300, 300, dtype=np.int32)
    a = (f32(0.5).view(np.int32) + steps).view(f32)[:, None]
    b = (f32(0.5 / thr).view(np.int32) + steps).view(f32)[None, :]
    inter = np.maximum(np.minimum(f32(1), b) - np.maximum(f32(0), a), f32(0))
    iou = inter / np.maximum(f32(1) + np.maximum(b - a, f32(0)) - inter, f32(1e-12))
    x1, x2 = [], []
    for target in (np.nextafter(t32, f32(0)), t32, np.nextafter(t32, f32(1))):
        hit = np.argwhere(iou == target)
        assert hit.size, f"no interval pair at IoU {target!r}"
        x1 += [0.0, float(a[hit[0, 0], 0])]
        x2 += [1.0, float(b[0, hit[0, 1]])]
    reps = n // len(x1) + 1
    return np.array(x1 * reps, f32)[:n], np.array(x2 * reps, f32)[:n]


def _nms_cases(b, k, seed):
    """Random, chained and non-finite (B, K) interval bounds, numpy float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 60, (b, k)).astype(np.float32)
    w = rng.uniform(0.2, 20, (b, k)).astype(np.float32)
    cases = {"random": (np.clip(c - w / 2, 0, 60), np.clip(c + w / 2, 0, 60))}
    chain = np.arange(k, dtype=np.float32) * np.float32(0.6)
    cases["chain"] = (np.tile(chain, (b, 1)), np.tile(chain + np.float32(1), (b, 1)))
    x1n, x2n = cases["random"][0].copy(), cases["random"][1].copy()
    for arr, value, share in ((x1n, np.nan, 0.05), (x2n, np.inf, 0.03), (x1n, -np.inf, 0.03),
                              (x2n, np.nan, 0.02)):
        arr[rng.random(arr.shape) < share] = value
    cases["non-finite"] = (x1n, x2n)
    return cases


def device_ms(fn, name, iters=50, warmup=3):
    """Mean device milliseconds per launch of the kernels whose name holds
    ``name``, from a ``torch.profiler`` trace of ``iters`` calls of ``fn``
    (over the launches the trace holds: now and then it misses one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # now and then a trace comes back without the device's events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) == DeviceType.CUDA and name in ev.key:
                us = getattr(ev, "self_device_time_total", None)
                total_us += ev.self_cuda_time_total if us is None else us
                count += ev.count
        if iters // 2 <= count <= iters:
            return total_us / count / 1e3
    raise AssertionError(f"the profiler saw {count} launches of {name} of {iters}")


def phase_nms(dev, card):
    import ctypes

    import numpy as np
    import torch

    from audioyolo_tpu_torch.ops import build
    from audioyolo_tpu_torch.ops.nms_kernel import (K_MAX, greedy_suppress_blocked,
                                                    greedy_suppress_rows,
                                                    greedy_suppress_unblocked)

    fns = (greedy_suppress_blocked, greedy_suppress_unblocked)
    checked, max_err = 0, 0
    for b, k in ((BATCH, 630), (1, 630), (3, 77), (2, 1024), (2, K_MAX)):
        cases = _nms_cases(b, k, seed=1 + k + b)
        for thr in (0.1, 0.45):
            near = _near_threshold(thr, k)
            cases_t = dict(cases, near=(np.tile(near[0], (b, 1)), np.tile(near[1], (b, 1))))
            for name, (x1n, x2n) in cases_t.items():
                x1, x2 = torch.from_numpy(x1n).to(dev), torch.from_numpy(x2n).to(dev)
                ref = greedy_suppress_rows(x1, x2, thr)
                for fn in fns:
                    got = fn(x1, x2, thr)
                    torch.cuda.synchronize()
                    max_err = max(max_err, int((got.to(torch.int8) - ref.to(torch.int8)).abs().max()))
                    assert torch.equal(got, ref), f"{fn.__name__} differs from plain ({name}, {thr}, {b}x{k})"
                    checked += 1
    log(f"[kernels 2, 3] bit-identical to the plain version in {checked} cases (random, "
        f"near-threshold +-1 ulp, chain, NaN and inf bounds; thresholds 0.1 and 0.45; "
        f"{BATCH}x630, 1x630, 3x77, 2x1024, 2x{K_MAX})")
    over = torch.zeros((1, K_MAX + 1), device=dev)
    for fn in fns:
        before = fn.launches
        try:
            fn(over, over, 0.1)
        except ValueError as e:
            assert str(K_MAX) in str(e) and fn.launches == before, e
        else:
            raise AssertionError(f"{fn.__name__} took K={K_MAX + 1} above its limit")
    log(f"[kernels 2, 3] K={K_MAX + 1} raises ValueError, as it must above K_MAX={K_MAX}")

    k = 630
    cases = _nms_cases(BATCH, k, seed=1)
    x1, x2 = (torch.from_numpy(a).to(dev) for a in cases["random"])
    c1, c2 = (torch.from_numpy(a).to(dev) for a in cases["chain"])
    keep = greedy_suppress_rows(x1, x2, 0.1)
    kept = keep.sum(1)
    log(f"[kernels 2, 3] rows kept per clip at thr 0.1: random mean {kept.float().mean().item():.2f} "
        f"max {kept.max().item()}, chain {int(greedy_suppress_rows(c1, c2, 0.1)[0].sum())} of {k}")
    # work this data needs: each kept row's IoU with every later column,
    # ~10 fp32 operations each (min, max, 3 add/sub, 2 max, div, compare, and)
    kept_idx = torch.nonzero(keep)[:, 1]
    flops = 10 * int((k - 1 - kept_idx).sum().item())
    nbytes = 2 * x1.numel() * 4 + keep.numel()
    bound_ms, bound_by = bound(flops, nbytes, PEAK_FP32)
    plain_ms = time_ms(lambda: greedy_suppress_rows(x1, x2, 0.1), iters=3, warmup=1)
    empty = build.function("interval_nms", "ayt_empty_launch", [ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream

    def empty_launch():
        build.check_launch(empty(stream), "empty launch")

    floor_ms, floor_call_ms = device_ms(empty_launch, "empty_kernel"), time_ms(empty_launch, iters=50)
    log(f"[launch floor] empty kernel {floor_ms:.6f} ms on the device, {floor_call_ms:.6f} ms per "
        f"ctypes call on CUDA events [{card}]")
    runs = {"": (x1, x2), "_b1": (x1[:1].contiguous(), x2[:1].contiguous()), "_chain": (c1, c2)}
    res = {}
    for fn in fns:
        r = dict(max_abs_err=float(max_err), plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                 bound_by=bound_by, launch_floor_ms=floor_ms, launch_floor_call_ms=floor_call_ms)
        for tag, (a, b) in runs.items():
            r["ms" + tag] = device_ms(lambda: fn(a, b, 0.1), "greedy_suppress_kernel")
            r["call_ms" + tag] = time_ms(lambda: fn(a, b, 0.1), iters=50)
        res[fn.__name__] = r
        log(f"[{fn.__name__} {BATCH}x{k}] kernel {r['ms']:.6f} ms on the device ({r['call_ms']:.6f} "
            f"per wrapper call); 1x{k} {r['ms_b1']:.6f} ({r['call_ms_b1']:.6f}); chain {BATCH}x{k} "
            f"{r['ms_chain']:.6f} ({r['call_ms_chain']:.6f}); launch floor {floor_ms:.6f}; plain "
            f"{plain_ms:.4f} ms; bound {bound_ms:.6f} ms ({bound_by}; the serial chain and the "
            f"launch are what bound it) [{card}]")
    return res


def _randomize_bn(sd, gen):
    import torch

    for key in list(sd):
        if key.endswith("running_var"):
            p = key[: -len("running_var")]
            sd[key] = torch.rand(sd[key].shape, generator=gen) + 0.5
            sd[p + "running_mean"] = torch.randn(sd[key].shape, generator=gen) * 0.1
            sd[p + "weight"] = torch.rand(sd[key].shape, generator=gen) * 0.8 + 0.6
            sd[p + "bias"] = torch.randn(sd[key].shape, generator=gen) * 0.1
    return sd


def _wav_bytes(path, seconds, rate, seed):
    import numpy as np

    from audioyolo_tpu_torch.data.wavio import write_wav

    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = 0.01 * rng.standard_normal(n)
    for start in range(0, int(seconds), 10):
        m = (t >= start + 2) & (t < start + 5)
        x[m] += 0.4 * np.sin(2 * np.pi * (440 if (start // 10) % 2 else 1200) * t[m])
    write_wav(path, x.astype(np.float32), rate)
    with open(path, "rb") as f:
        return f.read()


def _breakdown(infer_fn, fe, cfg, dev, card):
    """Where one serving batch (B=32 framed int16 clips) spends its time:
    host stages on the host clock, the forward on CUDA events, and the
    device's kernels from a profiler trace of one call."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(3)
    clips = np.clip(rng.standard_normal((BATCH, cfg.clip_samples)) * 3000,
                    -32768, 32767).astype(np.int16)
    t0 = time.perf_counter()
    framed = fe.frame_host(clips)
    t1 = time.perf_counter()
    x = torch.from_numpy(framed).to(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = infer_fn(x)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    out.cpu()
    t4 = time.perf_counter()
    fwd_ms = time_ms(lambda: infer_fn(x), iters=10)
    log(f"[breakdown B={BATCH}] host framing {(t1 - t0) * 1e3:.1f} ms, host->device "
        f"{(t2 - t1) * 1e3:.1f} ms ({x.numel() * 2 / 1e6:.0f} MB int16), forward+NMS "
        f"{(t3 - t2) * 1e3:.1f} ms wall / {fwd_ms:.3f} ms on CUDA events, device->host "
        f"{(t4 - t3) * 1e3:.2f} ms; {BATCH * cfg.sample_duration / fwd_ms * 1e3:.0f} audio-s/s "
        f"device-side [{card}]")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        infer_fn(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
    rows = []
    for ev in prof.key_averages():  # device-side events: the kernels and copies
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"[breakdown] profiled call: {wall_ms:.2f} ms wall, {busy_ms:.3f} ms of kernels "
        f"(device busy {busy_ms / wall_ms:.1%} of the call, profiler on)")
    for dev_us, count, key in rows[:12]:
        log(f"[breakdown]   {dev_us / 1e3:8.3f} ms  x{count:<4d} {key[:90]}")


def phase_serving(dev, card):
    import numpy as np
    import torch

    from audioyolo_tpu_torch import serve
    from audioyolo_tpu_torch.device import set_fp32_posture
    from audioyolo_tpu_torch.infer import make_inference_fn
    from audioyolo_tpu_torch.models import AudioDetectionModel, fold_repvgg
    from audioyolo_tpu_torch.ops import mel_kernel, nms_kernel

    cfg = _serving_config()
    cmap = os.path.join(ROOT, "idx2class_mapping", "class_map.json")
    gen = torch.Generator().manual_seed(0)
    sd = _randomize_bn(AudioDetectionModel.from_config(cfg, 2, generator=gen).state_dict(), gen)
    t0 = time.perf_counter()
    state = serve.build_app_state(cfg, state_dict=sd, class_map_path=cmap,
                                  batch_size=BATCH, device=dev)
    infer_fn = state["infer_fn"]
    fe = infer_fn.model.frontend
    # warm-up outside the counted run: both input paths once
    zf = torch.zeros((BATCH, fe.fused.n_ph, fe.fused.n_groups, fe.fused.frame_len),
                     dtype=torch.int16, device=dev)
    infer_fn(zf)
    infer_fn(torch.zeros((BATCH, 1, cfg.clip_samples), device=dev))
    torch.cuda.synchronize()
    log(f"[serving] model built, folded and warmed up in {time.perf_counter() - t0:.1f} s")

    # the predictions on the card (kernels) against the same model on the CPU:
    # the whole path from frames, and the body alone on the CPU's features;
    # each also with TF32 allowed, to show that the bounds would catch it
    rng = np.random.default_rng(2)
    wav16 = np.clip(rng.standard_normal((2, cfg.clip_samples)) * 3000, -32768, 32767).astype(np.int16)
    framed = torch.from_numpy(fe.frame_host(wav16))
    cpu_fn = make_inference_fn(AudioDetectionModel.from_config(cfg, 2, deploy=True),
                               fold_repvgg(sd), keep_k=128, device="cpu")

    def rel(a, ref):
        return ((a - ref).abs().max() / ref.abs().max()).item()

    with torch.inference_mode():
        p_cpu = cpu_fn.model(framed, combine_scales=True)
        feats = cpu_fn.model.frontend(framed)
        b_cpu = cpu_fn.model(features=feats, combine_scales=True)
        runs = {}
        for posture in ("fp32", "tf32"):
            torch.backends.cudnn.allow_tf32 = posture == "tf32"
            torch.backends.cuda.matmul.allow_tf32 = posture == "tf32"
            try:
                runs[posture] = (infer_fn.model(framed.to(dev), combine_scales=True).cpu(),
                                 infer_fn.model(features=feats.to(dev), combine_scales=True).cpu())
            finally:
                set_fp32_posture()
    p_card, b_card = runs["fp32"]
    d, d_body = rel(p_card, p_cpu), rel(b_card, b_cpu)
    packed_card, packed_cpu = infer_fn(framed.to(dev)).cpu(), cpu_fn(framed)
    agree = (packed_card[..., 5] == packed_cpu[..., 5]).float().mean().item()
    log(f"[serving] card vs CPU predictions, max |diff| / max |value|: whole path {d:.3e} "
        f"(bound {PREDS_REL_BOUND}; TF32 allowed: {rel(runs['tf32'][0], p_cpu):.3e}), body "
        f"on the same features {d_body:.3e} (bound {BODY_REL_BOUND}; TF32 allowed: "
        f"{rel(runs['tf32'][1], b_cpu):.3e}); packed valid-flag agreement {agree:.4f}")
    assert p_card.shape == (2, cfg.total_proposals, 5) and torch.isfinite(p_card).all()
    assert d < PREDS_REL_BOUND, f"card vs CPU predictions differ by {d:.3e} (relative)"
    assert d_body < BODY_REL_BOUND, f"card vs CPU body differs by {d_body:.3e} (relative)"

    _breakdown(infer_fn, fe, cfg, dev, card)

    httpd = serve.serve(state, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    classes = set(state["idx2class"].values())
    counts = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            requests = [("150 s @ 22050 Hz, framed", 150, 22050, 10),
                        ("7 s @ 22050 Hz, one padded clip", 7, 22050, 11),
                        ("60 s @ 16000 Hz, resampled", 60, 16000, 12)]
            bodies = [(name, sec, _wav_bytes(os.path.join(tmp, f"r{i}.wav"), sec, rate, seed))
                      for i, (name, sec, rate, seed) in enumerate(requests)]
            with urllib.request.urlopen(url + "/health", timeout=60) as r:
                assert json.loads(r.read()) == {"status": "ok"}
            mel_kernel.fused_mel_power.launches = 0
            nms_kernel.greedy_suppress_blocked.launches = 0
            nms_kernel.greedy_suppress_unblocked.launches = 0
            for name, sec, body in bodies:
                t0 = time.perf_counter()
                req = urllib.request.Request(url + "/detect", data=body, method="POST")
                with urllib.request.urlopen(req, timeout=600) as r:
                    status, out = r.status, json.loads(r.read())
                dt = time.perf_counter() - t0
                assert status == 200 and set(out) == {"events", "rows"}, out
                for row in out["rows"]:
                    assert row["class"] in classes and 0.0 <= row["confidence"] <= 1.0
                    assert 0.0 <= row["start"] <= row["end"] <= sec + 60.0
                for a, b in zip(out["events"], out["events"][1:]):
                    assert a["class"] != b["class"], "events must be RLE-merged"
                log(f"[serving] {name}: 200, {len(out['rows'])} rows, {len(out['events'])} "
                    f"events, {dt * 1e3:.1f} ms, {sec / dt:.1f} audio-s/s [{card}]")
            counts = {
                "fused_mel_power": mel_kernel.fused_mel_power.launches,
                "greedy_suppress_blocked": nms_kernel.greedy_suppress_blocked.launches,
                "greedy_suppress_unblocked": nms_kernel.greedy_suppress_unblocked.launches,
            }
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    log(f"[serving] kernel launches during the three requests: {counts}")
    for name in ("fused_mel_power", "greedy_suppress_blocked"):
        assert counts[name] > 0, f"{name} was not launched on the serving path"
    return counts


def _write_train_dataset(root, cfg, seed=7):
    """64 train and 32 eval clips at the config's rate, PCM16, with 1-6 tone
    events of two classes over random spans; one clip in four is shorter
    than the clip length. Annotations in the reference's flat layout."""
    import numpy as np

    from audioyolo_tpu_torch.data.wavio import write_wav

    rng = np.random.default_rng(seed)
    sr, dur = cfg.sample_rate, cfg.sample_duration
    freqs = {"music": 440.0, "alarm": 1200.0}
    ann = {}
    for split, n in (("train", TRAIN_CLIPS), ("eval", EVAL_CLIPS)):
        os.makedirs(os.path.join(root, split))
        for i in range(n):
            length = dur if i % 4 else float(rng.uniform(0.5, 0.9)) * dur
            x = (0.01 * rng.standard_normal(int(length * sr))).astype(np.float32)
            # spans in units of dur/60 (seconds at the shipped 60 s): widths 2-12,
            # gaps 0.5-6, the first event always fits
            u = dur / 60.0
            segs, cursor = {}, float(rng.uniform(0.0, 4.0)) * u
            for j in range(int(rng.integers(1, 7))):
                start = cursor
                end = min(cursor + float(rng.uniform(2.0, 12.0)) * u, length - 0.5 * u)
                if end <= start + 0.5 * u:
                    break
                cls = ("music", "alarm")[int(rng.integers(0, 2))]
                a, b = int(start * sr), int(end * sr)
                x[a:b] += 0.4 * np.sin(2 * np.pi * freqs[cls] * np.arange(b - a) / sr)
                segs[f"seg-{j}"] = {"start": start, "end": end, "class": cls}
                cursor = end + float(rng.uniform(0.5, 6.0)) * u
            write_wav(os.path.join(root, split, f"{split}{i:03d}.wav"), x, sr)
            ann[f"{split}{i:03d}"] = segs
    os.makedirs(os.path.join(root, "annotations"))
    with open(os.path.join(root, "annotations", "annotation.json"), "w") as f:
        json.dump({"annotations": {"annotator_a": ann}}, f)


def _train_config(tmp):
    from audioyolo_tpu_torch.config import Config

    raw = _serving_config().to_dict()
    raw["train_config"].update(
        dataset_path=os.path.join(tmp, "data"), class_map_path=os.path.join(tmp, "class_map"),
        model_path=os.path.join(tmp, "model"), metrics_path=os.path.join(tmp, "metrics"),
        epochs=1, verbose=True)
    return Config(raw)


def _check_epoch_metrics(where, metrics):
    import math

    vals = list(metrics.values())
    assert not any(math.isinf(v) for v in vals), (where, metrics)
    assert math.isfinite(metrics["aggregate_loss"]) and math.isfinite(metrics["conf_loss"]), \
        (where, metrics)


def _profiled(fn):
    """One call of ``fn`` under ``torch.profiler``: its result, the device
    kernels (ms, count, name) by device time, and their sum. The range
    ``torch.optim`` opens around a step (``Optimizer.step#Adam.step``) also
    shows on the device's timeline; it is no kernel and is left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if (getattr(ev, "device_type", None) != DeviceType.CUDA
                or ev.key.startswith("Optimizer.")):
            continue
        us = getattr(ev, "self_device_time_total", None)
        rows.append(((ev.self_cuda_time_total if us is None else us) / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    return out, rows, sum(r[0] for r in rows)


def _one_step(cfg, sd, inputs, targets, dev, tf32=False, dtype=None, features=False):
    """One train-mode forward, loss and backward of a fresh model from ``sd``
    on ``dev`` (``dtype`` float64 for the CPU's own reading): the loss, every
    parameter's gradient and every BatchNorm buffer after it, on the host."""
    import copy

    import torch

    from audioyolo_tpu_torch.device import set_fp32_posture
    from audioyolo_tpu_torch.models import AudioDetectionModel
    from audioyolo_tpu_torch.train_cli import make_loss

    model = AudioDetectionModel.from_config(cfg, 2)
    model.load_state_dict(copy.deepcopy(sd))
    model = model.to(dev).train()
    loss_fn = make_loss(cfg, 2, None)
    if dtype is not None:
        model = model.to(dtype)
        loss_fn.anchors = {k: a.to(dtype) for k, a in loss_fn.anchors.items()}
        inputs = inputs.to(dtype)
        targets = {k: v.to(dtype) if v.is_floating_point() else v for k, v in targets.items()}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        x = inputs.to(dev)
        preds = model(features=x) if features else model(x)
        loss, _ = loss_fn(preds, {k: v.to(dev) for k, v in targets.items()})
        loss.backward()
        return (loss.item(),
                {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()},
                {k: b.detach().double().cpu() for k, b in model.named_buffers() if "running" in k})
    finally:
        set_fp32_posture()


def _compare_steps(run, ref):
    """The readings of TRAIN_BODY_BOUNDS for ``run`` against ``ref`` (each
    an ``_one_step`` result), with the worst tensor of each kind."""
    import numpy as np
    import torch

    g, gr = run[1], ref[1]
    gmax = max(t.abs().max().item() for t in gr.values())
    zero = [k for k in gr if k.endswith("conv.conv.bias")
            and f"{k[:-len('conv.conv.bias')]}norm.weight" in gr]
    live = [k for k in gr if k not in zero]
    rel = {k: ((g[k] - gr[k]).abs().max() / gr[k].abs().max()).item() for k in live}
    flat, flat_ref = (torch.cat([d[k].flatten() for k in live]) for d in (g, gr))
    bn = {k: ((run[2][k] - ref[2][k]).abs().max() / ref[2][k].abs().max()).item() for k in ref[2]}
    vals = list(rel.values())
    return dict(loss=abs(run[0] - ref[0]) / abs(ref[0]), grad_median=float(np.median(vals)),
                grad_p90=float(np.percentile(vals, 90)),
                grad_l2=((flat - flat_ref).norm() / flat_ref.norm()).item(),
                grad_zero=max(max(g[k].abs().max().item(), gr[k].abs().max().item())
                              for k in zero) / gmax,
                bn=max(bn.values()), worst_grad=max(rel, key=rel.get),
                worst_grad_rel=max(vals), worst_bn=max(bn, key=bn.get), n_live=len(live),
                n_zero=len(zero))


def _unpadded_clip(cfg, seed):
    """60 s of PCM16 noise with a 440 Hz and a 1200 Hz tone, no zero tail."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sr = cfg.sample_rate
    x = 0.01 * rng.standard_normal(cfg.clip_samples)
    for f, a, b in ((440.0, 0.08, 0.28), (1200.0, 0.5, 0.68)):
        i, j = int(a * cfg.clip_samples), int(b * cfg.clip_samples)
        x[i:j] += 0.4 * np.sin(2 * np.pi * f * np.arange(j - i) / sr)
    return np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)


def phase_training(dev, card, tmp):
    """Writes its dataset, class map and saved model under ``tmp`` (phase 7
    evaluates them)."""
    import copy

    import numpy as np
    import torch

    from audioyolo_tpu_torch import serve, train_cli
    from audioyolo_tpu_torch.data.loader import BatchLoader
    from audioyolo_tpu_torch.models import AudioDetectionModel
    from audioyolo_tpu_torch.ops import mel_kernel, nms_kernel
    from audioyolo_tpu_torch.train import TrainerPipeline

    res = {}
    cfg = _train_config(tmp)
    tc = cfg.raw["train_config"]
    t0 = time.perf_counter()
    _write_train_dataset(tc["dataset_path"], cfg)
    log(f"[training] synthetic dataset: {TRAIN_CLIPS} train + {EVAL_CLIPS} eval clips of "
        f"{cfg.sample_duration:.0f} s at {cfg.sample_rate} Hz in {time.perf_counter() - t0:.1f} s")

    # one epoch through the CLI's run(), one through the trainer itself
    counters = (mel_kernel.fused_mel_power, nms_kernel.greedy_suppress_blocked,
                nms_kernel.greedy_suppress_unblocked)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    cli_trainer = train_cli.run(cfg, device=dev)
    cli_s = time.perf_counter() - t0
    after_cli = mel_kernel.fused_mel_power.launches
    train_ds, eval_ds = train_cli.resolve_datasets(cfg)
    model = AudioDetectionModel.from_config(cfg, 2, generator=torch.Generator().manual_seed(1))
    trainer = TrainerPipeline(model, train_cli.make_loss(cfg, 2, train_ds.get_class_weights()),
                              tc["optimizer_config"], tc["lr_scheduler_config"],
                              model_path=os.path.join(tmp, "direct"), device=dev)
    kw = dict(transfer_dtype="int16", frame_fn=model.frontend.frame_host)
    train_loader = BatchLoader(train_ds, BATCH, seed=5, **kw)
    eval_loader = BatchLoader(eval_ds, BATCH, shuffle=False, **kw)
    t0 = time.perf_counter()
    tm = trainer.train(train_loader, verbose=True)
    em = trainer.evaluate(eval_loader, verbose=True)
    direct_s = time.perf_counter() - t0
    counts = {c.__name__: c.launches for c in counters}
    bs = int(tc["batch_size"])
    cli_forwards = -(-len(train_ds) // bs) + -(-len(eval_ds) // bs)
    forwards = cli_forwards + len(train_loader) + len(eval_loader)
    log(f"[training] one epoch via train_cli.run {cli_s:.1f} s (data, model, trainer, save), "
        f"via the trainer {direct_s:.1f} s; launches {counts}, forward passes {forwards} "
        f"({cli_forwards} via the CLI)")
    assert after_cli == cli_forwards and counts["fused_mel_power"] == forwards, counts
    assert counts["greedy_suppress_blocked"] == counts["greedy_suppress_unblocked"] == 0
    res["train_launches"] = counts["fused_mel_power"]
    for where, m in (("cli train", cli_trainer.train_metrics[-1]),
                     ("cli eval", cli_trainer.eval_metrics[-1]), ("train", tm), ("eval", em)):
        _check_epoch_metrics(where, m)

    # the saved model (best eval loss) serves
    saved = os.path.join(tc["model_path"], "AudioDetectionModel.pt")
    state = serve.build_app_state(cfg, model_path=saved,
                                  class_map_path=os.path.join(tc["class_map_path"],
                                                              "class_map.json"),
                                  batch_size=BATCH, device=dev)
    fe = state["infer_fn"].model.frontend
    clips = np.zeros((2, cfg.clip_samples), np.int16)
    packed = state["infer_fn"](torch.from_numpy(fe.frame_host(clips)).to(dev)).cpu()
    assert packed.shape[::2] == (2, 6) and torch.isfinite(packed).all()
    log(f"[training] saved model {saved} ({os.path.getsize(saved) / 1e6:.1f} MB) loads into "
        f"the server and serves; classes {state['idx2class']}")
    del state

    # the loss falls on one fixed batch
    batch = next(iter(BatchLoader(train_ds, BATCH, shuffle=False, prefetch=0, **kw)))
    x, t = trainer.put_batch(batch)
    losses = torch.stack([trainer.train_step(x, t) for _ in range(10)])[:, 0].tolist()
    log(f"[training] 10 steps on one fixed B={BATCH} batch: aggregate loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} ({', '.join(f'{v:.4f}' for v in losses)})")
    assert losses[-1] < losses[0], losses
    res.update(loss_first=losses[0], loss_last=losses[-1])

    # one step on the card against the CPU, B=2, dropout 0, same weights:
    # the body on kernel 1's feature image, then the whole path from frames
    raw0 = cfg.to_dict()
    raw0["dropout"] = 0.0
    cfg0 = type(cfg)(raw0)
    model0 = AudioDetectionModel.from_config(cfg0, 2, generator=torch.Generator().manual_seed(3))
    sd, fe0 = model0.state_dict(), model0.frontend
    targets = {k: torch.from_numpy(batch[k][:2]) for k in ("classes", "centers", "widths",
                                                          "valid")}
    padded = torch.from_numpy(np.ascontiguousarray(batch["audio"][:2]))
    unpadded = torch.from_numpy(fe0.frame_host(np.stack([_unpadded_clip(cfg0, s)
                                                         for s in (1, 2)])))
    fe_card = copy.deepcopy(fe0).to(dev)
    feats = {}
    for name, framed in (("training clips", padded), ("unpadded clips", unpadded)):
        with torch.no_grad():
            f_cpu, f_card = fe0(framed), fe_card(framed.to(dev)).cpu()
        d = (f_card - f_cpu).abs()
        mel_rel = (d[..., 0].max() / f_cpu[..., 0].abs().max()).item()
        share = (d[..., 1] > 1e-3).float().mean().item()
        log(f"[training] features card vs CPU, {name}: log-mel max |diff| / max |value| "
            f"{mel_rel:.3e} (bound {FEATURE_MEL_REL_BOUND}); MFCC pixels off by > 1e-3 "
            f"{share:.3e} (max |diff| {d[..., 1].max():.3e})")
        assert mel_rel < FEATURE_MEL_REL_BOUND, (name, mel_rel)
        feats[name] = (f_card, share)
    assert feats["unpadded clips"][1] < FEATURE_MFCC_SHARE_BOUND, feats["unpadded clips"][1]

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    f_card = feats["training clips"][0]
    body_ref = _one_step(cfg0, sd, f_card, targets, cpu, features=True)
    cpu_s = time.perf_counter() - t0
    own = _compare_steps(body_ref, _one_step(cfg0, sd, f_card, targets, cpu,
                                             dtype=torch.float64, features=True))
    path_ref = _one_step(cfg0, sd, unpadded, targets, cpu)
    checks = (("body on kernel 1's features", TRAIN_BODY_BOUNDS, body_ref,
               dict(inputs=f_card, features=True)),
              ("whole path from unpadded frames", TRAIN_PATH_BOUNDS, path_ref,
               dict(inputs=unpadded)))
    keys = ("loss", "grad_median", "grad_p90", "grad_l2", "grad_zero", "bn")
    for name, bounds, ref, kw in checks:
        fp32, tf32 = (_compare_steps(_one_step(cfg0, sd, targets=targets, dev=dev, tf32=f,
                                               **kw), ref) for f in (False, True))
        log(f"[training] card vs CPU train step, B=2, {name} (CPU step {cpu_s:.1f} s): "
            f"{fp32['n_live']} gradients, {fp32['n_zero']} zero in exact arithmetic; "
            + "; ".join(f"{k} {fp32[k]:.3e} (bound {bounds[k]:g}; TF32 {tf32[k]:.3e})"
                        for k in keys)
            + f"; worst gradient {fp32['worst_grad_rel']:.3e} ({fp32['worst_grad']}), worst "
            f"buffer {fp32['worst_bn']}")
        bad = [k for k in keys if not fp32[k] < bounds[k]]
        assert not bad, f"card vs CPU train step ({name}) outside its bounds: {bad}"
        res[f"card_cpu_{'body' if bounds is TRAIN_BODY_BOUNDS else 'path'}"] = {
            k: fp32[k] for k in keys}
    log("[training] the CPU's own float32 body step against float64: "
        + "; ".join(f"{k} {own[k]:.3e}" for k in keys))

    # times at B=32
    wav16 = np.stack([np.clip(np.round(train_ds[i]["audio"][0] * 32768.0), -32768, 32767)
                      for i in range(BATCH)]).astype(np.int16)
    t0 = time.perf_counter()
    framed32 = model.frontend.frame_host(wav16)
    t1 = time.perf_counter()
    trainer.put_batch(dict(batch, audio=framed32))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = time_ms(lambda: trainer.train_step(x, t), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    phase = np.zeros(3)
    model.train()
    for _ in range(5):
        ev[0].record()
        preds = model(x, generator=trainer.generator)
        loss, _ = trainer.loss_fn(preds, t)
        ev[1].record()
        trainer.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[2].record()
        trainer.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        phase += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    phase /= 5
    audio_s = BATCH * cfg.sample_duration / step_ms * 1e3
    log(f"[training B={BATCH}] train step {step_ms:.3f} ms on CUDA events (forward+loss "
        f"{phase[0]:.3f}, backward {phase[1]:.3f}, optimizer {phase[2]:.3f}); "
        f"{audio_s:.0f} training audio-s/s device-side; host framing {(t1 - t0) * 1e3:.1f} ms, "
        f"host->device {(t2 - t1) * 1e3:.1f} ms (pinned, {framed32.nbytes / 1e6:.0f} MB int16); "
        f"peak memory {peak / 2**30:.2f} GiB [{card}]")
    res.update(step_ms=step_ms, forward_ms=float(phase[0]), backward_ms=float(phase[1]),
               optimizer_ms=float(phase[2]), audio_s_per_s=audio_s, peak_gib=peak / 2**30,
               framing_ms=(t1 - t0) * 1e3, h2d_ms=(t2 - t1) * 1e3)
    trainer.optimizer.zero_grad(set_to_none=True)
    (loss, _), fwd, fwd_ms = _profiled(lambda: trainer.loss_fn(model(x, generator=trainer.generator), t))
    _, bwd, bwd_ms = _profiled(loss.backward)
    _, opt, opt_ms = _profiled(trainer.optimizer.step)
    for name, rows, total in (("forward+loss", fwd, fwd_ms), ("backward", bwd, bwd_ms),
                              ("optimizer", opt, opt_ms)):
        log(f"[training B={BATCH}] {name}: {total:.3f} ms of kernels (profiler on)")
        for ms, count, key in rows[:6]:
            log(f"[training B={BATCH}]   {ms:8.3f} ms  x{count:<4d} {key[:90]}")
    k1 = sum(r[0] for r in fwd if "mel_power" in r[2] or "stage_frames" in r[2])
    log(f"[training B={BATCH}] kernel 1 (staging + main pass) {k1:.3f} ms of the forward's "
        f"{fwd_ms:.3f} ms of kernels")
    res["kernel1_in_forward_ms"] = k1
    return res


def _jax_variables(sd):
    """The port's train-form state dict as the JAX package's flax variables
    (the inverse of ``models/from_jax.py``): OIHW conv weights under a
    ``conv`` level become HWIO ``kernel``s, BatchNorm ``weight`` ``scale``,
    the running statistics ``batch_stats`` ``mean``/``var``."""
    import numpy as np

    tree = {"params": {}, "batch_stats": {}}
    for key, t in sd.items():
        *mods, leaf = key.split(".")
        a = t.detach().cpu().numpy()
        if not mods:  # the anchors
            coll, name = "params", leaf
        elif leaf.startswith("running_"):
            coll, name = "batch_stats", {"running_mean": "mean", "running_var": "var"}[leaf]
        elif mods[-1] == "conv":
            coll, name = "params", {"weight": "kernel", "bias": "bias"}[leaf]
            if leaf == "weight":
                a = a.transpose(2, 3, 1, 0)
        else:
            coll, name = "params", {"weight": "scale", "bias": "bias"}[leaf]
        node = tree[coll]
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return tree


def _msgpack(obj) -> bytes:
    """MessagePack as ``flax.serialization.msgpack_serialize`` writes it, for
    dicts, strings, ints and ndarrays (extension type 1: a nested
    ``(shape, dtype name, C-order bytes)``)."""
    import struct

    import numpy as np

    def sized(small, codes, n):  # (fixed-size head or None, (8-, 16-, 32-bit heads), length)
        if small is not None and n < 16:
            return bytes([small | n])
        for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (2**8, 2**16, 2**32)):
            if code is not None and n < limit:
                return bytes([code]) + struct.pack(fmt, n)
        raise ValueError(f"object of length {n} is too long")

    if isinstance(obj, dict):
        return sized(0x80, (None, 0xde, 0xdf), len(obj)) + b"".join(
            _msgpack(k) + _msgpack(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return sized(0x90, (None, 0xdc, 0xdd), len(obj)) + b"".join(map(_msgpack, obj))
    if isinstance(obj, str):
        raw = obj.encode()
        return (bytes([0xa0 | len(raw)]) if len(raw) < 32 else sized(None, (0xd9, 0xda, 0xdb), len(raw))) + raw
    if isinstance(obj, bytes):
        return sized(None, (0xc4, 0xc5, 0xc6), len(obj)) + obj
    if isinstance(obj, int):
        return bytes([obj]) if 0 <= obj < 128 else b"\xd3" + struct.pack(">q", obj)
    if isinstance(obj, np.ndarray):
        payload = _msgpack([list(obj.shape), obj.dtype.name, np.ascontiguousarray(obj).tobytes()])
        return sized(None, (0xc7, 0xc8, 0xc9), len(payload)) + b"\x01" + payload
    raise TypeError(f"cannot pack {type(obj).__name__}")


class _RowRecorder:
    """Records the unrounded rows each CSV is written from, keyed by
    (run, file name), while it is entered (``infer/streaming.py`` writes every
    CSV through its module's ``write_rows_csv``)."""

    def __init__(self):
        self.rows, self.run = {}, None

    def __enter__(self):
        from audioyolo_tpu_torch.infer import streaming

        self._write = write = streaming.write_rows_csv

        def record(all_rows, idx2class_map, audio_filepath, output_dir):
            self.rows[(self.run, os.path.basename(audio_filepath))] = sorted(
                (dict(r) for r in all_rows), key=lambda r: (r["start"], r["end"]))
            return write(all_rows, idx2class_map, audio_filepath, output_dir)

        streaming.write_rows_csv = record
        return self

    def __exit__(self, *exc):
        from audioyolo_tpu_torch.infer import streaming

        streaming.write_rows_csv = self._write


def _iou(a, b):
    inter = max(0.0, min(a["end"], b["end"]) - max(a["start"], b["start"]))
    union = (a["end"] - a["start"]) + (b["end"] - b["start"]) - inter
    return inter / union if union > 0 else 0.0


def _compare_rows(card, cpu, conf_thr, iou_thr, tol=1e-3):
    """Card rows against CPU rows of one file: each card row is matched to an
    unmatched CPU row of the same class whose start and end lie within
    ``tol`` s. An unmatched row is explained when its confidence is within
    ``tol`` of ``conf_thr`` or its IoU with another row of either side is
    within ``tol`` of ``iou_thr`` (a flip of the confidence filter or of the
    NMS). Returns (matched, explained, unexplained rows, max |time diff| and
    max |confidence diff| over the matched pairs)."""
    left, matched, dt, dc = list(cpu), 0, 0.0, 0.0
    unmatched = []
    for r in card:
        hit = next((q for q in left if q["class_idx"] == r["class_idx"]
                    and abs(q["start"] - r["start"]) <= tol and abs(q["end"] - r["end"]) <= tol),
                   None)
        if hit is None:
            unmatched.append(r)
            continue
        left.remove(hit)
        matched += 1
        dt = max(dt, abs(hit["start"] - r["start"]), abs(hit["end"] - r["end"]))
        dc = max(dc, abs(hit["confidence"] - r["confidence"]))
    unmatched += left
    everyone = list(card) + list(cpu)
    explained = [r for r in unmatched if abs(r["confidence"] - conf_thr) <= tol
                 or any(q is not r and abs(_iou(q, r) - iou_thr) <= tol for q in everyone)]
    unexplained = [r for r in unmatched if r not in explained]
    return matched, len(explained), unexplained, dt, dc


def phase_inference(dev, card, train_tmp):
    """Phase 7: the inference CLI over a directory and single files in every
    checkpoint format, card against CPU, threads against one thread, and the
    evaluator on phase 6's eval split and saved model."""
    import shutil

    import numpy as np
    import torch
    import yaml

    from audioyolo_tpu_torch import evaluate_cli, inference_cli
    from audioyolo_tpu_torch.models import AudioDetectionModel
    from audioyolo_tpu_torch.models.import_torch import port_key_to_torch_key
    from audioyolo_tpu_torch.ops import mel_kernel, nms_kernel

    cfg = _serving_config()
    tmp = os.path.join(train_tmp, "inference")
    audio_dir, sub_dir = os.path.join(tmp, "audio"), os.path.join(tmp, "cpu_subset")
    os.makedirs(audio_dir)
    os.makedirs(sub_dir)
    raw = cfg.to_dict()
    raw["train_config"]["class_map_path"] = os.path.join(ROOT, "idx2class_mapping")
    cfg_path = os.path.join(tmp, "serving.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)

    # at the shipped config: 20 s files at 22 050 Hz, 60 s at 16 000 Hz, 150 s
    t0 = time.perf_counter()
    dur, rate = cfg.sample_duration, cfg.sample_rate
    durations = {}
    for i in range(INFER_SHORT_FILES):
        durations[f"s{i:02d}.wav"] = (dur / 3, rate)
    for i in range(2):
        durations[f"r16k_{i}.wav"] = (dur, 16000)
    for i, (name, (sec, file_rate)) in enumerate(durations.items()):
        _wav_bytes(os.path.join(audio_dir, name), sec, file_rate, seed=100 + i)
    long_path = os.path.join(tmp, "long150.wav")
    _wav_bytes(long_path, 2.5 * dur, rate, seed=7)
    durations["long150.wav"] = (2.5 * dur, rate)
    for name in ("s00.wav", "s01.wav", "s02.wav", "r16k_0.wav"):
        shutil.copy(os.path.join(audio_dir, name), os.path.join(sub_dir, name))
    audio_s = sum(sec for name, (sec, _) in durations.items() if name != "long150.wav")
    log(f"[inference] {INFER_SHORT_FILES} files of {dur / 3:g} s at {rate} Hz, 2 of {dur:g} s at "
        f"16000 Hz and one of {2.5 * dur:g} s written in {time.perf_counter() - t0:.1f} s")

    # one set of seeded weights, saved three ways
    gen = torch.Generator().manual_seed(0)
    sd = _randomize_bn(AudioDetectionModel.from_config(cfg, 2, generator=gen).state_dict(), gen)
    weights = {ext: os.path.join(tmp, f"weights{ext}") for ext in (".pt", ".msgpack", ".pth.tar")}
    torch.save(sd, weights[".pt"])
    with open(weights[".msgpack"], "wb") as f:
        f.write(_msgpack(dict(_jax_variables(sd), opt_state={}, step=0)))
    torch.save({"network_params": {port_key_to_torch_key(k): v for k, v in sd.items()}},
               weights[".pth.tar"])

    counters = (mel_kernel.fused_mel_power, nms_kernel.greedy_suppress_blocked,
                nms_kernel.greedy_suppress_unblocked)
    conf_thr, iou_thr = 0.2, 0.1
    rec = _RowRecorder()

    def cli(run, *args, device=dev.type):
        rec.run = run
        t = time.perf_counter()
        inference_cli.main(["--config", cfg_path, "--output_dir", os.path.join(tmp, "out", run),
                            "--device", device, "--iou_threshold", str(iou_thr),
                            "--conf_threshold", str(conf_thr), *args])
        return time.perf_counter() - t

    res = {}
    with rec:
        for c in counters:
            c.launches = 0
        walls = {}
        for run, extra in (("dir", ["--num_concurrency", "4"]),
                           ("dir_framed", ["--num_concurrency", "4", "--framed_input"]),
                           ("dir_serial", ["--num_concurrency", "1"])):
            walls[run] = cli(run, "--model_path", weights[".pt"], "--audio_dir", audio_dir, *extra)
        t = time.perf_counter()
        _, _, busy_ms = _profiled(lambda: cli("dir_profiled", "--model_path", weights[".pt"],
                                              "--audio_dir", audio_dir, "--framed_input"))
        prof_wall = time.perf_counter() - t
        log(f"[inference] the framed directory run under the profiler: {busy_ms:.1f} ms of "
            f"kernels in {prof_wall * 1e3:.0f} ms wall, the device busy {busy_ms / prof_wall / 1e3:.1%} "
            f"of the run (model build included) [{card}]")
        walls["long"] = cli("long", "--model_path", weights[".msgpack"], "--audio_filepath",
                            long_path, "--framed_input")
        walls["ref_exact"] = cli("ref_exact", "--model_path", weights[".pth.tar"],
                                 "--audio_filepath", os.path.join(audio_dir, "s03.wav"),
                                 "--ref_exact")
        torch.cuda.synchronize()
        infer_counts = {c.__name__: c.launches for c in counters}
        # what of a run's wall time is the model build (load, fold, to the card)
        t = time.perf_counter()
        inference_cli.build_inference(cfg_path, 2, weights[".pt"], iou_thr, conf_thr, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        for run in ("dir", "dir_framed", "dir_serial"):
            log(f"[inference] CLI over the directory ({run}: {len(durations) - 1} files, "
                f"{audio_s:.0f} audio-s, .pt, B={BATCH}): {walls[run]:.2f} s wall, "
                f"{audio_s / walls[run]:.0f} audio-s/s, model build included (alone "
                f"{build_s:.2f} s) [{card}]")
        log(f"[inference] 150 s file (.msgpack, framed) {walls['long']:.2f} s, one file "
            f"(.pth.tar, --ref_exact) {walls['ref_exact']:.2f} s; kernel launches in the CLI runs "
            f"{infer_counts}")
        for name in ("fused_mel_power", "greedy_suppress_blocked"):
            assert infer_counts[name] > 0, f"{name} was not launched by inference_cli.main"

        # what came out: one CSV per file, finite rows inside the padded file
        for (run, name), rows in rec.rows.items():
            sec = durations[name][0]
            for r in rows:
                assert r["class_idx"] in (0, 1) and 0.0 <= r["confidence"] <= 1.0, (run, name, r)
                assert 0.0 <= r["start"] <= r["end"] <= -(-sec // dur) * dur, (run, name, r)
        n_dir = len(durations) - 1
        for run in ("dir", "dir_framed", "dir_serial"):
            assert sum(1 for (r, _) in rec.rows if r == run) == n_dir, run
        assert all(rec.rows[("dir", n)] == rec.rows[("dir_serial", n)] for n in durations
                   if n != "long150.wav"), "rows of 4 threads differ from one thread's"
        n_rows = sum(len(rec.rows[("dir", n)]) for n in durations if n != "long150.wav")
        log(f"[inference] threaded path at num_concurrency 4 and 1: the same {n_rows} rows in "
            f"{n_dir} files (the 16 kHz files ran on the threads)")

        # the card against the CPU, before CSV rounding
        t = time.perf_counter()
        cli("cpu_sub", "--model_path", weights[".pt"], "--audio_dir", sub_dir, "--batch_size", "2",
            device="cpu")
        cli("cpu_long", "--model_path", weights[".msgpack"], "--audio_filepath", long_path,
            "--framed_input", "--batch_size", "2", device="cpu")
        cpu_s = time.perf_counter() - t
    pairs = [(("dir", n), ("cpu_sub", n)) for n in sorted(os.listdir(sub_dir))]
    pairs.append((("long", "long150.wav"), ("cpu_long", "long150.wav")))
    total = {"matched": 0, "explained": 0, "rows": 0}
    dt = dc = 0.0
    for card_key, cpu_key in pairs:
        m, e, bad, t_diff, c_diff = _compare_rows(rec.rows[card_key], rec.rows[cpu_key],
                                                  conf_thr, iou_thr)
        total["matched"] += m
        total["explained"] += e
        total["rows"] += max(len(rec.rows[card_key]), len(rec.rows[cpu_key]))
        dt, dc = max(dt, t_diff), max(dc, c_diff)
        log(f"[inference] card vs CPU rows, {card_key[1]}: {len(rec.rows[card_key])} / "
            f"{len(rec.rows[cpu_key])}, {m} matched, {e} explained, {len(bad)} unexplained"
            + (f": {bad[:3]}" if bad else ""))
        assert not bad, f"card vs CPU rows of {card_key[1]} differ beyond a threshold flip"
    differ = 1.0 - total["matched"] / max(total["rows"], 1)
    log(f"[inference] card vs CPU row agreement {total['matched']}/{total['rows']} "
        f"({1 - differ:.4f}); {total['explained']} rows differ, each by a confidence within 1e-3 "
        f"of {conf_thr} or an IoU within 1e-3 of {iou_thr}; matched rows' times within "
        f"{dt:.2e} s, confidences within {dc:.2e} (CPU runs {cpu_s:.1f} s at B=2)")
    assert dt <= 1e-3 and differ <= ROW_DIFFER_SHARE, (dt, differ)

    # the evaluator on phase 6's eval split and saved model, card then CPU
    train_cfg = os.path.join(tmp, "train.yaml")
    with open(train_cfg, "w") as f:
        yaml.safe_dump(_train_config(train_tmp).to_dict(), f)
    eval_args = ["--config", train_cfg, "--dataset_path", os.path.join(train_tmp, "data"),
                 "--batch_size", str(BATCH)]
    for c in counters:
        c.launches = 0
    t = time.perf_counter()
    on_card = evaluate_cli.main(eval_args + ["--device", dev.type])
    torch.cuda.synchronize()
    card_eval_s = time.perf_counter() - t
    eval_counts = {c.__name__: c.launches for c in counters}
    t = time.perf_counter()
    on_cpu = evaluate_cli.main(eval_args + ["--device", "cpu"])
    cpu_eval_s = time.perf_counter() - t
    gaps = {k: abs(on_card[k] - on_cpu[k]) for k in on_card if k.startswith("mAP")}
    log(f"[evaluation] card {card_eval_s:.1f} s: {json.dumps(on_card)}")
    log(f"[evaluation] CPU {cpu_eval_s:.1f} s: {json.dumps(on_cpu)}")
    log(f"[evaluation] largest mAP gap card vs CPU {max(gaps.values()):.3e} (bound "
        f"{MAP_GAP_BOUND}); kernel launches {eval_counts}")
    assert on_card["num_ground_truth"] == on_cpu["num_ground_truth"] > 0
    assert all(np.isfinite(on_card[k]) for k in gaps) and max(gaps.values()) <= MAP_GAP_BOUND, gaps
    for name in ("fused_mel_power", "greedy_suppress_blocked"):
        assert eval_counts[name] > 0, f"{name} was not launched by evaluate_cli.main"
    res.update(infer_launches=infer_counts, eval_launches=eval_counts,
               dir_wall_s=walls["dir"], dir_framed_wall_s=walls["dir_framed"],
               dir_serial_wall_s=walls["dir_serial"], build_s=build_s,
               dir_profiled_busy_ms=busy_ms, dir_profiled_wall_s=prof_wall,
               dir_audio_s=audio_s, row_agreement=1 - differ, map_gap=max(gaps.values()),
               map_card=on_card["mAP@0.5"], map_cpu=on_cpu["mAP@0.5"])
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import audioyolo_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    from audioyolo_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    phase_build()
    card = phase_card()
    mel = phase_mel(dev, card)
    nms = phase_nms(dev, card)
    counts = phase_serving(dev, card)
    tmp = tempfile.mkdtemp(prefix="ayt_smoke_")
    try:
        training = phase_training(dev, card, tmp)
        inference = phase_inference(dev, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    src = "audioyolo_tpu_torch/csrc/"

    def paths(name):
        return dict(infer_launches=inference["infer_launches"][name],
                    eval_launches=inference["eval_launches"][name])

    kernels = [
        dict(name="fused_mel_power", route="cuda", source=src + "fused_mel_power.cu",
             replaces="audioyolo_tpu/ops/pallas_frontend.py:64",
             launches=counts["fused_mel_power"], train_launches=training["train_launches"],
             **paths("fused_mel_power"),
             **{k: mel["int16"][k] for k in ("max_abs_err", "ms", "stage_ms", "plain_ms",
                                              "bound_ms", "bound_by", "library_ms")}),
        dict(name="greedy_suppress_blocked", route="cuda", source=src + "interval_nms.cu",
             replaces="audioyolo_tpu/ops/pallas_nms.py:172",
             launches=counts["greedy_suppress_blocked"], **paths("greedy_suppress_blocked"),
             **nms["greedy_suppress_blocked"]),
        dict(name="greedy_suppress_unblocked", route="cuda", source=src + "interval_nms.cu",
             replaces="audioyolo_tpu/ops/pallas_nms.py:61",
             launches=counts["greedy_suppress_unblocked"], **paths("greedy_suppress_unblocked"),
             **nms["greedy_suppress_unblocked"]),
    ]
    log(json.dumps({"training": {k: v for k, v in training.items() if k != "train_launches"}}))
    log(json.dumps({"inference": {k: v for k, v in inference.items()
                                  if k not in ("infer_launches", "eval_launches")}}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

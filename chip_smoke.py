#!/usr/bin/env python3
"""Drive the PyTorch port (``audioyolo_tpu_torch``) on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. build every kernel under ``audioyolo_tpu_torch/csrc`` and the native
   audio library (one compiler per source, all started together; the host
   library's command line printed) and print the seconds taken;
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
   epoch of the shipped config through ``train_cli.run`` on the card (its
   ``compute_dtype: bfloat16``: no warning, every conv output bf16; under
   its default ``device_cache_dataset: auto`` both splits are held on the
   card, read by the native framed decode once, at the cache build) and one
   through the trainer
   directly on a float32 body (kernel 1 must launch once per training and
   evaluation forward, the 10 metrics finite, the saved model must load into
   the server); the loss must fall over 10 steps on one fixed batch; the
   frontend's features on the card against the CPU; one step at B=2 and
   dropout 0 on the card against the CPU (loss, every gradient, the
   BatchNorm buffers; TF32's reading beside the bounds), for the body on
   kernel 1's features and for the whole path from frames; the train
   step's time at B=32 (CUDA events, host framing and copy on the host
   clock, audio-s/s, peak memory, the top kernels of the forward, the
   backward and the optimizer step from profiler traces); then the bf16
   body: 10 steps on the fixed batch (the loss must fall), its step time
   against float32's in turns, its peak memory beside float32's, its top
   kernels;
7. inference and evaluation: the inference CLI (``inference_cli.main``) over
   a directory of 40 files of 20 s at 22 050 Hz (two cross-file batches) and
   2 of 60 s at 16 000 Hz (the threaded path, resampled on the card), over a
   150 s file and over one file, with one set of seeded weights saved as the
   port's ``.pt``, the JAX trainer's ``.msgpack`` and a reference
   ``.pth.tar`` (``--ref_exact``), and over the directory with ``--bf16``;
   kernels 1 and 2 must launch; 4 threads and 1 thread must give the same
   rows; the waveform and the framed directory runs under the profiler (the
   device's busy share); a subset rerun on the CPU must give the card's rows
   (a difference only where a confidence or an IoU lies within 1e-3 of its
   threshold), and its ``--bf16`` rerun the card's ``--bf16`` rows (at bf16's
   tolerances, beside the CPU's bf16 rows against float32's); the evaluator
   (``evaluate_cli.main``) on phase 6's eval split and saved model, card
   against CPU and a bf16 body against the float32 body (mAP gap bound); the
   directory's wall time and audio-s/s;
8. the native host path (``csrc/audio_io.cpp``): the framer bit-equal to
   the numpy framer on a B=32 int16 batch, the framed decode of 32 dataset
   spans bit-equal to read-then-frame, each with its host time; the framed
   batch's copy to the card from pageable and from pinned memory, and
   framing + copy as the streaming evaluator does them against the numpy
   framer + pageable copy; the waveform batch's copy as the streaming
   evaluator makes it against a plain pageable copy;
9. the bf16 body through ``make_inference_fn`` at B=32: kernels 1 and 2
   launched, its time against float32's, its top kernels; bf16 against the
   float32 body on the card (matched rows, the largest confidence gap) and
   against bf16 on the CPU at B=2 on the same features;
10. ``backbone: custom`` (block_layers [2,2,2,2]): the B=32 serving forward
    in float32 and bf16 (kernels 1 and 2 counted), card vs CPU at B=2 on the
    same features (float32 body), two bf16 train steps;
11. the int8 postures at B=32: ``int8_mm`` against the int64 product at the
    int8 paths' shapes; the int8 DFT (``frontend_precision: int8``): its int32
    accumulators card vs CPU bit for bit, its feature image card vs CPU, its
    time against kernel 1's on the same clips, the ``(q, scale)`` bytes and
    copy against the int16 frames'; the calibrated int8 body on kernel 1's
    posture (kernels 1 and 2 counted): two convs' int32 accumulators card vs
    CPU bit for bit, predictions against the float32 body, card against CPU
    on the same features and scales, forward + NMS in turns with float32 and
    bf16, its top kernels; the waveform batch's int8 transfer against int16;
    ``inference_cli.main`` with ``--int8``, ``--transfer int8`` and the
    framed int8 route over phase 7's directory (rows against the float32
    int16 rows, each miss a flip); ``evaluate_cli.main --int8`` (mAP gap
    against float32); ``serve --int8_calib`` answering one request;
12. the rest of the training path on phase 6's dataset: the device cache
    (its batches against ``BatchLoader``'s bit for bit, a bf16 epoch cached
    and uncached in turns with the bytes each copies from the host,
    ``quantize_clips_int8_device`` card = CPU bit for bit); ``train_remat``
    (one float32 and one bf16 step at B=32 with and without it: gradients
    compared, peak memory of each); ``steps_per_dispatch: 4`` as a CUDA graph
    (8 float32 and 8 bf16 steps against 8 eager steps on the same batches
    and seeds: per-step loss and the parameters after the last step, step
    time eager against graph in turns, the device's busy share of each from
    a profiler trace, kernel 1's launches per replayed step);
    ``train_cli.run(data_parallel=True)`` in a one-rank nccl group, then with
    ``steps_per_dispatch: 4`` over two epochs (the second replays);
13. the last modules of the JAX package: the serving artifact
    (``infer/export.py``) at B=32 in four entries (framed int16, the int16
    waveform, the bf16 body, the int8 body on the framed ``(q, scale)``
    entry), each exported, saved, loaded on the card and held to the live
    ``make_inference_fn`` (rows, the launches of one call, forward + NMS in
    turns), and its CPU program at B=2 to the card; a fresh process with an
    empty build directory loads and runs an artifact (the kernels built at
    the first op call, no module of ``models/`` imported);
    ``make_multi_inference_fn`` over 4 batches as one CUDA graph, float32
    and bf16 (the replay against 4 eager calls under deterministic cuDNN,
    the time per batch in turns, the busy share); ``inference_cli.main
    --workers 2`` over phase 7's directory and 150 s file against
    ``--workers 1`` (CSVs byte for byte, wall times, ``detect_regime``, the
    workers' launches from their ``ping``); SGD (nesterov) and Adagrad at
    ``steps_per_dispatch: 4`` against eager steps of their capturable form,
    and their graph step time against Adam's in turns;
14. the last modules of the JAX package's surface (needs phases 6 and 7's
    files): the server on the JAX server's command line (every flag parsed;
    the default ``--model_path``, phase 6's saved model; one 150 s request
    on the waveform path and one with ``--framed_input``, each path's rows
    against the same path on the CPU, its launches and host framer calls);
    ``train_prng: rbg`` (two steps at B=32, a second run from the same seed
    equal bit for bit under deterministic cuDNN); the int8 transfer gate
    (``gate_int8_cli``) on phase 6's model, card against ``--device cpu``,
    on phase 6's eval split and on its full-length clips with their spans
    stretched to the whole clip: the mAPs (absolute and relative gap), and
    every detection inside the audio, matched within 1e-3 s, a threshold
    flip or a twin within the gate's own tolerances (the rows over a
    zero-padded tail, where the MFCC image is rounding noise, are counted
    and not held);
    ``get_dataset_cli`` on ten 60 s files at 16 kHz,
    resampled to 22 050 Hz on the card against the CPU; phase 6 has already
    read the metric plots (written, or one warning where matplotlib is
    missing);
15. print one JSON line of every kernel's numbers (with each path's
    launches), then the device line.

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
import traceback
import urllib.request
import warnings

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
# phase 14's gate, card vs CPU: the mAP gap over the CPU's mAP. Phase 6's
# one-epoch model reads mAP@0.5 ~0.035 on its eval split, where
# MAP_GAP_BOUND is more than half the value; the card read 4.85e-2 there
# (the int16 entry). The strict check is on the rows inside the audio.
MAP_REL_GAP_BOUND = 0.1
# the bf16 body against the float32 body on the same clips (phase 9): the
# combined predictions' |diff| / max|value| at the 99th percentile; the share
# of float32 detections that find a bf16 one of their class with the center
# within BF16_ROW_TOL_S and the width within BF16_WIDTH_REL (the misses are NMS
# flips among overlapping proposals of near-equal confidence: 0.886 of 44 on
# the CPU at B=2), and the largest confidence gap of a matched pair
BF16_PRED_P99, BF16_ROW_SHARE, BF16_ROW_TOL_S, BF16_WIDTH_REL = 1e-2, 0.75, 0.05, 0.05
BF16_CONF_GAP = 0.05
# phase 7's --bf16 rows, card against the CPU's bf16 rows over the subset:
# start and end within BF16_ROW_TOL_S, a miss explained by a flip that a
# confidence or IoU difference of BF16_FLIP_TOL can make (7x the largest
# confidence gap of a matched bf16/float32 pair that phase 9 read, 2.9e-3);
# a flip may free or suppress a neighbour that is near no threshold itself,
# so up to BF16_UNEXPLAINED_SHARE of the rows may stay unexplained
BF16_FLIP_TOL, BF16_UNEXPLAINED_SHARE = 0.02, 0.05
# int8 postures (phase 11): bounds read as phase 9 reads the bf16 body. The
# int8 body against the float32 body on the card: p99 of |diff| / max|value|
# (the CPU's witness: JAX's own int8 body against its float32 body at
# tiny_cfg, 1.5e-2; an H100 80GB HBM3 at 700 W read 1.5e-2), the share of
# float32 detections with an int8 one of their class (center within
# BF16_ROW_TOL_S, width within BF16_WIDTH_REL; the H100 read 0.657) and the
# largest confidence gap of a matched pair (1.0e-2 there). The CLI's rows
# against the float32 int16 rows: each miss a flip within INT8_FLIP_TOL (a
# confidence or IoU moved by at most that much, ~5x the largest matched
# confidence gap, or the NMS cascade that follows), at most
# INT8_UNEXPLAINED_SHARE unexplained, and at least INT8_CLI_MATCHED_SHARE
# matched: the seeded model emits chains of overlapping near-equal
# proposals, so one flip reorders a chain (the H100 matched 36% of the
# --int8 rows and 53-54% of the int8 transfers', none unexplained), and a
# body wrong everywhere would match almost none. The evaluator's mAP gap
# against float32 within MAP_GAP_BOUND.
INT8_PRED_P99, INT8_ROW_SHARE, INT8_CONF_GAP = 5e-2, 0.5, 0.1
INT8_FLIP_TOL, INT8_UNEXPLAINED_SHARE, INT8_CLI_MATCHED_SHARE = 0.05, 0.05, 0.25


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
    log(f"[build] {len(logs)} libraries in {time.perf_counter() - t0:.1f} s: kernels "
        f"{build.sources()}, host {build.host_sources()}")
    for name in build.host_sources():
        log(f"[build] {name}: {' '.join(build.command(name))}")
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
                                  batch_size=BATCH, device=dev, framed_input=True)
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
    from audioyolo_tpu_torch.data.dataset import AudioDataset
    from audioyolo_tpu_torch.data.loader import BatchLoader, DeviceCachedLoader
    from audioyolo_tpu_torch.models import AudioDetectionModel
    from audioyolo_tpu_torch.models.layers import Conv2d
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
    # the shipped compute_dtype (bfloat16) trains a bf16 body, with no
    # warning; the loaders decode each batch straight into int16 frames
    # and, under the config's default device_cache_dataset (auto), each split
    # fits device_cache_max_mb: the native framed decode runs at the cache
    # build (a one-clip size probe, then the split in batches), never in the
    # epoch
    framed_reads = [0]
    load_framed = AudioDataset.load_audio_batch_framed
    caches = []
    cache_init = DeviceCachedLoader.__init__

    def counted(self, *a, **k):
        framed_reads[0] += 1
        return load_framed(self, *a, **k)

    def cache_built(self, *a, **k):
        cache_init(self, *a, **k)
        caches.append((len(self.loader.dataset), self.nbytes, framed_reads[0]))

    AudioDataset.load_audio_batch_framed = counted
    DeviceCachedLoader.__init__ = cache_built
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cli_trainer = train_cli.run(cfg, device=dev)
    finally:
        AudioDataset.load_audio_batch_framed = load_framed
        DeviceCachedLoader.__init__ = cache_init
    cli_s = time.perf_counter() - t0
    after_cli = mel_kernel.fused_mel_power.launches
    dtype_warnings = [str(w.message) for w in caught if "dtype" in str(w.message)]
    assert cfg.raw["tpu_config"]["compute_dtype"] == "bfloat16"
    assert not dtype_warnings and cli_trainer.model.dtype == torch.bfloat16, dtype_warnings
    # the metric plots: drawn where matplotlib is installed, else one warning
    plot_warnings = [str(w.message) for w in caught if "matplotlib" in str(w.message)]
    plots = sorted(f for f in os.listdir(tc["metrics_path"]) if f.endswith(".jpg"))
    try:
        import matplotlib  # noqa: F401
        want_plots, want_warnings = ["eval_metrics_plot.jpg", "train_metrics_plot.jpg"], 0
    except ImportError:
        want_plots, want_warnings = [], 1
    log(f"[training] metric plots written {plots}; matplotlib warnings {plot_warnings}")
    assert plots == want_plots and len(plot_warnings) == want_warnings, (plots, plot_warnings)
    res["plot_warnings"] = len(plot_warnings)
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
    # per split: 1 probe + ceil(n / B) batches, all before its epoch
    builds = [1 + -(-n // bs) for n, _, _ in caches]
    log(f"[training] device cache (auto): {[(n, f'{b / 1e6:.0f} MB') for n, b, _ in caches]} "
        f"(clips, bytes) resident; native framed decodes {framed_reads[0]} = probes and "
        f"cache builds {builds}, none in the epochs")
    assert [n for n, _, _ in caches] == [TRAIN_CLIPS, EVAL_CLIPS], caches
    assert framed_reads[0] == sum(builds) == caches[-1][2], (framed_reads, builds, caches)
    res["cache_mb"] = [b / 1e6 for _, b, _ in caches]
    res["train_launches"] = counts["fused_mel_power"]
    seen = set()
    hooks = [m.register_forward_hook(lambda mod, inp, out: seen.add(out.dtype))
             for m in cli_trainer.model.modules() if isinstance(m, Conv2d)]
    fz = cli_trainer.model.frontend.fused
    with torch.no_grad():
        cli_trainer.model.eval()(torch.zeros((2, fz.n_ph, fz.n_groups, fz.frame_len),
                                             dtype=torch.int16, device=dev))
    for h in hooks:
        h.remove()
    log(f"[training] train_cli.run on compute_dtype {cfg.raw['tpu_config']['compute_dtype']}: "
        f"no dtype warning, conv outputs {sorted(map(str, seen))} (forward hooks)")
    assert seen == {torch.bfloat16}, seen
    for where, m in (("cli train", cli_trainer.train_metrics[-1]),
                     ("cli eval", cli_trainer.eval_metrics[-1]), ("train", tm), ("eval", em)):
        _check_epoch_metrics(where, m)

    # the saved model (best eval loss) serves
    saved = os.path.join(tc["model_path"], "AudioDetectionModel.pt")
    state = serve.build_app_state(cfg, model_path=saved,
                                  class_map_path=os.path.join(tc["class_map_path"],
                                                              "class_map.json"),
                                  batch_size=BATCH, device=dev, framed_input=True)
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
    res.update(_bf16_steps(cfg, train_ds, batch, lambda: trainer.train_step(x, t), peak, dev,
                           card, tmp))
    return res


def _bf16_steps(cfg, train_ds, batch, f32_step, f32_peak, dev, card, tmp):
    """The bf16 body (the shipped ``compute_dtype``) through the trainer:
    the loss must fall over 10 steps on the fixed B=32 batch; its step time
    against the float32 step's (``f32_step``), timed in turns since the
    host's speed drifts, its peak memory and its top kernels."""
    import torch

    from audioyolo_tpu_torch import train_cli
    from audioyolo_tpu_torch.models import AudioDetectionModel
    from audioyolo_tpu_torch.train import TrainerPipeline

    tc = cfg.raw["train_config"]
    model = AudioDetectionModel.from_config(cfg, 2, generator=torch.Generator().manual_seed(1),
                                            dtype=torch.bfloat16)
    trainer = TrainerPipeline(model, train_cli.make_loss(cfg, 2, train_ds.get_class_weights()),
                              tc["optimizer_config"], tc["lr_scheduler_config"],
                              model_path=os.path.join(tmp, "direct_bf16"), device=dev)
    x, t = trainer.put_batch(batch)
    losses = torch.stack([trainer.train_step(x, t) for _ in range(10)])[:, 0].tolist()
    log(f"[training bf16] 10 steps on the fixed B={BATCH} batch: aggregate loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f} ({', '.join(f'{v:.4f}' for v in losses)})")
    assert losses[-1] < losses[0], losses
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.train_step(x, t)
    peak = torch.cuda.max_memory_allocated(dev)
    turns = {"f32": [], "bf16": []}
    for name, fn in (("f32", f32_step), ("bf16", lambda: trainer.train_step(x, t))) * 3:
        turns[name].append(time_ms(fn, iters=10, warmup=2))
    step_ms, f32_step_ms = min(turns["bf16"]), min(turns["f32"])
    trainer.optimizer.zero_grad(set_to_none=True)
    (loss, _), fwd, fwd_ms = _profiled(lambda: trainer.loss_fn(model(x, generator=trainer.generator), t))
    _, bwd, bwd_ms = _profiled(loss.backward)
    log(f"[training bf16 B={BATCH}] train step {step_ms:.3f} ms on CUDA events against "
        f"float32's {f32_step_ms:.3f} (the least of three turns of 10 steps each: bf16 "
        f"{', '.join(f'{v:.3f}' for v in turns['bf16'])}, float32 "
        f"{', '.join(f'{v:.3f}' for v in turns['f32'])}), "
        f"{BATCH * cfg.sample_duration / step_ms * 1e3:.0f} training "
        f"audio-s/s device-side; peak memory {peak / 2**30:.2f} GiB (float32 {f32_peak / 2**30:.2f}); "
        f"kernels forward+loss {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms (profiler on) [{card}]")
    for name, rows in (("forward+loss", fwd), ("backward", bwd)):
        for ms, count, key in rows[:6]:
            log(f"[training bf16 B={BATCH}] {name} {ms:8.3f} ms  x{count:<4d} {key[:80]}")
    return dict(bf16_loss_first=losses[0], bf16_loss_last=losses[-1], bf16_step_ms=step_ms,
                f32_step_turns_ms=turns["f32"], bf16_step_turns_ms=turns["bf16"],
                bf16_peak_gib=peak / 2**30, bf16_forward_kernels_ms=fwd_ms,
                bf16_backward_kernels_ms=bwd_ms)


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


def _compare_rows(card, cpu, conf_thr, iou_thr, tol=1e-3, flip_tol=None, cascade=False):
    """Card rows against CPU rows of one file: each card row is matched to an
    unmatched CPU row of the same class whose start and end lie within
    ``tol`` s. An unmatched row is explained by a flip that a difference of
    ``flip_tol`` (default ``tol``) in a confidence or an IoU can make: its
    confidence lies within ``flip_tol`` of ``conf_thr`` (the confidence
    filter), its IoU with another row of either side within ``flip_tol`` of
    ``iou_thr`` (a suppression), or a row of the other side of its class
    overlaps it past ``iou_thr`` with a confidence within ``flip_tol`` (the
    NMS took the two in the other order). With ``cascade``, a row that
    overlaps an explained row of its class past ``iou_thr`` is explained too
    (the greedy NMS's cascade: the flipped row suppressed or freed it).
    Returns (matched, explained, unexplained rows, max |time diff| and max
    |confidence diff| over the matched pairs)."""
    flip_tol = tol if flip_tol is None else flip_tol
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

    def swapped(r):
        other = cpu if any(r is q for q in card) else card
        return any(q["class_idx"] == r["class_idx"] and _iou(q, r) > iou_thr
                   and abs(q["confidence"] - r["confidence"]) <= flip_tol for q in other)

    explained = [r for r in unmatched if abs(r["confidence"] - conf_thr) <= flip_tol
                 or any(q is not r and abs(_iou(q, r) - iou_thr) <= flip_tol for q in everyone)
                 or swapped(r)]
    unexplained = [r for r in unmatched if not any(r is q for q in explained)]
    grown = cascade
    while grown:
        more = [r for r in unexplained if any(q["class_idx"] == r["class_idx"]
                                              and _iou(q, r) > iou_thr for q in explained)]
        explained += more
        unexplained = [r for r in unexplained if not any(r is q for q in more)]
        grown = bool(more)
    return matched, len(explained), unexplained, dt, dc


def phase_inference(dev, card, train_tmp):
    """Phase 7: the inference CLI over a directory and single files in every
    checkpoint format, card against CPU, threads against one thread, and the
    evaluator on phase 6's eval split and saved model."""
    import functools
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
        walls["dir_bf16"] = cli("dir_bf16", "--model_path", weights[".pt"], "--audio_dir",
                                audio_dir, "--num_concurrency", "4", "--bf16")
        busy = {}
        for run, extra in (("dir_profiled", ["--framed_input"]), ("dir_profiled_wave", [])):
            t = time.perf_counter()
            _, _, busy_ms = _profiled(lambda: cli(run, "--model_path", weights[".pt"],
                                                  "--audio_dir", audio_dir, *extra))
            busy[run] = (busy_ms, time.perf_counter() - t)
            log(f"[inference] the {'framed' if extra else 'waveform'} directory run under the "
                f"profiler: {busy_ms:.1f} ms of kernels in {busy[run][1] * 1e3:.0f} ms wall, the "
                f"device busy {busy_ms / busy[run][1] / 1e3:.1%} of the run (model build "
                f"included) [{card}]")
        busy_ms, prof_wall = busy["dir_profiled"]
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
        for run in ("dir", "dir_framed", "dir_serial", "dir_bf16"):
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
        for run in ("dir", "dir_framed", "dir_serial", "dir_bf16"):
            assert sum(1 for (r, _) in rec.rows if r == run) == n_dir, run
        assert all(rec.rows[("dir", n)] == rec.rows[("dir_serial", n)] for n in durations
                   if n != "long150.wav"), "rows of 4 threads differ from one thread's"
        n_rows = sum(len(rec.rows[("dir", n)]) for n in durations if n != "long150.wav")
        log(f"[inference] threaded path at num_concurrency 4 and 1: the same {n_rows} rows in "
            f"{n_dir} files (the 16 kHz files ran on the threads)")
        # --bf16 beside the float32 body's rows over the directory (the
        # card's bf16 rows are held to the CPU's below)
        names = [n for n in durations if n != "long150.wav"]
        n_f32 = sum(len(rec.rows[("dir", n)]) for n in names)
        n_bf = sum(len(rec.rows[("dir_bf16", n)]) for n in names)
        log(f"[inference] --bf16 over the directory: {n_bf} rows in {n_dir} files against the "
            f"float32 body's {n_f32}")
        assert n_bf > 0

        # the card against the CPU, before CSV rounding
        t = time.perf_counter()
        cli("cpu_sub", "--model_path", weights[".pt"], "--audio_dir", sub_dir, "--batch_size", "2",
            device="cpu")
        cli("cpu_long", "--model_path", weights[".msgpack"], "--audio_filepath", long_path,
            "--framed_input", "--batch_size", "2", device="cpu")
        cpu_s = time.perf_counter() - t
        t = time.perf_counter()
        cli("cpu_sub_bf16", "--model_path", weights[".pt"], "--audio_dir", sub_dir,
            "--batch_size", "2", "--bf16", device="cpu")
        cpu_bf16_s = time.perf_counter() - t
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

    # --bf16 on the card against --bf16 on the CPU over the subset, at bf16's
    # tolerances; beside it, what bf16 rounding alone does to the same rows:
    # the CPU's bf16 rows against the float32 rows (card = CPU, above)
    def bf16_rows(a, b):
        tot = dict(matched=0, explained=0, unexplained=0, rows=0)
        for n in sorted(os.listdir(sub_dir)):
            m, e, bad, _, _ = _compare_rows(rec.rows[(a, n)], rec.rows[(b, n)], conf_thr,
                                            iou_thr, tol=BF16_ROW_TOL_S, flip_tol=BF16_FLIP_TOL)
            for k, v in (("matched", m), ("explained", e), ("unexplained", len(bad)),
                         ("rows", max(len(rec.rows[(a, n)]), len(rec.rows[(b, n)])))):
                tot[k] += v
        return tot

    bf, yard = bf16_rows("dir_bf16", "cpu_sub_bf16"), bf16_rows("cpu_sub_bf16", "dir")
    log(f"[inference] --bf16 card vs --bf16 CPU rows over the {len(os.listdir(sub_dir))}-file "
        f"subset: {bf['matched']}/{bf['rows']} matched (start and end within {BF16_ROW_TOL_S} s), "
        f"{bf['explained']} explained by a flip within {BF16_FLIP_TOL}, {bf['unexplained']} "
        f"unexplained (bound {BF16_UNEXPLAINED_SHARE:.0%} of the rows); the CPU's bf16 rows "
        f"against the float32 rows read {yard['matched']}/{yard['rows']} matched, "
        f"{yard['explained']} explained, {yard['unexplained']} unexplained (CPU bf16 run "
        f"{cpu_bf16_s:.1f} s)")
    assert bf["rows"] > 0 and bf["unexplained"] <= BF16_UNEXPLAINED_SHARE * bf["rows"], bf

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
    # the evaluator on a bf16 body (evaluate_cli has no --bf16, as the JAX
    # evaluate_model.py has none: its model builder is given the dtype here)
    build_f32 = evaluate_cli.build_inference
    evaluate_cli.build_inference = functools.partial(build_f32, dtype=torch.bfloat16)
    try:
        on_card_bf16 = evaluate_cli.main(eval_args + ["--device", dev.type])
    finally:
        evaluate_cli.build_inference = build_f32
    gaps = {k: abs(on_card[k] - on_cpu[k]) for k in on_card if k.startswith("mAP")}
    gaps_bf16 = {k: abs(on_card_bf16[k] - on_card[k]) for k in gaps}
    log(f"[evaluation] bf16 body on the card: {json.dumps(on_card_bf16)}; largest mAP gap "
        f"against the float32 body {max(gaps_bf16.values()):.3e} (bound {MAP_GAP_BOUND})")
    assert max(gaps_bf16.values()) <= MAP_GAP_BOUND, gaps_bf16
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
               map_card=on_card["mAP@0.5"], map_cpu=on_cpu["mAP@0.5"],
               dir_bf16_wall_s=walls["dir_bf16"], dir_bf16_rows=n_bf,
               dir_profiled_wave_busy_ms=busy["dir_profiled_wave"][0],
               dir_profiled_wave_wall_s=busy["dir_profiled_wave"][1],
               map_card_bf16=on_card_bf16["mAP@0.5"], map_gap_bf16=max(gaps_bf16.values()),
               bf16_card_cpu_rows=bf, bf16_cpu_f32_rows=yard)
    return res


def _host_ms(fn, reps=5):
    """Median host milliseconds of ``fn()`` (which synchronizes itself)."""
    import statistics

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_native(dev, card, train_tmp):
    """Phase 8: the native host path (``csrc/audio_io.cpp``) on this
    machine's CPU, bit for bit against the numpy path, with its times and
    the pinned copy's."""
    import numpy as np
    import torch

    from audioyolo_tpu_torch import train_cli
    from audioyolo_tpu_torch.data import native
    from audioyolo_tpu_torch.data.wavio import read_wav
    from audioyolo_tpu_torch.infer.streaming import _frames_to_device, _to_device
    from audioyolo_tpu_torch.ops.frontend import SpectralFrontend

    cfg = _train_config(train_tmp)
    fe = SpectralFrontend(cfg)
    framer = fe.fused
    log(f"[native] library {native.library()._name}")
    rng = np.random.default_rng(4)
    clips = np.clip(rng.standard_normal((BATCH, cfg.clip_samples)) * 3000, -32768,
                    32767).astype(np.int16)
    framed = native.frame_i16(clips, framer)
    assert np.array_equal(framed, framer.frame_numpy(clips)), "native framing differs from numpy"
    native_ms = _host_ms(lambda: native.frame_i16(clips, framer))
    numpy_ms = _host_ms(lambda: framer.frame_numpy(clips), reps=3)
    log(f"[native] frame_i16 of a B={BATCH} int16 batch {clips.shape} -> {framed.shape}: "
        f"bit-equal to the numpy framer; {native_ms:.2f} ms native (2 threads), {numpy_ms:.2f} ms "
        f"numpy (host clock, median) [{card}]")

    train_ds, _ = train_cli.resolve_datasets(cfg)
    spans = [train_ds.audio_span(i) for i in range(BATCH)]
    paths, offs, counts = ([sp[k] for sp in spans] for k in range(3))
    got = native.load_batch_framed_i16(paths, offs, counts, cfg.clip_samples, framer)
    ref = []
    for path, off, count in spans:
        audio, _ = read_wav(path, frame_offset=off, num_frames=min(count, cfg.clip_samples))
        mono = audio.mean(axis=0) if audio.shape[0] != 1 else audio[0]
        q = np.clip(np.round(mono * 32768.0), -32768, 32767).astype(np.int16)
        ref.append(np.pad(q, (0, cfg.clip_samples - q.shape[0])))
    assert np.array_equal(got, framer.frame_numpy(np.stack(ref))), "framed decode differs"
    load_ms = _host_ms(lambda: native.load_batch_framed_i16(paths, offs, counts,
                                                            cfg.clip_samples, framer))
    log(f"[native] load_batch_framed_i16 of {BATCH} dataset spans (60 s PCM16 files): bit-equal "
        f"to read-then-frame; {load_ms:.2f} ms (4 threads, page cache warm) [{card}]")

    def pageable():
        torch.from_numpy(framed).to(dev)
        torch.cuda.synchronize()

    host = torch.from_numpy(framed).pin_memory()

    def pinned():
        host.to(dev, non_blocking=True)
        torch.cuda.synchronize()

    def streaming_path():  # what infer/streaming.py does per batch: frame into pinned, copy
        _frames_to_device(fe.frame_host, clips, dev)
        torch.cuda.synchronize()

    def old_path():  # the numpy framer, then a pageable copy
        torch.from_numpy(framer.frame_numpy(clips)).to(dev)
        torch.cuda.synchronize()

    pageable_ms, pinned_ms = _host_ms(pageable), _host_ms(pinned)
    stream_ms, old_ms = _host_ms(streaming_path), _host_ms(old_path, reps=3)
    mb = framed.nbytes / 1e6
    log(f"[native] host -> device of the framed batch ({mb:.0f} MB int16): pageable "
        f"{pageable_ms:.2f} ms ({mb / pageable_ms:.1f} GB/s), pinned non_blocking {pinned_ms:.2f} "
        f"ms ({mb / pinned_ms:.1f} GB/s); native framing into a fresh pinned tensor + copy "
        f"{stream_ms:.2f} ms against numpy framing + pageable copy {old_ms:.2f} ms (host clock, "
        f"median) [{card}]")

    # the waveform path's batch (B, 1, clip) int16: what streaming's _to_device
    # does against a plain pageable copy, in turns, the later of two each
    wave = clips[:, None, :]

    def wave_streaming():
        _to_device(wave, dev)
        torch.cuda.synchronize()

    def wave_pageable():
        torch.from_numpy(wave).to(dev)
        torch.cuda.synchronize()

    wave_ms = {}
    for name, fn in (("streaming", wave_streaming), ("pageable", wave_pageable)) * 2:
        wave_ms[name] = _host_ms(fn, reps=7)
    log(f"[native] host -> device of the waveform batch ({wave.nbytes / 1e6:.0f} MB int16): "
        f"streaming _to_device {wave_ms['streaming']:.2f} ms, plain pageable copy "
        f"{wave_ms['pageable']:.2f} ms (host clock, median of 7, the later of two turns) [{card}]")
    return dict(frame_native_ms=native_ms, frame_numpy_ms=numpy_ms, load_framed_ms=load_ms,
                h2d_pageable_ms=pageable_ms, h2d_pinned_ms=pinned_ms,
                frame_and_copy_ms=stream_ms, frame_and_copy_old_ms=old_ms,
                wave_h2d_streaming_ms=wave_ms["streaming"], wave_h2d_pageable_ms=wave_ms["pageable"])


def _rel_gap(a, ref):
    """(median, 99th percentile) of |a - ref| / max|ref|, in float64."""
    import torch

    d = (a.double() - ref.double()).abs().flatten() / ref.double().abs().max()
    return d.median().item(), torch.quantile(d, 0.99).item()


def _packed_rows(packed):
    """Valid rows of a packed (B, K, 6) tensor: per clip (conf, cls, center, width)."""
    out = []
    for clip in packed.cpu().numpy():
        out.append([(float(r[0]), int(r[2]), float(r[3]), float(r[4])) for r in clip if r[5] > 0.5])
    return out


def phase_bf16_serving(dev, card):
    """Phase 9: the bf16 body through ``make_inference_fn`` at B=32, against
    the float32 body on the card and against bf16 on the CPU."""
    import numpy as np
    import torch

    from audioyolo_tpu_torch.infer import make_inference_fn
    from audioyolo_tpu_torch.models import AudioDetectionModel, fold_repvgg
    from audioyolo_tpu_torch.ops import mel_kernel, nms_kernel

    cfg = _serving_config()
    gen = torch.Generator().manual_seed(0)
    sd = fold_repvgg(_randomize_bn(AudioDetectionModel.from_config(cfg, 2, generator=gen)
                                   .state_dict(), gen))
    fns = {name: make_inference_fn(AudioDetectionModel.from_config(cfg, 2, deploy=True,
                                                                   dtype=dt), sd, device=dev)
           for name, dt in (("f32", None), ("bf16", torch.bfloat16))}
    fe = fns["bf16"].model.frontend
    clips = np.stack([_unpadded_clip(cfg, 20 + i) for i in range(BATCH)])
    x = torch.from_numpy(fe.frame_host(clips)).to(dev)
    fns["bf16"](x)  # warm-up
    torch.cuda.synchronize()
    counters = (mel_kernel.fused_mel_power, nms_kernel.greedy_suppress_blocked)
    for c in counters:
        c.launches = 0
    packed = {"bf16": fns["bf16"](x)}
    torch.cuda.synchronize()
    counts = {c.__name__: c.launches for c in counters}
    assert all(v == 1 for v in counts.values()), counts
    packed["f32"] = fns["f32"](x)
    ms = {k: time_ms(lambda k=k: fns[k](x), iters=10) for k in ("f32", "bf16", "f32", "bf16")}
    _, rows, kern_ms = _profiled(lambda: fns["bf16"](x))
    log(f"[bf16 serving B={BATCH}] forward+NMS {ms['bf16']:.3f} ms on CUDA events against "
        f"float32's {ms['f32']:.3f} ms (each the later of two timings); "
        f"{BATCH * cfg.sample_duration / ms['bf16'] * 1e3:.0f} audio-s/s device-side; "
        f"{kern_ms:.3f} ms of kernels (profiler on); launches {counts} [{card}]")
    for kms, count, key in rows[:10]:
        log(f"[bf16 serving]   {kms:8.3f} ms  x{count:<4d} {key[:90]}")

    # bf16 against float32 on the card, over the same clips
    with torch.inference_mode():
        p = {k: fns[k].model(x, combine_scales=True).float().cpu() for k in fns}
    gap_card = _rel_gap(p["bf16"], p["f32"])
    rows = {k: _packed_rows(packed[k]) for k in packed}
    n_f32 = sum(map(len, rows["f32"]))
    hit, conf_gap = 0, 0.0
    for a, b in zip(rows["f32"], rows["bf16"]):
        for conf, cls, c, w in a:
            m = [q for q in b if q[1] == cls and abs(q[2] - c) <= BF16_ROW_TOL_S
                 and abs(q[3] - w) <= BF16_WIDTH_REL * w]
            if m:
                hit += 1
                conf_gap = max(conf_gap, min(abs(q[0] - conf) for q in m))
    share = hit / max(n_f32, 1)
    log(f"[bf16 serving] bf16 vs float32 on the card, {BATCH} clips: predictions |diff| / "
        f"max|value| median {gap_card[0]:.3e}, p99 {gap_card[1]:.3e} (bound {BF16_PRED_P99}); "
        f"{hit} of {n_f32} float32 detections ({share:.4f}, bound {BF16_ROW_SHARE}) have a bf16 "
        f"one of their class, center within {BF16_ROW_TOL_S} s, width within "
        f"{BF16_WIDTH_REL:.0%}; largest confidence gap {conf_gap:.3e} (bound {BF16_CONF_GAP})")
    assert gap_card[1] <= BF16_PRED_P99, gap_card
    assert n_f32 > 0 and share >= BF16_ROW_SHARE and conf_gap <= BF16_CONF_GAP, (share, conf_gap)

    # bf16 on the card against bf16 on the CPU, B=2, on the same features
    cpu_model = AudioDetectionModel.from_config(cfg, 2, deploy=True, dtype=torch.bfloat16)
    cpu_model.load_state_dict(sd)
    cpu_model.eval()
    with torch.inference_mode():
        feats = fns["bf16"].model.frontend(x[:2]).cpu()
        t0 = time.perf_counter()
        b_cpu = cpu_model(features=feats, combine_scales=True)
        cpu_s = time.perf_counter() - t0
        b_card = fns["bf16"].model(features=feats.to(dev), combine_scales=True).cpu()
        f_card = fns["f32"].model(features=feats.to(dev), combine_scales=True).cpu()
    gap_cpu, yard = _rel_gap(b_card, b_cpu), _rel_gap(b_card, f_card)
    log(f"[bf16 serving] bf16 card vs bf16 CPU, B=2, same features: median {gap_cpu[0]:.3e}, "
        f"p99 {gap_cpu[1]:.3e}; bound 2x the card's bf16-vs-float32 gap on them (median "
        f"{yard[0]:.3e}, p99 {yard[1]:.3e}); CPU forward {cpu_s:.1f} s")
    assert torch.isfinite(b_card).all() and b_card.shape == (2, cfg.total_proposals, 5)
    assert gap_cpu[0] <= 2 * yard[0] and gap_cpu[1] <= 2 * yard[1], (gap_cpu, yard)
    return dict(launches=counts, forward_ms=ms["bf16"], f32_forward_ms=ms["f32"],
                kernels_ms=kern_ms, gap_card_p99=gap_card[1], row_share=share,
                conf_gap=conf_gap, gap_cpu_p99=gap_cpu[1])


def phase_custom(dev, card, train_tmp):
    """Phase 10: ``backbone: custom`` at the shipped widths, block_layers
    [2,2,2,2]: the B=32 serving forward (kernels 1 and 2 counted), card vs
    CPU at B=2 (float32 body, same features), two train steps on the
    shipped bf16 body."""
    import numpy as np
    import torch

    from audioyolo_tpu_torch import train_cli
    from audioyolo_tpu_torch.config import Config
    from audioyolo_tpu_torch.data.loader import BatchLoader
    from audioyolo_tpu_torch.infer import make_inference_fn
    from audioyolo_tpu_torch.models import AudioDetectionModel, fold_repvgg
    from audioyolo_tpu_torch.ops import mel_kernel, nms_kernel
    from audioyolo_tpu_torch.train import TrainerPipeline

    raw = _train_config(train_tmp).to_dict()
    raw.update(backbone="custom", block_layers=[2, 2, 2, 2])
    cfg = Config(raw)
    gen = torch.Generator().manual_seed(2)
    sd = _randomize_bn(AudioDetectionModel.from_config(cfg, 2, generator=gen).state_dict(), gen)
    folded = fold_repvgg(sd)
    fns = {name: make_inference_fn(AudioDetectionModel.from_config(cfg, 2, deploy=True,
                                                                   dtype=dt), folded, device=dev)
           for name, dt in (("f32", None), ("bf16", torch.bfloat16))}
    fe = fns["f32"].model.frontend
    clips = np.stack([_unpadded_clip(cfg, 40 + i) for i in range(BATCH)])
    x = torch.from_numpy(fe.frame_host(clips)).to(dev)
    for fn in fns.values():
        fn(x)  # warm-up
    torch.cuda.synchronize()
    counters = (mel_kernel.fused_mel_power, nms_kernel.greedy_suppress_blocked)
    for c in counters:
        c.launches = 0
    outs = {k: fn(x) for k, fn in fns.items()}
    torch.cuda.synchronize()
    counts = {c.__name__: c.launches for c in counters}
    assert all(v == 2 for v in counts.values()), counts
    assert all(torch.isfinite(o).all() for o in outs.values())
    ms = {k: time_ms(lambda k=k: fns[k](x), iters=5) for k in fns}
    log(f"[custom B={BATCH}] serving forward+NMS float32 {ms['f32']:.3f} ms, bf16 "
        f"{ms['bf16']:.3f} ms on CUDA events; launches over the two forwards {counts} [{card}]")

    cpu_model = AudioDetectionModel.from_config(cfg, 2, deploy=True)
    cpu_model.load_state_dict(folded)
    cpu_model.eval()
    with torch.inference_mode():
        feats = fe(x[:2]).cpu()
        t0 = time.perf_counter()
        p_cpu = cpu_model(features=feats, combine_scales=True)
        cpu_s = time.perf_counter() - t0
        p_card = fns["f32"].model(features=feats.to(dev), combine_scales=True).cpu()
    d = ((p_card - p_cpu).abs().max() / p_cpu.abs().max()).item()
    log(f"[custom] card vs CPU, B=2, float32 body on the same features: max |diff| / max "
        f"|value| {d:.3e} (bound {BODY_REL_BOUND}); CPU forward {cpu_s:.1f} s")
    assert p_card.shape == (2, cfg.total_proposals, 5) and d < BODY_REL_BOUND, d

    train_ds, _ = train_cli.resolve_datasets(cfg)
    model = AudioDetectionModel.from_config(cfg, 2, generator=torch.Generator().manual_seed(3),
                                            dtype=train_cli.compute_dtype(raw["tpu_config"]))
    tc = raw["train_config"]
    trainer = TrainerPipeline(model, train_cli.make_loss(cfg, 2, train_ds.get_class_weights()),
                              tc["optimizer_config"], tc["lr_scheduler_config"],
                              model_path=os.path.join(train_tmp, "custom"), device=dev)
    batch = next(iter(BatchLoader(train_ds, BATCH, shuffle=False, prefetch=0,
                                  transfer_dtype="int16", framer=fe.fused)))
    xb, tb = trainer.put_batch(batch)
    mel_kernel.fused_mel_power.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    losses = [trainer.train_step(xb, tb)[0].item() for _ in range(2)]
    step_s = (time.perf_counter() - t0) / 2
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[custom] two bf16 train steps at B={BATCH}: aggregate loss {losses}, "
        f"{step_s * 1e3:.1f} ms a step (host clock, the first includes cuDNN's set-up), peak "
        f"memory {peak / 2**30:.2f} GiB; kernel 1 launches {mel_kernel.fused_mel_power.launches} "
        f"[{card}]")
    assert all(np.isfinite(losses)) and mel_kernel.fused_mel_power.launches == 2
    return dict(launches=counts, f32_forward_ms=ms["f32"], bf16_forward_ms=ms["bf16"],
                card_cpu_rel=d, train_losses=losses, train_peak_gib=peak / 2**30)


def _int8_acc(q, c_i8):
    """The int8 DFT's int32 accumulators (B, R, G, N) of ``FusedFrameDFT.
    power_int8``, kept whole for a bit-for-bit comparison."""
    import torch
    import torch.nn.functional as F

    from audioyolo_tpu_torch.ops.int8 import int8_mm

    b, r, g, f = q.shape
    kp = c_i8.shape[1]
    qp = F.pad(q, (0, kp - f))
    return torch.stack([int8_mm(qp[:, i].reshape(b * g, kp), c_i8[i]).reshape(b, g, -1)
                        for i in range(r)], dim=1)


def _conv_acc_pair(conv, x):
    """One int8 conv on the card's input ``x``: its int32 accumulator and its
    output, on the card and on the CPU from the same input, ``s_x`` and
    kernel (the H=1 middle-row slice as ``layers._int8_conv`` takes it)."""
    import torch

    from audioyolo_tpu_torch.models.layers import _int8_conv, int8_conv_acc

    w = conv.conv.weight
    xq = torch.clamp(torch.round(x.float() / conv.s_x), -127, 127).to(torch.int8)
    kh, ph = w.shape[2], conv.padding[0]
    wk, pad = ((w[:, :, ph:ph + 1], (0, conv.padding[1])) if x.shape[2] == 1 and kh > 1
               else (w, conv.padding))
    s_w = torch.clamp_min(wk.abs().amax(dim=(1, 2, 3)), 1e-12) / 127.0
    wq = torch.clamp(torch.round(wk / s_w.view(-1, 1, 1, 1)), -127, 127).to(torch.int8)
    a_card = int8_conv_acc(xq, wq, conv.stride, pad).cpu()
    a_cpu = int8_conv_acc(xq.cpu(), wq.cpu(), conv.stride, pad)
    y_card = _int8_conv(x, w, conv.conv.bias, conv.s_x, conv.stride, conv.padding).cpu()
    b = conv.conv.bias
    y_cpu = _int8_conv(x.cpu(), w.cpu(), None if b is None else b.cpu(), conv.s_x.cpu(),
                       conv.stride, conv.padding)
    return a_card, a_cpu, y_card, y_cpu


def phase_int8(dev, card, train_tmp):
    """Phase 11: the int8 postures at full width, B=32, on seeded weights:
    the int8 DFT (``frontend_precision: int8``), the calibrated int8 body on
    kernel 1's posture, ``inference_cli.main --int8`` and ``--transfer int8``
    over phase 7's directory, ``evaluate_cli.main --int8`` and ``serve
    --int8_calib``. Kernels 1 and 2 are counted over the whole phase."""
    import shutil

    import numpy as np
    import torch
    import yaml

    from audioyolo_tpu_torch import evaluate_cli, inference_cli, serve
    from audioyolo_tpu_torch.config import Config, load_config
    from audioyolo_tpu_torch.infer import make_inference_fn
    from audioyolo_tpu_torch.infer.streaming import _int8_to_device, _to_device
    from audioyolo_tpu_torch.models import AudioDetectionModel, fold_repvgg
    from audioyolo_tpu_torch.models.layers import Conv2d
    from audioyolo_tpu_torch.models.quant import calibrate_quant, set_quant
    from audioyolo_tpu_torch.ops import mel_kernel, nms_kernel
    from audioyolo_tpu_torch.ops.frontend import SpectralFrontend
    from audioyolo_tpu_torch.ops.int8 import int8_mm, int8_mm_plain

    counters = (mel_kernel.fused_mel_power, nms_kernel.greedy_suppress_blocked,
                nms_kernel.greedy_suppress_unblocked)
    checks = []  # (what, holds): every reading is logged before any is asserted

    # the int8 GEMM on the card at the shapes the int8 paths give it
    rng = np.random.default_rng(11)
    for m, k, n in ((10, 45, 15), (3840, 1784, 1008), (7680, 1152, 128), (17, 8, 8), (33, 7, 9)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
        same = torch.equal(int8_mm(a.to(dev), b.to(dev)).cpu(), int8_mm_plain(a, b))
        checks.append((f"int8_mm ({m}, {k}) x ({k}, {n}) on the card == the int64 product", same))
    log(f"[int8] int8_mm against the int64 product on the card: "
        f"{all(h for w, h in checks)} for (10,45,15), (3840,1784,1008), (7680,1152,128), "
        f"(17,8,8), (33,7,9)")

    # A. the int8 DFT
    cfg = _serving_config()
    raw8 = cfg.to_dict()
    raw8["tpu_config"]["frontend_precision"] = "int8"
    cfg8 = Config(raw8)
    fe = SpectralFrontend(cfg).to(dev)
    fe8 = SpectralFrontend(cfg8).to(dev)
    clips = np.stack([_unpadded_clip(cfg, 40 + i) for i in range(BATCH)])
    t0 = time.perf_counter()
    q, s = fe8.frame_host_int8(clips)
    quant_host_ms = (time.perf_counter() - t0) * 1e3
    frames = fe.frame_host(clips)
    qd, sd_, fd = (torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev),
                   torch.from_numpy(frames).to(dev))
    with torch.inference_mode():
        acc_card = _int8_acc(qd[:2], fe8.fused_c_i8).cpu()
        acc_cpu = _int8_acc(torch.from_numpy(q[:2]), fe8.fused_c_i8.cpu())
        checks.append(("int8 DFT accumulators card == CPU (2 clips)",
                       torch.equal(acc_card, acc_cpu)))
        img_card = fe8((qd[:2], sd_[:2])).cpu()
        fe8_cpu = SpectralFrontend(cfg8)
        img_cpu = fe8_cpu((torch.from_numpy(q[:2]), torch.from_numpy(s[:2])))
        raw32 = cfg.to_dict()
        raw32["tpu_config"]["frontend_precision"] = "highest"
        img_f32 = SpectralFrontend(Config(raw32))(torch.from_numpy(frames[:2]))
    d = (img_card - img_cpu).abs()
    mel_rel = (d[..., 0].max() / img_cpu[..., 0].abs().max()).item()
    mfcc_share = (d[..., 1] > 1e-3).float().mean().item()
    d32 = (img_card - img_f32).abs()
    log(f"[int8] int8 DFT accumulators (2 clips, {tuple(acc_card.shape)} int32) card vs CPU: "
        f"{'bit-equal' if torch.equal(acc_card, acc_cpu) else 'DIFFER'}; feature image card vs "
        f"CPU: log-mel max |diff| / max {mel_rel:.3e} (bound {FEATURE_MEL_REL_BOUND}), MFCC "
        f"pixels off by > 1e-3 {mfcc_share:.2e} (bound {FEATURE_MFCC_SHARE_BOUND}); against the "
        f"float32 frontend on the int16 frames: log-mel mean |diff| {d32[..., 0].mean():.3e}, "
        f"max {d32[..., 0].max():.3e}")
    checks.append(("int8 image card vs CPU, log-mel", mel_rel <= FEATURE_MEL_REL_BOUND))
    checks.append(("int8 image card vs CPU, MFCC share", mfcc_share <= FEATURE_MFCC_SHARE_BOUND))

    with torch.inference_mode():
        dft_ms = {}
        for k in ("int8", "kernel1", "int8", "kernel1"):
            dft_ms[k] = time_ms(lambda: fe8._fused_int8_mel(qd, sd_) if k == "int8"
                                else fe.fused_kernel(fd), iters=10)
        _, rows8, k8_ms = _profiled(lambda: fe8._fused_int8_mel(qd, sd_))
    log(f"[int8] B={BATCH} DFT -> power -> mel: int8 DFT (8 x _int_mm + power + bf16 mel "
        f"product) {dft_ms['int8']:.3f} ms against kernel 1 {dft_ms['kernel1']:.3f} ms on the "
        f"same clips (CUDA events, the later of two turns); {k8_ms:.3f} ms of kernels [{card}]")
    for kms, count, key in rows8[:6]:
        log(f"[int8]   {kms:8.3f} ms  x{count:<4d} {key[:90]}")

    def copy_ms(arrays):
        hosts = [torch.from_numpy(a).pin_memory() for a in arrays]

        def run():
            for h in hosts:
                h.to(dev, non_blocking=True)
            torch.cuda.synchronize()
        return _host_ms(run, reps=7)

    framed_ms = {"q_scale": copy_ms([q, s]), "int16": copy_ms([frames])}
    log(f"[int8] framed host -> device, pinned: (q, scale) {q.nbytes / 1e6:.1f} + {s.nbytes} B "
        f"in {framed_ms['q_scale']:.2f} ms against the int16 frames' {frames.nbytes / 1e6:.1f} MB "
        f"in {framed_ms['int16']:.2f} ms; frame_host_int8 on the host {quant_host_ms:.0f} ms "
        f"(host clock) [{card}]")

    # B. the calibrated int8 body on kernel 1's posture; from here on the
    # phase drives the int8 paths, and the kernels' launches are counted
    for c in counters:
        c.launches = 0
    gen = torch.Generator().manual_seed(0)
    sd = fold_repvgg(_randomize_bn(AudioDetectionModel.from_config(cfg, 2, generator=gen)
                                   .state_dict(), gen))
    fns = {name: make_inference_fn(AudioDetectionModel.from_config(cfg, 2, deploy=True,
                                                                   dtype=dt), sd, device=dev)
           for name, dt in (("f32", None), ("bf16", torch.bfloat16), ("int8", None))}
    body = fns["int8"].model
    with torch.inference_mode():
        scales = calibrate_quant(body, [fd[:4]])
    set_quant(body, scales)
    n_q = sum(m.s_x is not None for m in body.modules() if isinstance(m, Conv2d))
    fns["int8"](fd)  # warm-up
    torch.cuda.synchronize()
    before = {c.__name__: c.launches for c in counters}
    packed = {"int8": fns["int8"](fd)}
    torch.cuda.synchronize()
    one_fwd = {c.__name__: c.launches - before[c.__name__] for c in counters}
    checks.append(("int8 body forward launches kernels 1 and 2 once",
                   one_fwd["fused_mel_power"] == 1 and one_fwd["greedy_suppress_blocked"] == 1))
    packed["f32"] = fns["f32"](fd)

    # one conv's accumulator, card against CPU, on the input the card gave it
    seen = {}
    names = ("feature_extractor.layer1_0.conv1", "multiscale_module.conv2_downsample.conv")
    hooks = [dict(body.named_modules())[n].register_forward_pre_hook(
        lambda mod, args, n=n: seen.setdefault(n, args[0].detach().clone())) for n in names]
    with torch.inference_mode():
        body(fd[:2], combine_scales=True)
    for h in hooks:
        h.remove()
    for n in names:
        conv = dict(body.named_modules())[n]
        x = seen[n]
        with torch.inference_mode():
            a_card, a_cpu, y_card, y_cpu = _conv_acc_pair(conv, x)
        same = torch.equal(a_card, a_cpu)
        checks.append((f"{n} int32 accumulator card == CPU", same))
        log(f"[int8] {n}: input {tuple(x.shape)}, accumulator {tuple(a_card.shape)} card vs CPU "
            f"{'bit-equal' if same else 'DIFFER'}; output max |diff| "
            f"{(y_card - y_cpu).abs().max().item():.3e}")
    ms = {}
    for k in ("f32", "int8", "bf16") * 2:
        ms[k] = time_ms(lambda k=k: fns[k](fd), iters=10)
    _, rows, kern_ms = _profiled(lambda: fns["int8"](fd))
    log(f"[int8 body B={BATCH}] {n_q} convs int8; forward+NMS {ms['int8']:.3f} ms against float32 "
        f"{ms['f32']:.3f} and bf16 {ms['bf16']:.3f} ms in turns (CUDA events, the later of two); "
        f"{kern_ms:.3f} ms of kernels (profiler on) [{card}]")
    for kms, count, key in rows[:10]:
        log(f"[int8 body]   {kms:8.3f} ms  x{count:<4d} {key[:90]}")

    with torch.inference_mode():
        p = {k: fns[k].model(fd, combine_scales=True).float().cpu() for k in ("f32", "int8")}
    gap = _rel_gap(p["int8"], p["f32"])
    prow = {k: _packed_rows(v) for k, v in packed.items()}
    n_f32 = sum(map(len, prow["f32"]))
    hit, conf_gap = 0, 0.0
    for a, b in zip(prow["f32"], prow["int8"]):
        for conf, cls, c, w in a:
            m = [r for r in b if r[1] == cls and abs(r[2] - c) <= BF16_ROW_TOL_S
                 and abs(r[3] - w) <= BF16_WIDTH_REL * w]
            if m:
                hit += 1
                conf_gap = max(conf_gap, min(abs(r[0] - conf) for r in m))
    share = hit / max(n_f32, 1)
    log(f"[int8 body] int8 vs float32 on the card, {BATCH} clips: predictions median "
        f"{gap[0]:.3e}, p99 {gap[1]:.3e} (bound {INT8_PRED_P99}); {hit} of {n_f32} float32 "
        f"detections ({share:.4f}, bound {INT8_ROW_SHARE}) matched; largest confidence gap "
        f"{conf_gap:.3e} (bound {INT8_CONF_GAP})")
    checks.append(("int8 vs float32 predictions p99", gap[1] <= INT8_PRED_P99))
    checks.append(("int8 vs float32 matched share", n_f32 > 0 and share >= INT8_ROW_SHARE))
    checks.append(("int8 vs float32 confidence gap", conf_gap <= INT8_CONF_GAP))

    # the card's int8 body against the CPU's, same features, same s_x
    cpu_body = AudioDetectionModel.from_config(cfg, 2, deploy=True)
    cpu_body.load_state_dict(sd)
    set_quant(cpu_body.eval(), {k: v.cpu() for k, v in scales.items()})
    with torch.inference_mode():
        feats = body.frontend(fd[:2])
        t0 = time.perf_counter()
        b_cpu = cpu_body(features=feats.cpu(), combine_scales=True)
        cpu_s = time.perf_counter() - t0
        b_card = body(features=feats, combine_scales=True).cpu()
        f_card = fns["f32"].model(features=feats, combine_scales=True).cpu()
    g_cpu, yard = _rel_gap(b_card, b_cpu), _rel_gap(b_card, f_card)
    log(f"[int8 body] card vs CPU, B=2, same features and scales: median {g_cpu[0]:.3e}, p99 "
        f"{g_cpu[1]:.3e}; bound 2x the card's int8-vs-float32 gap on them (median {yard[0]:.3e}, "
        f"p99 {yard[1]:.3e}); CPU forward {cpu_s:.1f} s")
    checks.append(("int8 body card vs CPU", torch.isfinite(b_card).all().item()
                   and g_cpu[0] <= 2 * yard[0] and g_cpu[1] <= 2 * yard[1]))

    # the waveform batch's int8 transfer against int16, as streaming makes it
    wave = clips[:, None, :]

    def wave_copy(fn):
        def run():
            fn(wave, dev)
            torch.cuda.synchronize()
        return run

    wave_ms = {}
    for k, fn in (("int8", _int8_to_device), ("int16", _to_device)) * 2:
        wave_ms[k] = _host_ms(wave_copy(fn), reps=7)
    q8, s8 = _int8_to_device(wave, dev)
    log(f"[int8] waveform batch host -> device as streaming makes it: int8 {q8.numel() / 1e6:.1f} "
        f"MB + {s8.numel() * 4} B scales (native quantizer into pinned memory + copy) "
        f"{wave_ms['int8']:.2f} ms against int16 {wave.nbytes / 1e6:.1f} MB {wave_ms['int16']:.2f} "
        f"ms (host clock, median of 7, the later of two turns) [{card}]")

    # C. the inference CLI over phase 7's directory
    tmp = os.path.join(train_tmp, "inference")
    cfg_path, audio_dir = os.path.join(tmp, "serving.yaml"), os.path.join(tmp, "audio")
    weights = os.path.join(tmp, "weights.pt")
    native_dir = os.path.join(tmp, "native_rate")  # --transfer int8 refuses other rates
    os.makedirs(native_dir, exist_ok=True)
    for name in sorted(os.listdir(audio_dir)):
        if not name.startswith("r16k"):
            shutil.copy(os.path.join(audio_dir, name), os.path.join(native_dir, name))
    raw8_cli = load_config(cfg_path).to_dict()
    raw8_cli["tpu_config"]["frontend_precision"] = "int8"
    cfg8_path = os.path.join(tmp, "serving_int8.yaml")
    with open(cfg8_path, "w") as f:
        yaml.safe_dump(raw8_cli, f)
    conf_thr, iou_thr = 0.2, 0.1
    rec = _RowRecorder()
    walls = {}
    with rec:
        for run, where, extra in (("f32", audio_dir, []), ("int8", audio_dir, ["--int8"]),
                                  ("transfer_int8", native_dir, ["--transfer", "int8"]),
                                  ("framed_int8", native_dir, ["--framed_input", "--transfer",
                                                               "int8"])):
            rec.run = run
            t0 = time.perf_counter()
            inference_cli.main(["--config", cfg8_path if run == "framed_int8" else cfg_path,
                                "--output_dir", os.path.join(tmp, "out8", run), "--model_path",
                                weights, "--audio_dir", where, "--num_concurrency", "4",
                                "--iou_threshold", str(iou_thr), "--conf_threshold",
                                str(conf_thr), "--device", dev.type, *extra])
            torch.cuda.synchronize()
            walls[run] = time.perf_counter() - t0
    tot = {}
    for run in ("int8", "transfer_int8", "framed_int8"):
        t = dict(matched=0, unexplained=0, without_cascade=0, rows=0)
        for name in sorted(os.listdir(native_dir)):
            a, b = rec.rows[(run, name)], rec.rows[("f32", name)]
            m, _, bad, _, _ = _compare_rows(a, b, conf_thr, iou_thr, tol=BF16_ROW_TOL_S,
                                            flip_tol=INT8_FLIP_TOL, cascade=True)
            t["without_cascade"] += len(_compare_rows(a, b, conf_thr, iou_thr,
                                                      tol=BF16_ROW_TOL_S,
                                                      flip_tol=INT8_FLIP_TOL)[2])
            t["matched"] += m
            t["unexplained"] += len(bad)
            t["rows"] += max(len(a), len(b))
        tot[run] = t
        log(f"[int8] inference_cli {run} over {len(os.listdir(native_dir))} native-rate files "
            f"against the float32 int16 rows: {t['matched']}/{t['rows']} matched (start and end "
            f"within {BF16_ROW_TOL_S} s, bound {INT8_CLI_MATCHED_SHARE:.0%}), {t['unexplained']} "
            f"unexplained by a flip within {INT8_FLIP_TOL} or its NMS cascade (bound "
            f"{INT8_UNEXPLAINED_SHARE:.0%}; {t['without_cascade']} without the cascade); wall "
            f"{walls[run]:.2f} s against float32's {walls['f32']:.2f} s [{card}]")
        checks.append((f"inference_cli {run} rows", t["rows"] > 0 and t["unexplained"]
                       <= INT8_UNEXPLAINED_SHARE * t["rows"]
                       and t["matched"] >= INT8_CLI_MATCHED_SHARE * t["rows"]))
    checks.append(("inference_cli --int8 wrote every file",
                   sum(1 for (r, _) in rec.rows if r == "int8") == len(os.listdir(audio_dir))))

    # D. the evaluator, float32 and --int8, on phase 6's eval split
    train_cfg = os.path.join(tmp, "train.yaml")
    eval_args = ["--config", train_cfg, "--dataset_path", os.path.join(train_tmp, "data"),
                 "--batch_size", str(BATCH), "--device", dev.type]
    ev = {k: evaluate_cli.main(eval_args + extra) for k, extra in (("f32", []),
                                                                  ("int8", ["--int8"]))}
    gaps = {k: abs(ev["int8"][k] - ev["f32"][k]) for k in ev["f32"] if k.startswith("mAP")}
    log(f"[int8] evaluate_cli --int8: {json.dumps(ev['int8'])}; largest mAP gap against float32 "
        f"{max(gaps.values()):.3e} (bound {MAP_GAP_BOUND})")
    checks.append(("evaluate_cli --int8 mAP gap", max(gaps.values()) <= MAP_GAP_BOUND
                   and ev["int8"]["num_ground_truth"] == ev["f32"]["num_ground_truth"] > 0))

    # E. serve --int8_calib: one request
    cmap = os.path.join(ROOT, "idx2class_mapping", "class_map.json")
    calib = os.path.join(native_dir, sorted(os.listdir(native_dir))[0])
    state = serve.build_app_state(cfg, model_path=weights, class_map_path=cmap,
                                  batch_size=BATCH, device=dev, int8_calib=calib,
                                  framed_input=True)
    httpd = serve.serve(state, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        with open(os.path.join(tmp, "long150.wav"), "rb") as f:
            req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/detect",
                                         data=f.read(), method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            status, out = r.status, json.loads(r.read())
        req_ms = (time.perf_counter() - t0) * 1e3
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    n_q = sum(m.s_x is not None for m in state["infer_fn"].model.modules()
              if isinstance(m, Conv2d))
    log(f"[int8] serve --int8_calib ({n_q} convs int8): 150 s request {status}, "
        f"{len(out.get('rows', []))} rows, {req_ms:.1f} ms [{card}]")
    checks.append(("serve --int8_calib answered", status == 200 and set(out) == {"events", "rows"}
                   and n_q > 0))

    counts = {c.__name__: c.launches for c in counters}
    log(f"[int8] kernel launches over phase 11: {counts}")
    for name in ("fused_mel_power", "greedy_suppress_blocked"):
        checks.append((f"{name} launched in phase 11", counts[name] > 0))
    failed = [w for w, held in checks if not held]
    log(f"[int8] {len(checks) - len(failed)} of {len(checks)} checks hold"
        + (f"; failed: {failed}" if failed else ""))
    assert not failed, failed
    return dict(launches=counts, dft_int8_ms=dft_ms["int8"], dft_kernel1_ms=dft_ms["kernel1"],
                frame_host_int8_ms=quant_host_ms, framed_q_bytes=int(q.nbytes),
                framed_int16_bytes=int(frames.nbytes), framed_q_copy_ms=framed_ms["q_scale"],
                framed_int16_copy_ms=framed_ms["int16"], forward_int8_ms=ms["int8"],
                forward_f32_ms=ms["f32"], forward_bf16_ms=ms["bf16"], kernels_ms=kern_ms,
                int8_convs=n_q, gap_p99=gap[1], row_share=share, conf_gap=conf_gap,
                card_cpu_p99=g_cpu[1], wave_int8_copy_ms=wave_ms["int8"],
                wave_int16_copy_ms=wave_ms["int16"], cli_rows=tot,
                cli_wall_s=walls, map_gap=max(gaps.values()), serve_request_ms=req_ms)


# phase 12: the rest of the training path. The graph's steps against eager
# steps of the same optimizer form (the capturable Adam, its learning rate a
# tensor) on the same batches and seeds, read as phase 6 reads a step: the
# per-step loss, and the parameters and the EMA after the last step per
# tensor as max |diff| / max |move| (median, 90th percentile) and as an L2
# norm over all tensors against the move. The comparison runs with cuDNN's
# deterministic algorithms: in its default mode float32 backward sums some
# gradients in another order from run to run, and Adam passes any rounding
# on at ~lr a step whatever a gradient's size, so two eager float32 runs of
# 8 steps read losses 1.0e-3 to 2.0e-3 apart (H100 80GB HBM3, 700 W), as far
# as the graph reads from either. The bound is twice the spread of two eager
# runs of the shipped S=1 form, or GRAPH_FLOOR where that spread is 0.
GRAPH_FLOOR = 1e-6
# remat against the plain step at B=32, same weights, batch and dropout masks:
# the recomputed forward is the forward, so only the backward's summation
# order can differ; per-tensor max |diff| / max |grad|, median / p90 / L2
REMAT_BOUNDS = {"float32": dict(grad_median=1e-4, grad_p90=1e-3, grad_l2=1e-3),
                "bfloat16": TRAIN_BODY_BOUNDS}
GRAPH_STEPS, DISPATCH = 8, 4


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _host_device(fn):
    """One synchronised call of ``fn`` under ``torch.profiler``: the
    window's host ms, the device's busy ms in it (the union of its kernels),
    the kernels' count and kernel 1's (staging + main pass) among them, and
    the host ops with the most self time (name, count, ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("ayt_window"):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    window = [e for e in events if e.name == "ayt_window"
              and getattr(e, "device_type", None) != DeviceType.CUDA][0].time_range
    # device work only: the ranges that record_function and torch.optim open
    # are mirrored on the device's timeline as user annotations
    kernels = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name != "ayt_window" and not e.name.startswith("Optimizer.")]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if b > end:
            busy += b - max(a, end)
            end = b
    k1 = sum(1 for e in kernels if "mel_power" in e.name or "stage_frames" in e.name)
    host = sorted(((ev.self_cpu_time_total / 1e3, ev.count, ev.key) for ev in prof.key_averages()
                   if getattr(ev, "device_type", None) != DeviceType.CUDA
                   and ev.key not in ("ayt_window", "cudaDeviceSynchronize")), reverse=True)
    return dict(host_ms=(window.end - window.start) / 1e3, device_busy_ms=busy / 1e3,
                kernels=len(kernels), kernel1_events=k1, top_host_ops=[(k, n, round(ms, 3)) for ms, n, k in host[:5]])


def _busy_share(fn):
    """The device's busy share over one call of ``fn`` (synchronised), from
    a profiler trace (``_host_device``): its kernels' union over the
    window's span on the host; their count; and the kernel-1 events
    (staging + main pass) among them."""
    r = _host_device(fn)
    return r["device_busy_ms"] / max(r["host_ms"], 1e-12), r["kernels"], r["kernel1_events"]


def _param_readings(run, ref, start):
    """Per tensor max |run - ref| / max |ref - start| (median, p90), and the
    L2 norm of run - ref over all tensors against that of the move."""
    import numpy as np
    import torch

    rel = {k: ((run[k] - ref[k]).abs().max() / (ref[k] - start[k]).abs().max().clamp_min(1e-30))
           .item() for k in ref}
    flat = torch.cat([(run[k] - ref[k]).flatten() for k in ref])
    move = torch.cat([(ref[k] - start[k]).flatten() for k in ref])
    vals = list(rel.values())
    return dict(param_median=float(np.median(vals)), param_p90=float(np.percentile(vals, 90)),
                param_l2=(flat.norm() / move.norm()).item(), worst=max(rel, key=rel.get),
                worst_rel=max(vals))


def phase_train_postures(dev, card, train_tmp):
    """Phase 12: the device cache, remat, several steps per dispatch as a
    CUDA graph, and data parallel in a one-rank nccl group, on phase 6's
    dataset at the shipped config's full width. Kernel 1 is counted over
    each path's run."""
    import copy

    import numpy as np
    import torch
    import torch.distributed

    from audioyolo_tpu_torch import train_cli
    from audioyolo_tpu_torch.config import Config
    from audioyolo_tpu_torch.data.loader import BatchLoader, DeviceCachedLoader
    from audioyolo_tpu_torch.infer.streaming import quantize_clips_int8_device
    from audioyolo_tpu_torch.models import AudioDetectionModel
    from audioyolo_tpu_torch.ops import mel_kernel, nms_kernel
    from audioyolo_tpu_torch.train import METRIC_KEYS, TrainerPipeline

    counters = (mel_kernel.fused_mel_power, nms_kernel.greedy_suppress_blocked,
                nms_kernel.greedy_suppress_unblocked)
    checks = []  # (what, holds): every reading is logged before any is asserted
    res = {}
    cfg = _train_config(train_tmp)
    tc = cfg.raw["train_config"]
    train_ds, eval_ds = train_cli.resolve_datasets(cfg)
    fe = AudioDetectionModel.from_config(cfg, 2).frontend

    def loader(ds=train_ds, **kw):
        return BatchLoader(ds, BATCH, seed=5, transfer_dtype="int16", framer=fe.fused, **kw)

    def trainer_for(dtype=None, seed=1, **kw):
        model = AudioDetectionModel.from_config(cfg, 2, generator=torch.Generator().manual_seed(seed),
                                                dtype=dtype)
        return TrainerPipeline(model, train_cli.make_loss(cfg, 2, train_ds.get_class_weights()),
                               tc["optimizer_config"], tc["lr_scheduler_config"],
                               model_path=os.path.join(train_tmp, "postures"),
                               ema_config=tc.get("ema_config"), device=dev, **kw)

    def zero():
        for c in counters:
            c.launches = 0

    def launches():
        return {c.__name__: c.launches for c in counters}

    # (a) the cache: its batches against the loader's, bit for bit, on the card
    cached = DeviceCachedLoader.wrap(loader(), device=dev)
    assert isinstance(cached, DeviceCachedLoader)
    same = True
    for rb, cb in zip(list(loader()), list(cached), strict=True):
        same &= set(rb) == set(cb) and cb["audio"].device == dev
        same &= all(np.array_equal(rb[k], cb[k].cpu().numpy() if torch.is_tensor(cb[k]) else cb[k])
                    for k in rb)
    log(f"[cache] {TRAIN_CLIPS} clips resident ({cached.nbytes / 1e6:.1f} MB, framed int16); "
        f"one epoch's batches equal to BatchLoader's: {same}")
    checks.append(("cached batches equal BatchLoader's on the card", same))

    # epoch time cached against uncached, in turns, and the bytes each copies
    # from the host (the epoch's numpy arrays: the whole audio uncached, the
    # targets and the gather's indices cached)
    copied = [0]
    put = TrainerPipeline.put_batch

    def counting_put(self, batch):
        copied[0] += sum(v.nbytes for v in batch.values() if isinstance(v, np.ndarray))
        if torch.is_tensor(batch["audio"]):
            copied[0] += 8 * batch["audio"].shape[0]  # the gather's int64 indices
        return put(self, batch)

    bf16 = trainer_for(torch.bfloat16)
    turns = {"uncached": [], "cached": []}
    h2d = {}
    TrainerPipeline.put_batch = counting_put
    try:
        for name in ("uncached", "cached", "cached", "uncached"):
            ld = cached if name == "cached" else loader()
            copied[0] = 0
            zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bf16.train(ld)
            torch.cuda.synchronize()
            turns[name].append((time.perf_counter() - t0) * 1e3)
            h2d[name] = copied[0]
            if name == "cached":
                res["cache_launches"] = launches()
    finally:
        TrainerPipeline.put_batch = put
    log(f"[cache] bf16 epoch ({TRAIN_CLIPS} clips, {len(cached)} steps) in turns: uncached "
        f"{', '.join(f'{v:.1f}' for v in turns['uncached'])} ms, cached "
        f"{', '.join(f'{v:.1f}' for v in turns['cached'])} ms; host->device per epoch "
        f"uncached {h2d['uncached'] / 1e6:.1f} MB, cached {h2d['cached'] / 1e3:.1f} KB; "
        f"launches in a cached epoch {res['cache_launches']} [{card}]")
    checks.append(("kernel 1 launched once per cached step",
                   res["cache_launches"]["fused_mel_power"] == len(cached)))
    res.update(epoch_uncached_ms=turns["uncached"], epoch_cached_ms=turns["cached"],
               h2d_uncached_bytes=h2d["uncached"], h2d_cached_bytes=h2d["cached"])

    # quantize_clips_int8_device on the card against the CPU, bit for bit
    clips16 = train_ds.load_audio_batch_i16(np.arange(BATCH))
    clips32 = train_ds.load_audio_batch(np.arange(BATCH))
    for name, clips in (("int16", clips16), ("float32", clips32)):
        host = torch.from_numpy(clips)
        on_card = host.to(dev)
        q, sc = quantize_clips_int8_device(on_card)
        q_ref, sc_ref = quantize_clips_int8_device(host)
        q_off = (q.cpu() != q_ref).sum().item()
        sc_off = (sc.cpu() != sc_ref).sum().item()
        equal = q_off == 0 and sc_off == 0
        ms = time_ms(lambda: quantize_clips_int8_device(on_card), iters=10, warmup=2)
        log(f"[cache] quantize_clips_int8_device {name} ({BATCH}, 1, {clips.shape[-1]}): card = "
            f"CPU bit for bit {equal} ({q_off} of q, {sc_off} of the scales differ); {ms:.3f} ms "
            f"on the card [{card}]")
        checks.append((f"quantize_clips_int8_device {name} card = CPU", equal))
        res[f"quantize_{name}_ms"] = ms

    # (b) remat: one step at B=32 with and without it, float32 and bf16
    batch = next(iter(loader(shuffle=False, prefetch=0)))
    for dtype_name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        steps = {}
        for remat in (False, True):
            t = trainer_for(dtype, seed=2, remat=remat)
            x, tg = t.put_batch(batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            loss = t.train_step(x, tg)[0].item()
            peak = torch.cuda.max_memory_allocated(dev)
            steps[remat] = (loss, {k: p.grad.detach().double().cpu()
                                   for k, p in t.model.named_parameters()}, peak)
            del t, x, tg
        (l0, g0, p0), (l1, g1, p1) = steps[False], steps[True]
        rel = {k: ((g1[k] - g0[k]).abs().max() / g0[k].abs().max().clamp_min(1e-30)).item()
               for k in g0}
        flat = torch.cat([(g1[k] - g0[k]).flatten() for k in g0])
        vals = list(rel.values())
        r = dict(grad_median=float(np.median(vals)), grad_p90=float(np.percentile(vals, 90)),
                 grad_l2=(flat.norm() / torch.cat([g.flatten() for g in g0.values()]).norm()).item())
        worst = max(rel, key=rel.get)
        log(f"[remat {dtype_name}] B={BATCH} step: loss {l1:.6f} vs {l0:.6f}; gradients "
            + ", ".join(f"{k} {v:.3e}" for k, v in r.items())
            + f", worst {rel[worst]:.3e} ({worst}), largest |diff| {flat.abs().max():.3e}; "
            f"peak memory {p1 / 2**30:.3f} GiB with remat, {p0 / 2**30:.3f} without [{card}]")
        bounds = REMAT_BOUNDS[dtype_name]
        checks.append((f"remat {dtype_name} loss and gradients within {bounds}",
                       abs(l1 - l0) <= 1e-5 * abs(l0) and all(r[k] < bounds[k] for k in r)))
        res[f"remat_{dtype_name}"] = dict(r, peak_gib=p1 / 2**30, plain_peak_gib=p0 / 2**30,
                                          max_abs_diff=flat.abs().max().item())

    # (c) the graph: 8 steps at steps_per_dispatch 4 (the first dispatch eager,
    # then captured; the second replayed) against 8 eager steps of the same
    # optimizer form, and the spread of two eager runs of the S=1 form; EMA
    # on, and the learning rate halved between the two dispatches (the
    # replay reads it from its tensor)
    cache_batches = [b for _ in range(GRAPH_STEPS // len(cached)) for b in cached]
    assert len(cache_batches) == GRAPH_STEPS
    graph_launches = 0
    keys = ("loss", "param_median", "param_p90", "param_l2")
    lr = float(tc["optimizer_config"].get("lr", 1e-3))

    def state(t):
        return {**{k: p.detach().clone() for k, p in t.model.named_parameters()},
                **{f"ema.{k}": p.clone() for k, p in t.ema.params.items()}}

    for dtype_name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        torch.backends.cudnn.deterministic = True
        try:
            graph = trainer_for(dtype, seed=3, steps_per_dispatch=DISPATCH, use_ema=True)
            start = state(graph)
            dev_batches = [graph.put_batch(b) for b in cache_batches]
            runs = {}
            for name, kw in (("eager", {}), ("eager again", {}),
                             ("eager, capturable form", dict(steps_per_dispatch=DISPATCH))):
                t = trainer_for(dtype, seed=3, use_ema=True, **kw)
                rows = []
                for i, (x, tg) in enumerate(dev_batches):
                    if i == DISPATCH:
                        t.set_learning_rate(lr / 2)
                    rows.append(t.train_step(x, tg))
                runs[name] = (torch.stack(rows), state(t))
                del t
            zero()
            rows_graph = [graph.train_steps(dev_batches[:DISPATCH])]
            graph.set_learning_rate(lr / 2)
            rows_graph.append(graph.train_steps(dev_batches[DISPATCH:]))
            rows_graph = torch.cat(rows_graph)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = False
        graph_launches += launches()["fused_mel_power"]
        run_launches = launches()["fused_mel_power"]
        graphs = list(graph._graphs.values())
        per_replay_step = graphs[0].counts[0] / DISPATCH if len(graphs) == 1 else float("nan")
        runs["graph"] = (rows_graph, state(graph))

        def readings(a, b):
            (ra, pa), (rb, pb) = runs[a], runs[b]
            pr = _param_readings(pa, pb, start)
            return dict(loss=((ra[:, 0] - rb[:, 0]).abs() / rb[:, 0].abs()).max().item(),
                        **{k: pr[k] for k in keys[1:]}, worst=pr["worst"])

        spread = readings("eager again", "eager")
        got = readings("graph", "eager, capturable form")
        shipped = readings("graph", "eager")
        finite = bool(torch.isfinite(rows_graph[:, [0, 1, 2, 5]]).all())
        del graph
        # step time per step in turns, in cuDNN's default mode: a fresh graph
        # trainer (its first dispatch captures) against eager steps of the
        # S=1 form, on the second dispatch's batches
        eager = trainer_for(dtype, seed=3)
        graph = trainer_for(dtype, seed=3, steps_per_dispatch=DISPATCH)
        last = dev_batches[DISPATCH:]
        graph.train_steps(last)
        step_turns = {"eager": [], "graph": []}
        for name in ("eager", "graph", "graph", "eager"):
            fn = ((lambda: [eager.train_step(x, tg) for x, tg in last]) if name == "eager"
                  else (lambda: graph.train_steps(last)))
            step_turns[name].append(time_ms(fn, iters=3, warmup=1) / DISPATCH)
        busy_e, n_e, k1_e = _busy_share(lambda: [eager.train_step(x, tg) for x, tg in last])
        busy_g, n_g, k1_g = _busy_share(lambda: graph.train_steps(last))
        log(f"[graph {dtype_name}] {GRAPH_STEPS} steps at steps_per_dispatch {DISPATCH}, per-step "
            f"loss: graph {', '.join(f'{v:.5f}' for v in rows_graph[:, 0].tolist())}; eager "
            f"{', '.join(f'{v:.5f}' for v in runs['eager'][0][:, 0].tolist())}")
        for what, r in (("graph vs eager of its optimizer form", got),
                        ("eager vs eager (the spread)", spread),
                        ("graph vs eager of the S=1 form", shipped)):
            log(f"[graph {dtype_name}] {what}: " + ", ".join(f"{k} {r[k]:.3e}" for k in keys)
                + f" (worst tensor {r['worst']})")
        log(f"[graph {dtype_name}] kernel 1 launches per replayed step {per_replay_step:g} "
            f"(recorded at capture, counted per replay), in the graph trainer's run {run_launches}")
        log(f"[graph {dtype_name}] B={BATCH} step in turns: eager "
            f"{', '.join(f'{v:.3f}' for v in step_turns['eager'])} ms, graph "
            f"{', '.join(f'{v:.3f}' for v in step_turns['graph'])} ms; device busy over a "
            f"dispatch of {DISPATCH} steps: eager {busy_e:.3f} ({n_e} kernels, {k1_e} kernel-1 "
            f"events), graph {busy_g:.3f} ({n_g} kernels, {k1_g} kernel-1 events) (profiler) "
            f"[{card}]")
        bound = {k: max(2 * spread[k], GRAPH_FLOOR) for k in keys}
        checks.append((f"graph {dtype_name} against eager within twice the eager spread {bound}",
                       finite and all(got[k] <= bound[k] for k in keys)))
        checks.append((f"graph {dtype_name}: kernel 1 in each replayed step", per_replay_step == 1))
        res[f"graph_{dtype_name}"] = dict(
            against_eager={k: got[k] for k in keys}, spread={k: spread[k] for k in keys},
            against_s1={k: shipped[k] for k in keys}, eager_step_ms=step_turns["eager"],
            graph_step_ms=step_turns["graph"], busy_eager=busy_e, busy_graph=busy_g,
            kernel1_events_eager=k1_e, kernel1_events_graph=k1_g,
            launches_per_replayed_step=per_replay_step)
        del eager, graph, dev_batches, last, runs
    res["graph_launches"] = {"fused_mel_power": graph_launches, "greedy_suppress_blocked": 0,
                             "greedy_suppress_unblocked": 0}

    # (d) data parallel: train_cli.run(data_parallel=True) in a one-rank nccl
    # group (torchrun's environment set here), the shipped bf16 config; then
    # steps_per_dispatch 4 over two epochs of 4 batches (B=16): the first
    # epoch's dispatch runs eagerly and captures, the second replays
    env = dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()))
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    dp = {}
    try:
        for name, updates in (("dp", {}), ("dp_graph", dict(steps_per_dispatch=DISPATCH))):
            raw = copy.deepcopy(cfg.to_dict())
            raw["tpu_config"].update(updates)
            raw["train_config"].update(model_path=os.path.join(train_tmp, name),
                                       metrics_path=os.path.join(train_tmp, name))
            if updates:
                raw["train_config"].update(batch_size=BATCH // 2, epochs=2)
            zero()
            t0 = time.perf_counter()
            try:
                tr = train_cli.run(Config(raw), device=dev, data_parallel=True)
            except Exception:  # logged here, failed below with the other checks
                log(f"[{name}] train_cli.run(data_parallel=True) raised:\n"
                    f"{traceback.format_exc()}")
                checks.append((f"{name}: train_cli.run(data_parallel=True) ran", False))
                continue
            torch.cuda.synchronize()
            dp[name] = dict(s=time.perf_counter() - t0, launches=launches(), trainer=tr,
                            backend=torch.distributed.get_backend(tr.group))
            del tr
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for name, d in dp.items():
        tr = d["trainer"]
        metrics = tr.train_metrics + tr.eval_metrics
        graphs = list(tr._graphs.values())
        log(f"[{name}] train_cli.run(data_parallel=True): {d['backend']} group of {tr.world}, "
            f"{len(tr.train_metrics)} epoch(s), {tr.step} steps in {d['s']:.1f} s, last train "
            f"loss {tr.train_metrics[-1]['aggregate_loss']:.4f}, eval "
            f"{tr.eval_metrics[-1]['aggregate_loss']:.4f}; launches {d['launches']}; captured "
            f"graphs {len(graphs)} (kernel 1 per replay {[g.counts[0] for g in graphs]})")
        checks.append((f"{name}: nccl group, finite metrics, kernel 1 launched",
                       d["backend"] == "nccl" and tr.group is not None
                       and all(np.isfinite(m["aggregate_loss"]) for m in metrics)
                       and d["launches"]["fused_mel_power"] > 0))
        res[f"{name}_launches"] = d["launches"]
    checks.append(("dp_graph: the second epoch replayed a captured graph",
                   "dp_graph" in dp and len(dp["dp_graph"]["trainer"]._graphs) == 1))
    res["dp_launches"] = {c.__name__: sum(d["launches"][c.__name__] for d in dp.values())
                          for c in counters}
    del dp

    for what, holds in checks:
        log(f"[phase 12] {'ok  ' if holds else 'FAIL'} {what}")
    bad = [what for what, holds in checks if not holds]
    assert not bad, f"phase 12 checks failed: {bad}"
    return res


MULTI_N = 4
# the exported program against the live function on the card: the rows of
# each clip matched as phase 7 matches card and CPU; a difference must be a
# flip within the entry's tolerance (the same ops on the same inputs: none
# expected)
EXPORT_FLIP_TOL = {"framed_int16": 1e-3, "wave_int16": 1e-3, "bf16_framed_int16": BF16_FLIP_TOL,
                   "int8_body_framed_q": INT8_FLIP_TOL}
EXPORT_UNEXPLAINED = {"framed_int16": 0.0, "wave_int16": 0.0,
                      "bf16_framed_int16": BF16_UNEXPLAINED_SHARE,
                      "int8_body_framed_q": INT8_UNEXPLAINED_SHARE}
OPTIMIZERS_13 = {"SGD": {"name": "SGD", "lr": 1e-3, "momentum": 0.9, "nesterov": True},
                 "Adagrad": {"name": "Adagrad", "lr": 1e-3}}


def _dets_rows(dets, duration):
    """Per clip, the rows ``evaluate_audio`` would write from a detection dict."""
    from audioyolo_tpu_torch.infer.decode import postprocess_detections

    return [[dict(confidence=r[0], class_idx=r[2], start=r[3], end=r[4]) for r in clip]
            for clip in postprocess_detections(dets, duration)]


def _rows_against(got, ref, conf_thr, iou_thr, flip_tol):
    """(matched, explained, unexplained) summed over the clips."""
    m = e = 0
    bad = []
    for a, b in zip(got, ref, strict=True):
        mi, ei, ui, _, _ = _compare_rows(a, b, conf_thr, iou_thr, tol=1e-3, flip_tol=flip_tol,
                                         cascade=True)
        m, e, bad = m + mi, e + ei, bad + ui
    return m, e, bad


def _fresh_process_load(path):
    """Start a new interpreter with an empty build directory that loads the
    artifact and runs it once: its first op call builds the kernels'
    libraries, and no module of ``models/`` is imported. Returns a function
    that waits for it: ``(its JSON reading or None, seconds)``."""
    code = (
        "import json, os, sys, tempfile\n"
        "import numpy as np\n"
        "from audioyolo_tpu_torch.ops import build\n"
        "build.BUILD = tempfile.mkdtemp(prefix='ayt_build_')\n"
        "from audioyolo_tpu_torch.infer.export import load_serving_artifact\n"
        "from audioyolo_tpu_torch.ops.cuda_graph import COUNTERS\n"
        f"fn, meta = load_serving_artifact({path!r})\n"
        "dets = fn(np.zeros(meta['input_shape'], meta['input_dtype']))\n"
        "print(json.dumps(dict(built=sorted(os.listdir(build.BUILD)),\n"
        "    launches={c.__name__: c.launches for c in COUNTERS},\n"
        "    models=[m for m in sys.modules if m.startswith('audioyolo_tpu_torch.models')],\n"
        "    shape=list(dets['valid'].shape))))\n"
        "import shutil; shutil.rmtree(build.BUILD)\n"
    )
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)

    def wait():
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        s = time.perf_counter() - t0
        if proc.returncode != 0:
            log(f"[export] the fresh process failed (exit {proc.returncode}):\n{out}\n{err}")
            return None, s
        return json.loads(out.strip().splitlines()[-1]), s

    return wait


def _aten_ops(fn):
    """The ATen ops one call of ``fn`` dispatches, counted by name (host side)."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    seen = Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen[str(func)] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return seen


def _dispatch_cost(dev, card):
    """What the torch dispatcher adds to a kernel op's call: each wrapper
    (through its registered op) against the op's ``cuda`` registration
    called directly, at the serving forward's shapes (framed int16, B=32,
    K=630), in turns. Per call: CUDA-event ms over 200 calls queued back to
    back, and the host's us to queue one."""
    import numpy as np
    import torch

    from audioyolo_tpu_torch.ops import mel_kernel, nms_kernel
    from audioyolo_tpu_torch.ops.frontend import SpectralFrontend

    cfg = _serving_config()
    fe = SpectralFrontend(cfg).to(dev)
    mk = fe.fused_kernel
    wav = np.clip(np.random.default_rng(21).standard_normal((BATCH, cfg.clip_samples)) * 3000,
                  -32768, 32767).astype(np.int16)
    x = torch.from_numpy(fe.frame_host(wav)).to(dev)
    b, _, g, _ = x.shape
    fp = mk.ct_i16.shape[-1]
    xs = mel_kernel.stage_frames(x, fp)
    x1n, x2n = _nms_cases(BATCH, 630, seed=21)["random"]
    x1, x2 = torch.from_numpy(x1n).to(dev), torch.from_numpy(x2n).to(dev)
    calls = {
        "stage_frames": (lambda: mel_kernel.stage_frames(x, fp),
                         lambda: mel_kernel._stage_frames_cuda(x, fp)),
        "mel_power_staged": (lambda: mel_kernel.mel_power_staged(xs, mk.ct_i16, mk.mel2t, b, g),
                             lambda: mel_kernel._mel_power_staged_cuda(xs, mk.ct_i16, mk.mel2t,
                                                                       b, g)),
        "greedy_suppress": (lambda: nms_kernel.greedy_suppress_blocked(x1, x2, 0.1),
                            lambda: nms_kernel._greedy_suppress_cuda(x1, x2, 0.1, 32)),
    }

    def host_us(fn, n=200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return t

    res = {}
    for name, (op, direct) in calls.items():
        turns = {"op": [], "direct": []}
        for which in ("op", "direct", "direct", "op"):
            fn = op if which == "op" else direct
            turns[which].append((time_ms(fn, iters=200, warmup=5), host_us(fn)))
        res[name] = {k: dict(ms=[t[0] for t in v], host_us=[t[1] for t in v])
                     for k, v in turns.items()}
        log(f"[dispatch {name}] per call in turns, through the registered op: "
            + ", ".join(f"{m:.4f} ms ({h:.1f} us host)" for m, h in turns["op"])
            + "; its cuda registration called directly: "
            + ", ".join(f"{m:.4f} ms ({h:.1f} us host)" for m, h in turns["direct"])
            + f" [{card}]")
    return res


def phase_port_rest(dev, card, train_tmp, postures):
    """Phase 13: the serving artifact (export, save, load) in four entries,
    ``make_multi_inference_fn`` as one CUDA graph over 4 forwards,
    ``inference_cli --workers 2`` (the streaming pool) and SGD and Adagrad
    under ``steps_per_dispatch: 4``, each path's kernel launches counted."""
    import copy

    import numpy as np
    import torch

    from audioyolo_tpu_torch import inference_cli, train_cli
    from audioyolo_tpu_torch.config import Config
    from audioyolo_tpu_torch.data.loader import BatchLoader, DeviceCachedLoader
    from audioyolo_tpu_torch.infer import pool as pool_mod
    from audioyolo_tpu_torch.infer.decode import (make_inference_fn, make_multi_inference_fn,
                                                  unpack_detections)
    from audioyolo_tpu_torch.infer.export import (build_serving_exported,
                                                  load_serving_artifact, save_serving_artifact)
    from audioyolo_tpu_torch.models import AudioDetectionModel, fold_repvgg
    from audioyolo_tpu_torch.models.quant import calibrate_quant, set_quant
    from audioyolo_tpu_torch.ops.cuda_graph import COUNTERS
    from audioyolo_tpu_torch.ops.frontend import SpectralFrontend
    from audioyolo_tpu_torch.train import TrainerPipeline

    checks, res = [], {}
    conf_thr, iou_thr, keep_k = 0.2, 0.1, 128
    t_phase = time.perf_counter()

    def zero():
        for c in COUNTERS:
            c.launches = 0

    def launches():
        return {c.__name__: c.launches for c in COUNTERS}

    def kernels_ran(counts):
        return counts["fused_mel_power"] > 0 and counts["greedy_suppress_blocked"] > 0

    res["dispatch"] = _dispatch_cost(dev, card)

    # (a) the serving artifact: four entries at B=32, full width; the cpu
    # platform's program for the first entry only (the CPU tests hold all four)
    cfg = _serving_config()
    raw8 = cfg.to_dict()
    raw8["tpu_config"]["frontend_precision"] = "int8"
    cfg8 = Config(raw8)
    gen = torch.Generator().manual_seed(0)
    sd = _randomize_bn(AudioDetectionModel.from_config(cfg, 2, generator=gen).state_dict(), gen)
    folded = fold_repvgg(sd)
    fe, fe8 = SpectralFrontend(cfg), SpectralFrontend(cfg8)
    rng = np.random.default_rng(13)
    wav = [np.clip(rng.standard_normal((BATCH, cfg.clip_samples)) * 3000, -32768,
                   32767).astype(np.int16) for _ in range(MULTI_N)]
    framed = fe.frame_host(wav[0])
    q8 = fe8.frame_host_int8(wav[0])
    entries = {
        "framed_int16": (cfg, None, framed, dict(input_dtype="int16", framed=True)),
        "wave_int16": (cfg, None, wav[0][:, None, :], dict(input_dtype="int16")),
        "bf16_framed_int16": (cfg, torch.bfloat16, framed, dict(input_dtype="int16", framed=True)),
        "int8_body_framed_q": (cfg8, None, q8, dict(input_dtype="int8", framed=True)),
    }
    tmp = os.path.join(train_tmp, "export")
    os.makedirs(tmp)
    export_counts = {c.__name__: 0 for c in COUNTERS}
    res["export"] = {}
    for name, (ecfg, dtype, x, kw) in entries.items():
        parts = x if isinstance(x, tuple) else (x,)
        if kw.get("framed"):
            kw = dict(kw, frame_shape=tuple(parts[0].shape[1:]))
        model = AudioDetectionModel.from_config(ecfg, 2, deploy=True, dtype=dtype)
        if name.startswith("int8_body"):
            model.load_state_dict(folded)
            model.to(dev).eval()
            calib = tuple(torch.from_numpy(p[:4]).to(dev) for p in parts)
            set_quant(model, calibrate_quant(model, [calib]))
        with_cpu = name == "framed_int16"
        t0 = time.perf_counter()
        programs = build_serving_exported(model, folded, BATCH, conf_threshold=conf_thr,
                                          iou_threshold=iou_thr, keep_k=keep_k,
                                          platforms=("cuda",), **kw)
        export_s = time.perf_counter() - t0
        path, path_cpu = os.path.join(tmp, f"{name}.aytx"), os.path.join(tmp, f"{name}_cpu.aytx")
        t0 = time.perf_counter()
        save_serving_artifact(path, programs, idx2class_map={0: "alarm", 1: "music"},
                              sample_duration=ecfg.sample_duration,
                              input_sample_rate=ecfg.sample_rate)
        save_s = time.perf_counter() - t0
        if with_cpu:
            save_serving_artifact(path_cpu, build_serving_exported(
                model, folded, 2, conf_threshold=conf_thr, iou_threshold=iou_thr,
                keep_k=keep_k, platforms=("cpu",), **kw), idx2class_map={0: "alarm", 1: "music"},
                sample_duration=ecfg.sample_duration, input_sample_rate=ecfg.sample_rate)
        t0 = time.perf_counter()
        fn, meta = load_serving_artifact(path)
        load_s = time.perf_counter() - t0
        live = make_inference_fn(model, folded, iou_thr, conf_thr, keep_k=keep_k, device=dev)
        args = tuple(torch.from_numpy(p).to(dev) for p in parts)
        live_arg = args if len(args) > 1 else args[0]
        zero()
        dets = fn(x)
        torch.cuda.synchronize()
        for k, v in launches().items():
            export_counts[k] += v
        one_call = launches()
        ref = unpack_detections(live(live_arg).cpu().numpy())
        bit_equal = all(np.array_equal(dets[k], ref[k]) for k in ref)
        m, e, bad = _rows_against(_dets_rows(dets, ecfg.sample_duration),
                                  _dets_rows(ref, ecfg.sample_duration), conf_thr, iou_thr,
                                  EXPORT_FLIP_TOL[name])
        # the program on the card against the live function, in turns: as
        # load_serving_artifact runs it (inference mode) and with autograd on
        # (the loaded weights require grad); the ATen ops each dispatches per
        # call; a profile of one call of each
        prog = fn.program

        def loaded():
            with torch.inference_mode():
                return prog(*args)

        calls = {"live": lambda: live(live_arg), "loaded": loaded,
                 "loaded_grad": lambda: prog(*args)}
        by_name = {"live": _aten_ops(calls["live"]), "loaded": _aten_ops(loaded)}
        ops = {k: sum(v.values()) for k, v in by_name.items()}
        extra = {k: v for k, v in (by_name["loaded"] - by_name["live"]).items()}
        missing = {k: v for k, v in (by_name["live"] - by_name["loaded"]).items()}
        turns = {k: [] for k in calls}
        for which in ("live", "loaded", "loaded_grad", "loaded_grad", "loaded", "live"):
            turns[which].append(time_ms(calls[which], iters=10, warmup=2))
        prof = {k: _host_device(f) for k, f in calls.items()}
        # the cpu program at B=2 against the card's loaded program's first 2 clips
        mc = ec = 0
        bad_c, cpu_s = [], 0.0
        if with_cpu:
            t0 = time.perf_counter()
            fn_cpu, _ = load_serving_artifact(path_cpu, device="cpu")
            small_x = tuple(p[:2] for p in parts)
            d_cpu = fn_cpu(small_x if len(small_x) > 1 else small_x[0])
            first2 = {k: v[:2] for k, v in dets.items()}
            mc, ec, bad_c = _rows_against(_dets_rows(first2, ecfg.sample_duration),
                                          _dets_rows(d_cpu, ecfg.sample_duration), conf_thr,
                                          iou_thr, EXPORT_FLIP_TOL[name])
            cpu_s = time.perf_counter() - t0
            del fn_cpu
        n, nc = m + e + len(bad), mc + ec + len(bad_c)
        log(f"[export {name}] traced (cuda B={BATCH}) in {export_s:.1f} s, saved in "
            f"{save_s:.1f} s, loaded in {load_s:.2f} s; meta input {meta['input_shape']} "
            f"{meta['input_dtype']}; loaded vs live on the card: bit-equal {bit_equal}, rows {m} "
            f"matched, {e} explained flips, {len(bad)} unexplained; launches in one call "
            f"{one_call}; forward + NMS in turns: "
            + "; ".join(f"{k} {', '.join(f'{v:.3f}' for v in ts)} ms" for k, ts in turns.items())
            + f"; ATen ops per call live {ops['live']}, loaded {ops['loaded']} (the loaded "
            f"program's extra ops {extra}, missing {missing}) [{card}]")
        for k, pr in prof.items():
            log(f"[export {name}] profile of one {k} call: host {pr['host_ms']:.3f} ms, device "
                f"busy {pr['device_busy_ms']:.3f} ms over {pr['kernels']} kernels; host ops by "
                f"self time {pr['top_host_ops']} [{card}]")
        if with_cpu:
            log(f"[export {name}] the cpu program (B=2) loaded and run in {cpu_s:.1f} s: vs the "
                f"card's first 2 clips {mc} matched, {ec} explained, {len(bad_c)} unexplained")
        share = EXPORT_UNEXPLAINED[name]
        # kernel 1 is not on the int8 posture's (q, scale) frames (the int8 DFT)
        ran = (one_call["greedy_suppress_blocked"] == 1
               and one_call["fused_mel_power"] == (0 if name.startswith("int8") else 1))
        checks.append((f"export {name}: loaded = live on the card within flips, kernels 1 "
                       "and 2 once per call", m > 0 and len(bad) <= share * n and ran))
        if with_cpu:
            checks.append((f"export {name}: cpu program B=2 = card within flips",
                           mc > 0 and len(bad_c) <= max(share * nc, 0)))
        res["export"][name] = dict(bit_equal=bit_equal, matched=m, explained=e,
                                   unexplained=len(bad), live_ms=turns["live"],
                                   loaded_ms=turns["loaded"], loaded_grad_ms=turns["loaded_grad"],
                                   profile=prof, export_s=export_s, save_s=save_s, load_s=load_s,
                                   cpu_s=cpu_s, aten_ops_live=ops["live"],
                                   aten_ops_loaded=ops["loaded"], aten_ops_extra=extra,
                                   aten_ops_missing=missing, cpu_matched=mc,
                                   cpu_explained=ec, cpu_unexplained=len(bad_c))
        del programs, fn, prog, live, model, args, live_arg, calls
    res["export_launches"] = export_counts
    res["export_s"] = time.perf_counter() - t_phase

    # (b) make_multi_inference_fn: one CUDA graph over 4 forwards at B=32
    t_part = time.perf_counter()
    frames = [torch.from_numpy(fe.frame_host(w)).to(dev) for w in wav]
    res["multi_launches"] = {c.__name__: 0 for c in COUNTERS}
    for dtype_name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        model = AudioDetectionModel.from_config(cfg, 2, deploy=True, dtype=dtype)
        single = make_inference_fn(copy.deepcopy(model), folded, iou_thr, conf_thr,
                                   keep_k=keep_k, device=dev)
        multi = make_multi_inference_fn(model, folded, MULTI_N, iou_thr, conf_thr, keep_k,
                                        device=dev)
        torch.backends.cudnn.deterministic = True
        try:
            first = multi(frames)  # eager on a side stream, then the capture
            zero()
            outs = multi(frames)   # the replay
            torch.cuda.synchronize()
            counts = launches()
            eager = [single(f) for f in frames]
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = False
        for k, v in counts.items():
            res["multi_launches"][k] += v
        equal = all(torch.equal(a, b) for a, b in zip(outs, eager))
        equal_first = all(torch.equal(a, b) for a, b in zip(first, eager))
        turns = {"eager": [], "graph": []}
        for which in ("eager", "graph", "graph", "eager"):
            call = ((lambda: [single(f) for f in frames]) if which == "eager"
                    else (lambda: multi(frames)))
            turns[which].append(time_ms(call, iters=5, warmup=1) / MULTI_N)
        busy_e, n_e, k1_e = _busy_share(lambda: [single(f) for f in frames])
        busy_g, n_g, k1_g = _busy_share(lambda: multi(frames))
        log(f"[multi {dtype_name}] {MULTI_N} x B={BATCH} framed int16 in one CUDA graph "
            f"({len(multi.graphs)} captured): replay = 4 eager calls bit for bit {equal} (the "
            f"capturing call's eager pass {equal_first}, deterministic cuDNN); launches in one "
            f"replay {counts}; per batch in turns: eager "
            f"{', '.join(f'{v:.3f}' for v in turns['eager'])} ms, graph "
            f"{', '.join(f'{v:.3f}' for v in turns['graph'])} ms; device busy over a dispatch: "
            f"eager {busy_e:.3f} ({n_e} kernels, {k1_e} kernel-1 events), graph {busy_g:.3f} "
            f"({n_g} kernels, {k1_g} kernel-1 events) (profiler) [{card}]")
        checks.append((f"multi {dtype_name}: one graph, replay = eager, kernels 1 and 2 once "
                       "per forward",
                       equal and len(multi.graphs) == 1
                       and counts["fused_mel_power"] == MULTI_N
                       and counts["greedy_suppress_blocked"] == MULTI_N))
        res[f"multi_{dtype_name}"] = dict(equal=equal, eager_ms=turns["eager"],
                                          graph_ms=turns["graph"], busy_eager=busy_e,
                                          busy_graph=busy_g)
        del model, single, multi, first, outs, eager
    del frames
    res["multi_s"] = time.perf_counter() - t_part

    # (c) inference_cli --workers 2 over phase 7's directory and 150 s file,
    # against --workers 1. The two --workers 2 runs share one pool: the
    # second run's construction gets the first's workers, and the pool
    # closes after both (each worker's launches from a ping first);
    # detect_regime once the pool is warm
    itmp = os.path.join(train_tmp, "inference")
    t_part = time.perf_counter()
    pool_seen = {"launches": None, "regime": None, "ready_s": None, "close_s": None,
                 "exits": None}

    class _Shared(pool_mod.StreamWorkerPool):
        def __init__(self, *a, **kw):
            self.t0, self.args = time.perf_counter(), (a, kw)
            super().__init__(*a, **kw)

        def warmup(self):
            out = super().warmup()
            if pool_seen["ready_s"] is None:
                pool_seen["ready_s"] = time.perf_counter() - self.t0
                pool_seen["regime"] = self.detect_regime(mb=64.0)
                self.regime = None  # shard over every worker, as main does
            return out

        def close(self):  # main's close: the pool serves the next run
            pass

        def finish(self):
            pool_seen["launches"] = pool_mod.StreamWorkerPool.warmup(self)  # a ping each
            t0 = time.perf_counter()
            super().close()
            pool_seen["close_s"] = time.perf_counter() - t0
            pool_seen["exits"] = [p.returncode for p in self._procs]

    shared = []

    def one_pool(*a, **kw):
        if not shared:
            shared.append(_Shared(*a, **kw))
        assert shared[0].args == (a, kw), "the two --workers 2 runs build different pools"
        return shared[0]

    walls = {}
    saved = inference_cli.StreamWorkerPool
    inference_cli.StreamWorkerPool = one_pool
    try:
        for workers in ("1", "2"):
            for where, arg in (("dir", ["--audio_dir", os.path.join(itmp, "audio")]),
                               ("long", ["--audio_filepath", os.path.join(itmp, "long150.wav")])):
                out = os.path.join(itmp, "out", f"pool_{where}_{workers}")
                t0 = time.perf_counter()
                inference_cli.main(["--config", os.path.join(itmp, "serving.yaml"),
                                    "--model_path", os.path.join(itmp, "weights.pt"),
                                    "--device", dev.type,
                                    "--output_dir", out, "--iou_threshold", str(iou_thr),
                                    "--conf_threshold", str(conf_thr), "--framed_input",
                                    "--workers", workers, *arg])
                torch.cuda.synchronize()
                walls[(where, workers)] = time.perf_counter() - t0
    finally:
        inference_cli.StreamWorkerPool = saved
        for pool in shared:
            pool.finish()
    pool_counts = {c.__name__: sum(w.get(c.__name__, 0) for w in pool_seen["launches"])
                   for c in COUNTERS}
    same = {}
    for where in ("dir", "long"):
        a = _csv_tree(os.path.join(itmp, "out", f"pool_{where}_1"))
        b = _csv_tree(os.path.join(itmp, "out", f"pool_{where}_2"))
        same[where] = (a == b and len(a) > 0, len(a))
    regime = pool_seen["regime"] or {}
    log(f"[pool] inference_cli --framed_input over the directory: --workers 1 "
        f"{walls[('dir', '1')]:.2f} s, --workers 2 {walls[('dir', '2')]:.2f} s (the pool's "
        f"start-up included); the 150 s file: {walls[('long', '1')]:.2f} s / "
        f"{walls[('long', '2')]:.2f} s (the same pool, warm); model builds included; "
        f"CSVs byte-identical: directory {same['dir']}, 150 s file {same['long']}; "
        f"detect_regime(64 MB): {regime}; the workers' launches {pool_seen['launches']}; the "
        f"pool ready (every worker's model built) after {pool_seen['ready_s']:.2f} s, closed in "
        f"{pool_seen['close_s']:.2f} s, exit codes {pool_seen['exits']} [{card}]")
    checks.append(("pool: --workers 2 CSVs = --workers 1, byte for byte",
                   same["dir"][0] and same["long"][0]))
    checks.append(("pool: kernels 1 and 2 launched in the workers, every worker exited 0",
                   kernels_ran(pool_counts) and pool_seen["exits"] == [0, 0]))
    res.update(pool_launches=pool_counts, pool_walls={f"{k[0]}_{k[1]}": v
                                                      for k, v in walls.items()},
               pool_regime=regime, pool_ready_s=pool_seen["ready_s"],
               pool_close_s=pool_seen["close_s"], pool_s=time.perf_counter() - t_part)

    # (d) SGD (nesterov) and Adagrad at steps_per_dispatch 4: 8 graph steps
    # against 8 eager steps of the same optimizer form, as phase 12 reads Adam,
    # within twice the spread of phase 12's two eager runs (the same model,
    # batches and cuDNN mode: the spread is the forward and backward's);
    # graph step time against Adam's in turns
    tcfg = _train_config(train_tmp)
    tc = tcfg.raw["train_config"]
    train_ds, _ = train_cli.resolve_datasets(tcfg)
    tfe = AudioDetectionModel.from_config(tcfg, 2).frontend
    cached = DeviceCachedLoader.wrap(BatchLoader(train_ds, BATCH, seed=5, transfer_dtype="int16",
                                                 framer=tfe.fused), device=dev)
    batches = [b for _ in range(GRAPH_STEPS // len(cached)) for b in cached]
    keys = ("loss", "param_median", "param_p90", "param_l2")

    def trainer_for(opt_cfg, dtype=None, **kw):
        model = AudioDetectionModel.from_config(tcfg, 2, dtype=dtype,
                                                generator=torch.Generator().manual_seed(3))
        return TrainerPipeline(model, train_cli.make_loss(tcfg, 2, train_ds.get_class_weights()),
                               opt_cfg, None, use_lr_scheduler=False,
                               model_path=os.path.join(train_tmp, "p13"),
                               ema_config=tc.get("ema_config"), use_ema=True, device=dev, **kw)

    def params(t):
        return {k: p.detach().clone() for k, p in t.model.named_parameters()}

    res["optim"] = {}
    t_part = time.perf_counter()
    # the fresh process of (a) runs beside the exactness checks, which time nothing
    fresh_wait = _fresh_process_load(os.path.join(tmp, "framed_int16.aytx"))
    for dtype_name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        for opt_name, opt_cfg in OPTIMIZERS_13.items():
            lr = opt_cfg["lr"]
            torch.backends.cudnn.deterministic = True
            try:
                graph = trainer_for(opt_cfg, dtype, steps_per_dispatch=DISPATCH)
                start = params(graph)
                dev_batches = [graph.put_batch(b) for b in batches]
                t = trainer_for(opt_cfg, dtype, steps_per_dispatch=DISPATCH)
                rows = []
                for i, (x, tg) in enumerate(dev_batches):
                    if i == DISPATCH:
                        t.set_learning_rate(lr / 2)
                    rows.append(t.train_step(x, tg))
                runs = {"eager": (torch.stack(rows), params(t))}
                del t
                zero()
                rows = [graph.train_steps(dev_batches[:DISPATCH])]
                graph.set_learning_rate(lr / 2)
                rows.append(graph.train_steps(dev_batches[DISPATCH:]))
                runs["graph"] = (torch.cat(rows), params(graph))
                torch.cuda.synchronize()
            finally:
                torch.backends.cudnn.deterministic = False
            per_replay = [g.counts[0] for g in graph._graphs.values()]

            def readings(a, b):
                (ra, pa), (rb, pb) = runs[a], runs[b]
                pr = _param_readings(pa, pb, start)
                return dict(loss=((ra[:, 0] - rb[:, 0]).abs() / rb[:, 0].abs()).max().item(),
                            **{k: pr[k] for k in keys[1:]})

            spread, got = postures[f"graph_{dtype_name}"]["spread"], readings("graph", "eager")
            finite = bool(torch.isfinite(runs["graph"][0][:, [0, 1, 2, 5]]).all())
            bound_ = {k: max(2 * spread[k], GRAPH_FLOOR) for k in keys}
            losses = ", ".join(f"{v:.5f}" for v in runs["graph"][0][:, 0].tolist())
            log(f"[optim {opt_name} {dtype_name}] {GRAPH_STEPS} steps at steps_per_dispatch "
                f"{DISPATCH}: graph loss {losses}; "
                f"graph vs eager of its form: " + ", ".join(f"{k} {got[k]:.3e}" for k in keys)
                + "; phase 12's eager spread: " + ", ".join(f"{k} {spread[k]:.3e}" for k in keys)
                + f"; kernel 1 per replay {per_replay} [{card}]")
            checks.append((f"optim {opt_name} {dtype_name}: graph = eager of its form within "
                           f"{bound_}", finite and all(got[k] <= bound_[k] for k in keys)
                           and per_replay == [DISPATCH]))
            res["optim"][f"{opt_name}_{dtype_name}"] = dict(against_eager=got, spread=spread)
            del runs, dev_batches, graph
    fresh, fresh_s = fresh_wait()
    if fresh is not None:
        log(f"[export] a fresh process with an empty build directory loaded and ran the "
            f"framed_int16 artifact in {fresh_s:.1f} s (beside the optimizers' checks): built "
            f"{fresh['built']}, launches {fresh['launches']}, models modules imported "
            f"{fresh['models']}")
    checks.append(("export: a fresh process builds the kernels at the loaded program's first "
                   "call and imports no models module",
                   fresh is not None and len(fresh["built"]) == 2 and not fresh["models"]
                   and kernels_ran(fresh["launches"])))
    shutil.rmtree(tmp, ignore_errors=True)
    for dtype_name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        # graph step time of each optimizer against Adam's, in turns, each
        # graph captured in cuDNN's default mode (as phase 12 times Adam's)
        step_ms = {name: trainer_for(opt_cfg, dtype, steps_per_dispatch=DISPATCH)
                   for name, opt_cfg in (*OPTIMIZERS_13.items(),
                                         ("Adam", tc["optimizer_config"]))}
        last = [step_ms["Adam"].put_batch(b) for b in batches[DISPATCH:]]
        for t in step_ms.values():
            t.train_steps(last)  # eager, then the capture
        times = {k: [] for k in step_ms}
        order = list(step_ms) + list(step_ms)[::-1]
        for k in order:
            times[k].append(time_ms(lambda: step_ms[k].train_steps(last), iters=3,
                                    warmup=1) / DISPATCH)
        log(f"[optim {dtype_name}] B={BATCH} graph step per step in turns: "
            + "; ".join(f"{k} {', '.join(f'{v:.3f}' for v in ts)} ms" for k, ts in times.items())
            + f" [{card}]")
        res["optim"][f"step_ms_{dtype_name}"] = times
        del step_ms, last
    del cached
    res["optim_s"] = time.perf_counter() - t_part

    for name in ("export_launches", "multi_launches", "pool_launches"):
        checks.append((f"{name}: kernels 1 and 2 launched ({res[name]})", kernels_ran(res[name])))
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 13] {res['seconds']:.1f} s: export {res['export_s']:.1f}, multi "
        f"{res['multi_s']:.1f}, pool {res['pool_s']:.1f}, optimizers {res['optim_s']:.1f}")
    for what, holds in checks:
        log(f"[phase 13] {'ok  ' if holds else 'FAIL'} {what}")
    bad = [what for what, holds in checks if not holds]
    assert not bad, f"phase 13 checks failed: {bad}"
    return res


def _wav_seconds(path):
    from audioyolo_tpu_torch.data.wavio import read_wav_info

    rate, frames, _ = read_wav_info(path)
    return frames / rate


def _raw_dataset(root, n, seconds, rate, seed):
    """``n`` PCM16 WAVs of tones over noise and two annotation JSONs, in the
    unsplit layout ``get_dataset.py`` expects under ``root/openbmat/raw``."""
    import numpy as np

    from audioyolo_tpu_torch.data.wavio import write_wav

    rng = np.random.default_rng(seed)
    audio, anns = (os.path.join(root, "openbmat", "raw", d) for d in ("audio", "anns"))
    os.makedirs(audio)
    os.makedirs(anns)
    t = np.arange(int(seconds * rate)) / rate
    for i in range(n):
        x = 0.01 * rng.standard_normal(t.size) + 0.3 * np.sin(2 * np.pi * 440.0 * (1 + i) * t)
        write_wav(os.path.join(audio, f"clip{i}.wav"), x.astype(np.float32), rate)
    for name in ("annotations_a.json", "annotations_b.json"):
        with open(os.path.join(anns, name), "w") as f:
            json.dump({"dummy": True}, f)


def phase_last_modules(dev, card, train_tmp):
    """Phase 14: the server on the JAX server's command line (the waveform
    path by default, ``--framed_input``, the default ``--model_path``),
    ``train_prng: rbg``, the int8 transfer gate and dataset preparation,
    each on the card against the CPU; needs phases 6 and 7's files."""
    import numpy as np
    import torch

    from audioyolo_tpu_torch import gate_int8_cli, get_dataset_cli, serve, train_cli
    from audioyolo_tpu_torch.data.loader import BatchLoader
    from audioyolo_tpu_torch.data.wavio import read_wav, read_wav_info
    from audioyolo_tpu_torch.models import AudioDetectionModel
    from audioyolo_tpu_torch.ops.cuda_graph import COUNTERS
    from audioyolo_tpu_torch.train import TrainerPipeline

    checks, res = [], {}
    t_phase = time.perf_counter()

    def zero():
        for c in COUNTERS:
            c.launches = 0

    def launches():
        return {c.__name__: c.launches for c in COUNTERS}

    cfg6 = _train_config(train_tmp)
    tc = cfg6.raw["train_config"]
    itmp = os.path.join(train_tmp, "inference")
    train_yaml = os.path.join(itmp, "train.yaml")  # phase 6's config, written by phase 7
    long_path = os.path.join(itmp, "long150.wav")

    # A. the server on the JAX server's command line: every JAX flag parsed;
    # no --model_path (the default is phase 6's saved model); one 150 s
    # request on the waveform path, one with --framed_input; each path's rows
    # against the same path on the CPU
    t_part = time.perf_counter()
    jax_line = ["--config", train_yaml, "--class_map_path", "", "--model_path", "",
                "--host", "127.0.0.1", "--port", "0", "--batch_size", str(BATCH),
                "--iou_threshold", "0.1", "--conf_threshold", "0.2", "--int8_calib", ""]
    parser = serve.make_parser()
    full = parser.parse_args(jax_line + ["--bf16", "--framed_input"])
    checks.append(("serve parses the JAX command line", full.bf16 and full.framed_input
                   and full.port == 0 and full.device == "cuda"))
    with open(long_path, "rb") as f:
        body = f.read()
    serve_counts, framer_calls = {}, {}
    res["serve"] = {}
    for path, extra in (("waveform", []), ("framed", ["--framed_input"])):
        args = parser.parse_args(jax_line + extra)
        state = serve.app_state_from_args(args)
        calls = [0]
        if state["frame_fn"] is not None:
            framer = state["frame_fn"]

            def counted(*a, _framer=framer, **k):
                calls[0] += 1
                return _framer(*a, **k)

            state["frame_fn"] = counted
        rows = {}
        real = serve.evaluate_audio

        def recording(key, real=real, rows=rows):
            def run(*a, **k):
                rows[key] = real(*a, **k)
                return rows[key]
            return run

        httpd = serve.serve(state, "127.0.0.1", 0)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            serve.evaluate_audio = recording("card")
            zero()
            t0 = time.perf_counter()
            req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/detect",
                                         data=body, method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                status, out = r.status, json.loads(r.read())
            req_ms = (time.perf_counter() - t0) * 1e3
            serve_counts[path], framer_calls[path] = launches(), calls[0]
            cpu_state = serve.app_state_from_args(parser.parse_args(jax_line + extra
                                                                    + ["--device", "cpu"]))
            serve.evaluate_audio = recording("cpu")
            serve.detect_wav_bytes(cpu_state, body)
        finally:
            serve.evaluate_audio = real
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=30)
        m, e, unexplained, dt, dc = _compare_rows(rows["card"], rows["cpu"], 0.2, 0.1)
        log(f"[serve cli] {path}: 150 s request {status}, {len(out.get('rows', []))} rows, "
            f"{req_ms:.1f} ms; host framer calls {calls[0]}; launches {serve_counts[path]}; "
            f"card vs CPU rows: {m} matched, {e} explained flips, {len(unexplained)} "
            f"unexplained, max |dt| {dt:.2e} s, max |dconf| {dc:.2e} [{card}]")
        counts = serve_counts[path]
        checks.append((f"serve {path}: answered, kernels 1 and 2 launched",
                       status == 200 and set(out) == {"events", "rows"} and out["rows"]
                       and counts["fused_mel_power"] > 0 and counts["greedy_suppress_blocked"] > 0))
        checks.append((f"serve {path}: host framer calls", (calls[0] > 0) == (path == "framed")))
        checks.append((f"serve {path}: rows match the CPU's", not unexplained and m > 0))
        res["serve"][path] = dict(request_ms=req_ms, rows=len(rows["card"]), matched=m,
                                  explained=e, framer_calls=calls[0])
    saved = os.path.join(tc["model_path"], "AudioDetectionModel.pt")
    checks.append(("serve's default --model_path is phase 6's saved model",
                   os.path.isfile(saved) and full.model_path == ""))
    res["serve_s"] = time.perf_counter() - t_part

    # B. train_prng: rbg, two steps at B=32 twice from one seed under
    # deterministic cuDNN: finite, and the second run equals the first
    t_part = time.perf_counter()
    train_ds, _ = train_cli.resolve_datasets(cfg6)
    dtype = train_cli.compute_dtype(cfg6.raw.get("tpu_config"))

    def two_steps():
        model = AudioDetectionModel.from_config(cfg6, 2, dtype=dtype,
                                                generator=torch.Generator().manual_seed(11))
        trainer = TrainerPipeline(model, train_cli.make_loss(cfg6, 2, train_ds.get_class_weights()),
                                  tc["optimizer_config"], tc["lr_scheduler_config"],
                                  model_path=os.path.join(train_tmp, "prng"), seed=42,
                                  prng_impl="rbg", device=dev)
        batch = next(iter(BatchLoader(train_ds, BATCH, shuffle=False, prefetch=0,
                                      transfer_dtype="int16",
                                      frame_fn=model.frontend.frame_host)))
        x, t = trainer.put_batch(batch)
        return trainer, torch.stack([trainer.train_step(x, t) for _ in range(2)]).cpu()

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        trainer, first = two_steps()
        _, second = two_steps()
    finally:
        torch.backends.cudnn.deterministic = False
    losses = first[:, 0].tolist()
    log(f"[train_prng] rbg: two steps at B={BATCH}, dropout {cfg6.raw['dropout']}, aggregate "
        f"loss {losses}; a second run from the same seed equal bit for bit: "
        f"{torch.equal(first, second)} (deterministic cuDNN) [{card}]")
    checks.append(("train_prng rbg: finite, the trainer holds it",
                   bool(torch.isfinite(first).all()) and trainer.prng_impl == "rbg"))
    checks.append(("train_prng rbg: same seed, same steps", torch.equal(first, second)))
    res["prng_losses"] = losses
    res["prng_s"] = time.perf_counter() - t_part

    # C. the int8 transfer gate on phase 6's saved model, card against
    # --device cpu, on phase 6's eval split (annotated spans, each padded to
    # the clip with zeros) and on the same split's full-length clips with
    # their spans stretched to the whole clip: the mAPs, and every detection
    # inside the audio. A row that reaches past the audio's end lies over a
    # zero-padded tail, where the MFCC image is rounding noise that kernel 1
    # and its plain version read differently (ROADMAP's deviations): those
    # rows are counted, not held; a row inside the audio that misses the
    # CPU's by more than 1e-3 s must have a twin within the gate's own
    # tolerances
    whole = os.path.join(train_tmp, "gate_whole")
    os.makedirs(os.path.join(whole, "eval"))
    with open(os.path.join(tc["dataset_path"], "annotations", "annotation.json")) as f:
        ann = json.load(f)["annotations"][tc["annotator"]]
    stretched = {}
    for name in sorted(ann):
        wav = os.path.join(tc["dataset_path"], "eval", f"{name}.wav")
        segs = ann[name]
        if not os.path.isfile(wav) or not segs or _wav_seconds(wav) < cfg6.sample_duration:
            continue
        keys = sorted(segs, key=lambda k: int(k.split("-")[-1]))
        segs = {k: dict(v) for k, v in segs.items()}
        segs[keys[0]]["start"], segs[keys[-1]]["end"] = 0.0, float(cfg6.sample_duration)
        stretched[name] = segs
        shutil.copy(wav, os.path.join(whole, "eval"))
    os.makedirs(os.path.join(whole, "annotations"))
    with open(os.path.join(whole, "annotations", "annotation.json"), "w") as f:
        json.dump({"annotations": {tc["annotator"]: stretched}}, f)
    # where each clip's audio ends on the padded split (the gate numbers its
    # clips in the dataset's order); the whole split's clips have no tail
    eval_ds = train_cli.make_dataset(os.path.join(tc["dataset_path"], "eval"), ann, cfg6)
    audio_end = []
    for i in range(len(eval_ds)):
        wav, offset, count = eval_ds.audio_span(i)
        rate, frames, _ = read_wav_info(wav)
        audio_end.append(min(count, frames - offset) / rate)
    audio_ends = {"padded": audio_end, "whole": [float("inf")] * len(stretched)}

    def gate(dataset, device_args):
        """The gate's JSON and each entry's detections."""
        dets, real = {}, gate_int8_cli.summarize

        def record(name, detections, *a, **k):
            dets[name] = detections
            return real(name, detections, *a, **k)

        gate_int8_cli.summarize = record
        try:
            out = gate_int8_cli.main(["--config", train_yaml, "--dataset_path", dataset,
                                      "--model_path", saved, "--class_map",
                                      os.path.join(tc["class_map_path"], "class_map.json"),
                                      *device_args])
        finally:
            gate_int8_cli.summarize = real
        return out, dets

    def by_clip(dets):
        rows = {}
        for fid, cls, conf, start, end in dets:
            rows.setdefault(fid, []).append(dict(class_idx=cls, confidence=conf, start=start,
                                                 end=end))
        return rows

    gate_read = {}
    for split, dataset in (("padded", tc["dataset_path"]), ("whole", whole)):
        zero()
        t0 = time.perf_counter()
        on_card, card_dets = gate(dataset, [])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        counts = launches()
        t0 = time.perf_counter()
        on_cpu, cpu_dets = gate(dataset, ["--device", "cpu"])
        cpu_s = time.perf_counter() - t0
        gap = max(abs(a[k] - b[k]) for a, b in zip(on_card["results"], on_cpu["results"])
                  for k in a if k.startswith("mAP"))
        rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                  for a, b in zip(on_card["results"], on_cpu["results"])
                  for k in a if k.startswith("mAP"))
        n = [(a["num_detections"], b["num_detections"])
             for a, b in zip(on_card["results"], on_cpu["results"])]
        m = e = 0
        unexplained = []  # (entry, clip, side, row)
        for entry in ("int16", "int8"):
            a, b = by_clip(card_dets[entry]), by_clip(cpu_dets[entry])
            for fid in sorted(set(a) | set(b)):
                mm, ee, uu, _, _ = _compare_rows(a.get(fid, []), b.get(fid, []), 0.05, 0.1,
                                                 cascade=True)
                m, e = m + mm, e + ee
                unexplained += [(entry, fid, "card" if any(r is q for q in a.get(fid, []))
                                 else "cpu", r) for r in uu]
        end = audio_ends[split]
        tail = [u[3]["start"] - end[u[1]] for u in unexplained if u[3]["end"] > end[u[1]]]
        inside = [u for u in unexplained if u[3]["end"] <= end[u[1]]]

        def twin(u):
            """A row of the other side for the same event within the gate's
            own tolerances (``row_diff``: 0.05 s, 0.02 confidence)."""
            return next((v for v in unexplained if v[:2] == u[:2] and v[2] != u[2]
                         and v[3]["class_idx"] == u[3]["class_idx"]
                         and abs(v[3]["start"] - u[3]["start"]) <= 0.05
                         and abs(v[3]["end"] - u[3]["end"]) <= 0.05
                         and abs(v[3]["confidence"] - u[3]["confidence"]) <= 0.02), None)

        # a row inside the audio with such a twin: the same event, its box or
        # confidence moved by the zeros through the model's receptive field
        paired = [(u, twin(u)) for u in inside]
        moved = [(u, v) for u, v in paired if v is not None]
        lone = [u for u, v in paired if v is None]
        moved_dt = max((max(abs(v[3]["start"] - u[3]["start"]), abs(v[3]["end"] - u[3]["end"]))
                        for u, v in moved), default=0.0)
        tails = sum(x < cfg6.sample_duration for x in end)
        log(f"[gate] {split} split ({len(os.listdir(os.path.join(dataset, 'eval')))} clips): "
            f"card {card_s:.1f} s: {json.dumps(on_card)}; launches {counts}")
        log(f"[gate] {split} split: CPU {cpu_s:.1f} s: {json.dumps(on_cpu)}; largest mAP gap "
            f"{gap:.3e} (bound {MAP_GAP_BOUND}); detections card/CPU per entry {n}; "
            f"relative {rel:.3e} (bound {MAP_REL_GAP_BOUND}); {m} matched, {e} explained "
            f"flips, {len(unexplained)} unexplained [{card}]")
        log(f"[gate] {split} split: {tails} of {len(end)} clips end in zeros; unexplained rows "
            f"over a zero-padded tail {len(tail)}"
            + (f" (start minus the audio's end {min(tail):.2f} to {max(tail):.2f} s)" if tail
               else "")
            + f", inside the audio {len(inside)}: {len(moved)} with a twin on the other side "
            f"(max |dt| {moved_dt:.3f} s), {len(lone)} without"
            + "".join(f"; {en} clip {fid} {side}: class {r['class_idx']}, confidence "
                      f"{r['confidence']:.4f}, {r['start']:.3f}-{r['end']:.3f} s, the audio "
                      f"ends at {end[fid]:.3f} s" for en, fid, side, r in inside))
        checks.append((f"gate {split}: card vs CPU mAP gap", gap <= MAP_GAP_BOUND))
        checks.append((f"gate {split}: card vs CPU mAP gap relative to the CPU's",
                       rel <= MAP_REL_GAP_BOUND))
        checks.append((f"gate {split}: every row inside the audio is matched, a flip or a "
                       "twin within the gate's tolerances", not lone and m > 0))
        checks.append((f"gate {split}: kernel 2 launched", counts["greedy_suppress_blocked"] > 0))
        gate_read[split] = dict(json=on_card, card_s=card_s, cpu_s=cpu_s, map_gap=gap,
                                map_rel_gap=rel, detections=n, matched=m, explained=e,
                                unexplained_over_tail=len(tail), moved_inside=len(moved),
                                unexplained_inside=len(lone),
                                launches=counts)
    gate_counts = gate_read["padded"]["launches"]
    res["gate"] = {k: {kk: vv for kk, vv in v.items() if kk != "launches"}
                   for k, v in gate_read.items()}

    # D. dataset preparation: ten 60 s files at 16 kHz resampled to 22 050 Hz
    # on the card and on the CPU; the same split and PCM16 within 1 LSB
    src = os.path.join(train_tmp, "get_dataset", "src")
    _raw_dataset(src, 10, cfg6.sample_duration, 16000, seed=3)
    walls, dirs = {}, {}
    for where in ("cuda", "cpu"):
        root = os.path.join(train_tmp, "get_dataset", where)
        shutil.copytree(src, root)
        t0 = time.perf_counter()
        get_dataset_cli.main(["--root", root, "--name", "openbmat", "--seed", "0",
                              "--target_sample_rate", str(cfg6.sample_rate), "--device", where])
        walls[where] = time.perf_counter() - t0
        dirs[where] = os.path.join(root, "openbmat")
    listing = {w: sorted(os.path.relpath(os.path.join(dp, n), d) for dp, _, names in os.walk(d)
                         for n in names) for w, d in dirs.items()}
    lsb, rates = 0.0, set()
    for rel in (r for r in listing["cuda"] if r.endswith(".wav")):
        a, ra = read_wav(os.path.join(dirs["cuda"], rel))
        b, rb = read_wav(os.path.join(dirs["cpu"], rel))
        rates |= {ra, rb}
        assert a.shape == b.shape, rel
        lsb = max(lsb, float(np.abs(a - b).max() * 32768.0))
    log(f"[get_dataset] 10 files of {cfg6.sample_duration:g} s, 16000 -> {cfg6.sample_rate} Hz: "
        f"card {walls['cuda']:.2f} s, CPU {walls['cpu']:.2f} s; listings equal "
        f"{listing['cuda'] == listing['cpu']}; rates {sorted(rates)}; largest PCM16 difference "
        f"{lsb:.0f} LSB [{card}]")
    checks.append(("get_dataset: same split and files", listing["cuda"] == listing["cpu"]
                   and sum(r.endswith(".wav") for r in listing["cuda"]) == 10))
    checks.append(("get_dataset: resampled, within 1 LSB",
                   rates == {cfg6.sample_rate} and lsb <= 1.0))
    res.update(get_dataset_s=walls["cuda"], get_dataset_cpu_s=walls["cpu"], get_dataset_lsb=lsb)

    res["serve_cli_launches"] = {k: serve_counts["waveform"][k] + serve_counts["framed"][k]
                                 for k in serve_counts["framed"]}
    res["gate_launches"] = gate_counts
    res["seconds"] = time.perf_counter() - t_phase
    failed = [w for w, held in checks if not held]
    log(f"[last modules] phase 14 {res['seconds']:.1f} s; {len(checks) - len(failed)} of "
        f"{len(checks)} checks hold" + (f"; failed: {failed}" if failed else ""))
    assert not failed, failed
    return res


def _csv_tree(root):
    found = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n)) as f:
                found[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return found


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
        host = phase_native(dev, card, tmp)
        bf16 = phase_bf16_serving(dev, card)
        custom = phase_custom(dev, card, tmp)
        int8 = phase_int8(dev, card, tmp)
        postures = phase_train_postures(dev, card, tmp)
        rest = phase_port_rest(dev, card, tmp, postures)
        last = phase_last_modules(dev, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    src = "audioyolo_tpu_torch/csrc/"

    def paths(name):
        return dict(infer_launches=inference["infer_launches"][name],
                    eval_launches=inference["eval_launches"][name],
                    bf16_launches=bf16["launches"].get(name, 0),
                    custom_launches=custom["launches"].get(name, 0),
                    int8_launches=int8["launches"].get(name, 0),
                    graph_launches=postures["graph_launches"][name],
                    cache_launches=postures["cache_launches"][name],
                    dp_launches=postures["dp_launches"][name],
                    export_launches=rest["export_launches"][name],
                    multi_launches=rest["multi_launches"][name],
                    pool_launches=rest["pool_launches"][name],
                    serve_cli_launches=last["serve_cli_launches"][name],
                    gate_launches=last["gate_launches"][name])

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
    log(json.dumps({"native": host, "bf16_serving": {k: v for k, v in bf16.items()
                                                     if k != "launches"},
                    "custom": {k: v for k, v in custom.items() if k != "launches"}}))
    log(json.dumps({"int8": {k: v for k, v in int8.items() if k != "launches"}}))
    log(json.dumps({"train_postures": {k: v for k, v in postures.items()
                                       if not k.endswith("launches")}}))
    log(json.dumps({"port_rest": {k: v for k, v in rest.items() if not k.endswith("launches")}}))
    log(json.dumps({"last_modules": {k: v for k, v in last.items()
                                     if not k.endswith("launches")}}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

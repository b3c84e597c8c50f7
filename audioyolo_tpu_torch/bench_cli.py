"""Benchmarks of the five baseline configurations on the card (port of the
root ``bench.py``).

Usage::

    python3 -m audioyolo_tpu_torch.bench_cli [--full] [--device cpu]

By default one JSON line, the headline: batched offline inference of 60 s
clips, RepVGG folded, bf16 deploy model with the calibrated int8 body, the
int8 DFT frontend on ``(q, scale)`` frames, 4 batches of 256 clips per
dispatch (``make_multi_inference_fn``, one CUDA graph)::

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

``vs_baseline`` is the ratio against the 50x-audio-realtime target of
``BASELINE.md``. ``--full`` adds six lines, in ``bench.py``'s order:
single-clip latency, long-form streaming through a 4-worker
``StreamWorkerPool`` and in one process, the training step at B=128 and
B=32, and the scaled backbone (Bottleneck [3,4,6,3]) in the headline's
posture. Metric names, units and extra keys are ``bench.py``'s, but
``hbm_pct``: PyTorch has no count of the bytes a fused program moves (XLA's
cost model gave the JAX bench one), so no memory share is claimed.
``tflops_per_dispatch`` and ``mfu_pct`` come from
``torch.utils.flop_counter.FlopCounterMode`` over one eager pass of a
dispatch's work (a CUDA graph replay is invisible to it), with formulas for
``torch._int_mm`` (2MKN, int8 MACs counted as the JAX bench counts them)
and kernel 1's main pass, against the H100 SXM's dense bf16 peak.

The JAX bench's environment switches, same names and defaults:
``BENCH_INT8_BODY`` (1: int8 body in the headline and the scaled backbone),
``BENCH_STREAM_TRANSFER`` (int8), ``BENCH_TRAIN_B`` (128), ``BENCH_TRAIN_S``
(8), ``BENCH_TRAIN_FRONTEND`` (int8), ``BENCH_TRAIN_REMAT`` (0) and
``BENCH_TRAIN_PRNG`` (rbg). Kernel 1 runs where the frontend is
``default`` and the config sets ``pallas_frontend: on``, as in the JAX
package; the int8 DFT runs ``torch._int_mm``.

Stdout carries the JSON lines only; each posture's peak device memory goes
to stderr. ``--device cpu`` runs on the CPU (for the tests, at small
sizes); without a card and without it, the bench raises.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .config import Config, load_config
from .device import resolve_device

BASELINE_AUDIO_SECONDS_PER_SEC = 50.0  # 50x realtime target per chip (BASELINE.md)
NUM_CLASSES = 2
CONFIG = "config/config.yaml"
BATCH_INFER = 256  # offline batch of the headline and the scaled backbone
BATCH = 32         # single-process streaming keeps the reference's batch
N_DISPATCH = 4     # batches per dispatch in the headline and the scaled backbone
WARMUP = 3
ITERS = 10
T1_SAMPLES = 3     # single-dispatch timings, the least taken (_differenced)
TRAIN_ITERS = 8
TRAIN_B_REF = 32   # the reference's training batch, the second train line
STREAM_MINUTES, POOL_MINUTES = 30, 120
POOL_WORKERS, POOL_BATCH = 4, 8
SCALED_BLOCK, SCALED_LAYERS = "Bottleneck", (3, 4, 6, 3)
# NVIDIA H100 SXM data sheet, dense bf16 tensor-core peak
H100_BF16_PEAK = 989.4e12
CACHE_DIR = os.path.join("~", ".cache", "audioyolo_torch_bench")
STREAM_FACTORY = "audioyolo_tpu_torch.bench_cli:_stream_factory"


def _emit(metric, value, unit, vs=None, **extra) -> dict:
    """Print one JSON line (``bench.py``'s keys and rounding) and return it
    as a dict."""
    line = {
        "metric": metric,
        "value": round(float(value), 2),
        "unit": unit,
        "vs_baseline": round(float(vs if vs is not None
                                   else value / BASELINE_AUDIO_SECONDS_PER_SEC), 3),
        **extra,
    }
    print(json.dumps(line), flush=True)
    return line


def _source_hash() -> str:
    """md5 of the port's ``models/`` and ``ops/`` sources."""
    pkg = os.path.dirname(os.path.abspath(__file__))
    code = hashlib.md5()
    for sub in ("models", "ops"):
        d = os.path.join(pkg, sub)
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".py"):
                with open(os.path.join(d, fn), "rb") as f:
                    code.update(f.read())
    return code.hexdigest()


def _weights_path(raw, block=None, layers=None, code=None) -> str:
    """The weight file of a posture: keyed on the config, the backbone
    override and the model code's hash, so that no stale weights outlive a
    change to ``models/`` or ``ops/``."""
    key = hashlib.md5(repr((sorted(raw.items(), key=str), block,
                            None if layers is None else list(layers), NUM_CLASSES,
                            code or _source_hash())).encode()).hexdigest()[:16]
    return os.path.join(os.path.expanduser(CACHE_DIR), f"ayt_bench_vars_{key}.pt")


def _bench_variables(raw, block=None, layers=None):
    """Seeded, folded bench weights (a state dict on the CPU), built once per
    posture and machine and shared through a file, so that the streaming
    pool's workers load them instead of each building their own.

    The train-form model is initialised from a ``torch.Generator`` seeded 0
    and folded (``models/reparam.py::fold_repvgg``); the file is written
    through an atomic ``os.replace`` (pool workers may race). The weights
    are not the JAX bench's ``PRNGKey(0)`` draw: the bench's detections are
    meaningless either way. The JAX bench's branches for a CPU backend beside
    a remote TPU runtime have no counterpart: the init runs on the CPU here.
    """
    from .models import AudioDetectionModel, fold_repvgg

    path = _weights_path(raw, block, layers)
    if os.path.exists(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    model = AudioDetectionModel.from_config(raw, NUM_CLASSES,
                                            generator=torch.Generator().manual_seed(0))
    state = fold_repvgg({k: v.detach() for k, v in model.state_dict().items()})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return state


def _build_infer(cfg, block=None, layers=None, keep_k=128, packed=False, n_dispatch=1,
                 int8=False, int8_input=False, frontend="int8", device=None):
    """``(infer_fn, frame_fn, raw)`` of a posture on ``device``.

    ``frontend``: ``tpu_config.frontend_precision`` ("int8": the int8 DFT on
    the host's ``(q, scale)`` frames; "default": one bf16 pass, kernel 1
    where the config sets ``pallas_frontend: on``). The deploy model is
    bf16. ``frame_fn`` is ``frame_host_int8`` for the int8 DFT,
    ``frame_host`` for another fused frontend, else None. ``int8``: the body
    runs int8 at scales calibrated (``models/quant.py``) on
    ``synth_event_clips(8, sr, duration)`` framed by ``frame_fn``.
    ``n_dispatch > 1``: ``make_multi_inference_fn`` (one CUDA graph on the
    card), else ``make_inference_fn``. IoU 0.1, confidence 0.2.
    """
    from .infer.decode import make_inference_fn, make_multi_inference_fn
    from .inference_cli import model_input_on
    from .models import AudioDetectionModel
    from .models.quant import calibrate_quant, set_quant
    from .utils.synth_audio import synth_event_clips

    dev = resolve_device(device)
    raw = cfg.to_dict()
    if block:
        raw["resnet_config"] = {"block": block}
        raw["block_layers"] = list(layers)
    raw.setdefault("tpu_config", {})["frontend_precision"] = frontend
    # the weights do not depend on the frontend posture: one file for all
    raw_vars = {**raw, "tpu_config": {**raw["tpu_config"], "frontend_precision": "default"}}
    state = _bench_variables(raw_vars, block, layers)
    deploy = AudioDetectionModel.from_config(raw, NUM_CLASSES, deploy=True,
                                             dtype=torch.bfloat16)
    fe = deploy.frontend
    if fe.fused is None:
        frame_fn = None
    elif fe.fused_int8:
        frame_fn = fe.frame_host_int8  # -> (q int8, scale) tuple
    else:
        frame_fn = fe.frame_host
    if int8:
        # event audio, not noise: tonal events drive ~20 dB more activation
        # range through the frontend than a flat noise floor
        calib = synth_event_clips(8, int(cfg.sample_rate), float(cfg.sample_duration))
        calib = frame_fn(calib[:, 0, :]) if frame_fn is not None else calib
        deploy.load_state_dict(state)
        deploy.to(dev).eval()
        set_quant(deploy, calibrate_quant(deploy, [model_input_on(calib, dev)]))
    if n_dispatch > 1:
        infer_fn = make_multi_inference_fn(deploy, state, n_dispatch, 0.1, 0.2, keep_k,
                                           packed=packed, device=dev)
    else:
        infer_fn = make_inference_fn(deploy, state, 0.1, 0.2, keep_k, packed=packed,
                                     device=dev, int8_input=int8_input)
    return infer_fn, frame_fn, raw


def _flop_formulas(model) -> dict:
    """FlopCounterMode formulas for what it has none of: ``torch._int_mm``
    (2MKN) and kernel 1's main pass, counted as ``chip_smoke.py`` counts its
    bound, 2·B·R·G·(F·2F' + 2F'·32) over the unpadded sizes."""
    from .ops.mel_kernel import MelKernelFrontend

    dims = {tuple(m.ct.shape): (m.frame_len, m.n_spec)
            for m in model.modules() if isinstance(m, MelKernelFrontend)}

    def int_mm(a_shape, b_shape, *args, out_shape=None, **kwargs):
        return 2 * a_shape[0] * a_shape[1] * b_shape[1]

    def mel_power_staged(xs_shape, ct_shape, mel2t_shape, b, g, *args, out_shape=None,
                         **kwargs):
        f, k2 = dims[tuple(ct_shape)]
        return 2 * b * ct_shape[0] * g * (f * k2 + k2 * mel2t_shape[0])

    return {torch.ops.aten._int_mm: int_mm,
            torch.ops.audioyolo_tpu_torch.mel_power_staged: mel_power_staged}


def count_flops(fn, arg, model) -> int:
    """FLOPs of ``fn(arg)``, run once, eagerly, under ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False, custom_mapping=_flop_formulas(model))
    with counter:
        fn(arg)
    return int(counter.get_total_flops())


def _cost_fields(flops, dt_dispatch) -> dict:
    """``tflops_per_dispatch`` and ``mfu_pct`` of a dispatch of ``flops``
    that took ``dt_dispatch`` s. A count of 0 raises: it would read as a
    meaningless utilization."""
    if flops <= 0:
        raise RuntimeError("the FLOP count of a dispatch read 0")
    return {
        "tflops_per_dispatch": round(flops / 1e12, 3),
        "mfu_pct": round(100.0 * flops / max(dt_dispatch, 1e-12) / H100_BF16_PEAK, 2),
    }


def _force(dev) -> None:
    """Wait until every queued kernel has run."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _differenced(timed, n):
    """Seconds a dispatch: ``timed(n + 1)`` minus ``timed(1)`` (each the
    seconds of that many dispatches closed by a wait), over ``n``, so that
    the wait and the host overhead common to both cancel. The single
    dispatch is the least of ``T1_SAMPLES`` timings, so that one stall of
    the host in it cannot swamp the difference; a difference at or below 0
    is noise and raises (it would read as an impossible rate)."""
    t1 = min(timed(1) for _ in range(T1_SAMPLES))
    tn = timed(n + 1)
    if tn <= t1:
        raise RuntimeError(f"{n + 1} dispatches took {tn:.6f} s, no longer than one "
                           f"({t1:.6f} s): the timing is noise")
    return (tn - t1) / n


def _steady_state(fn, arg, dev):
    """Steady time of one dispatch, in s, after ``WARMUP`` dispatches."""
    for _ in range(WARMUP):
        fn(arg)
    _force(dev)

    def timed(n):
        t0 = time.perf_counter()
        for _ in range(n):
            fn(arg)
        _force(dev)
        return time.perf_counter() - t0

    return _differenced(timed, ITERS)


def _bench_input(cfg, frame_fn, batch, seed, dev):
    """A batch generated on the device from a seeded generator, in the
    serving layout: ``(q int8, scale)`` frames for the int8 DFT (scale
    0.1/127), float32 frames for another fused frontend, else a float32
    waveform. Per-frame iid noise costs what framed audio costs; the
    detections are meaningless either way."""
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    if frame_fn is not None:
        probe = frame_fn(np.zeros((1, int(cfg.clip_samples)), np.float32))
        if isinstance(probe, tuple):
            shape = (batch,) + tuple(probe[0].shape[1:])
            q = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            return q, torch.full((batch,), 0.1 / 127.0, dtype=torch.float32, device=dev)
        shape = (batch,) + tuple(probe.shape[1:])
    else:
        shape = (batch, 1, int(cfg.clip_samples))
    return torch.randn(shape, generator=gen, device=dev) * 0.1


def _finite(out) -> bool:
    if isinstance(out, dict):
        return all(_finite(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return all(_finite(v) for v in out)
    return bool(torch.isfinite(out.float()).all()) if out.is_floating_point() else True


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _log_peak(what, dev) -> None:
    if dev.type == "cuda":
        print(f"[bench] {what}: peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB", file=sys.stderr,
              flush=True)


def bench_batched(cfg, infer_fn, frame_fn, batch=None, n_dispatch=1, with_cost=False):
    """audio-s/s of ``infer_fn`` at ``batch`` (default ``BATCH_INFER``) and
    ``n_dispatch`` batches per dispatch (``(audio-s/s, cost)`` with
    ``with_cost``). A dispatch whose outputs are not finite, or whose MFU
    exceeds 100%, raises: the JAX bench slept and measured again there,
    because its remote runtime could return before the work ran; a CUDA
    wait cannot, so a retry would only hide a fault."""
    batch = BATCH_INFER if batch is None else batch
    dev = infer_fn.device
    if n_dispatch > 1:
        arg = [_bench_input(cfg, frame_fn, batch, i, dev) for i in range(n_dispatch)]
        eager = infer_fn.single
        model = eager.model

        def eager_all(audios):
            return [eager(a) for a in audios]
    else:
        arg = _bench_input(cfg, frame_fn, batch, 0, dev)
        eager_all, model = infer_fn, infer_fn.model
    dt_dispatch = _steady_state(infer_fn, arg, dev)
    cost = _cost_fields(count_flops(eager_all, arg, model), dt_dispatch)
    out = infer_fn(arg)
    _force(dev)
    if not _finite(out):
        raise RuntimeError("bench_batched: a dispatch gave non-finite outputs")
    if cost["mfu_pct"] > 100.0:
        raise RuntimeError(f"bench_batched: impossible utilization {cost}")
    dt = dt_dispatch / max(n_dispatch, 1)
    thr = batch * float(cfg.sample_duration) / dt
    return (thr, cost) if with_cost else thr


def bench_single_clip(cfg, infer_fn_b1, frame_fn):
    """ms per 60 s clip through one single-clip dispatch."""
    audio = _bench_input(cfg, frame_fn, 1, 1, infer_fn_b1.device)
    return _steady_state(infer_fn_b1, audio, infer_fn_b1.device) * 1000.0


def _long_wav(cfg, tmpdir, minutes):
    """A ``minutes``-long noise WAV at the config's rate, written once."""
    from .data.wavio import write_wav

    os.makedirs(tmpdir, exist_ok=True)
    sr = int(cfg.sample_rate)
    path = os.path.join(tmpdir, f"long{minutes}_{sr}.wav")
    if not os.path.exists(path):
        x = (np.random.default_rng(2).standard_normal(int(minutes * 60 * sr)) * 0.1
             ).astype(np.float32)
        tmp = f"{path}.{os.getpid()}.tmp"
        write_wav(tmp, x, sr)
        os.replace(tmp, path)
    return path


def _stream_tmpdir() -> str:
    return os.path.join(tempfile.gettempdir(), "bench_stream_torch")


def bench_streaming(cfg, infer_fn, frame_fn, tmpdir=None, transfer="int16", minutes=None):
    """Long-form streaming in one process (host IO, chunking, the transfer
    and the RLE merge included): audio-s/s of a ``STREAM_MINUTES`` file at
    batch ``BATCH``, one warm run, then the median of 3."""
    from .infer.streaming import evaluate_audio

    tmpdir = tmpdir or _stream_tmpdir()
    minutes = STREAM_MINUTES if minutes is None else minutes
    path = _long_wav(cfg, tmpdir, minutes)
    kwargs = dict(
        input_sample_rate=int(cfg.sample_rate), sample_duration=float(cfg.sample_duration),
        batch_size=BATCH, idx2class_map={i: f"c{i}" for i in range(NUM_CLASSES)},
        frame_fn=frame_fn, transfer=transfer,
    )
    evaluate_audio(infer_fn, path, tmpdir, **kwargs)  # warm: lazy setup, page cache
    dts = []
    for _ in range(3):
        t0 = time.perf_counter()
        evaluate_audio(infer_fn, path, tmpdir, **kwargs)
        dts.append(time.perf_counter() - t0)
    return minutes * 60 / float(np.median(dts))


def _stream_factory(config=CONFIG, int8_input=False, device=None):
    """The pool workers' factory: the bench model (loaded from the shared
    weight file) as ``(infer_fn, None)``; streaming ships waveforms (int16,
    or int8 ``(q, scale)`` with ``int8_input``), not host frames."""
    infer_fn, _, _ = _build_infer(load_config(config), packed=True, int8_input=int8_input,
                                  device=device)
    return infer_fn, None


def bench_streaming_pool(cfg, workers=None, tmpdir=None, transfer="int16", minutes=None,
                         config=CONFIG, device=None):
    """Streaming through a ``StreamWorkerPool``: a ``POOL_MINUTES`` file
    sharded by chunk ranges (batch ``POOL_BATCH``) over ``workers`` (default
    ``POOL_WORKERS``) processes, each building its model from ``config`` on
    ``device``. Pool start and the first run are excluded; the median of 3
    runs on the warm pool. Returns ``(audio-s/s, detect_regime())``."""
    from .infer.pool import StreamWorkerPool

    dev = resolve_device(device)
    tmpdir = tmpdir or _stream_tmpdir()
    minutes = POOL_MINUTES if minutes is None else minutes
    workers = POOL_WORKERS if workers is None else workers
    path = _long_wav(cfg, tmpdir, minutes)
    eval_kwargs = dict(
        input_sample_rate=int(cfg.sample_rate), sample_duration=float(cfg.sample_duration),
        batch_size=POOL_BATCH, idx2class_map={i: f"c{i}" for i in range(NUM_CLASSES)},
        transfer=transfer,
    )
    # the shared weight file first, so that the workers load it
    raw = cfg.to_dict()
    raw.setdefault("tpu_config", {})["frontend_precision"] = "default"
    _bench_variables(raw)
    with StreamWorkerPool(STREAM_FACTORY, {"config": config, "int8_input": transfer == "int8",
                                           "device": str(dev)},
                          workers, eval_kwargs) as pool:
        pool.warmup()
        regime = pool.detect_regime()
        pool.evaluate_file(path, tmpdir)  # warm
        dts = []
        for _ in range(3):
            t0 = time.perf_counter()
            pool.evaluate_file(path, tmpdir)
            dts.append(time.perf_counter() - t0)
    return minutes * 60 / float(np.median(dts)), regime


def _build_train(cfg, batch=None, steps=None, device=None):
    """``(trainer, S device batches, cfg)`` of the training posture: bf16
    body, ``frontend_precision`` from ``BENCH_TRAIN_FRONTEND`` (int8: the
    host's ``(q, scale)`` frames), the JAX bench's loss arguments, the
    config's optimizer, EMA on, ``steps_per_dispatch`` S (``steps``, else
    ``BENCH_TRAIN_S``), remat from ``BENCH_TRAIN_REMAT``, dropout masks from
    ``BENCH_TRAIN_PRNG``; S seeded batches of ``batch`` (else
    ``BENCH_TRAIN_B``) clips with 16 targets each, put on the device."""
    from .models import AudioDetectionModel
    from .train import AudioDetectionLoss, TrainerPipeline

    dev = resolve_device(device)
    B = int(batch if batch is not None else os.environ.get("BENCH_TRAIN_B", "128"))
    S = int(steps if steps is not None else os.environ.get("BENCH_TRAIN_S", "8"))
    R = os.environ.get("BENCH_TRAIN_REMAT", "0") not in ("0", "false", "off")
    raw = cfg.to_dict()
    raw.setdefault("tpu_config", {})["frontend_precision"] = os.environ.get(
        "BENCH_TRAIN_FRONTEND", "int8")
    cfg = Config(raw)
    model = AudioDetectionModel.from_config(cfg, NUM_CLASSES, dtype=torch.bfloat16)
    tc = cfg.raw["train_config"]
    loss_fn = AudioDetectionLoss(
        cfg.raw["anchors"], NUM_CLASSES, sample_duration=cfg.sample_duration,
        multi_label=True, label_smoothing=0.08, box_w=0.1, class_w=0.3, anchor_t=5,
    )
    out = os.path.join(tempfile.gettempdir(), "bench_m")
    trainer = TrainerPipeline(model, loss_fn, tc["optimizer_config"], tc["lr_scheduler_config"],
                              use_ema=True, ema_config=tc["ema_config"], metrics_path=out,
                              model_path=out, steps_per_dispatch=S, remat=R,
                              prng_impl=os.environ.get("BENCH_TRAIN_PRNG", "rbg") or None,
                              device=dev)
    rng = np.random.default_rng(3)
    n = 16
    fe = model.frontend
    audio = (rng.standard_normal((B, 1, int(cfg.clip_samples))) * 0.1).astype(np.float32)
    if fe.fused is not None and fe.fused_int8:
        audio = fe.frame_host_int8(audio[:, 0, :])
    elif fe.fused is not None:
        audio = fe.frame_host(audio[:, 0, :])
    batch = {
        "audio": audio,
        "classes": rng.integers(0, NUM_CLASSES, (B, n)).astype(np.int32),
        "centers": rng.uniform(1, 59, (B, n)).astype(np.float32),
        "widths": rng.uniform(0.5, 30, (B, n)).astype(np.float32),
        "valid": np.ones((B, n), bool),
    }
    batches = []
    for _ in range(S):  # S distinct device batches, as a prefetching loader holds them
        b = dict(batch)
        b["classes"] = rng.integers(0, NUM_CLASSES, (B, n)).astype(np.int32)
        batches.append(trainer.put_batch(b))
    return trainer, batches, cfg


def bench_train_step(cfg, batch=None, device=None):
    """Training audio-s/s of the training posture and its cost fields.

    The FLOPs are those of one dispatch's S steps taken eagerly (the first
    S steps); then one dispatch (on the card: the capture), then the steady
    time of ``train_steps`` (one CUDA graph on the card). The metrics must
    be finite and the step counter must advance by the steps dispatched,
    else it raises."""
    trainer, batches, cfg = _build_train(cfg, batch, device=device)
    dev = trainer.device
    B = batches[0][1]["classes"].shape[0]
    S = len(batches)
    model = trainer.model
    flops = count_flops(lambda bs: [trainer.train_step(a, t) for a, t in bs], batches, model)
    trainer.train_steps(batches)
    _force(dev)

    last = {}

    def timed(n):
        t0 = time.perf_counter()
        for _ in range(n):
            m = trainer.train_steps(batches)
        last["metrics"] = m.float().cpu().numpy()  # waits for the last dispatch
        return time.perf_counter() - t0

    step0 = trainer.step
    dt = _differenced(timed, TRAIN_ITERS) / S
    mv = last["metrics"]
    steps_done = trainer.step - step0
    cost = _cost_fields(flops, dt * S)
    if not (np.isfinite(mv).all() and steps_done == (TRAIN_ITERS + 1 + T1_SAMPLES) * S
            and cost["mfu_pct"] <= 100.0):
        raise RuntimeError(f"bench_train_step: invalid measurement (steps_done={steps_done}, "
                           f"finite={bool(np.isfinite(mv).all())}, cost={cost})")
    return B * float(cfg.sample_duration) / dt, cost


def _release(dev) -> None:
    """Return what a finished posture held (its graphs, inputs and pools)."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(config=CONFIG, full=False, device=None) -> list:
    """The bench's lines, printed as they come, returned as dicts."""
    dev = resolve_device(device)
    cfg = load_config(config)
    use_int8_body = os.environ.get("BENCH_INT8_BODY", "1") == "1"
    body = "int8" if use_int8_body else "bf16"
    fe_mode = "int8"
    _reset_peak(dev)
    infer_multi, frame_fn, _ = _build_infer(cfg, n_dispatch=N_DISPATCH, int8=use_int8_body,
                                            frontend=fe_mode, device=dev)
    thr, cost = bench_batched(cfg, infer_multi, frame_fn, n_dispatch=N_DISPATCH,
                              with_cost=True)
    _log_peak(f"headline, B={BATCH_INFER} x {N_DISPATCH}", dev)
    lines = [_emit("audio_seconds_per_sec_per_chip", thr, "audio-s/s", body=body,
                   frontend=fe_mode, **cost)]
    del infer_multi
    _release(dev)
    if not full:
        return lines
    infer_fn, _, _ = _build_infer(cfg, device=dev)
    lines.append(_emit("single_clip_latency", bench_single_clip(cfg, infer_fn, frame_fn),
                       "ms/60s-clip", vs=0.0))
    del infer_fn
    _release(dev)
    transfer = os.environ.get("BENCH_STREAM_TRANSFER", "int8")
    pooled, regime = bench_streaming_pool(cfg, transfer=transfer, config=config, device=dev)
    lines.append(_emit("streaming_audio_seconds_per_sec", pooled, "audio-s/s",
                       transfer=transfer, **(regime or {})))
    infer_packed, _, _ = _build_infer(cfg, packed=True, int8_input=transfer == "int8",
                                      device=dev)
    lines.append(_emit("streaming_single_process_audio_seconds_per_sec",
                       bench_streaming(cfg, infer_packed, None, transfer=transfer),
                       "audio-s/s", transfer=transfer))
    del infer_packed
    _release(dev)
    train_b = int(os.environ.get("BENCH_TRAIN_B", "128"))
    train_s = int(os.environ.get("BENCH_TRAIN_S", "8"))
    train_fe = os.environ.get("BENCH_TRAIN_FRONTEND", "int8")
    for metric, b in (("train_audio_seconds_per_sec", train_b),
                      ("train_b32_audio_seconds_per_sec", TRAIN_B_REF)):
        _reset_peak(dev)
        thr, cost = bench_train_step(cfg, batch=b, device=dev)
        _log_peak(f"training, B={b} S={train_s}", dev)
        lines.append(_emit(metric, thr, "audio-s/s", batch=b, steps_per_dispatch=train_s,
                           frontend=train_fe, **cost))
        _release(dev)
    _reset_peak(dev)
    infer50, frame50, _ = _build_infer(cfg, block=SCALED_BLOCK, layers=SCALED_LAYERS,
                                       n_dispatch=N_DISPATCH, int8=use_int8_body,
                                       frontend=fe_mode, device=dev)
    thr50, cost50 = bench_batched(cfg, infer50, frame50, n_dispatch=N_DISPATCH, with_cost=True)
    _log_peak(f"scaled backbone, B={BATCH_INFER} x {N_DISPATCH}", dev)
    lines.append(_emit("scaled_backbone_audio_seconds_per_sec", thr50, "audio-s/s", body=body,
                       frontend=fe_mode, **cost50))
    del infer50
    _release(dev)
    return lines


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Benchmarks of the five baseline configs "
                                            "(PyTorch port)")
    p.add_argument("--full", action="store_true", help="run all 5 baseline configs")
    p.add_argument("--device", type=str, default=None, metavar="",
                   help="'cpu' to run on the CPU (default: the card)")
    args = p.parse_args(argv)
    run(CONFIG, full=args.full, device=args.device)


if __name__ == "__main__":
    main()

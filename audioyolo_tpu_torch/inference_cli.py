"""Inference entry point of the PyTorch port (port of the root ``inference.py``).

Usage::

    python -m audioyolo_tpu_torch.inference_cli --model_path M \\
        (--audio_filepath FILE | --audio_dir DIR) [--output_dir model_predictions] \\
        [--config config/config.yaml] [--device cuda]

Loads a checkpoint, folds every RepVGG block into its single-conv deploy form
(``--no_fold`` keeps the branches; ``--ref_exact`` runs a reference checkpoint
as the reference does, with per-branch activations and no fold; ``--bf16``
runs the backbone and neck in bfloat16 on the same float32 weights), and streams
a file or a directory into one ``{start, end, class}`` CSV per file. A
directory's files at the model rate are batched across files; files at other
rates run on ``--num_concurrency`` threads (``infer/runner.py``).

Checkpoints (``load_model_state``): ``.pt`` is the port's own train-form state
dict (``train_cli`` writes it); ``.pth``/``.pth.tar`` a reference checkpoint
(``models/import_torch.py``); ``.msgpack`` the JAX trainer's file
(``models/flax_msgpack.py`` + ``models/from_jax.py``).

``--int8`` runs the int8 body (``models/quant.py``), calibrated on the first
windows of the input (``load_calib_batch``); the stem and the prediction
convs stay float. ``--transfer int8`` ships per-clip int8 waveforms (half the
int16 bytes; native-rate files only), or with ``--framed_input`` under
``frontend_precision: int8`` the ``(q, scale)`` frames of
``frame_host_int8``.

``--workers N`` (N > 1) streams through a pool of N worker processes, each
with its own model and device context (``infer/pool.py``): one file sharded
by chunk ranges, a directory by files; the CSVs are the single process's.
``--device`` defaults to the CUDA card.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .config import load_config
from .data.wavio import read_wav, read_wav_info
from .device import DeviceLike, resolve_device
from .infer.decode import make_inference_fn
from .infer.pool import StreamWorkerPool
from .infer.runner import evaluate_dir
from .infer.streaming import evaluate_audio
from .models.detector import AudioDetectionModel
from .models.flax_msgpack import load as load_msgpack
from .models.from_jax import state_dict_from_jax
from .models.import_torch import import_torch_state_dict, load_torch_checkpoint
from .models.quant import calibrate_quant, set_quant
from .models.reparam import fold_repvgg
from .ops.frontend import SpectralFrontend
from .serve import get_label_map


def load_model_state(model_path: str, cfg, num_classes: int) -> Dict[str, torch.Tensor]:
    """The train-form state dict of ``cfg``'s model with ``num_classes``
    from a ``.pt`` (the port's), ``.pth``/``.pth.tar`` (the reference's,
    read against the names and shapes of a train-form model built for it
    alone) or ``.msgpack`` (the JAX trainer's) checkpoint."""
    if not os.path.isfile(model_path):
        raise FileNotFoundError(f"path: {model_path} does not exist")
    if model_path.endswith(".pt"):
        return torch.load(model_path, map_location="cpu", weights_only=True)
    if model_path.endswith((".pth", ".pth.tar")):
        template = AudioDetectionModel.from_config(cfg, num_classes).state_dict()
        return import_torch_state_dict(load_torch_checkpoint(model_path), template)
    if model_path.endswith(".msgpack"):
        return state_dict_from_jax(load_msgpack(model_path))
    raise ValueError(f"unknown checkpoint format '{model_path}' (.pt, .pth, .pth.tar or .msgpack)")


def model_input_on(x, dev: torch.device):
    """A numpy model input (an array or the ``(q, scale)`` tuple) on ``dev``."""
    if isinstance(x, tuple):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in x)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def build_inference(cfg, num_classes: int, model_path: str, iou_threshold: float,
                    conf_threshold: float, fold: bool = True, ref_exact: bool = False,
                    device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None, int8_calib=None,
                    int8_input: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """The packed-output inference function of a checkpoint on ``device``
    (default: the card). ``ref_exact=True`` runs a reference checkpoint in
    the form it was trained in: per-branch RepVGG activation and no fold
    (folding is not exact under per-branch activation). ``dtype`` is the
    body's compute dtype (``torch.bfloat16`` for ``--bf16``).

    ``int8_calib``: a numpy model-input batch (waveform, frames or the
    ``(q, scale)`` tuple); when given, the body runs int8 at scales
    calibrated on it (``models/quant.py``), which needs the folded model.
    ``int8_input``: the function takes ``(q, scale)`` int8 waveforms
    (``--transfer int8``)."""
    dev = resolve_device(device)
    cfg = load_config(cfg)
    if ref_exact:
        fold = False
    if int8_calib is not None and not fold:
        raise ValueError("--int8 requires the folded model (drop --no_fold/--ref_exact)")
    state = load_model_state(model_path, cfg, num_classes)
    if fold:
        model = AudioDetectionModel.from_config(cfg, num_classes, deploy=True, dtype=dtype)
        state = fold_repvgg(state)
    else:
        model = AudioDetectionModel.from_config(cfg, num_classes, branch_act=ref_exact,
                                                dtype=dtype)
    if int8_calib is not None:
        model.load_state_dict(state)
        model.to(dev).eval()
        set_quant(model, calibrate_quant(model, [model_input_on(int8_calib, dev)]))
    keep_k = int((cfg.raw.get("tpu_config") or {}).get("nms_keep", 128))
    return make_inference_fn(model, state, iou_threshold, conf_threshold, keep_k=keep_k,
                             packed=True, device=dev, int8_input=int8_input)


def load_calib_batch(paths, cfg, frame_fn=None, n_clips: int = 4):
    """The first ``n_clips`` windows of ``paths`` (tails zero-padded) as a
    float32 model-input batch for int8 calibration, framed by ``frame_fn``
    when given. Files are downmixed to mono and brought to
    ``cfg.sample_rate`` by linear interpolation (calibration needs only
    absmax-accurate amplitudes), as the JAX package's ``inference.py``
    does."""
    size = int(cfg.clip_samples)
    rate = int(cfg.sample_rate)
    clips = []
    for p in paths:
        og_rate = read_wav_info(p)[0]
        need_src = int(np.ceil(size * n_clips * og_rate / rate))
        audio, _ = read_wav(p, num_frames=need_src)
        if audio.shape[0] != 1:
            audio = audio.mean(axis=0, keepdims=True)
        mono = audio[0].astype(np.float32)
        if og_rate != rate:
            n_out = int(mono.size * rate / og_rate)
            mono = np.interp(np.arange(n_out) * (og_rate / rate), np.arange(mono.size),
                             mono).astype(np.float32)
        n = min(n_clips - len(clips), max(1, int(np.ceil(mono.size / size))))
        buf = np.zeros((n, size), np.float32)
        flat = mono[: n * size]
        buf.reshape(-1)[: flat.size] = flat
        clips.extend(buf)
        if len(clips) >= n_clips:
            break
    if not clips:
        raise ValueError("no calibration audio found")
    batch = np.stack(clips)[:, None, :]
    return frame_fn(batch[:, 0, :]) if frame_fn is not None else batch


def framed_frontend(cfg) -> SpectralFrontend:
    """``--framed_input``'s frontend, whose ``fused`` framer frames on the
    host; raises when the config's frontend has none (the flag is never
    dropped without a word)."""
    fe = SpectralFrontend(load_config(cfg))
    if fe.fused is None:
        raise ValueError("--framed_input: this config's frontend has no fused framer "
                         "(it needs non-overlapping, uncentred frames, no taper and one "
                         "shared mel config)")
    return fe


def build_frame_fn(cfg) -> Callable:
    """``--framed_input``'s host framer: ``frame_host``, or under
    ``frontend_precision: int8`` the quantizing ``frame_host_int8``."""
    fe = framed_frontend(cfg)
    return fe.frame_host_int8 if fe.fused_int8 else fe.frame_host


def build_worker(config, model_path: str, class_map_path: str, iou_threshold: float,
                 conf_threshold: float, fold: bool = True, bf16: bool = False,
                 ref_exact: bool = False, framed_input: bool = False,
                 int8_calib_path: Optional[str] = None, transfer: str = "int16",
                 device: DeviceLike = None):
    """``(infer_fn, frame_fn)`` of a checkpoint: what one process of
    ``main`` serves, and the factory the streaming pool's workers call
    (``infer/pool.py``). ``frame_fn`` is ``--framed_input``'s host framer
    or None; ``int8_calib_path`` the file ``--int8`` calibrates on."""
    cfg = load_config(config)
    idx2class = get_label_map(class_map_path)
    frame_fn = build_frame_fn(cfg) if framed_input else None
    if transfer == "int8" and frame_fn is not None and not SpectralFrontend(cfg).fused_int8:
        raise ValueError("--transfer int8 with --framed_input requires "
                         "tpu_config.frontend_precision: int8 (the quantizing framer)")
    calib = (load_calib_batch([int8_calib_path], cfg, frame_fn=frame_fn)
             if int8_calib_path else None)
    # framed int8 tuples go to the model's own framed entry; the (q, scale)
    # waveform entry is for the unframed int8 transfer only
    infer_fn = build_inference(cfg, len(idx2class), model_path, iou_threshold, conf_threshold,
                               fold=fold, ref_exact=ref_exact, device=device,
                               dtype=torch.bfloat16 if bf16 else None, int8_calib=calib,
                               int8_input=transfer == "int8" and frame_fn is None)
    return infer_fn, frame_fn


def first_input_path(audio_filepath: str, audio_dir: str, extension: str) -> str:
    """The file ``--int8`` calibrates on: the single input, or the first
    file of the directory."""
    if audio_filepath:
        return audio_filepath
    ext = extension.replace(".", "")
    names = sorted(f for f in os.listdir(audio_dir) if f.endswith(f".{ext}"))
    if not names:
        raise OSError(f"no .{ext} files in {audio_dir}")
    return os.path.join(audio_dir, names[0])


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Audio model inference (PyTorch port)")
    parser.add_argument("--config", type=str, default="config/config.yaml", metavar="")
    parser.add_argument("--class_map_path", type=str, default="", metavar="")
    parser.add_argument("--model_path", type=str, default="", metavar="")
    parser.add_argument("--batch_size", type=int, default=0, metavar="",
                        help="windows per device batch (0 -> config batch_size)")
    parser.add_argument("--audio_filepath", type=str, default="", metavar="")
    parser.add_argument("--audio_dir", type=str,
                        default=os.path.join("dataset", "openbmat", "eval"), metavar="")
    parser.add_argument("--extension", type=str, default="wav", metavar="")
    parser.add_argument("--output_dir", type=str, default="model_predictions", metavar="")
    parser.add_argument("--num_concurrency", type=int, default=10, metavar="")
    parser.add_argument("--workers", type=int, default=1, metavar="",
                        help="streaming worker processes (infer/pool.py): a single file is "
                             "sharded by chunk ranges, a directory by files")
    parser.add_argument("--iou_threshold", type=float, default=0.1, metavar="")
    parser.add_argument("--conf_threshold", type=float, default=0.2, metavar="")
    parser.add_argument("--no_fold", action="store_true",
                        help="run the unfused multi-branch RepVGG form")
    parser.add_argument("--ref_exact", action="store_true",
                        help="reference-exact forward for .pth checkpoints (per-branch "
                             "RepVGG activation, no fold)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute for the detector body")
    parser.add_argument("--int8", action="store_true",
                        help="int8 detector body, scales calibrated on the first windows of "
                             "the input; the stem and prediction convs stay float")
    parser.add_argument("--framed_input", action="store_true",
                        help="frame clips on the host for the fused frontend; raises when "
                             "the config's frontend has no framer")
    parser.add_argument("--transfer", type=str, default="int16", choices=("int16", "int8"),
                        help="host->device format: int16 (exact for PCM16) or int8 (per-clip "
                             "scales, half the bytes; native-rate files only; with "
                             "--framed_input needs frontend_precision: int8)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if args.workers <= 1:  # the pool's workers resolve their own device
        resolve_device(args.device)

    cfg = load_config(args.config)
    tc = cfg.raw["train_config"]
    class_map_path = args.class_map_path or os.path.join(tc["class_map_path"], "class_map.json")
    model_path = args.model_path or os.path.join(tc["model_path"], "AudioDetectionModel.pt")
    batch_size = args.batch_size or int(tc["batch_size"])
    if not os.path.isfile(class_map_path):
        raise FileNotFoundError(f"{class_map_path} does not exist")
    idx2class = get_label_map(class_map_path)
    worker_kwargs = dict(config=args.config, model_path=model_path,
                         class_map_path=class_map_path, iou_threshold=args.iou_threshold,
                         conf_threshold=args.conf_threshold, fold=not args.no_fold,
                         bf16=args.bf16, ref_exact=args.ref_exact,
                         framed_input=args.framed_input,
                         int8_calib_path=(first_input_path(args.audio_filepath, args.audio_dir,
                                                           args.extension)
                                          if args.int8 else None),
                         transfer=args.transfer, device=args.device)

    if args.workers > 1:
        eval_kwargs = dict(input_sample_rate=cfg.sample_rate,
                           sample_duration=cfg.sample_duration, batch_size=batch_size,
                           idx2class_map=idx2class, transfer=args.transfer)
        with StreamWorkerPool("audioyolo_tpu_torch.inference_cli:build_worker",
                              worker_kwargs, args.workers, eval_kwargs) as pool:
            pool.warmup()
            if args.audio_filepath:
                if not os.path.isfile(args.audio_filepath):
                    raise FileNotFoundError(f"{args.audio_filepath} not found")
                pool.evaluate_file(args.audio_filepath, args.output_dir)
            else:
                if not os.path.isdir(args.audio_dir):
                    raise OSError(f"directory {args.audio_dir} not found")
                ext = args.extension.replace(".", "")
                paths = sorted(os.path.join(args.audio_dir, f)
                               for f in os.listdir(args.audio_dir) if f.endswith(f".{ext}"))
                pool.evaluate_dir(paths, args.output_dir)
        return

    # the construction and checks the pool's workers run
    infer_fn, frame_fn = build_worker(**worker_kwargs)
    kwargs = dict(input_sample_rate=cfg.sample_rate, sample_duration=cfg.sample_duration,
                  batch_size=batch_size, idx2class_map=idx2class, frame_fn=frame_fn,
                  transfer=args.transfer)
    if args.audio_filepath:
        if not os.path.isfile(args.audio_filepath):
            raise FileNotFoundError(f"{args.audio_filepath} not found")
        os.makedirs(args.output_dir, exist_ok=True)
        evaluate_audio(infer_fn, args.audio_filepath, args.output_dir, **kwargs)
    else:
        if not os.path.isdir(args.audio_dir):
            raise OSError(f"directory {args.audio_dir} not found")
        evaluate_dir(infer_fn, args.audio_dir, args.output_dir,
                     extension=args.extension.replace(".", ""),
                     num_concurrency=args.num_concurrency, **kwargs)


if __name__ == "__main__":
    main()

"""Inference entry point of the PyTorch port (port of the root ``inference.py``).

Usage::

    python -m audioyolo_tpu_torch.inference_cli --model_path M \\
        (--audio_filepath FILE | --audio_dir DIR) [--output_dir model_predictions] \\
        [--config config/config.yaml] [--device cuda]

Loads a checkpoint, folds every RepVGG block into its single-conv deploy form
(``--no_fold`` keeps the branches; ``--ref_exact`` runs a reference checkpoint
as the reference does, with per-branch activations and no fold), and streams
a file or a directory into one ``{start, end, class}`` CSV per file. A
directory's files at the model rate are batched across files; files at other
rates run on ``--num_concurrency`` threads (``infer/runner.py``).

Checkpoints (``load_model_state``): ``.pt`` is the port's own train-form state
dict (``train_cli`` writes it); ``.pth``/``.pth.tar`` a reference checkpoint
(``models/import_torch.py``); ``.msgpack`` the JAX trainer's file
(``models/flax_msgpack.py`` + ``models/from_jax.py``).

Not ported, each raising ``NotImplementedError``: ``--bf16``, ``--int8`` and
``--transfer int8`` (ROADMAP A10), ``--workers`` above 1 (the process pool,
ROADMAP A11). ``--device`` defaults to the CUDA card.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict

import torch

from .config import load_config
from .device import DeviceLike, resolve_device
from .infer.decode import make_inference_fn
from .infer.runner import evaluate_dir
from .infer.streaming import evaluate_audio
from .models.detector import AudioDetectionModel
from .models.flax_msgpack import load as load_msgpack
from .models.from_jax import state_dict_from_jax
from .models.import_torch import import_torch_state_dict, load_torch_checkpoint
from .models.reparam import fold_repvgg
from .ops.frontend import SpectralFrontend
from .serve import get_label_map


def load_model_state(model: AudioDetectionModel, model_path: str) -> Dict[str, torch.Tensor]:
    """The train-form state dict for ``model`` from a ``.pt`` (the port's),
    ``.pth``/``.pth.tar`` (the reference's) or ``.msgpack`` (the JAX
    trainer's) checkpoint."""
    if not os.path.isfile(model_path):
        raise FileNotFoundError(f"path: {model_path} does not exist")
    if model_path.endswith(".pt"):
        return torch.load(model_path, map_location="cpu", weights_only=True)
    if model_path.endswith((".pth", ".pth.tar")):
        return import_torch_state_dict(load_torch_checkpoint(model_path), model.state_dict())
    if model_path.endswith(".msgpack"):
        return state_dict_from_jax(load_msgpack(model_path))
    raise ValueError(f"unknown checkpoint format '{model_path}' (.pt, .pth, .pth.tar or .msgpack)")


def build_inference(cfg, num_classes: int, model_path: str, iou_threshold: float,
                    conf_threshold: float, fold: bool = True, ref_exact: bool = False,
                    device: DeviceLike = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The packed-output inference function of a checkpoint on ``device``
    (default: the card). ``ref_exact=True`` runs a reference checkpoint in
    the form it was trained in: per-branch RepVGG activation and no fold
    (folding is not exact under per-branch activation)."""
    dev = resolve_device(device)
    cfg = load_config(cfg)
    if ref_exact:
        fold = False
    train_model = AudioDetectionModel.from_config(cfg, num_classes, branch_act=ref_exact)
    state = load_model_state(train_model, model_path)
    if fold:
        model = AudioDetectionModel.from_config(cfg, num_classes, deploy=True)
        state = fold_repvgg(state)
    else:
        model = train_model
    keep_k = int((cfg.raw.get("tpu_config") or {}).get("nms_keep", 128))
    return make_inference_fn(model, state, iou_threshold, conf_threshold, keep_k=keep_k,
                             packed=True, device=dev)


def build_frame_fn(cfg) -> Callable:
    """``--framed_input``'s host framer of the fused frontend path; raises
    when the config's frontend has none (the flag is never dropped without a
    word)."""
    fe = SpectralFrontend(load_config(cfg))
    if fe.fused is None:
        raise ValueError("--framed_input: this config's frontend has no fused framer "
                         "(it needs non-overlapping, uncentred frames, no taper and one "
                         "shared mel config)")
    return fe.frame_host


def refuse_unported(bf16: bool = False, int8: bool = False, transfer: str = "int16",
                    workers: int = 1) -> None:
    """``NotImplementedError`` for the flags whose posture is not ported."""
    if bf16:
        raise NotImplementedError("--bf16 (a bfloat16 body) is not ported yet (ROADMAP A10)")
    if int8:
        raise NotImplementedError("--int8 (the int8 PTQ body) is not ported yet (ROADMAP A10)")
    if transfer == "int8":
        raise NotImplementedError("--transfer int8 is not ported yet (ROADMAP A10)")
    if workers > 1:
        raise NotImplementedError("--workers > 1 (the streaming process pool) is not ported "
                                  "yet (ROADMAP A11)")


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
                        help="not ported: above 1 raises NotImplementedError (ROADMAP A11)")
    parser.add_argument("--iou_threshold", type=float, default=0.1, metavar="")
    parser.add_argument("--conf_threshold", type=float, default=0.2, metavar="")
    parser.add_argument("--no_fold", action="store_true",
                        help="run the unfused multi-branch RepVGG form")
    parser.add_argument("--ref_exact", action="store_true",
                        help="reference-exact forward for .pth checkpoints (per-branch "
                             "RepVGG activation, no fold)")
    parser.add_argument("--bf16", action="store_true",
                        help="not ported: raises NotImplementedError (ROADMAP A10)")
    parser.add_argument("--int8", action="store_true",
                        help="not ported: raises NotImplementedError (ROADMAP A10)")
    parser.add_argument("--framed_input", action="store_true",
                        help="frame clips on the host for the fused frontend; raises when "
                             "the config's frontend has no framer")
    parser.add_argument("--transfer", type=str, default="int16", choices=("int16", "int8"),
                        help="host->device waveform format; int8 is not ported (ROADMAP A10)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    refuse_unported(args.bf16, args.int8, args.transfer, args.workers)
    device = resolve_device(args.device)

    cfg = load_config(args.config)
    tc = cfg.raw["train_config"]
    class_map_path = args.class_map_path or os.path.join(tc["class_map_path"], "class_map.json")
    model_path = args.model_path or os.path.join(tc["model_path"], "AudioDetectionModel.pt")
    batch_size = args.batch_size or int(tc["batch_size"])
    if not os.path.isfile(class_map_path):
        raise FileNotFoundError(f"{class_map_path} does not exist")
    idx2class = get_label_map(class_map_path)

    frame_fn = build_frame_fn(cfg) if args.framed_input else None
    infer_fn = build_inference(cfg, len(idx2class), model_path, args.iou_threshold,
                               args.conf_threshold, fold=not args.no_fold,
                               ref_exact=args.ref_exact, device=device)
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

"""Export a checkpoint as a standalone serving artifact (port of the JAX
package's ``tools/export_model.py``).

Usage::

    python -m audioyolo_tpu_torch.export_cli --config config/config.yaml \\
        --output model.aytx [--batch_size 32] [--int16] [--framed] [--bf16] \\
        [--int8_body calib.wav] [--model_path M] [--class_map_path D] \\
        [--platforms cuda,cpu]

``torch.export`` traces the folded inference function (frontend -> backbone
-> neck -> decode -> NMS -> packing) with the weights baked in, one program
per platform (``infer/export.py``); ``load_serving_artifact`` runs it with no
model code. Checkpoints as ``inference_cli`` reads them (``.pt``, ``.pth``,
``.pth.tar``, ``.msgpack``). ``--platforms`` lists ``cuda`` and/or ``cpu``
(the default both; ``cuda`` needs the card). Under ``frontend_precision:
int8``, ``--framed`` exports the ``(q, scale)`` entry of
``frame_host_int8``; ``--int8_body`` calibrates the int8 body on a WAV
through the entry it exports, on the first platform's device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .config import load_config
from .device import resolve_device
from .infer.export import build_serving_exported, save_serving_artifact
from .inference_cli import framed_frontend, load_calib_batch, load_model_state, model_input_on
from .models.detector import AudioDetectionModel
from .models.quant import calibrate_quant, set_quant
from .models.reparam import fold_repvgg
from .serve import get_label_map


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Export serving artifact (PyTorch port)")
    p.add_argument("--config", type=str, default="config/config.yaml", metavar="")
    p.add_argument("--model_path", type=str, default="", metavar="")
    p.add_argument("--class_map_path", type=str, default="", metavar="")
    p.add_argument("--output", type=str, required=True, metavar="")
    p.add_argument("--batch_size", type=int, default=0, metavar="")
    p.add_argument("--iou_threshold", type=float, default=0.1, metavar="")
    p.add_argument("--conf_threshold", type=float, default=0.2, metavar="")
    p.add_argument("--platforms", type=str, default="cuda,cpu", metavar="",
                   help="comma-separated platforms, one program traced on each")
    p.add_argument("--int16", action="store_true",
                   help="export the PCM16 entry (dequantized in the program)")
    p.add_argument("--framed", action="store_true",
                   help="export the phase-grouped frames entry (the host runs "
                        "SpectralFrontend.frame_host)")
    p.add_argument("--bf16", action="store_true", help="bf16 detector body")
    p.add_argument("--int8_body", type=str, default="", metavar="",
                   help="WAV file to calibrate an int8 detector body on; the quantized "
                        "form is baked into the artifact (models/quant.py)")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    tc = cfg.raw["train_config"]
    class_map_path = args.class_map_path or os.path.join(tc["class_map_path"], "class_map.json")
    model_path = args.model_path or os.path.join(tc["model_path"], "AudioDetectionModel.pt")
    batch_size = args.batch_size or int(tc["batch_size"])
    platforms = [s.strip() for s in args.platforms.split(",") if s.strip()]
    for platform in platforms:  # raises before any work without a card
        resolve_device(platform)
    idx2class = get_label_map(class_map_path)

    dtype = torch.bfloat16 if args.bf16 else None
    train_model = AudioDetectionModel.from_config(cfg, len(idx2class), dtype=dtype)
    state = fold_repvgg(load_model_state(train_model, model_path))
    model = AudioDetectionModel.from_config(cfg, len(idx2class), deploy=True, dtype=dtype)
    frame_shape, framed_int8, frame_fn = None, False, None
    if args.framed:
        fe = framed_frontend(cfg)
        # under frontend_precision: int8 the framed entry is the (q int8,
        # scale f32) pair of frame_host_int8; the exporter follows the config
        framed_int8 = fe.fused_int8
        frame_fn = fe.frame_host_int8 if framed_int8 else fe.frame_host
        sample = fe.frame_host(np.zeros((1, int(cfg.clip_samples)),
                                        np.int16 if args.int16 else np.float32))
        frame_shape = tuple(sample.shape[1:])

    if args.int8_body:
        # calibrate through the entry the artifact serves, on the first
        # platform's device; the scales are baked into every program
        dev = resolve_device(platforms[0])
        calib = load_calib_batch([args.int8_body], cfg, frame_fn=frame_fn)
        model.load_state_dict(state)
        model.to(dev).eval()
        set_quant(model, calibrate_quant(model, [model_input_on(calib, dev)]))

    input_dtype = "int8" if framed_int8 else "int16" if args.int16 else "float32"
    exported = build_serving_exported(
        model, state, batch_size,
        iou_threshold=args.iou_threshold, conf_threshold=args.conf_threshold,
        keep_k=int((cfg.raw.get("tpu_config") or {}).get("nms_keep", 128)),
        input_dtype=input_dtype, framed=args.framed, frame_shape=frame_shape,
        platforms=platforms)
    save_serving_artifact(
        args.output, exported, idx2class_map=idx2class,
        sample_duration=float(cfg.sample_duration), input_sample_rate=int(cfg.sample_rate),
        extra_meta={
            "iou_threshold": args.iou_threshold,
            "conf_threshold": args.conf_threshold,
            "framed": bool(args.framed),
            "body_dtype": "bfloat16" if args.bf16 else "float32",
            "int8_body": bool(args.int8_body),
        })
    size = os.path.getsize(args.output)
    print(f"wrote {args.output} ({size / 1e6:.1f} MB, platforms={','.join(platforms)}, "
          f"input={'framed ' if args.framed else ''}{input_dtype} batch={batch_size})")


if __name__ == "__main__":
    main()

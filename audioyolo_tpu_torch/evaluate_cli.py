"""Event-mAP evaluation over an annotated dataset split (port of the root
``evaluate_model.py``).

Usage::

    python -m audioyolo_tpu_torch.evaluate_cli --dataset_path ROOT --model_path M \\
        [--split eval] [--config config/config.yaml] [--device cuda]

Runs the detector over every annotated window of ``ROOT/<split>``, matches
the predicted ``(start, end, class, confidence)`` events to the ground-truth
events by 1-D interval IoU (greedy, per class) and prints one JSON object:
``mAP@0.5`` .. ``mAP@0.95``, ``mAP@[.5:.95]``, ``num_detections``,
``num_ground_truth`` and ``AP50_per_class``. Ground truth uses the training
targets' time convention (the window's annotated span), so the number
measures the task the model was trained on.

The batches come from the port's ``BatchLoader``; without a host framer the
split goes through ``DeviceCachedLoader.wrap_from_config`` (the config's
``device_cache_dataset``, ``auto`` by default: a split that fits
``device_cache_max_mb`` stays on the device, and its batches reach the model
without a copy). With ``--framed_input`` and ``transfer_dtype: int16`` it decodes each batch
straight into int16 frames, and under ``frontend_precision: int8`` it frames
each batch with ``frame_host_int8`` into the int8 DFT's ``(q, scale)``.
``--int8`` runs the int8 body, calibrated on the first four files of the
split (``inference_cli.load_calib_batch``). ``--framed_input`` raises when
the config's frontend has no framer. ``--device`` defaults to the CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .config import load_config
from .data.dataset import AudioDataset
from .data.loader import BatchLoader, DeviceCachedLoader
from .device import resolve_device
from .infer.decode import postprocess_detections, unpack_detections
from .infer.eval_map import event_average_precision, event_map
from .inference_cli import build_inference, framed_frontend, load_calib_batch, model_input_on
from .serve import get_label_map
from .train_cli import load_annotations


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Event-mAP evaluation (PyTorch port)")
    parser.add_argument("--config", type=str, default="config/config.yaml", metavar="")
    parser.add_argument("--dataset_path", type=str, required=True, metavar="",
                        help="dataset root containing eval/ and annotations/")
    parser.add_argument("--split", type=str, default="eval", metavar="")
    parser.add_argument("--annotator", type=str, default="", metavar="")
    parser.add_argument("--class_map_path", type=str, default="", metavar="")
    parser.add_argument("--model_path", type=str, default="", metavar="")
    parser.add_argument("--batch_size", type=int, default=0, metavar="")
    parser.add_argument("--iou_threshold", type=float, default=0.1, metavar="",
                        help="NMS IoU threshold")
    parser.add_argument("--conf_threshold", type=float, default=0.05, metavar="",
                        help="confidence floor for scored detections")
    parser.add_argument("--int8", action="store_true",
                        help="int8 detector body, scales calibrated on the first split files")
    parser.add_argument("--framed_input", action="store_true",
                        help="frame clips on the host for the fused frontend; raises when "
                             "the config's frontend has no framer")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config(args.config)
    fe = framed_frontend(cfg) if args.framed_input else None
    # int16 frames come straight from the loader's framed decode; the int8
    # posture's (q, scale) frames from frame_host_int8 on each batch
    int8_frames = fe is not None and fe.fused_int8
    framer = fe.fused if fe is not None and not int8_frames else None
    frame_fn = None if fe is None else (fe.frame_host_int8 if int8_frames else fe.frame_host)
    tc = cfg.raw["train_config"]
    annotator = args.annotator or tc["annotator"]
    class_map_path = args.class_map_path or os.path.join(tc["class_map_path"], "class_map.json")
    model_path = args.model_path or os.path.join(tc["model_path"], "AudioDetectionModel.pt")
    batch_size = args.batch_size or int(tc["batch_size"])

    idx2class = get_label_map(class_map_path)
    num_classes = len(idx2class)
    ds = AudioDataset(os.path.join(args.dataset_path, args.split),
                      load_annotations(args.dataset_path, annotator),
                      sample_duration=cfg.sample_duration, sample_rate=cfg.sample_rate,
                      extension=cfg.raw["audio_extension"], max_targets=cfg.max_targets)
    ds.class2idx = {v: k for k, v in idx2class.items()}  # the training vocabulary

    calib = (load_calib_batch([ds.audio_span(i)[0] for i in range(min(4, len(ds)))], cfg,
                              frame_fn=frame_fn) if args.int8 else None)
    infer_fn = build_inference(cfg, num_classes, model_path, args.iou_threshold,
                               args.conf_threshold, device=device, int8_calib=calib)
    tpu_cfg = cfg.raw.get("tpu_config") or {}
    loader = BatchLoader(ds, batch_size, shuffle=False, last_batch="partial",
                         transfer_dtype=tpu_cfg.get("transfer_dtype", "float32"), framer=framer)
    if frame_fn is None:  # host framing needs host-resident audio
        loader = DeviceCachedLoader.wrap_from_config(loader, tpu_cfg, device)

    detections, ground_truth = [], []
    clip = 0
    for batch in loader:
        audio = batch["audio"]
        if int8_frames:
            audio = frame_fn(audio[:, 0, :] if audio.ndim == 3 else audio)
        out = infer_fn(audio if torch.is_tensor(audio) else model_input_on(audio, device))
        rows = postprocess_detections(unpack_detections(out.cpu().numpy()), cfg.sample_duration,
                                      return_start_end=True)
        b = batch["audio"].shape[0]
        for i in range(b):
            fid = clip + i
            for conf, _obj, cls, start, end in rows[i]:
                detections.append((fid, cls, conf, start, end))
            mask = batch["valid"][i] & (batch["classes"][i] != -100)
            for j in np.nonzero(mask)[0]:
                c = float(batch["centers"][i, j])
                w = float(batch["widths"][i, j])
                ground_truth.append((fid, int(batch["classes"][i, j]), c - w / 2, c + w / 2))
        clip += b

    thresholds = [round(t, 2) for t in np.arange(0.5, 0.96, 0.05)]
    result = event_map(detections, ground_truth, num_classes, iou_thresholds=thresholds)
    result["mAP@[.5:.95]"] = result.pop("mAP")
    result["num_detections"] = len(detections)
    result["num_ground_truth"] = len(ground_truth)
    per_class = {}
    for c in range(num_classes):
        ap = event_average_precision(detections, ground_truth, c, 0.5)
        per_class[idx2class[c]] = None if np.isnan(ap) else round(float(ap), 4)
    result["AP50_per_class"] = per_class
    print(json.dumps(result, default=float))
    return result


if __name__ == "__main__":
    main()

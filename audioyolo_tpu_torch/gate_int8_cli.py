"""Detection-equivalence gate for the int8 waveform transfer (port of
``tools/gate_int8_transfer.py``).

Usage::

    python -m audioyolo_tpu_torch.gate_int8_cli --dataset_path ROOT \\
        --model_path M --class_map idx2class_mapping/class_map.json \\
        [--split eval] [--config config/config.yaml] [--device cuda]

Sends one checkpoint's split through the model twice: through the exact
int16 waveform entry, and through the int8 ``(q, scale)`` entry
(``infer/streaming.py::quantize_clips_int8``, per-clip absmax scales). It
prints one JSON line: ``results``, each entry's mAP@0.5, mAP@[.5:.95],
``num_detections`` and AP50 per class, and ``row_diff_unmatched``, the
events of one entry that the other does not match within 0.05 s and 0.02
confidence. The split is loaded as int16 in batches of 16 and kept on the
device when it fits (``DeviceCachedLoader.wrap_from_config``), and a cached
split is quantized where it lies (``quantize_clips_int8_device``).
``--model_path`` takes what ``inference_cli.load_model_state`` reads.
``--device`` defaults to the CUDA card.
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
from .evaluate_cli import split_events
from .infer.eval_map import event_average_precision, event_map
from .infer.streaming import quantize_clips_int8, quantize_clips_int8_device
from .inference_cli import build_inference, model_input_on
from .serve import get_label_map
from .train_cli import load_annotations


def run_split(infer_fn, loader, cfg, int8: bool, device: torch.device):
    """``(detections, ground_truth)`` of ``loader``'s split through the
    int16 entry, or with ``int8`` through the ``(q, scale)`` entry."""
    def run(batch):
        audio = batch["audio"]
        if not int8:
            return infer_fn(audio if torch.is_tensor(audio) else model_input_on(audio, device))
        if torch.is_tensor(audio):  # a cached split: quantize on the device
            return infer_fn(quantize_clips_int8_device(audio))
        return infer_fn(model_input_on(quantize_clips_int8(np.asarray(audio)), device))

    return split_events(loader, run, cfg.sample_duration)


def summarize(name, detections, ground_truth, num_classes, idx2class) -> dict:
    thresholds = [round(t, 2) for t in np.arange(0.5, 0.96, 0.05)]
    result = event_map(detections, ground_truth, num_classes, iou_thresholds=thresholds)
    out = {
        "entry": name,
        "mAP@0.5": result.get("mAP@0.5"),
        "mAP@[.5:.95]": result.get("mAP"),
        "num_detections": len(detections),
    }
    for c in range(num_classes):
        ap = event_average_precision(detections, ground_truth, c, 0.5)
        out[f"AP50_{idx2class[c]}"] = None if np.isnan(ap) else round(float(ap), 4)
    return out


def row_diff(a, b, tol_t: float = 0.05, tol_conf: float = 0.02) -> int:
    """Events present in one list but unmatched in the other (same file and
    class, start and end within ``tol_t`` s, confidence within
    ``tol_conf``)."""
    unmatched = 0
    used = set()
    for fid, cls, conf, s, e in a:
        hit = None
        for j, (fid2, cls2, conf2, s2, e2) in enumerate(b):
            if j in used or fid2 != fid or cls2 != cls:
                continue
            if abs(s - s2) <= tol_t and abs(e - e2) <= tol_t and abs(conf - conf2) <= tol_conf:
                hit = j
                break
        if hit is None:
            unmatched += 1
        else:
            used.add(hit)
    return unmatched + (len(b) - len(used))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="int8 transfer gate (PyTorch port)")
    ap.add_argument("--config", default="config/config.yaml")
    ap.add_argument("--dataset_path", required=True)
    ap.add_argument("--split", default="eval")
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--class_map", required=True)
    ap.add_argument("--conf_threshold", type=float, default=0.05)
    ap.add_argument("--iou_threshold", type=float, default=0.1)
    ap.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config(args.config)
    idx2class = get_label_map(args.class_map)
    num_classes = len(idx2class)
    ds = AudioDataset(os.path.join(args.dataset_path, args.split),
                      load_annotations(args.dataset_path, cfg.raw["train_config"]["annotator"]),
                      sample_duration=cfg.sample_duration, sample_rate=cfg.sample_rate,
                      extension=cfg.raw["audio_extension"], max_targets=cfg.max_targets)
    ds.class2idx = {v: k for k, v in idx2class.items()}
    loader = BatchLoader(ds, 16, shuffle=False, last_batch="partial", transfer_dtype="int16")
    loader = DeviceCachedLoader.wrap_from_config(loader, cfg.raw.get("tpu_config"), device)

    results, dets = [], {}
    for int8 in (False, True):
        infer_fn = build_inference(cfg, num_classes, args.model_path, args.iou_threshold,
                                   args.conf_threshold, device=device, int8_input=int8)
        d, gt = run_split(infer_fn, loader, cfg, int8, device)
        name = "int8" if int8 else "int16"
        dets[name] = d
        results.append(summarize(name, d, gt, num_classes, idx2class))

    out = {"results": results, "row_diff_unmatched": row_diff(dets["int16"], dets["int8"])}
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()

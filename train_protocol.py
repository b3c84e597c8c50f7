"""The training protocol of ``docs/RESULTS.md``, run with the PyTorch port.

Usage::

    python3 train_protocol.py [--epochs 400] [--batch_size 16]
        [--config config/config.yaml] [--out chiprun_out/protocol] [--device cuda]

1. ``tools/make_synth_dataset.py --out .protocol/ds --seed 0`` (48 train and
   16 eval clips of 60 s at 22 050 Hz; it imports no JAX), skipped when the
   dataset is there already.
2. ``python -m audioyolo_tpu_torch.train_cli`` on the shipped config (or
   ``--config``) with that dataset, ``batch_size`` 16, ``epochs`` 400 and the
   device cache at its default (``auto``); the model, metrics and class map
   under ``.protocol/``.
3. On the best checkpoint: ``evaluate_cli``, ``gate_int8_cli`` and
   ``evaluate_cli --int8``.

It writes the config, the training log, the metric CSVs, the best
checkpoint and one JSON summary (the card, the best eval loss and its
epoch, each command's JSON and wall seconds, seconds per epoch) to
``--out``, and prints the summary as its last line. Everything runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import subprocess
import sys
import time

import yaml

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".protocol")  # the dataset, model, metrics and class map


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"


def run(cmd, log_path: str) -> tuple:
    """Run ``cmd`` from the repo root, its output appended to ``log_path``;
    returns (wall seconds, the last stdout line)."""
    t0 = time.perf_counter()
    with open(log_path, "a") as log:
        log.write(f"\n$ {' '.join(cmd)}\n")
        log.flush()
        proc = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=log, text=True)
        log.write(proc.stdout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"{cmd[2] if len(cmd) > 2 else cmd} exited {proc.returncode}; "
                         f"see {log_path}")
    lines = proc.stdout.strip().splitlines()
    return wall, lines[-1] if lines else ""


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default=os.path.join(ROOT, "config", "config.yaml"))
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "protocol"))
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    log = os.path.join(out, "protocol.log")
    summary = {"card": card(), "device": args.device, "epochs": args.epochs,
               "batch_size": args.batch_size}

    ds = os.path.join(WORK, "ds")
    if not os.path.isfile(os.path.join(ds, "annotations", "annotation.json")):
        summary["dataset_s"] = run([sys.executable, "tools/make_synth_dataset.py", "--out", ds,
                                    "--seed", "0"], log)[0]

    with open(args.config) as f:
        raw = yaml.safe_load(f)
    raw["train_config"].update(
        dataset_path=ds, batch_size=args.batch_size, epochs=args.epochs,
        model_path=os.path.join(WORK, "saved_model"), metrics_path=os.path.join(WORK, "metrics"),
        class_map_path=os.path.join(WORK, "idx2class_mapping"))
    cfg_path = os.path.join(out, "train.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)

    dev = ["--device", args.device]
    summary["train_s"] = run([sys.executable, "-m", "audioyolo_tpu_torch.train_cli",
                              "--config", cfg_path, *dev], log)[0]
    for name in ("train_metrics.csv", "eval_metrics.csv"):
        shutil.copy(os.path.join(WORK, "metrics", name), out)
    with open(os.path.join(WORK, "metrics", "eval_metrics.csv")) as f:
        losses = [float(r["aggregate_loss"]) for r in csv.DictReader(f)]
    best = min(range(len(losses)), key=losses.__getitem__)
    summary.update(best_eval_loss=losses[best], best_epoch=best + 1, epochs_run=len(losses),
                   train_s_per_epoch=summary["train_s"] / len(losses))

    model = os.path.join(WORK, "saved_model", "AudioDetectionModel.pt")
    shutil.copy(model, out)  # the trained checkpoint, kept beside its numbers
    cmap = os.path.join(WORK, "idx2class_mapping", "class_map.json")
    common = ["--config", cfg_path, "--dataset_path", ds, "--model_path", model, *dev]
    evaluate = [sys.executable, "-m", "audioyolo_tpu_torch.evaluate_cli", *common,
                "--class_map_path", cmap]
    for key, cmd in (("evaluate", evaluate),
                     ("gate", [sys.executable, "-m", "audioyolo_tpu_torch.gate_int8_cli",
                               *common, "--class_map", cmap]),
                     ("evaluate_int8", evaluate + ["--int8"])):
        wall, last = run(cmd, log)
        summary[key] = json.loads(last)
        summary[f"{key}_s"] = wall
    with open(os.path.join(out, "protocol.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

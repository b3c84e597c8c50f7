"""Training entry point of the PyTorch port (port of the root ``train.py``).

Usage::

    python -m audioyolo_tpu_torch.train_cli [--config config/config.yaml] [--resume]
        [--device cuda]

Resolves the datasets from ``train_config.dataset_path`` (one directory with
``train/``, ``eval/`` and ``annotations/annotation.json``, a ``;``-separated
list of them, or a glob ending in ``*``), writes the label map, and runs the
epoch loop: one training epoch, one evaluation, the best-eval-loss model
saved (``<model_path>/AudioDetectionModel.pt``, a train-form state dict that
``python -m audioyolo_tpu_torch.serve --model_path`` loads), the plateau
controller stepped, and a resume checkpoint every ``checkpoint_every``
epochs; the metric CSVs at the end. ``--device`` defaults to the CUDA card.

``tpu_config.compute_dtype: bfloat16`` (or ``bf16``) trains a bfloat16 body
(``models/layers.py``); parameters, Adam's moments, the EMA and the
checkpoints stay float32 either way, so a checkpoint does not depend on the
dtype. With ``transfer_dtype: int16`` and the fused framer the loaders decode
each batch straight into int16 frames in one native call
(``data/native.py``).

``--data_parallel`` (under ``torchrun --nproc_per_node=N``, one process per
card): each rank loads its shard of every epoch (``last_batch: pad``, the
global batch ``N * batch_size`` clips in rank order) and the step is the
single-device step on the global batch (``train/trainer.py``); rank 0 alone
writes the label map, the saved model, the resume checkpoint and the metric
CSVs, and every rank resumes from the same checkpoint. Without ``torchrun``'s
environment it is a world of one (the pad policy, no group).

``tpu_config.device_cache_dataset`` (``auto`` by default, ``on``, ``off``)
and ``device_cache_max_mb`` (512) keep a split that fits on the device
(``data/loader.py::DeviceCachedLoader``), as the JAX ``train.py`` does; a
sharded split is never cached. ``steps_per_dispatch`` and ``train_remat``
are the trainer's. Not ported: the metric plots and ``train_prng`` (the
TPU's hardware RNG), which raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
from datetime import datetime

import torch

from .config import load_config
from .data.dataset import AudioConcatDataset, AudioDataset
from .data.loader import BatchLoader, DeviceCachedLoader
from .device import DeviceLike, resolve_device
from .parallel import dist
from .models.detector import AudioDetectionModel
from .train.loss import AudioDetectionLoss
from .train.optim import ReduceLROnPlateau, is_plateau
from .train.trainer import TrainerPipeline

SEED = 42


def load_annotations(data_path: str, annotator: str):
    with open(os.path.join(data_path, "annotations", "annotation.json"), "r") as f:
        return json.load(f)["annotations"][annotator]


def make_dataset(path, annotations, cfg):
    kwargs = dict(sample_duration=cfg.sample_duration, sample_rate=cfg.sample_rate,
                  extension=cfg.raw["audio_extension"], max_targets=cfg.max_targets)
    if isinstance(path, str):
        return AudioDataset(path, annotations, **kwargs)
    return AudioConcatDataset.make_combo_dataset(path, annotations, **kwargs)


def resolve_datasets(cfg):
    tc = cfg.raw["train_config"]
    data_path, annotator = tc["dataset_path"], tc["annotator"]
    split_paths = data_path.split(";")
    if not data_path.endswith("*") and len(split_paths) == 1:
        ann = load_annotations(data_path, annotator)
        return (make_dataset(os.path.join(data_path, "train"), ann, cfg),
                make_dataset(os.path.join(data_path, "eval"), ann, cfg))
    paths = split_paths if len(split_paths) > 1 else sorted(glob.glob(data_path))
    if not paths:
        raise OSError(f"no datasets found at {data_path}")
    for p in paths:
        if not os.path.exists(p):
            raise OSError(f"path {p} not found")
    anns = [load_annotations(p, annotator) for p in paths]
    return (make_dataset([os.path.join(p, "train") for p in paths], anns, cfg),
            make_dataset([os.path.join(p, "eval") for p in paths], anns, cfg))


def make_loss(cfg, num_classes: int, class_weights) -> AudioDetectionLoss:
    lc = cfg.raw["train_config"]["loss_config"]
    return AudioDetectionLoss(
        anchors_dict=cfg.raw["anchors"], num_classes=num_classes,
        sample_duration=cfg.sample_duration, class_weights=class_weights,
        anchor_t=lc.get("anchor_t", 4.0), edge_t=lc.get("edge_t", 0.5),
        box_w=lc.get("box_w", 1.0), conf_w=lc.get("conf_w", 1.0),
        class_w=lc.get("class_w", 1.0), multi_label=lc.get("multi_label", False),
        label_smoothing=lc.get("label_smoothing", 0.0),
        batch_scale_loss=lc.get("batch_scale_loss", False),
        alpha=lc.get("alpha"), gamma=lc.get("gamma"))


def compute_dtype(tpu_cfg) -> torch.dtype | None:
    """The body's dtype for ``tpu_config.compute_dtype``: bfloat16 for
    ``bfloat16``/``bf16``, else ``None`` (float32), as the JAX ``train.py``
    reads it."""
    return torch.bfloat16 if (tpu_cfg or {}).get("compute_dtype") in ("bfloat16", "bf16") else None


def run(cfg, resume: bool = False, device: DeviceLike = None,
        data_parallel: bool = False) -> TrainerPipeline:
    """Train as the config says; returns the trainer (its model, metrics)."""
    device = resolve_device(device)
    group = dist.init(device.type) if data_parallel else None
    if group is not None and device.type == "cuda":
        device = resolve_device(f"cuda:{dist.local_rank()}")
    rank, world = (dist.rank(), dist.world_size()) if group is not None else (0, 1)
    cfg = load_config(cfg)
    tc = cfg.raw["train_config"]
    tpu_cfg = cfg.raw.get("tpu_config") or {}

    train_ds, eval_ds = resolve_datasets(cfg)
    if rank == 0:  # one writer on a shared filesystem
        AudioDataset.save_label_map(train_ds.class2idx, tc["class_map_path"])
    num_classes = len(train_ds.class2idx)
    model = AudioDetectionModel.from_config(cfg, num_classes,
                                            generator=torch.Generator().manual_seed(SEED),
                                            dtype=compute_dtype(tpu_cfg))
    trainer = TrainerPipeline(
        model, make_loss(cfg, num_classes, train_ds.get_class_weights()),
        tc["optimizer_config"], tc.get("lr_scheduler_config"),
        use_lr_scheduler=bool(tc.get("use_lr_scheduler", True)),
        model_path=tc["model_path"], metrics_path=tc["metrics_path"],
        ema_config=tc.get("ema_config"), use_ema=bool(tc.get("use_ema", False)), seed=SEED,
        steps_per_dispatch=int(tpu_cfg.get("steps_per_dispatch", 1)),
        remat=bool(tpu_cfg.get("train_remat", False)),
        prng_impl=tpu_cfg.get("train_prng") or None, device=device, process_group=group)

    # frame on the loader's prefetch thread, so the card's frontend is GEMMs;
    # the framer also opens the native decode straight into int16 frames.
    # frontend_precision: int8 ships frame_host_int8's (q, scale) instead
    # (the native decode makes no tuples, so it stays off there)
    fe = model.frontend
    framer = frame_fn = None
    if bool(tpu_cfg.get("framed_input", True)) and fe.fused is not None:
        if fe.fused_int8:
            frame_fn = fe.frame_host_int8
        else:
            framer = fe.fused
    kw = dict(transfer_dtype=tpu_cfg.get("transfer_dtype", "float32"), framer=framer,
              frame_fn=frame_fn, last_batch="pad" if data_parallel else "partial",
              shard=(rank, world) if world > 1 else None)
    batch_size = int(tc["batch_size"])
    train_loader = BatchLoader(train_ds, batch_size, shuffle=bool(tc.get("shuffle_samples", True)),
                               seed=SEED, **kw)
    eval_loader = BatchLoader(eval_ds, batch_size, shuffle=False, **kw)
    train_loader = DeviceCachedLoader.wrap_from_config(train_loader, tpu_cfg, device)
    eval_loader = DeviceCachedLoader.wrap_from_config(eval_loader, tpu_cfg, device)
    for name, ld in (("train", train_loader), ("eval", eval_loader)):
        if isinstance(ld, DeviceCachedLoader):
            print(f"[device-cache] {name} dataset resident on device ({ld.nbytes / 1e6:.0f} MB)")

    sched_cfg = tc.get("lr_scheduler_config") or {}
    plateau = None
    if is_plateau(sched_cfg, bool(tc.get("use_lr_scheduler", True))):
        plateau = ReduceLROnPlateau.from_config(sched_cfg,
                                                float(tc["optimizer_config"].get("lr", 1e-3)))

    verbose = bool(tc.get("verbose", True))
    best_loss, start_epoch = math.inf, 0
    if resume and os.path.exists(trainer.resume_checkpoint_path):
        start_epoch, best_loss = trainer.load_checkpoint()
        if plateau is not None and (trainer.checkpoint_extra or {}).get("plateau"):
            plateau.load_state_dict(trainer.checkpoint_extra["plateau"])
        print(f"[{datetime.now():%Y-%m-%d %H:%M:%S}] Resumed from epoch {start_epoch} "
              f"(best eval loss {best_loss:.4f})")
    ckpt_every = max(int(tpu_cfg.get("checkpoint_every", 1)), 1)
    last_epoch = int(tc["epochs"]) - 1
    for epoch in range(start_epoch, int(tc["epochs"])):
        print(f"\n[{datetime.now():%Y-%m-%d %H:%M:%S}]: Epoch {epoch}")
        trainer.train(train_loader, verbose=verbose)
        eval_loss = trainer.evaluate(eval_loader, verbose=verbose)["aggregate_loss"]
        if eval_loss < best_loss:
            trainer.save_model()
            best_loss = eval_loss
            print(f"[{datetime.now():%Y-%m-%d %H:%M:%S}] Model saved at epoch: {epoch + 1} "
                  f"loss: {best_loss}")
        if plateau is not None:
            trainer.set_learning_rate(plateau.step(eval_loss))
        if epoch % ckpt_every == 0 or epoch == last_epoch:
            extra = {"plateau": plateau.state_dict()} if plateau is not None else None
            trainer.save_checkpoint(epoch, best_loss, extra=extra)
    trainer.metrics_to_csv()
    return trainer


def main() -> None:
    p = argparse.ArgumentParser(description="Audio activity detection training (PyTorch port)")
    p.add_argument("--config", type=str, default="config/config.yaml")
    p.add_argument("--resume", action="store_true",
                   help="resume from <model_path>/checkpoint.pt if present")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--data_parallel", action="store_true",
                   help="one rank per process under torchrun: shard each batch over the "
                        "ranks (nccl on the card, gloo on the CPU)")
    args = p.parse_args()
    run(load_config(args.config), resume=args.resume, device=args.device,
        data_parallel=args.data_parallel)


if __name__ == "__main__":
    main()

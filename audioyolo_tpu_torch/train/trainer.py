"""Training engine (port of ``audioyolo_tpu/train/trainer.py``).

``train_step`` runs the train-mode forward (kernel 1 computes the frontend
on the card in the ``default`` + ``pallas_frontend: on`` posture), the loss
with its metrics, the backward pass, the optimizer step and the EMA update,
and returns the (10,) metric vector, which stays on the device. The body runs
in the model's compute dtype; parameters, gradients, Adam's moments, the EMA
and every checkpoint stay float32 whatever it is. An epoch
fetches its metrics once, as one stacked tensor; nothing in the step waits
for the host. Batches go to the card one ahead of the step that uses them,
from pinned host memory with ``non_blocking`` copies.

The dropout mask of step ``n`` comes from a generator seeded with
``(seed, n)``, as the JAX package folds the step into its key, so a resumed
run draws the masks it would have drawn.

Not ported (each raises ``NotImplementedError``): several steps per
dispatch (a CUDA graph, later), selective rematerialisation
(``torch.utils.checkpoint``, later) and the TPU's hardware RNG for dropout.
"""

from __future__ import annotations

import csv
import math
import os
from datetime import datetime
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..device import DeviceLike, resolve_device
from .ema import EMA
from .loss import METRIC_KEYS, AudioDetectionLoss
from .optim import make_lr_scheduler, make_optimizer, set_learning_rate

TARGET_KEYS = ("classes", "centers", "widths", "valid", "clip_valid")


class TrainerPipeline:
    def __init__(self, model, loss_fn: AudioDetectionLoss, optimizer_config: Dict[str, Any],
                 lr_scheduler_config: Optional[Dict[str, Any]] = None,
                 use_lr_scheduler: bool = True, model_path: str = "saved_model",
                 metrics_path: str = "metrics", ema_config: Optional[Dict[str, Any]] = None,
                 use_ema: bool = False, seed: int = 42, steps_per_dispatch: int = 1,
                 remat: bool = False, prng_impl: Optional[str] = None,
                 device: DeviceLike = None):
        if int(steps_per_dispatch) > 1:
            raise NotImplementedError(
                "steps_per_dispatch > 1 is a TPU dispatch setting; the port runs one step "
                "per call (a CUDA graph later, ROADMAP)")
        if remat:
            raise NotImplementedError(
                "train_remat is not ported yet (torch.utils.checkpoint, ROADMAP)")
        if prng_impl:
            raise NotImplementedError(
                f"train_prng '{prng_impl}' is the TPU's hardware RNG; the port draws dropout "
                "masks from a seeded torch.Generator (ROADMAP)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.optimizer = make_optimizer(self.model.parameters(), optimizer_config,
                                        lr_scheduler_config, use_lr_scheduler)
        self.scheduler = make_lr_scheduler(self.optimizer, lr_scheduler_config, use_lr_scheduler)
        self.model_path = model_path
        self.metrics_path = metrics_path
        self.ema_config = dict(ema_config or {})
        self.ema = (EMA(dict(self.model.named_parameters()),
                        int(self.ema_config.get("num_updates", 0))) if use_ema else None)
        self.seed = int(seed)
        self.step = 0
        self.generator = torch.Generator(device=self.device)
        self.saved_model_path = os.path.join(model_path, "AudioDetectionModel.pt")
        self.train_metrics: List[Dict[str, float]] = []
        self.eval_metrics: List[Dict[str, float]] = []
        self.checkpoint_extra: Optional[Dict[str, Any]] = None

    # ---- steps ---------------------------------------------------------

    def train_step(self, audio: torch.Tensor, targets: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step on a device batch; returns the (10,) metrics."""
        self.model.train()
        self.generator.manual_seed((self.seed << 32) + self.step)
        preds = self.model(audio, generator=self.generator)
        loss, metrics = self.loss_fn(preds, targets)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        if self.ema is not None:
            self.ema.update(dict(self.model.named_parameters()),
                            float(self.ema_config.get("momentum", 0.002)),
                            int(self.ema_config.get("N", 2000)))
        self.step += 1
        return AudioDetectionLoss.metrics_vector(metrics)

    @torch.no_grad()
    def eval_step(self, audio: torch.Tensor, targets: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Eval-mode forward (the EMA parameters with the live BatchNorm
        statistics when EMA is on) and the loss's (10,) metrics."""
        self.model.eval()
        if self.ema is not None:
            preds = functional_call(self.model, self.ema.params, (audio,))
        else:
            preds = self.model(audio)
        _, metrics = self.loss_fn(preds, targets)
        return AudioDetectionLoss.metrics_vector(metrics)

    # ---- host -> device ------------------------------------------------

    def put_batch(self, batch: Dict[str, np.ndarray]):
        """A loader batch -> (audio, targets) on the device: pinned host
        copies sent with ``non_blocking`` (the host runs on meanwhile). The
        ``(q, scale)`` audio of the ``int8`` posture moves as a tuple."""
        cuda = self.device.type == "cuda"

        def put(x):
            if isinstance(x, tuple):
                return tuple(put(a) for a in x)
            t = torch.from_numpy(np.ascontiguousarray(x))
            return t.pin_memory().to(self.device, non_blocking=True) if cuda else t

        targets = {k: put(batch[k]) for k in TARGET_KEYS if k in batch}
        return put(batch["audio"]), targets

    def device_batches(self, loader: Iterable[Dict[str, np.ndarray]]):
        """Device batches, each copy issued one batch ahead of its step."""
        it = iter(loader)
        try:
            nxt = self.put_batch(next(it))
        except StopIteration:
            return
        for batch in it:
            cur, nxt = nxt, self.put_batch(batch)
            yield cur
        yield nxt

    # ---- epoch loops ---------------------------------------------------

    def train(self, loader: Iterable[Dict[str, np.ndarray]], verbose: bool = False) -> Dict[str, float]:
        """One epoch; steps the scheduler once at its end."""
        collected = [self.train_step(a, t) for a, t in self.device_batches(loader)]
        if self.scheduler is not None:
            self.scheduler.step()
        metrics = self._reduce(collected)
        self.train_metrics.append(metrics)
        if verbose:
            self._log("train", metrics)
        return metrics

    def evaluate(self, loader: Iterable[Dict[str, np.ndarray]], verbose: bool = False) -> Dict[str, float]:
        collected = [self.eval_step(a, t) for a, t in self.device_batches(loader)]
        metrics = self._reduce(collected)
        self.eval_metrics.append(metrics)
        if verbose:
            self._log("eval", metrics)
        return metrics

    def set_learning_rate(self, lr: float) -> None:
        """Write a learning rate into the optimizer (the plateau controller's)."""
        set_learning_rate(self.optimizer, lr)

    @staticmethod
    def _reduce(collected: List[torch.Tensor]) -> Dict[str, float]:
        """(n_batches, 10) metric vectors -> the epoch means, in one fetch."""
        if not collected:
            return {k: float("nan") for k in METRIC_KEYS}
        means = torch.stack(collected).cpu().double().mean(0).tolist()
        return dict(zip(METRIC_KEYS, means))

    @staticmethod
    def _log(mode: str, metrics: Dict[str, float]) -> None:
        ts = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        body = "\t".join(f"{k.replace('_', ' ')}: {v:.4f}" for k, v in metrics.items())
        print(f"[{ts}] [{mode.title()}]: {body}")

    # ---- checkpoints ---------------------------------------------------

    @staticmethod
    def _atomic_save(path: str, payload: Dict[str, Any]) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"  # pid-unique: two runs never share a temp file
        try:
            torch.save(payload, tmp)
            os.replace(tmp, path)  # a crash never leaves a torn file
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def model_state_dict(self) -> Dict[str, torch.Tensor]:
        """The train-form state dict on the host, with the EMA parameters in
        place of the live ones when EMA is on (what ``serve`` loads)."""
        sd = self.model.state_dict()
        if self.ema is not None:
            sd.update(self.ema.params)
        return {k: v.detach().cpu() for k, v in sd.items()}

    def save_model(self, path: Optional[str] = None) -> str:
        path = path or self.saved_model_path
        self._atomic_save(path, self.model_state_dict())
        return path

    @property
    def resume_checkpoint_path(self) -> str:
        return os.path.join(self.model_path, "checkpoint.pt")

    def save_checkpoint(self, epoch: int, best_loss: float, path: Optional[str] = None,
                        extra: Optional[Dict[str, Any]] = None) -> str:
        """Everything a resumed run needs; ``extra`` carries small host state
        (the plateau controller's), surfaced as ``checkpoint_extra`` on load."""
        payload = {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": None if self.scheduler is None else self.scheduler.state_dict(),
            "step": self.step,
            "epoch": int(epoch),
            "best_loss": float(best_loss),
            "train_metrics": self.train_metrics,
            "eval_metrics": self.eval_metrics,
        }
        if self.ema is not None:
            payload["ema_params"] = self.ema.params
            payload["ema_num_updates"] = self.ema.num_updates
        if extra:
            payload["extra"] = dict(extra)
        path = path or self.resume_checkpoint_path
        self._atomic_save(path, payload)
        return path

    def load_checkpoint(self, path: Optional[str] = None):
        """Restores the state; returns ``(next_epoch, best_loss)``."""
        path = path or self.resume_checkpoint_path
        if not os.path.exists(path):
            raise OSError(f"no resume checkpoint at {path}")
        payload = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        if self.scheduler is not None and payload.get("scheduler") is not None:
            self.scheduler.load_state_dict(payload["scheduler"])
        if self.ema is not None and "ema_params" in payload:
            self.ema.params = {k: v.to(self.device) for k, v in payload["ema_params"].items()}
            self.ema.num_updates = int(payload.get("ema_num_updates", 0))
        self.step = int(payload.get("step", 0))
        self.train_metrics = [dict(m) for m in payload.get("train_metrics", [])]
        self.eval_metrics = [dict(m) for m in payload.get("eval_metrics", [])]
        self.checkpoint_extra = payload.get("extra")
        return int(payload.get("epoch", -1)) + 1, float(payload.get("best_loss", math.inf))

    # ---- metrics -------------------------------------------------------

    def metrics_to_csv(self) -> None:
        """``train_metrics.csv`` and ``eval_metrics.csv``: one row per epoch,
        floats as ``repr`` writes them and NaN as an empty field (the JAX
        package's pandas output)."""
        os.makedirs(self.metrics_path, exist_ok=True)
        for mode, rows in (("train", self.train_metrics), ("eval", self.eval_metrics)):
            with open(os.path.join(self.metrics_path, f"{mode}_metrics.csv"), "w",
                      newline="") as f:
                w = csv.writer(f)
                if rows:
                    w.writerow(list(rows[0]))
                    w.writerows([["" if math.isnan(v) else repr(v) for v in r.values()]
                                 for r in rows])

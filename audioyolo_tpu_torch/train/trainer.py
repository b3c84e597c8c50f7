"""Training engine (port of ``audioyolo_tpu/train/trainer.py``).

``train_step`` runs the train-mode forward (kernel 1 computes the frontend
on the card in the ``default`` + ``pallas_frontend: on`` posture), the loss
with its metrics, the backward pass, the optimizer step and the EMA update,
and returns the (10,) metric vector, which stays on the device. The body runs
in the model's compute dtype; parameters, gradients, Adam's moments, the EMA
and every checkpoint stay float32 whatever it is. An epoch
fetches its metrics once, as one stacked tensor; nothing in the step waits
for the host. Batches go to the card one ahead of the step that uses them,
from pinned host memory with ``non_blocking`` copies; a batch already on the
device (``DeviceCachedLoader``) is taken as it is.

The dropout mask of step ``n`` comes from a generator seeded with
``(seed, n)``, as the JAX package folds the step into its key, so a resumed
run draws the masks it would have drawn.

The JAX package's step settings:

- ``steps_per_dispatch`` S > 1: S batches per dispatch and an (S, 10)
  metric block, an epoch's tail shorter than S through the single step. On
  the card the S steps are one CUDA graph over static input buffers. The
  first dispatch of each batch shape runs its S steps eagerly (on a side
  stream: they are the run's own steps and warm every lazy allocation) and
  then captures; later dispatches copy their batches into the buffers and
  replay. The optimizer is its capturable form with its learning rate a
  device tensor (the scheduler and the plateau controller fill it in
  place), the EMA counts on the device, and step ``i`` of the graph draws
  its dropout mask from its own generator, registered with the graph and
  seeded with ``(seed, n + i)`` before each replay: the masks of the eager
  steps. The kernels' launch counters are advanced by each replay by the
  number of launches the capture recorded (``ops/cuda_graph.py``).
  ``load_checkpoint`` drops the graphs (the optimizer's state tensors are
  new). On the CPU the S steps run eagerly.
- ``remat``: the train-mode forward runs its blocks (each ResNet, custom or
  ConvNeXt backbone block, RepVGG block and conv + BatchNorm + activation
  unit of the neck) under ``torch.utils.checkpoint`` with a selective
  policy that saves only the convolutions' outputs and the dropout and
  stochastic-depth masks, as the JAX package's
  ``save_only_these_names("ayt_tape")`` does; the frontend's feature image
  is the first block's input. Every BatchNorm and activation inside a block
  is recomputed in the backward pass, just before the block's backward, with
  the running statistics left as the forward pass set them, so the gradients
  are those of the step without remat. (torch recomputes a checkpointed
  region whole at its first backward use, where XLA recomputes value by
  value, so one region over the whole forward would hold every recomputed
  value at once and save nothing at the peak.)
- ``process_group`` (``--data_parallel``): each rank holds its shard of the
  global batch and the step is the single-device step on the global batch,
  as the JAX package's step sharded on its ``data`` axis: BatchNorm reduces
  its statistics over the group, dropout keeps the rank's rows of the global
  batch's mask, the loss and its metrics are computed on every rank from the
  gathered predictions and targets, and each rank back-propagates
  ``loss / world``. The collectives' backward passes sum over the group, so
  each rank's gradients are its rows' part of the global gradient and the
  parameters' gradients are summed over the group (no division by the world
  size: the loss is already global). Every rank keeps the same state.
- ``prng_impl`` (``train_prng``): the names the JAX package takes,
  ``threefry2x32``, ``rbg`` and ``unsafe_rbg``; any other raises JAX's
  ``ValueError``. The masks come from the step's seeded generator whatever
  the name: on the card that is Philox, a counter-based generator of the
  family XLA's ``RngBitGenerator`` uses off the TPU, and like ``rbg`` in JAX
  a stream that differs from threefry's but is fixed per seed.
"""

from __future__ import annotations

import contextlib
import csv
import math
import os
import warnings
from datetime import datetime
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import DeviceLike, resolve_device
from ..models.backbone import BasicBlock, Bottleneck, ConvNeXtBlock, ExtractorLayer, ShardedRng
from ..models.layers import BatchNorm, ConvNorm, RepVGGBlock
from ..ops.cuda_graph import clone, copy_into, count_replay, signature, warm_then_capture
from ..parallel.dist import all_reduce_grads, gather_rows
from .ema import EMA
from .loss import METRIC_KEYS, AudioDetectionLoss
from .optim import make_lr_scheduler, make_optimizer, set_learning_rate

TARGET_KEYS = ("classes", "centers", "widths", "valid", "clip_valid")

# what a rematerialised block keeps for the backward pass (JAX's "ayt_tape"
# names every conv output); the dropout masks are kept so that the recompute
# draws no random numbers
_REMAT_SAVED = (torch.ops.aten.convolution.default, torch.ops.aten.bernoulli.p)
_REMAT_UNITS = (BasicBlock, Bottleneck, ExtractorLayer, ConvNeXtBlock, RepVGGBlock, ConvNorm)


def _remat_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _REMAT_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_units(model) -> List[torch.nn.Module]:
    """The outermost blocks of ``_REMAT_UNITS`` in ``model``."""
    units: List[torch.nn.Module] = []

    def walk(m):
        for child in m.children():
            if isinstance(child, _REMAT_UNITS):
                units.append(child)
            else:
                walk(child)

    walk(model)
    return units


class _Rematerialised:
    """A block's forward under the selective checkpoint (an instance
    attribute that replaces the block's ``forward``)."""

    def __init__(self, block):
        self.forward = block.forward
        self.norms = [m for m in block.modules() if isinstance(m, BatchNorm)]

    def _contexts(self):
        fwd, recompute = create_selective_checkpoint_contexts(_remat_policy)
        return fwd, _running_stats_kept(self.norms, recompute)

    def __call__(self, *args):
        return checkpoint(self.forward, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=self._contexts)


@contextlib.contextmanager
def _running_stats_kept(norms: Sequence[BatchNorm], inner):
    """``inner`` (the recompute's context), with every BatchNorm's running
    statistics put back afterwards as the forward pass left them: the
    recompute runs the forward's very ops, running updates included."""
    kept = [(m.running_mean.clone(), m.running_var.clone()) for m in norms]
    try:
        with inner:
            yield
    finally:
        with torch.no_grad():
            for m, (mean, var) in zip(norms, kept):
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)


class _StepGraph:
    """S captured train steps: static input buffers, one registered
    generator per step, the (S, 10) metric output and each kernel's launches
    per replay (in ``ops/cuda_graph.py::COUNTERS``'s order)."""

    def __init__(self, graph, inputs, generators, out, counts):
        self.graph, self.inputs, self.generators = graph, inputs, generators
        self.out, self.counts = out, counts


def _shape_key(batches) -> Tuple:
    return tuple((signature(a), tuple(sorted((k, signature(v)) for k, v in t.items())))
                 for a, t in batches)


PRNG_IMPLS = ("threefry2x32", "rbg", "unsafe_rbg")


def check_prng_impl(name: Optional[str]) -> None:
    """Raise, as ``jax.random.key(seed, impl=name)`` does, for a
    ``train_prng`` name the JAX package does not know."""
    if name and name not in PRNG_IMPLS:
        known = ", ".join(f'"{n}"' for n in PRNG_IMPLS)
        raise ValueError(f'unrecognized PRNG implementation "{name}". '
                         f"Did you mean one of: {known}?")


class TrainerPipeline:
    def __init__(self, model, loss_fn: AudioDetectionLoss, optimizer_config: Dict[str, Any],
                 lr_scheduler_config: Optional[Dict[str, Any]] = None,
                 use_lr_scheduler: bool = True, model_path: str = "saved_model",
                 metrics_path: str = "metrics", ema_config: Optional[Dict[str, Any]] = None,
                 use_ema: bool = False, seed: int = 42, steps_per_dispatch: int = 1,
                 remat: bool = False, prng_impl: Optional[str] = None,
                 device: DeviceLike = None, process_group=None):
        check_prng_impl(prng_impl)
        self.prng_impl = prng_impl or None
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.steps_per_dispatch = max(int(steps_per_dispatch), 1)
        self.remat = bool(remat)
        self._graphed = self.steps_per_dispatch > 1 and self.device.type == "cuda"
        self.optimizer = make_optimizer(self.model.parameters(), optimizer_config,
                                        lr_scheduler_config, use_lr_scheduler,
                                        capturable=self._graphed)
        self.scheduler = make_lr_scheduler(self.optimizer, lr_scheduler_config, use_lr_scheduler)
        if self._graphed:
            self._tensor_lrs()
        self.model_path = model_path
        self.metrics_path = metrics_path
        self.ema_config = dict(ema_config or {})
        self.ema = (EMA(dict(self.model.named_parameters()),
                        int(self.ema_config.get("num_updates", 0))) if use_ema else None)
        self.seed = int(seed)
        self.step = 0
        self.generator = torch.Generator(device=self.device)
        self.group = process_group
        self.rank, self.world = 0, 1
        if process_group is not None:
            self.rank = torch.distributed.get_rank(process_group)
            self.world = torch.distributed.get_world_size(process_group)
        for m in self.model.modules():
            if isinstance(m, BatchNorm):
                m.process_group = process_group
        if self.remat:
            for block in _remat_units(self.model):
                block.forward = _Rematerialised(block)
        self._graphs: Dict[Tuple, _StepGraph] = {}
        self.saved_model_path = os.path.join(model_path, "AudioDetectionModel.pt")
        self.train_metrics: List[Dict[str, float]] = []
        self.eval_metrics: List[Dict[str, float]] = []
        self.checkpoint_extra: Optional[Dict[str, Any]] = None

    def _tensor_lrs(self) -> None:
        """A captured step reads its learning rate from a device tensor."""
        for group in self.optimizer.param_groups:
            if not torch.is_tensor(group["lr"]):
                group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32,
                                           device=self.device)

    # ---- steps ---------------------------------------------------------

    def _forward_loss(self, features, targets, rng):
        preds = self.model(features=features, generator=rng)
        if self.group is not None:
            preds = tuple(gather_rows(p, self.group) for p in preds)
        loss, metrics = self.loss_fn(preds, targets)
        return loss, AudioDetectionLoss.metrics_vector(metrics)

    def _step(self, audio, targets, generator: torch.Generator) -> torch.Tensor:
        """One optimizer step (no host counter moves): the (10,) metrics."""
        self.model.train()
        with torch.no_grad():
            features = self.model.frontend(audio)
        rng = generator
        if self.group is not None:
            targets = {k: gather_rows(v, self.group) for k, v in targets.items()}
            rng = ShardedRng(generator, self.rank, self.world)
        loss, metrics = self._forward_loss(features, targets, rng)
        self.optimizer.zero_grad(set_to_none=True)
        (loss if self.group is None else loss / self.world).backward()
        if self.group is not None:
            all_reduce_grads(self.model.parameters(), self.group)
        self.optimizer.step()
        if self.ema is not None:
            self.ema.update(dict(self.model.named_parameters()),
                            float(self.ema_config.get("momentum", 0.002)),
                            int(self.ema_config.get("N", 2000)))
        return metrics

    def _seed(self, generator: torch.Generator, step: int) -> None:
        generator.manual_seed((self.seed << 32) + step)

    def train_step(self, audio: torch.Tensor, targets: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step on a device batch; returns the (10,) metrics."""
        self._seed(self.generator, self.step)
        metrics = self._step(audio, targets, self.generator)
        self.step += 1
        return metrics

    def train_steps(self, batches: Sequence[Tuple[Any, Dict[str, torch.Tensor]]]) -> torch.Tensor:
        """``steps_per_dispatch`` optimizer steps, one per device batch, in
        one dispatch: the (S, 10) metrics (a CUDA graph on the card, eager
        steps on the CPU)."""
        if not self._graphed:
            return torch.stack([self.train_step(a, t) for a, t in batches])
        key = _shape_key(batches)
        graph = self._graphs.get(key)
        if graph is None:
            metrics, self._graphs[key] = self._capture(batches)
            return metrics
        for (a, t), (sa, st) in zip(batches, graph.inputs):
            copy_into(sa, a)
            for k in st:
                st[k].copy_(t[k], non_blocking=True)
        for i, g in enumerate(graph.generators):
            self._seed(g, self.step + i)
        graph.graph.replay()
        count_replay(graph.counts)
        self.step += len(batches)
        return graph.out.clone()

    def _capture(self, batches) -> Tuple[torch.Tensor, _StepGraph]:
        """The S steps eagerly (their metrics), then captured."""
        inputs = [(clone(a), clone(t)) for a, t in batches]
        generators = [torch.Generator(device=self.device) for _ in batches]
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        metrics, out, counts = warm_then_capture(
            self.device, graph, lambda: torch.stack([self.train_step(a, t) for a, t in batches]),
            lambda: torch.stack([self._step(a, t, g) for (a, t), g in zip(inputs, generators)]))
        return metrics, _StepGraph(graph, inputs, generators, out, counts)

    @torch.no_grad()
    def eval_step(self, audio: torch.Tensor, targets: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Eval-mode forward (the EMA parameters with the live BatchNorm
        statistics when EMA is on) and the loss's (10,) metrics, over the
        group's whole batch under data parallel."""
        self.model.eval()
        if self.ema is not None:
            preds = functional_call(self.model, self.ema.params, (audio,))
        else:
            preds = self.model(audio)
        if self.group is not None:
            preds = tuple(gather_rows(p, self.group) for p in preds)
            targets = {k: gather_rows(v, self.group) for k, v in targets.items()}
        _, metrics = self.loss_fn(preds, targets)
        return AudioDetectionLoss.metrics_vector(metrics)

    # ---- host -> device ------------------------------------------------

    def put_batch(self, batch: Dict[str, np.ndarray]):
        """A loader batch -> (audio, targets) on the device: pinned host
        copies sent with ``non_blocking`` (the host runs on meanwhile). The
        ``(q, scale)`` audio of the ``int8`` posture moves as a tuple; a
        tensor already on the device (a cached batch) is taken as it is."""
        cuda = self.device.type == "cuda"

        def put(x):
            if isinstance(x, tuple):
                return tuple(put(a) for a in x)
            if torch.is_tensor(x):
                return x.to(self.device, non_blocking=True)
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
        """One epoch; steps the scheduler once at its end. With
        ``steps_per_dispatch`` S > 1, S batches per dispatch and the epoch's
        tail shorter than S one step at a time."""
        s = self.steps_per_dispatch
        collected, pending = [], []
        for audio, targets in self.device_batches(loader):
            if s == 1:
                collected.append(self.train_step(audio, targets))
                continue
            pending.append((audio, targets))
            if len(pending) == s:
                collected.append(self.train_steps(pending))
                pending = []
        collected += [self.train_step(a, t) for a, t in pending]
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
        """(10,) metric vectors and (S, 10) blocks -> the epoch means, in
        one fetch."""
        if not collected:
            return {k: float("nan") for k in METRIC_KEYS}
        rows = torch.cat([m.reshape(-1, len(METRIC_KEYS)) for m in collected])
        means = rows.cpu().double().mean(0).tolist()
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
        """Writes the model (rank 0 alone under data parallel: every rank
        holds the same state); returns the path."""
        path = path or self.saved_model_path
        if self.rank == 0:
            self._atomic_save(path, self.model_state_dict())
        return path

    @property
    def resume_checkpoint_path(self) -> str:
        return os.path.join(self.model_path, "checkpoint.pt")

    def save_checkpoint(self, epoch: int, best_loss: float, path: Optional[str] = None,
                        extra: Optional[Dict[str, Any]] = None) -> str:
        """Everything a resumed run needs (written by rank 0 alone); ``extra``
        carries small host state (the plateau controller's), surfaced as
        ``checkpoint_extra`` on load. The learning rate is saved as a float
        whichever form of the optimizer ran."""
        optimizer = self.optimizer.state_dict()
        for group in optimizer["param_groups"]:  # a float, whichever form ran
            group["lr"] = float(group["lr"])
        payload = {
            "model": self.model.state_dict(),
            "optimizer": optimizer,
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
        if self.rank == 0:
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
        self._graphs.clear()  # captured against the state tensors just replaced
        if self._graphed:
            self._tensor_lrs()
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
        package's pandas output); rank 0 alone writes them."""
        if self.rank != 0:
            return
        os.makedirs(self.metrics_path, exist_ok=True)
        for mode, rows in (("train", self.train_metrics), ("eval", self.eval_metrics)):
            with open(os.path.join(self.metrics_path, f"{mode}_metrics.csv"), "w",
                      newline="") as f:
                w = csv.writer(f)
                if rows:
                    w.writerow(list(rows[0]))
                    w.writerows([["" if math.isnan(v) else repr(v) for v in r.values()]
                                 for r in rows])

    def save_metrics_plots(self, figsize=(25, 10)) -> None:
        """``train_metrics_plot.jpg`` and ``eval_metrics_plot.jpg`` in
        ``metrics_path`` (rank 0 alone), as the JAX package draws them. Where
        matplotlib is missing this warns once and writes nothing: the CSVs
        hold the same numbers (the JAX package raises ``ImportError``)."""
        if self.rank != 0:
            return
        try:
            import matplotlib
        except ImportError:
            warnings.warn("matplotlib is not installed: the metric plots are not written "
                          f"(the CSVs in {self.metrics_path} hold the same metrics)",
                          stacklevel=2)
            return
        matplotlib.use("Agg")
        for mode in ("train", "eval"):
            self._save_plot(mode, figsize)

    def _save_plot(self, mode: str, figsize) -> None:
        """One subplot per metric column, in the CSV's column order; nothing
        for a split without rows."""
        from matplotlib import pyplot as plt

        rows = getattr(self, f"{mode}_metrics")
        columns = list(dict.fromkeys(k for r in rows for k in r))
        if not rows or not columns:
            return
        fig, axs = plt.subplots(len(columns), 1, figsize=figsize)
        if len(columns) == 1:
            axs = [axs]
        for ax, col in zip(axs, columns):
            label = col.replace("_", " ").title()
            ax.plot(np.array([r.get(col, np.nan) for r in rows], np.float64))
            ax.grid(visible=True)
            ax.set_xlabel("Epoch")
            ax.set_ylabel(label)
            ax.set_title(f"[{mode.title()}] {label} vs Epoch")
        os.makedirs(self.metrics_path, exist_ok=True)
        fig.savefig(os.path.join(self.metrics_path, f"{mode}_metrics_plot.jpg"))
        plt.close(fig)

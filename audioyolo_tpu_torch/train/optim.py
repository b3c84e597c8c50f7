"""Optimizer and learning-rate scheduler by name (port of
``audioyolo_tpu/train/optim.py``).

The reference builds ``torch.optim.<name>`` and
``torch.optim.lr_scheduler.<name>`` from the config; so does the port, with
the keys and defaults the JAX package reads for each name (its optax chains
are held to these torch classes by ``tests/test_optim.py``). In particular:

- ``Adam`` with ``weight_decay`` is torch's Adam, L2 added to the gradient;
- the scheduler is stepped once per epoch (the trainer does so at the end of
  each training epoch), as the reference steps it;
- ``ConstantLR`` keeps the base learning rate (the JAX package's reading);
- ``OneCycleLR`` anneals the learning rate only (``cycle_momentum`` off);
- ``ReduceLROnPlateau`` is the host-side controller below, fed the epoch's
  eval loss; its learning rate goes into the optimizer between epochs;
- ``NAdam`` is torch's own, which the JAX package's optax form approximates.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional

import torch

# name -> the keys the JAX package reads, with its defaults
_OPTIMIZERS: Dict[str, Dict[str, Any]] = {
    "Adam": {"betas": (0.9, 0.999), "eps": 1e-8},
    "AdamW": {"betas": (0.9, 0.999), "eps": 1e-8},
    "SGD": {"momentum": 0.0, "nesterov": False},
    "RMSprop": {"alpha": 0.99, "eps": 1e-8},
    "Adagrad": {"eps": 1e-10, "initial_accumulator_value": 0.0},
    "Adadelta": {"rho": 0.9, "eps": 1e-6},
    "Adamax": {"betas": (0.9, 0.999), "eps": 1e-8},
    "NAdam": {"betas": (0.9, 0.999), "eps": 1e-8},
    "RAdam": {"betas": (0.9, 0.999), "eps": 1e-8},
    "ASGD": {"lambd": 1e-4, "alpha": 0.75, "t0": 1e6},
    "Rprop": {"etas": (0.5, 1.2), "step_sizes": (1e-6, 50.0)},
}

_SCHEDULERS: Dict[str, Dict[str, Any]] = {
    "CosineAnnealingWarmRestarts": {"T_0": 200, "T_mult": 1, "eta_min": 0.0},
    "CosineAnnealingLR": {"T_max": 200, "eta_min": 0.0},
    "StepLR": {"step_size": 30, "gamma": 0.1},
    "ExponentialLR": {"gamma": 0.95},
    "MultiStepLR": {"milestones": [30, 80], "gamma": 0.1},
    "LinearLR": {"start_factor": 1.0 / 3.0, "end_factor": 1.0, "total_iters": 5},
    "PolynomialLR": {"total_iters": 5, "power": 1.0},
    "OneCycleLR": {"pct_start": 0.3, "div_factor": 25.0, "final_div_factor": 1e4},
    "ConstantLR": {},
}


def _value(v: Any) -> Any:
    return tuple(float(x) for x in v) if isinstance(v, (list, tuple)) else v


def is_plateau(lr_scheduler_cfg: Optional[Dict[str, Any]], use_lr_scheduler: bool = True) -> bool:
    return bool(use_lr_scheduler and lr_scheduler_cfg
                and lr_scheduler_cfg.get("name") == "ReduceLROnPlateau")


def make_optimizer(params: Iterable[torch.nn.Parameter], optimizer_cfg: Dict[str, Any],
                   lr_scheduler_cfg: Optional[Dict[str, Any]] = None,
                   use_lr_scheduler: bool = True,
                   capturable: bool = False) -> torch.optim.Optimizer:
    """``capturable=True``: the optimizer's form that a CUDA graph can
    capture (its state and step counters on the device): torch's own
    ``capturable`` form, or for SGD and Adagrad, which have none,
    :class:`CapturableSGD` and :class:`CapturableAdagrad`."""
    cfg = dict(optimizer_cfg)
    name = cfg.pop("name", "Adam")
    lr = float(cfg.pop("lr", 1e-3))
    wd = float(cfg.pop("weight_decay", 0.0))
    if name not in _OPTIMIZERS:
        # LBFGS needs a closure the training loop never passes and SparseAdam
        # rejects the dense gradients of this model: the reference's loop
        # would fail on both, so there is no behaviour to match
        raise ValueError(
            f"unsupported optimizer '{name}'; supported: Adam, AdamW, SGD, RMSprop, "
            "Adagrad, Adadelta, Adamax, NAdam, RAdam, ASGD, Rprop")
    if name in ("ASGD", "Rprop") and is_plateau(lr_scheduler_cfg, use_lr_scheduler):
        raise ValueError(
            f"ReduceLROnPlateau is not supported with {name}: {name} owns its "
            "learning rate internally (torch ignores/folds group-lr changes "
            "there too) — pick a gradient-scaled optimizer or a step schedule")
    kw = {k: _value(cfg.get(k, d)) for k, d in _OPTIMIZERS[name].items()}
    if name == "Rprop":
        if wd:
            raise ValueError("Rprop does not take weight_decay (torch has none)")
    else:
        kw["weight_decay"] = wd
    if capturable:
        if name in _CAPTURABLE:
            return _CAPTURABLE[name](params, lr=lr, **kw)
        kw["capturable"] = True
    return getattr(torch.optim, name)(params, lr=lr, **kw)


class _Capturable(torch.optim.Optimizer):
    """An update a CUDA graph can capture: its state lives on the parameters'
    device, made at the first step (an eager one: the trainer's first
    dispatch runs its steps before it captures), the learning rate is a
    float or a device tensor (``set_learning_rate`` fills it in place), and
    ``step`` reads nothing back to the host."""

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                self._update(group, params, [p.grad for p in params])


class CapturableSGD(_Capturable):
    """``torch.optim.SGD`` (dampening 0) as a capturable update: L2 added to
    the gradient, then ``buf = momentum * buf + g`` and ``g + momentum *
    buf`` (nesterov) or ``buf``, as torch and the JAX package's
    ``optax.trace`` read it. The momentum buffer starts at zeros, so the
    first step's buffer is the gradient, as torch's clone of it."""

    def __init__(self, params, lr: float = 1e-3, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        if nesterov and momentum <= 0:
            raise ValueError("nesterov momentum requires a momentum > 0")
        super().__init__(params, dict(lr=lr, momentum=momentum, nesterov=nesterov,
                                      weight_decay=weight_decay))

    def _update(self, group, params, grads):
        wd, momentum = group["weight_decay"], group["momentum"]
        if wd:
            grads = torch._foreach_add(grads, params, alpha=wd)
        if momentum:
            bufs = []
            for p in params:
                state = self.state[p]
                if "momentum_buffer" not in state:
                    state["momentum_buffer"] = torch.zeros_like(p)
                bufs.append(state["momentum_buffer"])
            torch._foreach_mul_(bufs, momentum)
            torch._foreach_add_(bufs, grads)
            grads = torch._foreach_add(grads, bufs, alpha=momentum) if group["nesterov"] else bufs
        lr = group["lr"]
        if torch.is_tensor(lr):  # torch.optim.SGD's forms for a tensor and a float
            torch._foreach_add_(params, torch._foreach_mul(grads, -lr))
        else:
            torch._foreach_add_(params, grads, alpha=-lr)


class CapturableAdagrad(_Capturable):
    """``torch.optim.Adagrad`` (no learning-rate decay) as a capturable
    update: L2 added to the gradient, ``sum += g * g``, ``p -= lr * g /
    (sqrt(sum) + eps)``; the sums start at ``initial_accumulator_value`` and
    the step count is a device tensor, as in torch's state."""

    def __init__(self, params, lr: float = 1e-2, eps: float = 1e-10,
                 initial_accumulator_value: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, eps=eps, weight_decay=weight_decay,
                                      initial_accumulator_value=initial_accumulator_value))

    def _update(self, group, params, grads):
        sums, steps = [], []
        for p in params:
            state = self.state[p]
            if "sum" not in state:
                state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                state["sum"] = torch.full_like(p, group["initial_accumulator_value"])
            sums.append(state["sum"])
            steps.append(state["step"])
        torch._foreach_add_(steps, 1)
        if group["weight_decay"]:
            grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
        torch._foreach_addcmul_(sums, grads, grads, value=1)
        std = torch._foreach_sqrt(sums)
        torch._foreach_add_(std, group["eps"])
        torch._foreach_addcdiv_(params, torch._foreach_mul(grads, -group["lr"]), std)


_CAPTURABLE = {"SGD": CapturableSGD, "Adagrad": CapturableAdagrad}


def make_lr_scheduler(optimizer: torch.optim.Optimizer,
                      lr_scheduler_cfg: Optional[Dict[str, Any]],
                      use_lr_scheduler: bool = True):
    """The epoch-stepped scheduler, or None (no scheduler, or plateau)."""
    if not (use_lr_scheduler and lr_scheduler_cfg) or is_plateau(lr_scheduler_cfg):
        return None
    cfg = dict(lr_scheduler_cfg)
    name = cfg.get("name", "ConstantLR")
    if name not in _SCHEDULERS:
        raise ValueError(
            f"unsupported lr scheduler '{name}'; supported: "
            "CosineAnnealingWarmRestarts, CosineAnnealingLR, StepLR, MultiStepLR, "
            "ExponentialLR, LinearLR, PolynomialLR, OneCycleLR, ConstantLR, "
            "ReduceLROnPlateau (the host-side controller)")
    kw = {k: cfg.get(k, d) for k, d in _SCHEDULERS[name].items()}
    sched = getattr(torch.optim.lr_scheduler, name)
    if name == "MultiStepLR":
        kw["milestones"] = sorted(int(m) for m in kw["milestones"])
    elif name == "OneCycleLR":
        kw.update(max_lr=float(cfg.get("max_lr", optimizer.param_groups[0]["lr"])),
                  total_steps=int(cfg.get("total_steps") or cfg.get("epochs", 200)),
                  cycle_momentum=False)
    elif name == "ConstantLR":
        kw = {"factor": 1.0}
    return sched(optimizer, **kw)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Writes ``lr`` into every group; a tensor learning rate (a captured
    step's) is filled in place."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)


class ReduceLROnPlateau:
    """Host-side metric-driven learning rate with the semantics of
    ``torch.optim.lr_scheduler.ReduceLROnPlateau``, fed once per epoch (the
    eval loss); its ``state_dict`` goes into the checkpoint's ``extra``."""

    def __init__(self, base_lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4, threshold_mode: str = "rel",
                 cooldown: int = 0, min_lr: float = 0.0, eps: float = 1e-8):
        if factor >= 1.0:
            raise ValueError("ReduceLROnPlateau factor must be < 1.0")
        if mode not in ("min", "max") or threshold_mode not in ("rel", "abs"):
            raise ValueError(f"bad mode={mode!r} / threshold_mode={threshold_mode!r}")
        self.lr = float(base_lr)
        self.mode, self.factor, self.patience = mode, float(factor), int(patience)
        self.threshold, self.threshold_mode = float(threshold), threshold_mode
        self.cooldown, self.min_lr, self.eps = int(cooldown), float(min_lr), float(eps)
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    @classmethod
    def from_config(cls, cfg: Dict[str, Any], base_lr: float) -> "ReduceLROnPlateau":
        keys = ("mode", "factor", "patience", "threshold", "threshold_mode",
                "cooldown", "min_lr", "eps")
        return cls(base_lr, **{k: cfg[k] for k in keys if k in cfg})

    def _is_better(self, a: float, best: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < best * (1.0 - self.threshold)
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold

    def state_dict(self) -> Dict[str, float]:
        return {"lr": self.lr, "best": self.best, "num_bad_epochs": self.num_bad_epochs,
                "cooldown_counter": self.cooldown_counter}

    def load_state_dict(self, d: Dict[str, float]) -> None:
        self.lr = float(d["lr"])
        self.best = float(d["best"])
        self.num_bad_epochs = int(d["num_bad_epochs"])
        self.cooldown_counter = int(d["cooldown_counter"])

    def step(self, metric: float) -> float:
        """Feed one epoch's metric; returns the (possibly reduced) learning rate."""
        current = float(metric)
        if self._is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

"""The capturable SGD and Adagrad of ``train/optim.py`` (what
``steps_per_dispatch > 1`` captures in a CUDA graph on the card) on the CPU.

- Against ``torch.optim.SGD`` / ``Adagrad`` over 8 steps of seeded gradients:
  with a float learning rate (as ``make_optimizer`` returns them) the state
  and the parameters are torch's bit for bit; with a tensor learning rate (as
  the trainer's captured step reads it) the parameters and the state within
  1e-6, the product with the tensor being rounded apart from the add.
- Against the JAX package's optax chain (``audioyolo_tpu/train/optim.py``)
  over one dispatch of 2 steps at the tensor learning rate: the parameters
  within ``test_torch_train_loop.py``'s ``PARAM_ABS``.
- ``set_learning_rate`` fills the tensor the captured step reads.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioyolo_tpu.train.optim import make_optimizer as j_make_optimizer

from audioyolo_tpu_torch.train.optim import (CapturableAdagrad, CapturableSGD, make_optimizer,
                                             set_learning_rate)

from test_torch_train_loop import PARAM_ABS

CONFIGS = {
    "sgd": {"name": "SGD", "lr": 0.1},
    "sgd_momentum": {"name": "SGD", "lr": 0.1, "momentum": 0.9},
    "sgd_nesterov": {"name": "SGD", "lr": 0.1, "momentum": 0.9, "nesterov": True},
    "sgd_nesterov_wd": {"name": "SGD", "lr": 0.1, "momentum": 0.9, "nesterov": True,
                        "weight_decay": 0.01},
    "adagrad": {"name": "Adagrad", "lr": 0.1, "weight_decay": 0.01,
                "initial_accumulator_value": 0.1, "eps": 1e-10},
}
SHAPES = ((5, 3), (7,), (2, 3, 4))
STEPS = 8


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return [torch.nn.Parameter(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
            for s in SHAPES]


def _grads(steps, seed=1):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(s).astype(np.float32) for s in SHAPES] for _ in range(steps)]


def _run(opt, params, grads):
    for step in grads:
        for p, g in zip(params, step):
            p.grad = torch.from_numpy(g.copy())
        opt.step()


def _tensor_lr(opt):
    for group in opt.param_groups:
        group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32)


def _states(opt, params):
    return [{k: torch.as_tensor(v, dtype=torch.float32) for k, v in opt.state[p].items()}
            for p in params]


@pytest.mark.parametrize("case", list(CONFIGS))
def test_capturable_matches_torch_optim(case):
    cfg = CONFIGS[case]
    grads = _grads(STEPS)
    ref_p = _params()
    ref = make_optimizer(ref_p, cfg)
    assert type(ref) is getattr(torch.optim, cfg["name"])
    _run(ref, ref_p, grads)
    for tensor_lr in (False, True):
        ours_p = _params()
        ours = make_optimizer(ours_p, cfg, capturable=True)
        assert type(ours) is {"SGD": CapturableSGD, "Adagrad": CapturableAdagrad}[cfg["name"]]
        if tensor_lr:
            _tensor_lr(ours)
        _run(ours, ours_p, grads)
        got, want = _states(ours, ours_p), _states(ref, ref_p)
        assert [sorted(s) for s in got] == [sorted(s) for s in want]
        p_diff = max((a - b).abs().max().item() for a, b in zip(ours_p, ref_p))
        s_diff = max([(s[k] - w[k]).abs().max().item() for s, w in zip(got, want) for k in w]
                     or [0.0])
        moved = max((a.detach() - b.detach()).abs().max().item()
                    for a, b in zip(ref_p, _params()))
        print(f"{case} tensor lr {tensor_lr}: params {p_diff:.3e}, state {s_diff:.3e} "
              f"(the largest move {moved:.3e})")
        if tensor_lr:
            assert p_diff < 1e-6 and s_diff < 1e-6
        else:
            assert p_diff == 0.0 and s_diff == 0.0
        assert moved > 1e-2


@pytest.mark.parametrize("case", ["sgd_nesterov_wd", "adagrad"])
def test_capturable_matches_the_jax_chain(case):
    """One dispatch of 2 steps: the port's capturable form at a tensor
    learning rate against the optax chain the JAX package builds for the same
    config (L2 in torch's position; ``optax.trace`` / ``scale_by_rss``)."""
    cfg = CONFIGS[case]
    grads = _grads(2, seed=3)
    params = _params(seed=2)
    ours = make_optimizer(params, cfg, capturable=True)
    _tensor_lr(ours)
    _run(ours, params, grads)
    tx = j_make_optimizer(cfg, None, 2, use_lr_scheduler=False)
    jp = [jnp.asarray(p.detach().numpy()) for p in _params(seed=2)]
    state = tx.init(jp)
    for step in grads:
        updates, state = tx.update([jnp.asarray(g) for g in step], state, jp)
        jp = [p + u for p, u in zip(jp, updates)]
    diff = max(np.abs(p.detach().numpy() - np.asarray(j)).max() for p, j in zip(params, jp))
    print(f"{case}: largest |port - JAX| {diff:.3e}")
    assert diff < PARAM_ABS


@pytest.mark.parametrize("name", ["SGD", "Adagrad"])
def test_set_learning_rate_fills_the_tensor_in_place(name):
    params = _params()
    opt = make_optimizer(params, {"name": name, "lr": 0.1, "momentum": 0.5}
                         if name == "SGD" else {"name": name, "lr": 0.1}, capturable=True)
    _tensor_lr(opt)
    lr = opt.param_groups[0]["lr"]
    set_learning_rate(opt, 0.025)
    assert opt.param_groups[0]["lr"] is lr and lr.item() == pytest.approx(0.025)
    grads = _grads(3)
    _run(opt, params, grads)
    ref_p = _params()
    ref = make_optimizer(ref_p, {"name": name, "lr": 0.025, "momentum": 0.5}
                         if name == "SGD" else {"name": name, "lr": 0.025})
    _run(ref, ref_p, grads)
    assert max((a - b).abs().max().item() for a, b in zip(params, ref_p)) < 1e-6

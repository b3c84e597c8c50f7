"""The trainer's step settings on the CPU: selective rematerialisation
(``train_remat``) against the plain step, and ``steps_per_dispatch`` against
single steps and against the JAX package's ``steps_per_dispatch``.

On the card a dispatch of S steps is one captured CUDA graph
(``chip_smoke.py`` phase 12 holds it to eager steps); on the CPU the same S
steps run eagerly through the same step code, so the port's dispatch equals
its single steps bit for bit here. Against the JAX package (one dispatch of 2 batches of 2, SGD at
learning rate 1e-5, EMA on, dropout 0, one JAX initialisation, the port's
feature image on both sides as in ``test_torch_train_loop.py``), the bounds
of its ``test_train_step_matches_jax``: the metrics 1e-5 relative and the
BatchNorm statistics 1e-5 (its highest posture's); the parameters and the
EMA as its kernel posture reads them, robustly (the median over tensors of
the largest difference 1e-6, the L2 norm of the difference against JAX's
move 0.25). Observed: a median of 8.7e-11 and an L2 of 8.7e-3, and at worst
1.7e-6 on ``feature_extractor.conv1.conv.weight`` (of a 2.3e-4 move): the
first conv's gradient sums every clip's whole image, and a float32 sum in
another order moves it most.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioyolo_tpu.train import AudioDetectionLoss as JLoss
from audioyolo_tpu.train import TrainerPipeline as JTrainer
from audioyolo_tpu.train.optim import make_optimizer as j_make_optimizer

from audioyolo_tpu_torch.config import Config
from audioyolo_tpu_torch.models import AudioDetectionModel, state_dict_from_jax
from audioyolo_tpu_torch.models.layers import BatchNorm
from audioyolo_tpu_torch.train import METRIC_KEYS, AudioDetectionLoss, TrainerPipeline
from audioyolo_tpu_torch.train.optim import make_optimizer, set_learning_rate
from audioyolo_tpu_torch.train.trainer import _remat_units

from test_torch_train_loop import (BN_REL, KINK_BOUNDS, LOSS_KW, PARAM_ABS, SGD, _batches, _jax_state,
                                   _l2_rel, _raw)

EMA_CFG = {"momentum": 0.002, "num_updates": 0, "N": 2000}


def _trainer(raw, sd, dtype=None, **kw):
    model = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2, dtype=dtype)
    model.load_state_dict(sd)
    tc = raw["train_config"]
    return TrainerPipeline(model, AudioDetectionLoss(raw["anchors"], **LOSS_KW),
                           tc["optimizer_config"], None, use_lr_scheduler=False,
                           ema_config=EMA_CFG, use_ema=True, seed=11, device="cpu", **kw)


def _loader(batches):
    return [{"audio": a, **t} for a, t in batches]


def _state(trainer):
    m = trainer.model
    return dict(grads={k: p.grad.clone() for k, p in m.named_parameters()},
                params={k: p.detach().clone() for k, p in m.named_parameters()},
                buffers={k: b.clone() for k, b in m.named_buffers()},
                ema={k: p.clone() for k, p in trainer.ema.params.items()},
                ema_n=trainer.ema.num_updates, step=trainer.step)


def _equal(a, b):
    for part in ("grads", "params", "buffers", "ema"):
        for k, t in a[part].items():
            assert torch.equal(t, b[part][k]), (part, k)
    assert a["ema_n"] == b["ema_n"] and a["step"] == b["step"]


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_remat_gradients_equal_the_plain_step(dtype):
    """Dropout 0.4 and EMA on, three steps: with ``remat`` each block keeps
    only its conv outputs and dropout masks, its BatchNorms and activations
    are recomputed in the backward pass (the running statistics left as the
    forward set them), and every gradient, parameter, buffer, EMA value and
    metric is the plain step's, bit for bit."""
    raw = _raw("highest")
    raw["dropout"] = 0.4
    sd = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2).state_dict()
    plain, remat = _trainer(raw, sd, dtype), _trainer(raw, sd, dtype, remat=True)
    batches = _batches(raw, 3, seed=40)
    recomputed = []
    hook = [m.register_forward_hook(lambda *a: recomputed.append(1))
            for m in remat.model.modules() if isinstance(m, BatchNorm)]
    for audio, t in batches:
        x, tg = torch.from_numpy(audio), {k: torch.from_numpy(v) for k, v in t.items()}
        ma, mb = plain.train_step(x, tg), remat.train_step(x, tg)
        assert torch.equal(ma, mb), (ma, mb)
        _equal(_state(plain), _state(remat))
    for h in hook:
        h.remove()
    n_norms = sum(isinstance(m, BatchNorm) for m in remat.model.modules())
    n_kept = sum(isinstance(m, BatchNorm) for m in remat.model.modules()
                 if not any(m in set(u.modules()) for u in _remat_units(remat.model)))
    assert n_kept == 1  # the ResNet stem's, outside every block
    # each BatchNorm inside a block ran again in each backward
    assert len(recomputed) == 3 * (2 * n_norms - n_kept)


def _features(raw, sd, batches):
    model = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2)
    model.load_state_dict(sd)
    with torch.no_grad():
        return [model.frontend(torch.from_numpy(a)).numpy() for a, _ in batches]


class _FeatureModel:
    """The JAX detector fed the feature image where its trainer passes the
    audio (the port's image on both sides)."""

    def __init__(self, jm):
        self.jm = jm

    def init(self, rngs, x, train=False):
        return self.jm.init(rngs, features=x, train=train)

    def apply(self, variables, x, **kw):
        return self.jm.apply(variables, features=x, **kw)


def test_steps_per_dispatch_matches_single_steps_and_jax():
    """5 batches at ``steps_per_dispatch`` 2 (2 dispatches + 1 single step)
    against 5 single steps (bit for bit; dropout 0.4, EMA on), then the
    dispatch with dropout 0 against the JAX package's at 2 on the same
    batches and weights."""
    raw = _raw("highest")
    batches = _batches(raw, 5, seed=50)
    jm, v = _jax_state(raw, batches[0][0][:1])
    sd = state_dict_from_jax(v)

    drop = copy.deepcopy(raw)
    drop["dropout"] = 0.4
    one, two = _trainer(drop, sd), _trainer(drop, sd, steps_per_dispatch=2)
    calls = []
    single = two.train_step
    two.train_step = lambda *a: calls.append("single") or single(*a)
    dispatch = two.train_steps
    two.train_steps = lambda b: calls.append(len(b)) or dispatch(b)
    m1, m2 = one.train(_loader(batches)), two.train(_loader(batches))
    assert calls == [2, "single", "single", 2, "single", "single", "single"]
    assert m1 == m2
    _equal(_state(one), _state(two))
    assert two.step == 5 and two.ema.num_updates == 5

    # one dispatch of the first two batches against the JAX package's, SGD
    sgd = copy.deepcopy(raw)
    sgd["train_config"]["optimizer_config"] = SGD
    port = _trainer(sgd, sd, steps_per_dispatch=2)
    got = port.train(_loader(batches[:2]))
    jt = JTrainer(_FeatureModel(jm), JLoss(raw["anchors"], **LOSS_KW),
                  j_make_optimizer(SGD, None, 2, use_lr_scheduler=False),
                  ema_config=EMA_CFG, use_ema=True, steps_per_dispatch=2,
                  model_path="/nonexistent", metrics_path="/nonexistent")
    feats = _features(raw, sd, batches[:2])
    state = jt.create_state(feats[0][:1])
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"],
                          opt_state=jt.tx.init(v["params"]),
                          ema=state.ema._replace(params=jax.tree_util.tree_map(jnp.array,
                                                                               v["params"])))
    state, ref = jt.train(state, [{"audio": f, **t} for f, (_, t) in zip(feats, batches)])
    assert int(state.step) == 2 and int(state.ema.num_updates) == 2
    rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in METRIC_KEYS}
    print(f"metrics: loss {got['aggregate_loss']:.7f} vs {ref['aggregate_loss']:.7f}, worst "
          f"{max(rel, key=rel.get)} {max(rel.values()):.3e}")
    assert max(rel.values()) < 1e-5
    start = {k: t.numpy() for k, t in sd.items()}
    for name, ours, theirs in (("params", dict(port.model.named_parameters()), state.params),
                               ("ema", port.ema.params, state.ema.params)):
        ref_sd = {k: t.numpy() for k, t in state_dict_from_jax({"params": theirs}).items()}
        mine = {k: ours[k].detach().numpy() for k in ref_sd}
        diffs = {k: np.abs(mine[k] - r).max() for k, r in ref_sd.items()}
        diff = max(diffs.values())
        moved = max(np.abs(r - start[k]).max() for k, r in ref_sd.items())
        l2 = _l2_rel({k: mine[k] - start[k] for k in ref_sd},
                     {k: r - start[k] for k, r in ref_sd.items()})
        print(f"{name}: max |diff| {diff:.3e} ({max(diffs, key=diffs.get)}), median "
              f"{np.median(list(diffs.values())):.3e}, L2 against the move {l2:.3e}; the "
              f"largest move {moved:.3e}")
        assert np.median(list(diffs.values())) < PARAM_ABS and moved > 50 * PARAM_ABS, name
        assert l2 < KINK_BOUNDS["param_l2"], name
    bufs = dict(port.model.named_buffers())
    ref_bs = state_dict_from_jax({"batch_stats": state.batch_stats})
    worst = max(((bufs[k] - r).abs().max() / r.abs().max()).item() for k, r in ref_bs.items())
    print(f"BatchNorm buffers worst rel {worst:.3e}")
    assert worst < BN_REL


def test_learning_rate_and_ema_across_a_dispatch():
    """A captured step reads a tensor learning rate: ``set_learning_rate``
    and the scheduler fill it in place (the graph keeps its address), and
    SGD and Adagrad, which torch gives no capturable form, take the port's
    (``train/optim.py``). The EMA counts on the
    device: one count per step, ``m(n)`` in float32 as the JAX package
    computes it."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.Adam([p], lr=torch.tensor(1e-3), foreach=False)
    lr = opt.param_groups[0]["lr"]
    set_learning_rate(opt, 5e-4)
    assert opt.param_groups[0]["lr"] is lr and lr.item() == pytest.approx(5e-4)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=0.5)
    opt.step()
    sched.step()
    assert opt.param_groups[0]["lr"] is lr and lr.item() == pytest.approx(2.5e-4)
    for name in ("SGD", "Adagrad"):  # their capturable forms (train/optim.py)
        opt = make_optimizer([p], {"name": name, "lr": 0.1}, capturable=True)
        assert type(opt).__name__ == f"Capturable{name}"
    adam = make_optimizer([p], {"name": "Adam", "lr": 0.1}, capturable=True)
    assert adam.defaults["capturable"]

    raw = _raw("highest")
    batches = _batches(raw, 2, seed=60)
    sd = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2).state_dict()
    one, two = _trainer(raw, sd), _trainer(raw, sd, steps_per_dispatch=2)
    shadow = {k: v.clone() for k, v in one.ema.params.items()}
    for n, (audio, tg) in enumerate(batches, start=1):
        one.train_step(torch.from_numpy(audio), {k: torch.from_numpy(x) for k, x in tg.items()})
        m = 1.0 - (1.0 - EMA_CFG["momentum"]) * (
            1.0 - torch.exp(-torch.tensor(n, dtype=torch.float32) / EMA_CFG["N"]))
        shadow = {k: (1.0 - m) * e + m * dict(one.model.named_parameters())[k].detach()
                  for k, e in shadow.items()}
    two.train(_loader(batches))
    assert two.ema.num_updates == 2 and two.ema.count.dtype == torch.int32
    for k, e in shadow.items():
        assert torch.equal(two.ema.params[k], e), k

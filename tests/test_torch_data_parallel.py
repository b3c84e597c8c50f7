"""Data parallel training of the port on the CPU: two ``gloo`` ranks in
subprocesses (``parallel/dist.py`` reads the ``torchrun`` environment the
test sets), each holding its half of every global batch, against one process
on the rank-ordered global batch and against the JAX package's single-device
step on it.

One launch of the two ranks (this file run as a script) does it all:

1. one SGD step (lr 1e-5, the highest posture, dropout 0, JAX-initialised
   weights) on the rank's rows of a global batch of 4; then two Adam steps
   at ``steps_per_dispatch`` 2 and at 1 (the JAX package's
   ``test_steps_per_dispatch_matches_single_sharded``);
2. ``train_cli.run(data_parallel=True)`` for one epoch (dropout 0.4, the
   shards of ``BatchLoader(shard=)``, ``last_batch: pad``), then
   ``--resume`` to a second epoch; every file the rank writes is recorded.

Bounds: the ranks agree bit for bit (the collectives give each rank the same
sums); against one process on the global batch the loss and the 10 metrics
of a step 1e-5 relative, each gradient 1e-3 of its largest value, the
BatchNorm buffers 1e-5, the parameters after the SGD step 1e-6 and after
Adam the 97th percentile 1e-4 and the largest 3e-3 (JAX's own guard in
``tests/test_train_e2e.py``). Adam moves a parameter by ~lr whatever its
gradient's size on its first step, so a near-zero gradient summed in another
order moves one by ~2 lr, and every later forward reads that: the CLI's
epochs are one step each (3 clips per rank, 4 per rank's batch), so the
epoch's metrics are its step's (1e-5), and the evaluation after the step is
held at the JAX package's own guard for a data-parallel epoch against one
process (``tests/test_multiprocess_dp.py``: losses 2e-3 relative or 1e-4, F1
2e-2). At two steps per rank's epoch (batches of 2) the second step's loss
read 7e-5 relative under Adam and 6.5e-7 under SGD with momentum (observed),
so the difference is Adam's amplification, not a fault of the step. Against
the JAX package, the bounds of ``test_train_step_matches_jax``: the loss,
the metrics and the BatchNorm buffers as above, and the gradients and the
parameters read as its kernel posture reads them (median, 90th percentile and
L2 over the tensors; ``KINK_BOUNDS``). This global batch puts
pre-activations at a ReLU's kink, within float32's error: against the port's
own float64 step, the port's float32 gradients differ by up to 0.21 of a
tensor's largest (``layer4_0.bn1.bias``) and JAX's by up to 0.10
(``cspsppf.conv4.norm.bias``), at other tensors, medians ~1e-5; which side
a float32 sum lands on depends on its order. The ranks and one process of the
port land on the same side (1e-3 per tensor above).
"""

import copy
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)), ROOT]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from audioyolo_tpu.train import AudioDetectionLoss as JLoss  # noqa: E402
from audioyolo_tpu.train.optim import make_optimizer as j_make_optimizer  # noqa: E402

from audioyolo_tpu_torch import train_cli  # noqa: E402
from audioyolo_tpu_torch.config import Config  # noqa: E402
from audioyolo_tpu_torch.data.loader import BatchLoader  # noqa: E402
from audioyolo_tpu_torch.models import AudioDetectionModel, state_dict_from_jax  # noqa: E402
from audioyolo_tpu_torch.parallel import dist  # noqa: E402
from audioyolo_tpu_torch.train import METRIC_KEYS, AudioDetectionLoss, TrainerPipeline  # noqa: E402

from test_torch_train_loop import (KINK_BOUNDS, LOSS_KW, SGD, _batches, _cli_raw,  # noqa: E402
                                   _jax_state, _l2_rel, _raw)

WORLD = 2
ADAM = {"name": "Adam", "lr": 1e-3}
WORKER_TIMEOUT_S = 120


def _global(batches):
    """Two (framed, targets) batches of 2 -> one global batch of 4."""
    audio = np.concatenate([a for a, _ in batches])
    targets = {k: np.concatenate([t[k] for _, t in batches]) for k in batches[0][1]}
    return audio, targets


def _rows(batch, rank):
    audio, targets = batch
    sl = slice(2 * rank, 2 * rank + 2)
    return (torch.from_numpy(audio[sl]), {k: torch.from_numpy(v[sl]) for k, v in targets.items()})


def _model(raw, weights):
    model = AudioDetectionModel.from_config(Config(copy.deepcopy(raw)), 2)
    model.load_state_dict(torch.load(weights, weights_only=True))
    return model


def _step_state(trainer):
    m = trainer.model
    return dict(params={k: p.detach().clone() for k, p in m.named_parameters()},
                grads={k: p.grad.clone() for k, p in m.named_parameters()},
                buffers={k: b.clone() for k, b in m.named_buffers() if "running" in k})


def _record_rows():
    """Every epoch's per-step (n, 10) metric rows, in the order the trainer
    reduces them (a test's view into ``TrainerPipeline._reduce``)."""
    rows = []
    reduce = TrainerPipeline._reduce

    def recorded(collected):
        rows.append(torch.cat([m.reshape(-1, len(METRIC_KEYS)) for m in collected]))
        return reduce(collected)

    TrainerPipeline._reduce = staticmethod(recorded)
    return rows


# ---- the rank's side (this file run as a script) ----------------------------


def _worker(spec_path):
    import builtins
    import shutil

    torch.set_num_threads(1)
    spec = json.load(open(spec_path))
    group = dist.init("cpu")
    rank = dist.rank()
    assert dist.world_size() == WORLD and group is not None
    data = np.load(spec["batches"])
    steps = [(data[f"audio{i}"], {k: data[f"{k}{i}"] for k in ("classes", "centers", "widths",
                                                                  "valid")}) for i in range(2)]
    out = {"rank": rank}

    # 1. one SGD step on the rank's rows; two Adam steps at S=2 and at S=1
    trainer = TrainerPipeline(_model(spec["raw"], spec["weights"]),
                              AudioDetectionLoss(spec["raw"]["anchors"], **LOSS_KW), SGD,
                              device="cpu", process_group=group)
    out["step_metrics"] = trainer.train_step(*_rows(steps[0], rank))
    out["step"] = _step_state(trainer)
    for s in (1, 2):
        t = TrainerPipeline(_model(spec["raw"], spec["weights"]),
                            AudioDetectionLoss(spec["raw"]["anchors"], **LOSS_KW), ADAM,
                            device="cpu", process_group=group, steps_per_dispatch=s)
        metrics = t.train([{"audio": a.numpy(), **{k: v.numpy() for k, v in tg.items()}}
                           for a, tg in (_rows(b, rank) for b in steps)])
        out[f"dispatch{s}"] = dict(metrics=metrics, params=_step_state(t)["params"])

    # 2. the CLI: one epoch, then --resume to a second; the files each run
    # writes under the run's directory are recorded
    run_dir = os.path.dirname(spec["out"])
    real_open, real_replace = builtins.open, os.replace

    def recorded(fn, *args, **kwargs):
        writes = []

        def open_(file, mode="r", *a, **k):
            if any(c in mode for c in "wax") and str(file).startswith(run_dir):
                writes.append(str(file))
            return real_open(file, mode, *a, **k)

        def replace_(src, dst, *a, **k):
            if str(dst).startswith(run_dir):
                writes.append(str(dst))
            return real_replace(src, dst, *a, **k)

        builtins.open, os.replace = open_, replace_
        try:
            return fn(*args, **kwargs), writes
        finally:
            builtins.open, os.replace = real_open, real_replace

    raw = spec["cli_raw"]
    rows = _record_rows()
    t1, writes1 = recorded(train_cli.run, Config(copy.deepcopy(raw)), device="cpu",
                           data_parallel=True)
    out["epoch1"] = dict(train=t1.train_metrics[-1], eval=t1.eval_metrics[-1], **_step_state(t1))
    torch.distributed.barrier()
    if rank == 0:  # the checkpoint the second run resumes from, for the reference
        shutil.copy(t1.resume_checkpoint_path, spec["epoch1_ckpt"])
    torch.distributed.barrier()
    raw["train_config"]["epochs"] = 2
    t2, writes2 = recorded(train_cli.run, Config(raw), resume=True, device="cpu",
                           data_parallel=True)
    out["writes"] = writes1 + writes2
    out["rows"] = rows  # per-step metrics: epoch 1 train, eval, epoch 2 train, eval
    out["epoch2"] = dict(train=t2.train_metrics, eval=t2.eval_metrics, step=t2.step)
    torch.save(out, f"{spec['out']}.{rank}")
    torch.distributed.destroy_process_group()


# ---- the test's side --------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Runs the two ranks once; returns their results and the inputs."""
    from synth import make_flat_dataset, save_reference_layout

    tmp = tmp_path_factory.mktemp("dp")
    raw = _raw("highest")
    batches = _batches(raw, 4, seed=31)
    steps = [_global(batches[:2]), _global(batches[2:])]
    jm, v = _jax_state(raw, batches[0][0][:1])
    weights = str(tmp / "weights.pt")
    torch.save(state_dict_from_jax(v), weights)
    np.savez(tmp / "batches.npz", **{f"{k}{i}": x for i, (a, t) in enumerate(steps)
                                      for k, x in [("audio", a), *t.items()]})

    data = tmp / "data"
    ann = make_flat_dataset(str(data / "train"), n_files=8, seed=5)
    (data / "eval").mkdir()
    for name in ("clip006", "clip007"):
        os.rename(data / "train" / f"{name}.wav", data / "eval" / f"{name}.wav")
    save_reference_layout(str(data), ann)
    cli_raw = _cli_raw(tmp, str(data), epochs=1, batch_size=4)
    cli_raw["tpu_config"]["transfer_dtype"] = "int16"

    spec = dict(raw=raw, weights=weights, batches=str(tmp / "batches.npz"), cli_raw=cli_raw,
                out=str(tmp / "out"), epoch1_ckpt=str(tmp / "epoch1.pt"))
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps(spec))
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   JAX_PLATFORMS="cpu")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), str(spec_path)],
                                      cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    outs = [torch.load(f"{spec['out']}.{r}", weights_only=False) for r in range(WORLD)]
    return dict(outs=outs, logs=logs, raw=raw, steps=steps, weights=weights, jax=(jm, v),
                spec=spec, batches=batches)


def _close_states(got, ref, where, param_abs=None):
    """The readings of the module docstring: loss/metrics are checked by the
    callers; gradients, BatchNorm buffers and parameters here."""
    gmax = max(g.abs().max().item() for g in ref["grads"].values())
    worst = max(((got["grads"][k] - g).abs().max().item() / max(g.abs().max().item(), gmax * 1e-3),
                 k) for k, g in ref["grads"].items())
    bn = max(((got["buffers"][k] - b).abs().max() / b.abs().max()).item()
             for k, b in ref["buffers"].items())
    print(f"[{where}] worst gradient {worst[0]:.3e} ({worst[1]}); BatchNorm buffers {bn:.3e}")
    assert worst[0] < 1e-3 and bn < 1e-5, (where, worst, bn)
    if param_abs is not None:
        p = max((got["params"][k] - v).abs().max().item() for k, v in ref["params"].items())
        print(f"[{where}] parameters max |diff| {p:.3e}")
        assert p < param_abs, (where, p)


def _adam_params_close(got, ref, where):
    diff = np.concatenate([(got[k] - v).abs().flatten().numpy() for k, v in ref.items()])
    print(f"[{where}] parameters after Adam: p97 {np.quantile(diff, 0.97):.3e}, "
          f"max {diff.max():.3e}")
    assert np.quantile(diff, 0.97) < 1e-4 and diff.max() < 3e-3, where


def test_the_ranks_agree_bit_for_bit(dp):
    a, b = dp["outs"]
    assert torch.equal(a["step_metrics"], b["step_metrics"])
    for part in ("params", "grads", "buffers"):
        for k, t in a["step"][part].items():
            assert torch.equal(t, b["step"][part][k]), (part, k)
    assert a["epoch1"]["train"] == b["epoch1"]["train"]
    assert a["epoch1"]["eval"] == b["epoch1"]["eval"]
    for k, t in a["epoch1"]["params"].items():
        assert torch.equal(t, b["epoch1"]["params"][k]), k


def test_one_step_equals_one_process_on_the_global_batch(dp):
    """The SGD step of two ranks against one process given all 4 clips."""
    raw = dp["raw"]
    trainer = TrainerPipeline(_model(raw, dp["weights"]),
                              AudioDetectionLoss(raw["anchors"], **LOSS_KW), SGD, device="cpu")
    audio, targets = dp["steps"][0]
    ref_m = trainer.train_step(torch.from_numpy(audio),
                               {k: torch.from_numpy(v) for k, v in targets.items()})
    got = dp["outs"][0]
    rel = ((got["step_metrics"] - ref_m).abs() / ref_m.abs()).max().item()
    print(f"[one step] loss {got['step_metrics'][0]:.7f} vs {ref_m[0]:.7f}; metrics max rel {rel:.3e}")
    assert rel < 1e-5
    _close_states(got["step"], _step_state(trainer), "one step", param_abs=1e-6)


def test_one_step_matches_the_jax_single_device_step(dp):
    """The two ranks' step against the JAX package's step on the global
    batch, given the port's feature image (see test_train_step_matches_jax)."""
    raw, (jm, v) = dp["raw"], dp["jax"]
    audio, targets = dp["steps"][0]
    with torch.no_grad():
        feats = jnp.asarray(_model(raw, dp["weights"]).frontend(torch.from_numpy(audio)).numpy())
    jloss = JLoss(raw["anchors"], **LOSS_KW)

    def compute_loss(params, stats):
        preds, mut = jm.apply({"params": params, "batch_stats": stats}, features=feats,
                              train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(1)})
        loss, metrics = jloss(preds, {k: jnp.asarray(x) for k, x in targets.items()})
        return loss, (metrics, mut["batch_stats"])

    (j_l, (j_m, stats)), j_g = jax.jit(jax.value_and_grad(compute_loss, has_aux=True))(
        v["params"], v["batch_stats"])
    tx = j_make_optimizer(SGD, None, 1)
    updates, _ = tx.update(j_g, tx.init(v["params"]), v["params"])
    params = jax.tree_util.tree_map(lambda p, u: p + u, v["params"], updates)
    ref_m = torch.tensor([float(j_m[k]) for k in METRIC_KEYS])
    got = dp["outs"][0]
    rel = ((got["step_metrics"] - ref_m).abs() / ref_m.abs()).max().item()
    print(f"[jax] loss {got['step_metrics'][0]:.7f} vs {float(j_l):.7f}; metrics max rel {rel:.3e}")
    assert rel < 1e-5
    ref = dict(grads=state_dict_from_jax({"params": j_g}),
               buffers=state_dict_from_jax({"batch_stats": stats}),
               params=state_dict_from_jax({"params": params}))
    # the 15 conv biases ahead of a train-mode BatchNorm have a zero gradient
    # in exact arithmetic; both sides' are float32 noise
    gmax = max(g.abs().max().item() for g in ref["grads"].values())
    dead = [k for k in ref["grads"] if k.endswith("conv.conv.bias")
            and f"{k[:-len('conv.conv.bias')]}norm.weight" in ref["grads"]]
    assert len(dead) == 15
    assert max(got["step"]["grads"][k].abs().max().item() for k in dead) / gmax < 1e-6
    live = [k for k in ref["grads"] if k not in dead]
    vals = [((got["step"]["grads"][k] - ref["grads"][k]).abs().max()
             / ref["grads"][k].abs().max()).item() for k in live]
    start = torch.load(dp["weights"], weights_only=True)
    readings = dict(
        grad_median=float(np.median(vals)), grad_p90=float(np.percentile(vals, 90)),
        grad_l2=_l2_rel({k: got["step"]["grads"][k].numpy() for k in live},
                        {k: ref["grads"][k].numpy() for k in live}),
        param_l2=_l2_rel({k: (p - start[k]).numpy() for k, p in got["step"]["params"].items()},
                         {k: (p - start[k]).numpy() for k, p in ref["params"].items()}))
    bn = max(((got["step"]["buffers"][k] - b).abs().max() / b.abs().max()).item()
             for k, b in ref["buffers"].items())
    print(f"[jax] gradients worst {max(vals):.3e}, {readings}; BatchNorm buffers {bn:.3e}")
    assert all(readings[k] < KINK_BOUNDS[k] for k in readings), readings
    assert bn < 1e-5


def test_steps_per_dispatch_with_data_parallel(dp):
    """Two Adam steps as one dispatch of 2 equal two single steps, on both
    ranks (on the CPU a dispatch runs its steps eagerly)."""
    for out in dp["outs"]:
        one, two = out["dispatch1"], out["dispatch2"]
        assert one["metrics"] == two["metrics"]
        for k, t in one["params"].items():
            assert torch.equal(t, two["params"][k]), k


def _shard_batches(cfg, ds, shuffle, epochs):
    """The global batches of epoch ``epochs - 1``: both ranks' shard batches,
    concatenated in rank order, as train_cli's loaders make them."""
    tc, tpu = cfg.raw["train_config"], cfg.raw["tpu_config"]
    model = AudioDetectionModel.from_config(cfg, 2)
    loaders = [BatchLoader(ds, int(tc["batch_size"]), shuffle=shuffle, seed=train_cli.SEED,
                           last_batch="pad", transfer_dtype=tpu["transfer_dtype"],
                           framer=model.frontend.fused, shard=(r, WORLD)) for r in range(WORLD)]
    for _ in range(epochs - 1):
        for ld in loaders:
            ld.iter_spans()
    per_rank = [list(ld) for ld in loaders]
    return [{k: np.concatenate([b[k] for b in group]) for k in group[0]}
            for group in zip(*per_rank)]


def _reference_trainer(cfg, train_ds):
    tc = cfg.raw["train_config"]
    model = AudioDetectionModel.from_config(cfg, 2,
                                            generator=torch.Generator().manual_seed(train_cli.SEED))
    return TrainerPipeline(model, train_cli.make_loss(cfg, 2, train_ds.get_class_weights()),
                           tc["optimizer_config"], tc["lr_scheduler_config"],
                           model_path=os.path.join(os.path.dirname(tc["model_path"]), "ref"),
                           ema_config=tc["ema_config"], seed=train_cli.SEED, device="cpu")


def _epoch_close(got_rows, got, ref_rows, ref, where):
    """A one-step epoch: its metrics at 1e-5 relative."""
    assert got_rows.shape == ref_rows.shape == (1, len(METRIC_KEYS)), (got_rows.shape, where)
    rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in METRIC_KEYS if ref[k]}
    worst = max(rel, key=rel.get)
    print(f"[{where}] loss {got['aggregate_loss']:.7f} vs {ref['aggregate_loss']:.7f}; worst "
          f"metric {worst} {rel[worst]:.3e}")
    assert all(np.isnan(got[k]) == np.isnan(ref[k]) for k in METRIC_KEYS), where
    assert rel[worst] < 1e-5, (where, rel)


def _eval_close(got, ref, where):
    """The evaluation after an Adam step: the JAX package's data-parallel
    epoch guard (see the module docstring)."""
    print(f"[{where}] loss {got['aggregate_loss']:.7f} vs {ref['aggregate_loss']:.7f}, f1 "
          f"{got['f1']:.4f} vs {ref['f1']:.4f}")
    for k in ("aggregate_loss", "mean_ciou", "conf_loss", "class_loss"):
        assert got[k] == pytest.approx(ref[k], rel=2e-3, abs=1e-4), (where, k)
    assert got["f1"] == pytest.approx(ref["f1"], abs=2e-2), where


def _reference_epoch(trainer, cfg, train_ds, eval_ds, monkeypatch):
    """One process's epoch on the rank-ordered global batches of fresh shard
    loaders (a resumed run's loaders start at their first order, as the JAX
    package's do): its per-step rows and epoch metrics."""
    monkeypatch.setattr(TrainerPipeline, "_reduce", staticmethod(TrainerPipeline._reduce))
    rows = _record_rows()
    train = trainer.train(_shard_batches(cfg, train_ds, True, 1))
    ev = trainer.evaluate(_shard_batches(cfg, eval_ds, False, 1))
    return rows, train, ev


def test_one_epoch_of_the_cli_equals_one_process(dp, monkeypatch):
    """``train_cli.run(data_parallel=True)``'s first epoch (dropout 0.4:
    each rank keeps its rows of the global batch's mask; Adam) against one
    process stepping on the rank-ordered global batches, then evaluating."""
    cfg = Config(copy.deepcopy(dp["spec"]["cli_raw"]))
    train_ds, eval_ds = train_cli.resolve_datasets(cfg)
    trainer = _reference_trainer(cfg, train_ds)
    rows, ref_train, ref_eval = _reference_epoch(trainer, cfg, train_ds, eval_ds, monkeypatch)
    got = dp["outs"][0]
    _epoch_close(got["rows"][0], got["epoch1"]["train"], rows[0], ref_train, "epoch 1")
    _eval_close(got["epoch1"]["eval"], ref_eval, "epoch 1 eval")
    _adam_params_close(got["epoch1"]["params"], {k: p.detach() for k, p in
                                                 trainer.model.named_parameters()}, "epoch 1")
    bn = max(((got["epoch1"]["buffers"][k] - b).abs().max() / b.abs().max()).item()
             for k, b in trainer.model.named_buffers() if "running" in k)
    print(f"[epoch 1] BatchNorm buffers {bn:.3e}")
    assert bn < 1e-5


def test_both_ranks_resume_to_the_same_second_epoch(dp, monkeypatch):
    """Both ranks resume from rank 0's checkpoint and train the second epoch
    alike, as one process resumed from that checkpoint does on the global
    batches."""
    a, b = (out["epoch2"] for out in dp["outs"])
    assert a == b and len(a["train"]) == 2 and a["step"] == 2
    assert all("Resumed from epoch 1" in log for log in dp["logs"]), dp["logs"][0][-2000:]
    cfg = Config(copy.deepcopy(dp["spec"]["cli_raw"]))
    train_ds, eval_ds = train_cli.resolve_datasets(cfg)
    trainer = _reference_trainer(cfg, train_ds)
    trainer.load_checkpoint(dp["spec"]["epoch1_ckpt"])
    assert trainer.step == 1
    rows, ref_train, ref_eval = _reference_epoch(trainer, cfg, train_ds, eval_ds, monkeypatch)
    got_rows = dp["outs"][0]["rows"]
    assert torch.equal(got_rows[2], dp["outs"][1]["rows"][2])
    _epoch_close(got_rows[2], a["train"][1], rows[0], ref_train, "epoch 2")
    _eval_close(a["eval"][1], ref_eval, "epoch 2 eval")


if __name__ == "__main__":
    _worker(sys.argv[1])

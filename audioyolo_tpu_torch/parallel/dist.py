"""Data parallel training over ``torch.distributed`` (the port's counterpart
of ``audioyolo_tpu/parallel/mesh.py``).

The JAX package shards each batch over a ``data`` mesh axis and jits the
single-device step on the global batch; XLA inserts the collectives. Here
each rank is one process (``torchrun --nproc_per_node=N``) holding one shard
of the batch, and the step reduces across the group exactly where the
global-batch step needs it (``train/trainer.py``): train-mode BatchNorm's
statistics, the loss on the gathered predictions and targets, and the
gradients. :func:`init` joins the group that ``torchrun``'s environment
describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): ``nccl`` for the card, ``gloo`` for the CPU. Without that
environment the run is a world of one and no group is made.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist


def init(device_type: str = "cuda") -> Optional[dist.ProcessGroup]:
    """The default process group, joined from the environment on first use
    (each rank takes the card ``LOCAL_RANK``); ``None`` without ``RANK`` and
    ``WORLD_SIZE`` in the environment."""
    if dist.is_initialized():
        return dist.group.WORLD
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    if device_type == "cuda":
        torch.cuda.set_device(local_rank())
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return dist.group.WORLD


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the gradient is summed over the group too, so a
    value every rank uses gets the whole group's gradient on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (a new tensor), with autograd."""
    return _AllReduceSum.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's (B, ...) rows, in rank order, as one (world * B, ...)
    tensor on every rank (the ranks hold equal B). Each rank places its rows
    in its slot of a zero tensor and the group sums them, which is exact;
    a floating tensor keeps its autograd through :func:`all_reduce_sum`."""
    if x.dtype == torch.bool:
        return gather_rows(x.to(torch.int32), group).bool()
    world, me = dist.get_world_size(group), dist.get_rank(group)
    full = torch.cat([x if r == me else torch.zeros_like(x) for r in range(world)])
    if x.requires_grad:
        return all_reduce_sum(full, group)
    dist.all_reduce(full, group=group)
    return full


def all_reduce_grads(params: Iterable[torch.Tensor], group) -> None:
    """Sum the parameters' gradients over ``group`` in place, in one
    collective over their concatenation."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))

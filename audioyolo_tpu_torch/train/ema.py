"""EMA of the model's parameters (port of ``audioyolo_tpu/train/ema.py``).

``ema <- (1 - m) * ema + m * param`` with the reference's ramped weight of
the new parameters, ``m(n) = 1 - (1 - m0) * (1 - exp(-n / N))``: m starts
near 1 and decays to ``m0`` (the reference's "momentum" is that weight, the
inverse of the usual decay convention). Parameters only: evaluation pairs
the EMA parameters with the live model's BatchNorm statistics, as the JAX
package does (the reference's frozen copy keeps its initial statistics).
"""

from __future__ import annotations

from typing import Dict

import torch


class EMA:
    """The shadow parameters, on the parameters' device, and the update count.

    The count is an int32 tensor on that device and ``m(n)`` is computed
    there in float32, as the JAX package computes it inside its step, so an
    update never reads the host and replays in a CUDA graph."""

    def __init__(self, params: Dict[str, torch.Tensor], num_updates: int = 0):
        self.params = {k: p.detach().clone() for k, p in params.items()}
        device = next(iter(self.params.values())).device
        self.count = torch.tensor(int(num_updates), dtype=torch.int32, device=device)

    @property
    def num_updates(self) -> int:
        return int(self.count.item())

    @num_updates.setter
    def num_updates(self, n: int) -> None:
        self.count.fill_(int(n))

    def update(self, params: Dict[str, torch.Tensor], momentum: float = 0.002,
               n_ramp: int = 2000) -> None:
        """One update from the live ``params`` (in place, no host sync)."""
        with torch.no_grad():
            self.count.add_(1)
            m = 1.0 - (1.0 - momentum) * (1.0 - torch.exp(-self.count.float() / n_ramp))
            shadow = list(self.params.values())
            torch._foreach_mul_(shadow, 1.0 - m)
            torch._foreach_add_(shadow, torch._foreach_mul([params[k].detach()
                                                             for k in self.params], m))

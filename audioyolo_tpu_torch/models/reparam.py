"""Structural re-parameterization of RepVGG blocks over the port's state dict
(port of ``audioyolo_tpu/models/reparam.py``).

The 3x3+BN, 1x1+BN and identity-BN branches of every block fold into one
biased 3x3 conv under ``<block>.reparam.conv``. The fold is weight-load work:
it runs on CPU float32 tensors, in the JAX package's order of operations,
before the weights move to the card. The folded weights stay float32 in every
compute dtype: a bf16 body casts them in its convolutions, as the JAX package
serves float32 folded parameters with ``dtype=bfloat16``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5

StateDict = Dict[str, torch.Tensor]


def _merge_conv_bn(kernel: torch.Tensor, sd: StateDict, bn: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN (weight/bias + running stats) folded into an OIHW kernel."""
    gamma, beta = sd[bn + ".weight"], sd[bn + ".bias"]
    mu, var = sd[bn + ".running_mean"], sd[bn + ".running_var"]
    std = torch.sqrt(var + BN_EPS)
    k = kernel * (gamma / std)[:, None, None, None]
    b = beta - mu * gamma / std
    return k, b


def fold_repvgg(state_dict: StateDict) -> StateDict:
    """Train-form state dict -> deploy-form state dict (``deploy=True``)."""
    sd = {k: v.detach().to("cpu", torch.float32) for k, v in state_dict.items()}
    suffix = ".conv3x3.conv.conv.weight"
    blocks = [k[: -len(suffix)] for k in sd if k.endswith(suffix)]
    out = dict(sd)
    for p in blocks:
        k3, b3 = _merge_conv_bn(sd[p + suffix], sd, p + ".conv3x3.norm")
        k1, b1 = _merge_conv_bn(sd[p + ".conv1x1.conv.conv.weight"], sd, p + ".conv1x1.norm")
        k = k3 + F.pad(k1, (1, 1, 1, 1))
        b = b3 + b1
        if p + ".identity.weight" in sd:
            in_ch = k3.shape[1]
            eye = torch.eye(in_ch, dtype=k3.dtype)[:, :, None, None]  # dirac 1x1, OIHW
            ki, bi = _merge_conv_bn(eye, sd, p + ".identity")
            k = k + F.pad(ki, (1, 1, 1, 1))
            b = b + bi
        for key in [key for key in out if key.startswith((p + ".conv3x3.", p + ".conv1x1.",
                                                          p + ".identity."))]:
            del out[key]
        out[p + ".reparam.conv.weight"] = k
        out[p + ".reparam.conv.bias"] = b
    return out

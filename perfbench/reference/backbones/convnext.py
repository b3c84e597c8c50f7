"""ConvNeXt backbone (``backbone: convnext``; Liu et al. 2022,
arXiv:2201.03545, facebookresearch/ConvNeXt): a 4x4/4 stem conv and a
LayerNorm over channels, then four stages of ``block_layers`` blocks at
widths ``convnext_config.dims``, stages 2-4 opening with a LayerNorm and a
2x2/2 conv. A block: depthwise 7x7 conv, LayerNorm over channels (eps
1e-6), 1x1 conv to 4C, GELU (erf), 1x1 conv to C, per-channel layer scale
``gamma``, residual add. No final norm, pool or classifier; stochastic
depth is training's and does not run here. The leaves under the port's
``state_dict`` names: each block's ``gamma`` first, then its depthwise
conv, LayerNorm and the two pointwise convs (the official ``Linear`` layers
as 1x1 conv kernels)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.frontend import float32_posture

FE = "feature_extractor"
EPS = 1e-6
DIMS = (128, 256, 512, 1024)


def _dims(cfg: dict) -> Tuple[int, ...]:
    return tuple(int(d) for d in (cfg.get("convnext_config") or {}).get("dims", DIMS))


def shapes(cfg: dict) -> Tuple[Dict[str, tuple], Tuple[int, ...]]:
    """(name -> shape of every backbone leaf in draw order, pyramid widths)."""
    dims = _dims(cfg)
    out: Dict[str, tuple] = {}

    def conv(p, o, i, k):
        out[p + ".conv.weight"] = (o, i, k, k)
        out[p + ".conv.bias"] = (o,)

    def norm(p, c):
        out[p + ".weight"] = (c,)
        out[p + ".bias"] = (c,)

    conv(FE + ".stem", dims[0], 2, 4)
    norm(FE + ".stem_norm", dims[0])
    for s, n in enumerate(cfg["block_layers"]):
        c = dims[s]
        if s > 0:
            norm(f"{FE}.down{s + 1}_norm", dims[s - 1])
            conv(f"{FE}.down{s + 1}", c, dims[s - 1], 2)
        for b in range(int(n)):
            p = f"{FE}.stage{s + 1}_{b}"
            out[p + ".gamma"] = (c,)
            conv(p + ".dwconv", c, 1, 7)
            norm(p + ".norm", c)
            conv(p + ".pwconv1", 4 * c, c, 1)
            conv(p + ".pwconv2", c, 4 * c, 1)
    return out, dims


def draw(name: str, shape: tuple, u: torch.Tensor) -> Optional[torch.Tensor]:
    """The layer scale U(0.1, 0.5): at its initial 1e-6 every block is the
    identity to within bf16 rounding and no comparison could see a fault in
    one, and under the generic conv-bias rule (+-0.05) nearly so. The
    depthwise kernels glorot over one channel's 7x7 taps (fan in = fan out
    = 49, bound sqrt(6/98)): the generic rule counts the group's outputs as
    fan out and would leave each block's depthwise output at 2/(C+1) of its
    input's variance, under its bias. Every other leaf takes the generic
    rule."""
    if name.endswith(".gamma"):
        return 0.1 + 0.4 * u
    if name.endswith(".dwconv.conv.weight"):
        k = shape[2] * shape[3]
        return (2.0 * u - 1.0) * (6.0 / (2 * k)) ** 0.5
    return None


def layer_norm(det, x: torch.Tensor, p: str) -> torch.Tensor:
    """The official ``channels_first`` LayerNorm: each pixel over its
    channels, biased variance."""
    mean = x.mean(dim=1, keepdim=True)
    var = (x - mean).pow(2).mean(dim=1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + EPS)
    return det.r(det.sd[p + ".weight"].view(1, -1, 1, 1) * y
                 + det.sd[p + ".bias"].view(1, -1, 1, 1))


def block(det, x: torch.Tensor, p: str) -> torch.Tensor:
    sd, r = det.sd, det.r
    c = x.shape[1]
    y = r(F.conv2d(r(x), r(sd[p + ".dwconv.conv.weight"]), None, 1, 3, 1, c))
    y = r(y + r(sd[p + ".dwconv.conv.bias"]).view(1, -1, 1, 1))
    y = det.conv(layer_norm(det, y, p + ".norm"), p + ".pwconv1.conv")
    y = det.conv(r(F.gelu(y)), p + ".pwconv2.conv")
    y = r(y * r(sd[p + ".gamma"]).view(1, -1, 1, 1))
    return r(x + y)


def forward(det, x: torch.Tensor) -> List[torch.Tensor]:
    """The four stages' outputs, built from ``det``'s ``conv`` and ``r``
    and this module's depthwise conv and LayerNorm; every value rounded
    through ``det.r`` where it is produced."""
    float32_posture()
    fmaps = []
    for s, n in enumerate(det.cfg["block_layers"]):
        if s == 0:
            x = layer_norm(det, det.conv(x, FE + ".stem.conv", 4), FE + ".stem_norm")
        else:
            p = f"{FE}.down{s + 1}"
            x = det.conv(layer_norm(det, x, p + "_norm"), p + ".conv", 2)
        for b in range(int(n)):
            x = block(det, x, f"{FE}.stage{s + 1}_{b}")
        fmaps.append(x)
    return fmaps

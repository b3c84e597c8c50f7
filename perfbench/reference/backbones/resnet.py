"""ResNet backbone (``backbone: resnet``): two 7x7/s2 stem convs over the
2-channel spectral image, then BasicBlock or Bottleneck stages
(``resnet_config.block``, ``block_layers``) as torchvision builds them, no
max pool; the leaves under the port's ``state_dict`` names."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

FE = "feature_extractor"
PLANES = (64, 128, 256, 512)


def _bottleneck(cfg: dict) -> bool:
    return (cfg.get("resnet_config") or {}).get("block", "BasicBlock") == "Bottleneck"


def shapes(cfg: dict) -> Tuple[Dict[str, tuple], Tuple[int, ...]]:
    """(name -> shape of every backbone leaf in draw order, pyramid widths)."""
    shapes: Dict[str, tuple] = {}

    def norm(p, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{p}.{leaf}"] = (c,)

    shapes[FE + ".conv1.conv.weight"] = (64, 2, 7, 7)
    shapes[FE + ".conv2.conv.weight"] = (64, 64, 7, 7)
    norm(FE + ".bn1", 64)
    bottle = _bottleneck(cfg)
    exp = 4 if bottle else 1
    cin = 64
    for li, (planes, stride) in enumerate(zip(PLANES, (1, 2, 2, 2))):
        for bi in range(int(cfg["block_layers"][li])):
            s = stride if bi == 0 else 1
            p = f"{FE}.layer{li + 1}_{bi}"
            if bottle:
                convs = [("conv1", "bn1", planes, cin, 1), ("conv2", "bn2", planes, planes, 3),
                         ("conv3", "bn3", planes * 4, planes, 1)]
            else:
                convs = [("conv1", "bn1", planes, cin, 3), ("conv2", "bn2", planes, planes, 3)]
            for c, b, o, i, k in convs:
                shapes[f"{p}.{c}.conv.weight"] = (o, i, k, k)
                norm(f"{p}.{b}", o)
            if s != 1 or cin != planes * exp:
                shapes[p + ".downsample_conv.conv.weight"] = (planes * exp, cin, 1, 1)
                norm(p + ".downsample_bn", planes * exp)
            cin = planes * exp
    return shapes, tuple(c * exp for c in PLANES)


def block(det, x: torch.Tensor, p: str, stride: int, bottleneck: bool) -> torch.Tensor:
    sd = det.sd
    if bottleneck:
        y = F.relu(det.bn(det.conv(x, p + ".conv1.conv"), p + ".bn1"))
        y = F.relu(det.bn(det.conv(y, p + ".conv2.conv", stride, 1), p + ".bn2"))
        y = det.bn(det.conv(y, p + ".conv3.conv"), p + ".bn3")
    else:
        y = F.relu(det.bn(det.conv(x, p + ".conv1.conv", stride, 1), p + ".bn1"))
        y = det.bn(det.conv(y, p + ".conv2.conv", 1, 1), p + ".bn2")
    if p + ".downsample_conv.conv.weight" in sd:
        x = det.bn(det.conv(x, p + ".downsample_conv.conv", stride), p + ".downsample_bn")
    return F.relu(det.r(y + x))


def forward(det, x: torch.Tensor) -> List[torch.Tensor]:
    """The four stages' outputs, built from ``det``'s ``conv``, ``bn`` and
    ``r`` (ReLU of a rounded value needs no rounding)."""
    bottleneck = _bottleneck(det.cfg)
    x = det.conv(x, FE + ".conv1.conv", 2, 3)
    x = F.relu(det.bn(det.conv(x, FE + ".conv2.conv", 2, 3), FE + ".bn1"))
    fmaps = []
    for li, n in enumerate(det.cfg["block_layers"]):
        for bi in range(int(n)):
            x = block(det, x, f"{FE}.layer{li + 1}_{bi}", 2 if (li > 0 and bi == 0) else 1,
                      bottleneck)
        fmaps.append(x)
    return fmaps

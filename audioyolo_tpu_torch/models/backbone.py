"""ResNet feature extractor over the (B, 2, 32, 960) spectral image (NCHW)
(port of ``audioyolo_tpu/models/backbone.py::ResNetBackbone``).

A torchvision-semantics ResNet (BasicBlock or Bottleneck) whose stem is two
7x7/s2 convs over the 2-channel image, with no maxpool, avgpool or fc. The
shipped BasicBlock [2,2,2,2] gives pyramid channels 64/128/256/512 at time
widths 240/120/60/30 and heights 8/4/2/1. Dropout follows the stem in train
mode, its mask drawn from the ``torch.Generator`` the caller hands in. The JAX
package's ``CustomBackbone`` is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .layers import BatchNorm, Conv2d


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_ch, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.has_down = stride != 1 or in_ch != planes
        if self.has_down:
            self.downsample_conv = Conv2d(in_ch, planes, 1, stride, 0, bias=False)
            self.downsample_bn = BatchNorm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.has_down else x
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = Conv2d(in_ch, planes, 1, 1, 0, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, out_ch, 1, 1, 0, bias=False)
        self.bn3 = BatchNorm(out_ch)
        self.has_down = stride != 1 or in_ch != out_ch
        if self.has_down:
            self.downsample_conv = Conv2d(in_ch, out_ch, 1, stride, 0, bias=False)
            self.downsample_bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.has_down else x
        return torch.relu(out + identity)


_BLOCKS = {"BasicBlock": BasicBlock, "Bottleneck": Bottleneck}


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep each element with
    probability ``1 - p`` and scale the kept ones by ``1 / (1 - p)``. The
    mask comes from ``generator`` (on ``x``'s device), never the global RNG."""
    if p <= 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator (generator=...)")
    keep = 1.0 - p
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    return x * mask * (1.0 / keep)


class ResNetBackbone(nn.Module):
    def __init__(self, block: str = "BasicBlock", block_layers: Sequence[int] = (3, 4, 6, 3),
                 dropout: float = 0.0):
        super().__init__()
        blk = _BLOCKS[block]
        self.block_layers = tuple(block_layers)
        self.dropout = float(dropout)
        self.conv1 = Conv2d(2, 64, 7, 2, 3, bias=False)
        self.conv2 = Conv2d(64, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        in_ch = 64
        for li, (planes, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2))):
            for bi in range(self.block_layers[li]):
                setattr(self, f"layer{li + 1}_{bi}",
                        blk(in_ch, planes, stride if bi == 0 else 1))
                in_ch = planes * blk.expansion
        self.fmap_channels = tuple(p * blk.expansion for p in (64, 128, 256, 512))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        x = torch.relu(self.bn1(self.conv2(self.conv1(x))))
        if self.training:
            x = dropout(x, self.dropout, generator)
        fmaps = []
        for li in range(4):
            for bi in range(self.block_layers[li]):
                x = getattr(self, f"layer{li + 1}_{bi}")(x)
            fmaps.append(x)
        return tuple(fmaps)

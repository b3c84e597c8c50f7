"""Plain float32 ConvNeXt backbone for the port's tests, written after
facebookresearch/ConvNeXt's ``models/convnext.py`` (Liu et al. 2022,
arXiv:2201.03545): ``Block`` in NHWC with ``nn.LayerNorm``-style
``channels_last`` normalisation and two ``nn.Linear`` layers, the
``channels_first`` LayerNorm of the stem and the downsampling layers, the
``downsample_layers`` / ``stages`` layout. Departures: the stem takes the 2
channels of the spectral image, and there is no final norm, pool or head
(the four stage outputs are returned). Stochastic depth takes its per-sample
keep masks from the caller, so that a test can hand in the ones the port
drew. Plain ``torch``: nothing of the port, no JAX.

:meth:`ConvNeXtRef.load_port_state_dict` reads the port's ``state_dict`` by
name (a 1x1 conv kernel becomes a ``Linear`` weight by a reshape).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def float32_posture() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, data_format: str = "channels_last"):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.data_format = data_format

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.data_format == "channels_last":
            return F.layer_norm(x, self.weight.shape, self.weight, self.bias, self.eps)
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class Block(nn.Module):
    def __init__(self, dim: int, drop_path: float = 0.0):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, kernel_size=7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.act = nn.GELU()
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.ones(dim))
        self.drop_path = drop_path

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        inp = x
        x = self.dwconv(x)
        x = x.permute(0, 2, 3, 1)  # (N, C, H, W) -> (N, H, W, C)
        x = self.norm(x)
        x = self.pwconv1(x)
        x = self.act(x)
        x = self.pwconv2(x)
        x = self.gamma * x
        x = x.permute(0, 3, 1, 2)
        if keep is not None:  # (N, 1, 1, 1) keep mask of stochastic depth
            x = x / (1.0 - self.drop_path) * keep
        return inp + x


class ConvNeXtRef(nn.Module):
    def __init__(self, depths: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (128, 256, 512, 1024), in_chans: int = 2,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.depths = tuple(depths)
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            nn.Conv2d(in_chans, dims[0], kernel_size=4, stride=4),
            LayerNorm(dims[0], eps=1e-6, data_format="channels_first"))])
        for i in range(3):
            self.downsample_layers.append(nn.Sequential(
                LayerNorm(dims[i], eps=1e-6, data_format="channels_first"),
                nn.Conv2d(dims[i], dims[i + 1], kernel_size=2, stride=2)))
        rates = [x.item() for x in torch.linspace(0, drop_path_rate, sum(depths))]
        self.stages = nn.ModuleList()
        cur = 0
        for i in range(4):
            self.stages.append(nn.Sequential(*[Block(dims[i], rates[cur + j])
                                               for j in range(depths[i])]))
            cur += depths[i]

    def forward(self, x: torch.Tensor,
                keeps: Optional[List[Optional[torch.Tensor]]] = None) -> List[torch.Tensor]:
        """The four stage outputs; ``keeps``: one keep mask (or None) per
        block, in block order."""
        float32_posture()
        out, k = [], 0
        for i in range(4):
            x = self.downsample_layers[i](x)
            for blk in self.stages[i]:
                x = blk(x, None if keeps is None else keeps[k])
                k += 1
            out.append(x)
        return out

    def load_port_state_dict(self, sd: Dict[str, torch.Tensor],
                             prefix: str = "feature_extractor.") -> None:
        mine: Dict[str, torch.Tensor] = {}
        for key, v in sd.items():
            if not key.startswith(prefix):
                continue
            name = key[len(prefix):]
            head, rest = name.split(".", 1)
            if head == "stem":
                mine["downsample_layers.0.0." + rest.replace("conv.", "")] = v
            elif head == "stem_norm":
                mine["downsample_layers.0.1." + rest] = v
            elif head.startswith("down"):
                s = int(head[4]) - 1
                if head.endswith("_norm"):
                    mine[f"downsample_layers.{s}.0.{rest}"] = v
                else:
                    mine[f"downsample_layers.{s}.1.{rest.replace('conv.', '')}"] = v
            else:  # stage{s}_{b}
                s, b = head[len("stage"):].split("_")
                layer, _, leaf = rest.rpartition(".")
                layer = layer.replace(".conv", "")
                if layer in ("pwconv1", "pwconv2") and leaf == "weight":
                    v = v.reshape(v.shape[0], v.shape[1])
                mine[f"stages.{int(s) - 1}.{b}." + (f"{layer}.{leaf}" if layer else leaf)] = v
        self.load_state_dict(mine, strict=True)

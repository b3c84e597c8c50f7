"""Feature extractors over the (B, 2, 32, 960) spectral image (NCHW) (port of
``audioyolo_tpu/models/backbone.py``).

- :class:`ResNetBackbone`: a torchvision-semantics ResNet (BasicBlock or
  Bottleneck) whose stem is two 7x7/s2 convs over the 2-channel image, with
  no maxpool, avgpool or fc. The shipped BasicBlock [2,2,2,2] gives pyramid
  channels 64/128/256/512 at time widths 240/120/60/30 and heights 8/4/2/1.
  Dropout follows the stem in train mode.
- :class:`CustomBackbone` (``backbone: custom``): a 7x7 stem, then blocks of
  ``ExtractorLayer``s, each two (3, 7) convs + BatchNorm beside a 1x1
  residual projection, channel-concatenated; each block halves the time axis
  on its last layer. Pyramid channels 128/256/512/1024 at time widths
  240/120/60/30, all at height 32. Dropout follows every layer in train mode.
- :class:`ConvNeXtBackbone` (``backbone: convnext``): ConvNeXt (Liu et al.
  2022, arXiv:2201.03545) over the 2-channel image: a 4x4/4 stem conv and
  LayerNorm, then four stages of ``block_layers`` :class:`ConvNeXtBlock`s
  at widths ``convnext_config.dims``, stages 2-4 opening with a LayerNorm
  and a 2x2/2 conv; no final norm, pool or classifier. Pyramid channels
  ``dims`` at time widths 240/120/60/30 and heights 8/4/2/1. Stochastic
  depth in train mode, its rate rising linearly over the blocks to
  ``drop_path_rate``. It runs ``channels_last``: the depthwise and pointwise
  convs and the channel LayerNorm then read NHWC memory with no transposes.

Dropout masks come from the ``torch.Generator`` the caller hands in, or from
a :class:`ShardedRng` on a data-parallel rank; ``dtype`` is the compute dtype
(``models/layers.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.trace import span
from .layers import BatchNorm, Conv2d, LayerNorm2d, leaky_relu


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype)
        self.conv1 = Conv2d(in_ch, planes, 3, stride, 1, **kw)
        self.bn1 = BatchNorm(planes, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, **kw)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.has_down = stride != 1 or in_ch != planes
        if self.has_down:
            self.downsample_conv = Conv2d(in_ch, planes, 1, stride, 0, **kw)
            self.downsample_bn = BatchNorm(planes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.has_down else x
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        out_ch = planes * self.expansion
        kw = dict(bias=False, dtype=dtype)
        self.conv1 = Conv2d(in_ch, planes, 1, 1, 0, **kw)
        self.bn1 = BatchNorm(planes, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, **kw)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.conv3 = Conv2d(planes, out_ch, 1, 1, 0, **kw)
        self.bn3 = BatchNorm(out_ch, dtype=dtype)
        self.has_down = stride != 1 or in_ch != out_ch
        if self.has_down:
            self.downsample_conv = Conv2d(in_ch, out_ch, 1, stride, 0, **kw)
            self.downsample_bn = BatchNorm(out_ch, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.has_down else x
        return torch.relu(out + identity)


_BLOCKS = {"BasicBlock": BasicBlock, "Bottleneck": Bottleneck}


class ShardedRng(NamedTuple):
    """A data-parallel rank's dropout source: ``generator`` draws the mask of
    the whole group's batch (``world`` shards of equal size) and the rank
    keeps its own shard's rows, so the masks are those of the single-device
    step on the global batch."""
    generator: torch.Generator
    rank: int
    world: int


def dropout(x: torch.Tensor, p: float,
            generator: Union[torch.Generator, ShardedRng, None]) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep each element with
    probability ``1 - p`` and scale the kept ones by ``1 / (1 - p)``. The
    mask comes from ``generator`` (on ``x``'s device), never the global RNG."""
    if p <= 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator (generator=...)")
    keep = 1.0 - p
    return x * _keep_mask(x.detach(), keep, generator) * (1.0 / keep)


def _keep_mask(like: torch.Tensor, keep: float,
               generator: Union[torch.Generator, ShardedRng]) -> torch.Tensor:
    """A 0/1 mask of ``like``'s shape, each element 1 with probability
    ``keep``: out of place (a rematerialising step saves the mask this op
    returns), drawing what ``empty_like(like).bernoulli_(keep)`` draws; a
    :class:`ShardedRng` draws the group's batch and keeps the rank's rows."""
    if isinstance(generator, ShardedRng):
        b = like.shape[0]
        full = like.new_empty((generator.world * b,) + like.shape[1:])
        mask = torch.bernoulli(full, keep, generator=generator.generator)
        return mask[generator.rank * b: (generator.rank + 1) * b]
    return torch.bernoulli(like, keep, generator=generator)


def drop_path(x: torch.Tensor, p: float,
              generator: Union[torch.Generator, ShardedRng, None]) -> torch.Tensor:
    """Stochastic depth: each sample's whole branch kept with probability
    ``1 - p`` and scaled by ``1 / (1 - p)``, one draw per sample from
    ``generator``."""
    if p <= 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode stochastic depth needs a torch.Generator (generator=...)")
    keep = 1.0 - p
    like = x.new_empty((x.shape[0],) + (1,) * (x.dim() - 1))
    return x * _keep_mask(like, keep, generator) * (1.0 / keep)


class ResNetBackbone(nn.Module):
    def __init__(self, block: str = "BasicBlock", block_layers: Sequence[int] = (3, 4, 6, 3),
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        blk = _BLOCKS[block]
        self.block_layers = tuple(block_layers)
        self.dropout = float(dropout)
        self.conv1 = Conv2d(2, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.conv2 = Conv2d(64, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(64, dtype=dtype)
        in_ch = 64
        for li, (planes, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2))):
            for bi in range(self.block_layers[li]):
                setattr(self, f"layer{li + 1}_{bi}",
                        blk(in_ch, planes, stride if bi == 0 else 1, dtype=dtype))
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


class ExtractorLayer(nn.Module):
    """(3, 7) conv -> BatchNorm -> LeakyReLU -> (3, 7) conv -> BatchNorm ->
    dropout, beside a 1x1 residual projection (the reference's guard on it
    never holds, so it always exists); the two are concatenated on the
    channel axis, the convolutional half first."""

    def __init__(self, in_ch: int, features: int, dropout: float = 0.0,
                 halve_w: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        res_out = features // 2
        out = features - res_out
        ws = 2 if halve_w else 1
        self.dropout = float(dropout)
        self.conv_a = Conv2d(in_ch, 32, (3, 7), (1, ws), (1, 3), dtype=dtype)
        self.bn_a = BatchNorm(32, dtype=dtype)
        self.conv_b = Conv2d(32, out, (3, 7), 1, (1, 3), dtype=dtype)
        self.bn_b = BatchNorm(out, dtype=dtype)
        self.res_conv = Conv2d(in_ch, res_out, 1, (1, ws), 0, dtype=dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = leaky_relu(self.bn_a(self.conv_a(x)))
        y = self.bn_b(self.conv_b(y))
        if self.training:
            y = dropout(y, self.dropout, generator)
        return torch.cat([y, self.res_conv(x)], dim=1)


class ExtractorBlock(nn.Module):
    """``num_layers`` ExtractorLayers ``layer0`` ..: widths 64, 128, .. and
    ``features`` on the last, which alone halves the time axis."""

    def __init__(self, in_ch: int, features: int, num_layers: int, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = int(num_layers)
        out_ch = 64
        for i in range(self.num_layers):
            last = i + 1 == self.num_layers
            width = features if last else out_ch
            setattr(self, f"layer{i}", ExtractorLayer(in_ch, width, dropout, halve_w=last,
                                                      dtype=dtype))
            in_ch = width
            out_ch *= 2

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, generator)
        return x


class CustomBackbone(nn.Module):
    fmap_channels = (128, 256, 512, 1024)

    def __init__(self, block_layers: Sequence[int] = (3, 4, 6, 3), dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if len(block_layers) != 4:
            raise ValueError("block_layers must have length 4")
        self.first_conv = Conv2d(2, 64, 7, 1, 3, dtype=dtype)
        self.first_bn = BatchNorm(64, dtype=dtype)
        self.entry_block = ExtractorBlock(64, 64, 2, dropout, dtype=dtype)
        in_ch = 64
        for i, ch in enumerate(self.fmap_channels):
            setattr(self, f"block{i + 1}", ExtractorBlock(in_ch, ch, int(block_layers[i]),
                                                          dropout, dtype=dtype))
            in_ch = ch

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        x = leaky_relu(self.first_bn(self.first_conv(x)))
        x = self.entry_block(x, generator)
        fmaps = []
        for i in range(4):
            x = getattr(self, f"block{i + 1}")(x, generator)
            fmaps.append(x)
        return tuple(fmaps)


class ConvNeXtBlock(nn.Module):
    """Depthwise 7x7 conv -> LayerNorm over channels -> 1x1 conv to 4C ->
    GELU (erf) -> 1x1 conv to C -> per-channel layer scale ``gamma`` ->
    stochastic depth (train mode) -> residual add (the official ``Block``
    with its two ``Linear`` layers as 1x1 convs). GELU, the layer scale and
    the add run in the compute dtype."""

    def __init__(self, dim: int, drop_rate: float = 0.0, layer_scale_init: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = float(drop_rate)
        self.dwconv = Conv2d(dim, dim, 7, 1, 3, dtype=dtype, groups=dim)
        self.norm = LayerNorm2d(dim, dtype=dtype)
        self.pwconv1 = Conv2d(dim, 4 * dim, 1, dtype=dtype)
        self.pwconv2 = Conv2d(4 * dim, dim, 1, dtype=dtype)
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale_init)))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.pwconv1(self.norm(self.dwconv(x)))
        y = self.pwconv2(F.gelu(y))
        gamma = self.gamma if self.dtype is None else self.gamma.to(self.dtype)
        y = y * gamma.view(1, -1, 1, 1)
        if self.training:
            y = drop_path(y, self.drop_rate, generator)
        return x + y


class ConvNeXtBackbone(nn.Module):
    """``stem`` (4x4/4 conv) + ``stem_norm``; stage ``s`` (1-4) is
    ``down{s}_norm`` + ``down{s}`` (2x2/2 conv; stages 2-4) and blocks
    ``stage{s}_0`` ...; each stage's output is a pyramid map."""

    def __init__(self, block_layers: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (128, 256, 512, 1024), layer_scale_init: float = 1e-6,
                 drop_path_rate: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if len(block_layers) != 4 or len(dims) != 4:
            raise ValueError("block_layers and convnext_config.dims must have length 4")
        self.block_layers = tuple(int(n) for n in block_layers)
        self.fmap_channels = tuple(int(d) for d in dims)
        self.layer_scale_init = float(layer_scale_init)
        rates = torch.linspace(0.0, float(drop_path_rate), sum(self.block_layers)).tolist()
        self.stem = Conv2d(2, dims[0], 4, 4, 0, dtype=dtype)
        self.stem_norm = LayerNorm2d(dims[0], dtype=dtype)
        k = 0
        for s, (n, dim) in enumerate(zip(self.block_layers, self.fmap_channels)):
            if s > 0:
                setattr(self, f"down{s + 1}_norm", LayerNorm2d(dims[s - 1], dtype=dtype))
                setattr(self, f"down{s + 1}", Conv2d(dims[s - 1], dim, 2, 2, 0, dtype=dtype))
            for b in range(n):
                setattr(self, f"stage{s + 1}_{b}",
                        ConvNeXtBlock(dim, rates[k], self.layer_scale_init, dtype=dtype))
                k += 1

    def init_own_weights(self, generator: torch.Generator) -> None:
        """The paper's: conv kernels trunc-normal (std 0.02, cut at +-2),
        conv biases 0, LayerNorms at identity, layer scales at
        ``layer_scale_init``; called by ``layers.init_weights``."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv2d):
                    nn.init.trunc_normal_(m.conv.weight, std=0.02, generator=generator)
                    if m.conv.bias is not None:
                        m.conv.bias.zero_()
                elif isinstance(m, LayerNorm2d):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, ConvNeXtBlock):
                    m.gamma.fill_(self.layer_scale_init)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        x = x.contiguous(memory_format=torch.channels_last)
        fmaps = []
        for s, n in enumerate(self.block_layers):
            with span(f"ayt.model.stage{s + 1}"):
                if s == 0:
                    x = self.stem_norm(self.stem(x))
                else:
                    x = getattr(self, f"down{s + 1}")(getattr(self, f"down{s + 1}_norm")(x))
                for b in range(n):
                    x = getattr(self, f"stage{s + 1}_{b}")(x, generator)
            fmaps.append(x)
        return tuple(fmaps)

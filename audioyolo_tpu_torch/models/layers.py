"""Shared building blocks (port of ``audioyolo_tpu/models/layers.py``).

Public layouts follow the JAX package; inside the detector the convolutions
run NCHW, the layout cuDNN takes. Submodules are named after the flax tree
(``conv``, ``norm``, ``conv3x3``, ``reparam``, ``block0``, ...) so that a flax
variable path joined with dots is the port's ``state_dict`` key
(``models/from_jax.py``).

BatchNorm switches with ``nn.Module.train()`` / ``.eval()``: batch
statistics in train mode (PyTorch's two-pass form), running statistics in
eval mode. The JAX package's space-to-depth stem and its H=1 middle-row conv
slice are exact TPU rewrites of a plain convolution, so the port runs the
plain one.

``dtype`` is the compute dtype, with the JAX package's semantics (``None``:
no cast, the float32 body as it always ran). Parameters and BatchNorm
statistics stay float32. A conv casts its input and its kernel to ``dtype``
and adds its bias in ``dtype`` after the convolution; BatchNorm normalises in
float32 and casts its output to ``dtype`` (one mixed-precision
``F.batch_norm`` on a bf16 input: fewer launches, the same roundings); activations, pools, resizes,
concatenations and residual adds run in whatever dtype reaches them. The
casts are explicit, where the JAX package makes them: ``torch.autocast``
would keep BatchNorm and the adds in other dtypes.

int8 (``models/quant.py``): a ``Conv2d`` whose ``s_x`` buffer is set (the
calibrated scale of its input) runs :func:`_int8_conv`; with ``s_x`` unset
(the default) it is the float conv, untouched.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.int8 import int8_mm
from ..parallel.dist import all_reduce_sum

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)  # type: ignore[return-value]


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


class BatchNorm(nn.Module):
    """BatchNorm over channel axis 1 with PyTorch's numerics.

    Eval mode: ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` on the
    running statistics. Train mode: ``F.batch_norm(training=True)``, which
    normalises by the biased batch variance (two-pass, no cancellation) and
    moves the running estimates by ``momentum`` (the weight of the new batch)
    towards the batch mean and the unbiased batch variance. The JAX package's
    one-pass form shifted by the running mean agrees where a channel's batch
    mean is near its running mean, and cancels where it is far from it.

    ``process_group`` (set by a data-parallel trainer): train mode
    normalises by the statistics of the whole group's batch, as the JAX
    package's step on the global batch does. The sums of x and then of
    (x - mean)^2 (two passes, as above) are summed over the group with
    autograd; the running variance takes the global count. Every rank holds
    a batch of the same shape.
    """

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.process_group is not None:
            return self._group_forward(x)
        if x.dtype == self.dtype and x.dtype in (torch.bfloat16, torch.float16):
            # one mixed-precision kernel: reads the bf16 input, normalises in
            # float32 with the float32 statistics and affine, rounds once
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, self.training, self.momentum, self.eps)
        out_dtype = self.dtype or x.dtype
        x = x.to(torch.promote_types(x.dtype, torch.float32))  # float64 kept
        if self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                             self.bias, True, self.momentum, self.eps)
        else:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            shape = (1, -1) + (1,) * (x.dim() - 2)
            y = (x - self.running_mean.view(shape)) * inv.view(shape) + self.bias.view(shape)
        return y.to(out_dtype)

    def _group_forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.dtype or x.dtype
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        n = x.numel() // x.shape[1] * dist.get_world_size(self.process_group)
        mean = all_reduce_sum(x.sum(dims), self.process_group) / n
        xc = x - mean.view(shape)
        var = all_reduce_sum((xc * xc).sum(dims), self.process_group) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach() * (n / max(n - 1, 1)), alpha=m)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (xc * inv.view(shape) + self.bias.view(shape)).to(out_dtype)


class _ConvParams(nn.Module):
    """Bare OIHW weight (+ bias): the flax ``conv`` leaf level."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: Tuple[int, int], bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None


def _int8_im2col(xq: torch.Tensor, kh: int, kw: int, stride: Tuple[int, int],
                 pad: Tuple[int, int]):
    """(B, C, H, W) int8 -> ((B*Ho*Wo, kh*kw*C) int8 patches, Ho, Wo): rows
    in NHWC order, columns in (kh, kw, C) order, zero padding."""
    b = xq.shape[0]
    (sh, sw), (ph, pw) = stride, pad
    xp = F.pad(xq, (pw, pw, ph, ph)).permute(0, 2, 3, 1)  # NHWC view
    ho = (xp.shape[1] - kh) // sh + 1
    wo = (xp.shape[2] - kw) // sw + 1
    taps = [xp[:, i: i + sh * (ho - 1) + 1: sh, j: j + sw * (wo - 1) + 1: sw]
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, dim=3).reshape(b * ho * wo, -1), ho, wo


def int8_conv_acc(xq: torch.Tensor, wq: torch.Tensor, stride: Tuple[int, int],
                  pad: Tuple[int, int]) -> torch.Tensor:
    """The int32 accumulator of an int8 conv: ``xq`` (B, C, H, W) and ``wq``
    (O, C, kh, kw) int8 -> (B, O, Ho, Wo) int32, exact: an int8 im2col times
    the kernel through ``ops/int8.py::int8_mm``."""
    o, _, kh, kw = wq.shape
    cols, ho, wo = _int8_im2col(xq, kh, kw, stride, pad)
    acc = int8_mm(cols, wq.permute(2, 3, 1, 0).reshape(-1, o))
    return acc.reshape(xq.shape[0], ho, wo, o).permute(0, 3, 1, 2)


def _int8_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
               s_x: torch.Tensor, stride: Tuple[int, int],
               pad: Tuple[int, int]) -> torch.Tensor:
    """Symmetric int8 conv, the JAX package's ``layers._int8_conv``:
    ``y = conv(q(x), q(w)) * (s_x * s_w) + b`` in ``x``'s dtype.

    ``s_x`` is the calibrated per-tensor scale of the input, ``s_w`` the
    per-output-channel scale max|w| / 127 taken from the float32 kernel at
    call time; zero point 0, so zero padding stays exact. For an H=1 (W=1)
    input a 2p+1 kernel with padding p touches data only through its middle
    row (column): it is sliced out first, as the JAX package does, and
    ``s_w`` is taken from the slice."""
    out_dt = x.dtype
    kh, kw = w.shape[2], w.shape[3]
    ph, pw = pad
    if x.shape[2] == 1 and kh == 2 * ph + 1 and kh > 1:
        w, ph = w[:, :, ph: ph + 1], 0
    if x.shape[3] == 1 and kw == 2 * pw + 1 and kw > 1:
        w, pw = w[:, :, :, pw: pw + 1], 0
    xq = torch.clamp(torch.round(x.float() / s_x), -127.0, 127.0).to(torch.int8)
    s_w = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12) / 127.0
    wq = torch.clamp(torch.round(w / s_w.view(-1, 1, 1, 1)), -127.0, 127.0).to(torch.int8)
    acc = int8_conv_acc(xq, wq, stride, (ph, pw))
    y = acc.float() * (s_x * s_w).view(1, -1, 1, 1)
    if b is not None:
        y = y + b.view(1, -1, 1, 1)
    return y.to(out_dt)


class Conv2d(nn.Module):
    """Conv with explicit symmetric padding; parameters under ``.conv``.
    ``s_x`` (a 0-d float32 buffer, not in the state dict) switches it to
    :func:`_int8_conv`."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: IntPair,
                 stride: IntPair = 1, padding: IntPair = 0, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dtype = dtype
        self.conv = _ConvParams(in_ch, out_ch, _pair(kernel_size), bias)
        self.register_buffer("s_x", None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.conv.weight, self.conv.bias
        if self.s_x is not None:
            return _int8_conv(x, w, b, self.s_x, self.stride, self.padding)
        if self.dtype is None:
            return F.conv2d(x, w, b, self.stride, self.padding)
        y = F.conv2d(x.to(self.dtype), w.to(self.dtype), None, self.stride, self.padding)
        return y if b is None else y + b.to(self.dtype).view(1, -1, 1, 1)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init matching the JAX package's: glorot-uniform conv kernels
    (torch xavier_uniform_), conv biases 0.01, BatchNorm at identity."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, _ConvParams):
                o, i, kh, kw = m.weight.shape
                bound = math.sqrt(6.0 / ((i + o) * kh * kw))
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.fill_(0.01)
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


class ConvNorm(nn.Module):
    """conv -> BatchNorm -> optional activation (same padding by default)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: IntPair, stride: IntPair = 1,
                 padding: Optional[IntPair] = None, bias: bool = True,
                 act: Optional[Callable[[torch.Tensor], torch.Tensor]] = leaky_relu,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        if padding is None:
            padding = (kh // 2, kw // 2)
        self.conv = Conv2d(in_ch, out_ch, (kh, kw), stride, padding, bias=bias, dtype=dtype)
        self.norm = BatchNorm(out_ch, dtype=dtype)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.conv(x))
        return self.act(x) if self.act is not None else x


class RepVGGBlock(nn.Module):
    """3x3 conv+BN, 1x1 conv+BN and identity BN, summed, then LeakyReLU(0.2);
    ``deploy=True`` is the folded single biased 3x3 conv (``reparam``).
    ``branch_act=True`` applies the activation per branch before the sum
    (the reference's train form; not fold-exact)."""

    def __init__(self, in_ch: int, out_ch: int, stride: IntPair = 1,
                 deploy: bool = False, branch_act: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.deploy = deploy
        self.branch_act = branch_act
        s = _pair(stride)
        if deploy:
            self.reparam = Conv2d(in_ch, out_ch, 3, s, 1, bias=True, dtype=dtype)
            return
        self.conv3x3 = ConvNorm(in_ch, out_ch, 3, s, padding=1, bias=False, act=None, dtype=dtype)
        self.conv1x1 = ConvNorm(in_ch, out_ch, 1, s, padding=0, bias=False, act=None, dtype=dtype)
        if s == (1, 1) and in_ch == out_ch:
            self.identity = BatchNorm(in_ch, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.deploy:
            return leaky_relu(self.reparam(x))
        y3, y1 = self.conv3x3(x), self.conv1x1(x)
        if self.branch_act:
            y3, y1 = leaky_relu(y3), leaky_relu(y1)
        y = y3 + y1
        if hasattr(self, "identity"):
            y = y + self.identity(x)
        return leaky_relu(y)


class RepBlock(nn.Module):
    """n chained RepVGG blocks: ``conv1`` then ``block0`` .. ``block{n-2}``."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 2, deploy: bool = False,
                 branch_act: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n = n
        kw = dict(deploy=deploy, branch_act=branch_act, dtype=dtype)
        self.conv1 = RepVGGBlock(in_ch, out_ch, **kw)
        for i in range(n - 1):
            setattr(self, f"block{i}", RepVGGBlock(out_ch, out_ch, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        for i in range(self.n - 1):
            x = getattr(self, f"block{i}")(x)
        return x


def resize_w_bilinear(x: torch.Tensor, out_w: int) -> torch.Tensor:
    """Bilinear resize of the last (width) axis: half-pixel source
    coordinates clamped at 0, no antialiasing (``nn.Upsample(mode=
    "bilinear", align_corners=False)`` restricted to one axis)."""
    in_w = x.shape[-1]
    if in_w == out_w:
        return x
    scale = in_w / out_w
    src = torch.clamp_min(
        (torch.arange(out_w, dtype=torch.float32, device=x.device) + 0.5) * scale - 0.5, 0.0)
    i0 = torch.floor(src).long()
    frac = (src - i0.float()).to(x.dtype)
    i0 = torch.clamp(i0, 0, in_w - 1)
    i1 = torch.clamp(i0 + 1, 0, in_w - 1)
    g0 = x.index_select(-1, i0)
    g1 = x.index_select(-1, i1)
    return g0 * (1.0 - frac) + g1 * frac


def max_pool_same(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """k x k max pool, stride 1, same size, padding with -inf (NCHW)."""
    pad = k // 2
    x = F.pad(x, (pad, pad, pad, pad), value=float("-inf"))
    return F.max_pool2d(x, k, stride=1)


class BiCModule(nn.Module):
    """Bi-directional concat fusion: lateral 1x1 on the current and shallower
    maps, x0.5 / x2 bilinear time rescale, concat, 1x1 out."""

    def __init__(self, c1_ch: int, c0_ch: int, p2_ch: int, features: int, e: float = 0.5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        c_h = int(features * e)
        self.conv_c1 = ConvNorm(c1_ch, c_h, 1, dtype=dtype)
        self.conv_c0 = ConvNorm(c0_ch, c_h, 1, dtype=dtype)
        self.conv_out = ConvNorm(2 * c_h + p2_ch, features, 1, dtype=dtype)

    def forward(self, c1: torch.Tensor, c0: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
        c1 = self.conv_c1(c1)
        c0 = self.conv_c0(c0)
        c0 = resize_w_bilinear(c0, c0.shape[-1] // 2)
        p2 = resize_w_bilinear(p2, p2.shape[-1] * 2)
        return self.conv_out(torch.cat([c1, c0, p2], dim=1))


class CSPSPPFModule(nn.Module):
    """CSP split + chained 5x5 SPPF max pools on the deepest map."""

    def __init__(self, in_ch: int, features: int, e: float = 0.5, pool_k: int = 5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        c_h = int(features * e)
        self.pool_k = pool_k
        kw = dict(dtype=dtype)
        self.conv1 = ConvNorm(in_ch, c_h, 1, **kw)
        self.conv3 = ConvNorm(c_h, c_h, 3, **kw)
        self.conv4 = ConvNorm(c_h, c_h, 1, **kw)
        self.conv2 = ConvNorm(in_ch, c_h, 1, **kw)
        self.conv5 = ConvNorm(4 * c_h, c_h, 1, **kw)
        self.conv6 = ConvNorm(c_h, c_h, 3, **kw)
        self.conv7 = ConvNorm(2 * c_h, features, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv4(self.conv3(self.conv1(x)))
        y1 = self.conv2(x)
        p1 = max_pool_same(x1, self.pool_k)
        p2 = max_pool_same(p1, self.pool_k)
        p3 = max_pool_same(p2, self.pool_k)
        z = self.conv6(self.conv5(torch.cat([x1, p1, p2, p3], dim=1)))
        return self.conv7(torch.cat([z, y1], dim=1))

"""Plain float32 detector over a train-form checkpoint (the port's
``state_dict`` key names, the reference repository's layer names).

The configuration's backbone (``backbones/<backbone>.py``, found by the
``backbone`` key), the YOLOv6 neck (CSP-SPPF, BiC fusion, RepVGG blocks)
and the per-scale YOLO decode. BatchNorm runs on its running statistics.
Every RepVGG block is folded here, from the unfolded weights: 3x3+BN, 1x1+BN
and identity BN summed into one biased 3x3 conv. Functional code over a
dict of tensors; ``torch`` only.

A backbone module defines ``shapes(cfg) -> ({name: shape}, pyramid
widths)``, its train-form leaves in draw order; ``forward(det, x) ->
[f1, f2, f3, f4]``, the float32 backbone built from :class:`Detector`'s
``conv``, ``bn`` and ``r``, every value it produces rounded through
``det.r``; and optionally ``draw(name, shape, u) -> Tensor | None``, the
seeded value of a leaf from its uniform block (``weights.make``), None
leaving the leaf to the generic rule.
"""

from __future__ import annotations

import os
from types import ModuleType
from typing import Dict

import torch
import torch.nn.functional as F

from .. import harness
from .frontend import Frontend

EPS = 1e-5
Sd = Dict[str, torch.Tensor]


def backbone_module(cfg: dict) -> ModuleType:
    """``reference/backbones/<cfg["backbone"]>.py``; an unknown backbone
    raises ``FileNotFoundError`` naming the file looked for."""
    name = str(cfg["backbone"])
    path = harness.find(os.path.join("reference", "backbones"), name, ".py")
    return harness.load_module(path, "perfbench_backbone_" + name)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def fold_bn(w: torch.Tensor, sd: Sd, p: str):
    scale = sd[p + ".weight"] / torch.sqrt(sd[p + ".running_var"] + EPS)
    return w * scale[:, None, None, None], sd[p + ".bias"] - sd[p + ".running_mean"] * scale


def repvgg_folded(sd: Sd, p: str):
    """(3x3 kernel, bias) of the RepVGG block ``p`` with its branches summed."""
    k3, b3 = fold_bn(sd[p + ".conv3x3.conv.conv.weight"], sd, p + ".conv3x3.norm")
    k1, b1 = fold_bn(sd[p + ".conv1x1.conv.conv.weight"], sd, p + ".conv1x1.norm")
    k, b = k3 + F.pad(k1, (1, 1, 1, 1)), b3 + b1
    if p + ".identity.weight" in sd:
        c = k3.shape[1]
        eye = torch.zeros_like(k3)
        eye[torch.arange(c), torch.arange(c), 1, 1] = 1.0
        ki, bi = fold_bn(eye, sd, p + ".identity")
        k, b = k + ki, b + bi
    return k, b


def resize_w(x: torch.Tensor, w: int) -> torch.Tensor:
    return F.interpolate(x, size=(x.shape[2], w), mode="bilinear", align_corners=False)


def pool5(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(F.pad(x, (2, 2, 2, 2), value=float("-inf")), 5, stride=1)


class Detector:
    """``__call__(wave (B, S) float32) -> (B, 630, 3 + C)`` dense predictions
    ``[objectness logit, class logits, center s, width s]``, scales sm, md, lg.

    :meth:`fit_norms` sets every BatchNorm's running statistics to the
    batch statistics of its input on a batch of audio, layer after layer
    (the RepVGG blocks unfolded), as training would leave them.

    ``body_bf16``: the backbone and the neck computed as the configuration's
    ``compute_dtype: bfloat16`` states: the feature image, every conv's
    input, kernel and bias in bfloat16 (products exact, sums in float32),
    and every conv, BatchNorm, activation, residual sum and mean rounded to
    bfloat16 where it is produced; decode in float32. It is the yardstick of
    how far a bf16 body moves this seed's network."""

    def __init__(self, cfg: dict, sd: Sd, device, body_bf16: bool = False):
        self.cfg = cfg
        self.sd = {k: v.detach().to(device, torch.float32) for k, v in sd.items()}
        self.frontend = Frontend(cfg, device)
        self.backbone = backbone_module(cfg)
        self.duration = float(cfg["sample_duration"])
        self.fitting = False
        self.body_bf16 = body_bf16
        self._fold()

    def r(self, t: torch.Tensor) -> torch.Tensor:
        """A value of the body as its dtype stores it."""
        return t.to(torch.bfloat16).float() if self.body_bf16 else t

    def conv(self, x, p: str, stride=1, padding=0) -> torch.Tensor:
        """``p`` names the leaf level that holds ``weight`` (and maybe ``bias``)."""
        y = self.r(F.conv2d(self.r(x), self.r(self.sd[p + ".weight"]), None, stride, padding))
        b = self.sd.get(p + ".bias")
        return y if b is None else self.r(y + self.r(b).view(1, -1, 1, 1))

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return self.r(leaky(x))

    def _fold(self):
        suffix = ".conv3x3.conv.conv.weight"
        self.folded = {k[: -len(suffix)]: repvgg_folded(self.sd, k[: -len(suffix)])
                       for k in self.sd if k.endswith(suffix)}

    @torch.no_grad()
    def fit_norms(self, wave: torch.Tensor) -> Sd:
        self.fitting = True
        try:
            self(wave)
        finally:
            self.fitting = False
        self._fold()
        return self.sd

    def bn(self, x: torch.Tensor, p: str) -> torch.Tensor:
        sd = self.sd
        if self.fitting:
            dims = [0, 2, 3]
            sd[p + ".running_mean"] = x.mean(dim=dims)
            sd[p + ".running_var"] = x.var(dim=dims, unbiased=True)
        return self.r(F.batch_norm(x, sd[p + ".running_mean"], sd[p + ".running_var"],
                                   sd[p + ".weight"], sd[p + ".bias"], False, 0.0, EPS))

    def conv_bn_act(self, x, p, stride=1, act=True):
        k = self.sd[p + ".conv.conv.weight"].shape[-1]
        y = self.bn(self.conv(x, p + ".conv.conv", stride, k // 2), p + ".norm")
        return self.act(y) if act else y

    def repvgg(self, x, p):
        if not self.fitting:
            k, b = self.folded[p]
            y = self.r(F.conv2d(self.r(x), self.r(k), None, 1, 1))
            return self.act(self.r(y + self.r(b).view(1, -1, 1, 1)))
        y = self.bn(self.conv(x, p + ".conv3x3.conv.conv", 1, 1), p + ".conv3x3.norm")
        y = y + self.bn(self.conv(x, p + ".conv1x1.conv.conv"), p + ".conv1x1.norm")
        if p + ".identity.weight" in self.sd:
            y = y + self.bn(x, p + ".identity")
        return self.act(self.r(y))

    def rep_block(self, x, p):
        return self.repvgg(self.repvgg(x, p + ".conv1"), p + ".block0")

    def neck(self, f1, f2, f3, f4):
        p = "multiscale_module"
        cba = self.conv_bn_act
        if len({f.shape[2] for f in (f1, f2, f3, f4)}) > 1:
            f1, f2, f3, f4 = (self.r(f.mean(dim=2, keepdim=True)) for f in (f1, f2, f3, f4))
        c = p + ".cspsppf"
        x1 = cba(cba(cba(f4, c + ".conv1"), c + ".conv3"), c + ".conv4")
        y1 = cba(f4, c + ".conv2")
        q1 = pool5(x1)
        q2 = pool5(q1)
        q3 = pool5(q2)
        z = cba(cba(torch.cat([x1, q1, q2, q3], 1), c + ".conv5"), c + ".conv6")
        p4 = cba(torch.cat([z, y1], 1), c + ".conv7")

        def bic(name, cur, shallow, deep):
            a = cba(cur, f"{p}.{name}.conv_c1")
            s = cba(shallow, f"{p}.{name}.conv_c0")
            s = self.r(resize_w(s, s.shape[-1] // 2))
            d = self.r(resize_w(deep, deep.shape[-1] * 2))
            return cba(torch.cat([a, s, d], 1), f"{p}.{name}.conv_out")

        p3 = self.rep_block(bic("bic3", f3, f2, p4), p + ".rep_block3_1")
        n2 = self.rep_block(bic("bic2", f2, f1, p3), p + ".rep_block2_1")
        # the 3x3 downsampling ConvNorms stride 2 along time only
        n3 = self.rep_block(torch.cat([p3, cba(n2, p + ".conv2_downsample", (1, 2))], 1),
                            p + ".rep_block3_2")
        n4 = self.rep_block(torch.cat([p4, cba(n3, p + ".conv3_downsample", (1, 2))], 1),
                            p + ".rep_block4_1")
        return [self.r(n.mean(dim=2)).transpose(1, 2) for n in (n2, n3, n4)]

    def decode(self, raw: torch.Tensor, key: str, n_frames: int) -> torch.Tensor:
        b, g, _ = raw.shape
        anchors = self.sd[key + "_anchors"] * self.duration
        a = anchors.shape[0]
        q = raw.reshape(b, g, a, -1)
        stride = n_frames // g
        cell = torch.arange(g, device=raw.device, dtype=torch.float32)[None, :, None]
        center = (torch.sigmoid(q[..., -2]) * 2.0 - 0.5 + cell) * stride * self.duration / n_frames
        width = (torch.sigmoid(q[..., -1]) * 2.0) ** 2 * anchors[None, None, :]
        box = torch.stack([center, width], -1).clamp(0.0, self.duration)
        return torch.cat([q[..., :-2], box], -1).reshape(b, g * a, -1)

    @torch.no_grad()
    def __call__(self, wave: torch.Tensor) -> torch.Tensor:
        img = self.frontend(wave)
        outs = self.neck(*self.backbone.forward(self, self.r(img)))
        t = img.shape[-1]
        return torch.cat([self.decode(o, k, t) for o, k in zip(outs, ("sm", "md", "lg"))], 1)


def checkpoint_shapes(cfg: dict, num_classes: int) -> Dict[str, tuple]:
    """Name -> shape of every tensor of the train-form checkpoint, in draw
    order: the anchors, the backbone's leaves, the neck's (its inputs as wide
    as the backbone's pyramid)."""
    shapes: Dict[str, tuple] = {f"{k}_anchors": (int(cfg["num_anchors"]),)
                                for k in ("sm", "md", "lg")}

    def norm(p, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{p}.{leaf}"] = (c,)

    def conv_norm(p, cin, cout, k):
        shapes[p + ".conv.conv.weight"] = (cout, cin, k, k)
        shapes[p + ".conv.conv.bias"] = (cout,)
        norm(p + ".norm", cout)

    def repvgg_(p, cin, cout):
        for name, k in (("conv3x3", 3), ("conv1x1", 1)):
            shapes[f"{p}.{name}.conv.conv.weight"] = (cout, cin, k, k)
            norm(f"{p}.{name}.norm", cout)
        if cin == cout:
            norm(p + ".identity", cin)

    def rep_block_(p, cin, cout):
        repvgg_(p + ".conv1", cin, cout)
        repvgg_(p + ".block0", cout, cout)

    backbone, (f1, f2, f3, f4) = backbone_module(cfg).shapes(cfg)
    shapes.update(backbone)
    out = int(cfg["num_anchors"]) * (3 + num_classes)
    m = "multiscale_module"
    for name, i, o, k in (("conv1", f4, 64, 1), ("conv3", 64, 64, 3), ("conv4", 64, 64, 1),
                          ("conv2", f4, 64, 1), ("conv5", 256, 64, 1), ("conv6", 64, 64, 3),
                          ("conv7", 128, 128, 1)):
        conv_norm(f"{m}.cspsppf.{name}", i, o, k)
    for name, c1, c0 in (("bic3", f3, f2), ("bic2", f2, f1)):
        conv_norm(f"{m}.{name}.conv_c1", c1, 64, 1)
        conv_norm(f"{m}.{name}.conv_c0", c0, 64, 1)
        conv_norm(f"{m}.{name}.conv_out", 256, 128, 1)
    rep_block_(m + ".rep_block3_1", 128, 128)
    rep_block_(m + ".rep_block2_1", 128, out)
    conv_norm(m + ".conv2_downsample", out, 128, 3)
    rep_block_(m + ".rep_block3_2", 256, out)
    conv_norm(m + ".conv3_downsample", out, 128, 3)
    rep_block_(m + ".rep_block4_1", 256, out)
    return shapes

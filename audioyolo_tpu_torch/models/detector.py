"""Top-level detection model (port of ``audioyolo_tpu/models/detector.py``).

``AudioDetectionModel`` wires frontend -> backbone -> neck -> per-scale
decode. The per-cell layout along the last axis is ``[objectness,
class_0..C-1, center_sec, width_sec]``; three scales with grids T/8, T/16,
T/32 and ``num_anchors`` slots per cell (630 proposals per 60 s clip in the
shipped config). Anchors are parameters normalized by ``sample_duration``;
with ``train_anchors: false`` no gradient reaches them.

``model.train()`` selects the train form (batch-statistics BatchNorm,
dropout), ``model.eval()`` the serving form. The frontend has no trainable
input, so it runs without autograd and the graph starts at the feature image.

``dtype`` is the compute dtype of the backbone and the neck (``None``:
float32; ``torch.bfloat16`` is what the shipped config's ``compute_dtype``
asks for). As in the JAX package the frontend runs as it always does, its
feature image is cast to ``dtype``, and decode casts back to float32, so the
NMS and the loss see float32. Parameters stay float32 in every dtype.

Spans (``utils/trace.py``): ``ayt.model.frontend``, ``ayt.model.backbone``
and ``ayt.model.neck`` around the three calls, recorded only while a
profiler records.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import load_config
from ..ops.frontend import SpectralFrontend
from ..utils.trace import span
from .backbone import ConvNeXtBackbone, CustomBackbone, ResNetBackbone
from .layers import init_weights
from .neck import MultiScaleFmapModule


def decode_scale(raw: torch.Tensor, anchors_sec: torch.Tensor, num_classes: int,
                 spectral_size: int, sample_duration: float) -> torch.Tensor:
    """``raw`` (B, G, A*(3+C)) neck output -> (B, G, A, 3+C) with centers and
    widths decoded to seconds and clipped to ``[0, sample_duration]``."""
    b, g, _ = raw.shape
    a = anchors_sec.shape[0]
    p = raw.reshape(b, g, a, 3 + num_classes).float()
    objectness = p[..., :1]
    class_logits = p[..., 1: 1 + num_classes]
    stride = spectral_size // g
    center_scaler = spectral_size / sample_duration  # spectral frames per second
    grid = torch.arange(g, dtype=torch.float32, device=raw.device)[None, :, None, None]
    centers = (torch.sigmoid(p[..., -2:-1]) * 2.0 - 0.5) + grid
    centers = centers * stride / center_scaler
    widths = (torch.sigmoid(p[..., -1:]) * 2.0) ** 2 * anchors_sec[None, None, :, None]
    centers = torch.clamp(centers, 0.0, sample_duration)
    widths = torch.clamp(widths, 0.0, sample_duration)
    return torch.cat([objectness, class_logits, centers, widths], dim=-1)


class AudioDetectionModel(nn.Module):
    """Frontend + backbone (``resnet``, ``custom`` or ``convnext``) + YOLOv6
    neck + decode.

    ``deploy=True`` declares the folded RepVGG form (see
    ``models/reparam.py::fold_repvgg``); ``branch_act=True`` the reference's
    per-branch activation (train form only). Weights are initialised from
    ``generator`` (a seeded ``torch.Generator``; seed 0 when None).
    """

    def __init__(self, config, num_classes: int, deploy: bool = False,
                 branch_act: bool = False, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg = load_config(config)
        self.cfg = cfg
        self.dtype = dtype
        self.num_classes = int(num_classes)
        self.out_channels = cfg.num_anchors * (3 + self.num_classes)
        self.frontend = SpectralFrontend(cfg)
        dur = cfg.sample_duration
        anchors = cfg.anchors_array()
        self.train_anchors = bool(cfg.raw.get("train_anchors", True))
        for key in ("sm", "md", "lg"):
            norm = (anchors[key] / dur).astype(np.float32)
            self.register_parameter(f"{key}_anchors", nn.Parameter(torch.from_numpy(norm)))

        backbone = cfg.raw.get("backbone", "resnet")
        common = dict(block_layers=tuple(cfg.raw["block_layers"]),
                      dropout=float(cfg.raw.get("dropout", 0.0)), dtype=dtype)
        if backbone == "resnet":
            rc = dict(cfg.raw.get("resnet_config") or {})
            self.feature_extractor = ResNetBackbone(block=str(rc.get("block", "BasicBlock")),
                                                    **common)
        elif backbone == "custom":
            self.feature_extractor = CustomBackbone(**common)
        elif backbone == "convnext":
            # dims, layer_scale_init, drop_path_rate; ``dropout`` is unused
            self.feature_extractor = ConvNeXtBackbone(
                block_layers=common["block_layers"], dtype=dtype,
                **(cfg.raw.get("convnext_config") or {}))
        else:
            raise ValueError(f"unknown backbone type: {backbone}")
        self.multiscale_module = MultiScaleFmapModule(
            self.feature_extractor.fmap_channels, self.out_channels,
            deploy=deploy, branch_act=branch_act, dtype=dtype)
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))

    @classmethod
    def from_config(cls, config, num_classes: int, deploy: bool = False,
                    branch_act: bool = False, generator: Optional[torch.Generator] = None,
                    dtype: Optional[torch.dtype] = None) -> "AudioDetectionModel":
        return cls(config, num_classes, deploy=deploy, branch_act=branch_act,
                   generator=generator, dtype=dtype)

    def anchors_sec(self, key: str) -> torch.Tensor:
        a = getattr(self, f"{key}_anchors") * self.cfg.sample_duration
        return a if self.train_anchors else a.detach()

    def forward(self, audio: Optional[torch.Tensor] = None, combine_scales: bool = False,
                features: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``audio``: (B, S) / (B, 1, S) waveform at the dataset rate or
        (B, n_ph, G, F) frames; or precomputed ``features`` (B, n_mels, T, 2).
        ``generator`` draws the dropout mask in train mode."""
        if features is None:
            if audio is None:
                raise ValueError("provide either audio or features")
            with torch.no_grad(), span("ayt.model.frontend"):
                features = self.frontend(audio)
        if self.dtype is not None:
            features = features.to(self.dtype)
        x = features.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
        with span("ayt.model.backbone"):
            fmaps = self.feature_extractor(x, generator)
        with span("ayt.model.neck"):
            n2, n3, n4 = self.multiscale_module(*fmaps)
        spectral, dur = self.cfg.n_frames, self.cfg.sample_duration
        scales = [
            decode_scale(n, self.anchors_sec(key), self.num_classes, spectral, dur)
            for n, key in ((n2, "sm"), (n3, "md"), (n4, "lg"))
        ]
        if not combine_scales:
            return tuple(scales)
        b = scales[0].shape[0]
        return torch.cat([p.reshape(b, -1, 3 + self.num_classes) for p in scales], dim=1)

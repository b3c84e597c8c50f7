"""Seeded weights of a train-form checkpoint, made on the device in one draw.

A leaf that the configuration's backbone module draws itself (its
``draw``, ``reference/detector.py``) takes that value; the rest follow the
generic rule: conv kernels are glorot-uniform (the shipped initialiser),
conv biases U(-0.05, 0.05), BatchNorm scales U(0.8, 1.2) and shifts
U(-0.1, 0.1); anchors are the configuration's, normalised by the window.
The running statistics of every BatchNorm are then fitted by the plain
reference on eight windows of event audio drawn from the seed
(``Detector.fit_norms``), each running variance set to twice the variance
of the layer's input, so that folding BatchNorm and the RepVGG branches is
far from the identity and every layer damps what reaches it. (With the
fitted variance itself the random network is chaotic: a bf16 rounding of
its input moves confidences by 0.15, and no comparison with a reference
can tell rounding from a fault.) The same seed gives the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .reference.detector import Detector, backbone_module, checkpoint_shapes
from .traffic import synth


def make(cfg: dict, num_classes: int, seed: int, device,
         fit_windows: int = 8) -> Dict[str, torch.Tensor]:
    shapes = checkpoint_shapes(cfg, num_classes)
    draw = getattr(backbone_module(cfg), "draw", None)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    duration = float(cfg["sample_duration"])
    for (name, shape), n in zip(shapes.items(), sizes):
        u = flat[off: off + n].view(shape)
        off += n
        leaf = name.rsplit(".", 1)[-1]
        own = draw(name, shape, u) if draw is not None else None
        if own is not None:
            out[name] = own
        elif name.endswith("_anchors"):
            key = name[: -len("_anchors")]
            a = np.asarray(cfg["anchors"][key], np.float32) / np.float32(duration)
            out[name] = torch.from_numpy(a).to(device)
        elif leaf == "weight" and len(shape) == 4:
            o, i, kh, kw = shape
            out[name] = (2.0 * u - 1.0) * math.sqrt(6.0 / ((i + o) * kh * kw))
        elif leaf == "weight":
            out[name] = 0.8 + 0.4 * u
        elif leaf == "running_var":
            out[name] = 0.8 + 0.45 * u
        elif leaf in ("running_mean",) or (leaf == "bias" and ".conv.conv." not in name):
            out[name] = (2.0 * u - 1.0) * 0.1
        else:  # conv bias
            out[name] = (2.0 * u - 1.0) * 0.05
    rate, duration = int(cfg["sample_rate"]), float(cfg["sample_duration"])
    n = int(round(duration * rate))
    rng = np.random.default_rng([int(seed), 5])
    wave = torch.stack([synth.render(n, synth.event_layout(rng, duration), rate, gen, device)
                        for _ in range(fit_windows)])
    fitted = Detector(cfg, out, device).fit_norms(wave)
    out.update({k: fitted[k] for k in out if k.endswith("running_mean")})
    out.update({k: 2.0 * fitted[k] for k in out if k.endswith("running_var")})
    return out

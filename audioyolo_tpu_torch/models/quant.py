"""int8 post-training quantization of the detector body (port of
``audioyolo_tpu/models/quant.py``).

- **Calibration** (:func:`calibrate_quant`): run a few representative model
  inputs through the model; every ``Conv2d`` records the max |x| of its
  float32 input (a forward pre-hook, installed only for the calibration).
  Scales are ``max(absmax, 1e-12) / 127`` (symmetric, zero point 0).
- **Execution** (:func:`set_quant`): a conv whose ``s_x`` buffer holds its
  scale runs ``layers._int8_conv``: int8 input at that static scale, int8
  kernel at per-output-channel scales taken from the float32 parameters at
  call time, int32 sums. The parameters are untouched, so one checkpoint
  serves the float and the int8 body.
- **Selection**: by module name (the port's names are the JAX package's
  flax paths joined with dots, ``models/from_jax.py``). By default the stem
  convolutions and the neck's prediction emitters stay float, as in the JAX
  package.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import torch
from torch import nn

from .layers import Conv2d

# the JAX package's DEFAULT_EXCLUDE, in the port's module names: the ResNet
# stem convs, the custom backbone's stem, and the neck's RepBlocks that emit
# the raw predictions decode reads
DEFAULT_EXCLUDE = (
    "feature_extractor.conv1.",
    "feature_extractor.conv2.",
    "feature_extractor.first_conv.",
    "rep_block2_1", "rep_block3_2", "rep_block4_1",
)


def _convs(model: nn.Module) -> Dict[str, Conv2d]:
    return {name: m for name, m in model.named_modules() if isinstance(m, Conv2d)}


def set_quant(model: nn.Module, scales: Dict[str, torch.Tensor]) -> nn.Module:
    """Run the convs named in ``scales`` in int8 at their ``s_x`` and every
    other conv in float; returns ``model``. ``set_quant(model, {})`` is the
    float body again. Unknown names raise."""
    convs = _convs(model)
    unknown = sorted(set(scales) - set(convs))
    if unknown:
        raise ValueError(f"no Conv2d named {unknown[:3]} in the model")
    for name, conv in convs.items():
        s = scales.get(name)
        conv.s_x = None if s is None else torch.as_tensor(
            s, dtype=torch.float32, device=conv.conv.weight.device).reshape(())
    return model


@torch.no_grad()
def calibrate_quant(model: nn.Module, batches: Iterable, *,
                    exclude: Sequence[str] = DEFAULT_EXCLUDE,
                    include_only: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    """``{conv name: s_x}`` from calibration batches, for :func:`set_quant`.

    ``batches``: model inputs on the model's device (waveform or framed
    batches, or the framed-int8 ``(q, scale)`` tuple; a handful is enough,
    the scales are absmax-based). The model runs in the mode its caller left
    it (eval, to calibrate the serving body as the JAX package does with
    ``train=False``), on the float body: any scales it had are cleared
    first. ``exclude``: convs
    whose name + "." contains any of these stay float; ``include_only``:
    when given, only matching convs are quantized.
    """
    convs = _convs(model)
    set_quant(model, {})
    absmax: Dict[str, torch.Tensor] = {}

    def hook(name):
        def record(mod, args):
            a = args[0].float().abs().amax()
            absmax[name] = a if name not in absmax else torch.maximum(absmax[name], a)
        return record

    handles = [conv.register_forward_pre_hook(hook(name)) for name, conv in convs.items()]
    try:
        for b in batches:
            model(b, combine_scales=True)
    finally:
        for h in handles:
            h.remove()
    if not absmax:
        raise ValueError("calibration saw no Conv2d modules (no statistics recorded)")

    def wanted(name: str) -> bool:
        joined = name + "."
        if include_only is not None:
            return any(s in joined for s in include_only)
        return not any(s in joined for s in exclude)

    # float64 divide, then float32, as the JAX package computes it
    scales = {name: (torch.clamp_min(a.double(), 1e-12) / 127.0).float()
              for name, a in absmax.items() if wanted(name)}
    if not scales:
        raise ValueError(f"no convs selected for quantization (exclude={exclude!r}, "
                         f"include_only={include_only!r}; saw {len(absmax)} convs)")
    return scales


def quantized_paths(scales: Dict[str, torch.Tensor]) -> List[str]:
    """The names of the convs a set of scales quantizes, sorted."""
    return sorted(scales)

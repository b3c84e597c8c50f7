"""Reference-checkpoint importer (port of ``audioyolo_tpu/models/import_torch.py``).

Maps the reference's ``torch.save({"network_params": state_dict, ...})``
checkpoints onto the port's state dict. The port names its modules after the
flax tree (``models/from_jax.py``), so a port key is a flax path joined with
dots and the JAX package's name translation applies unchanged; only the leaf
differs (``weight`` under a conv's ``conv`` level is the flax ``kernel``):

==========================================  =====================================
reference torch key                         port key
==========================================  =====================================
sm_anchors                                  sm_anchors
feature_extractor.conv1.weight              feature_extractor.conv1.conv.weight
feature_extractor.bn1.weight                feature_extractor.bn1.weight
feature_extractor.layer2.0.conv1.weight     feature_extractor.layer2_0.conv1.conv.weight
...layer2.0.downsample.0.weight             ...layer2_0.downsample_conv.conv.weight
first_conv.0.weight (custom)                feature_extractor.first_conv.conv.weight
entry_block.module_dict.layer0._layer.0.*   ...entry_block.layer0.conv_a.conv.*
multiscale_module.cspsppf.conv_1_3_4.1.*    multiscale_module.cspsppf.conv3.*
...rep_block3_2.blocks.0.conv3x3.conv.*     ...rep_block3_2.block0.conv3x3.conv.conv.*
==========================================  =====================================

Both sides hold convolutions as OIHW, so nothing is transposed. BatchNorm
``weight``/``bias``/``running_*`` map straight across. The frontend buffers
(resample kernel, mel filterbank, DCT, windows) are recomputed, not imported,
and ``num_batches_tracked`` is ignored. The CustomBackbone's keys translate
the same way (``backbone: custom``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping

import numpy as np
import torch


def _module_to_torch(parts: List[str]) -> List[str]:
    """Translate one module path (no leaf) into torch attribute parts."""
    out: List[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        m = re.fullmatch(r"layer(\d)_(\d+)", p)
        if m:  # resnet stage block
            out += [f"layer{m.group(1)}", m.group(2)]
        elif p == "downsample_conv":
            out += ["downsample", "0"]
        elif p == "downsample_bn":
            out += ["downsample", "1"]
        elif p == "first_conv":
            out += ["first_conv", "0"]
        elif p == "first_bn":
            out += ["first_conv", "1"]
        elif re.fullmatch(r"block\d+", p) and i > 0 and parts[i - 1] in (
            "rep_block2_1", "rep_block3_1", "rep_block3_2", "rep_block4_1",
        ):  # RepBlock chain
            out += ["blocks", p[len("block"):]]
        elif re.fullmatch(r"layer\d+", p) and i > 0 and (
            parts[i - 1].startswith("block") or parts[i - 1] == "entry_block"
        ):  # custom-backbone ExtractorBlock layer
            out += ["module_dict", p]
        elif p == "conv_a":
            out += ["_layer", "0"]
        elif p == "bn_a":
            out += ["_layer", "1"]
        elif p == "conv_b":
            out += ["_layer", "3"]
        elif p == "bn_b":
            out += ["_layer", "4"]
        elif p == "res_conv":
            out += ["_res_layer"]
        elif p == "conv1" and i > 0 and parts[i - 1] == "cspsppf":
            out += ["conv_1_3_4", "0"]
        elif p == "conv3" and i > 0 and parts[i - 1] == "cspsppf":
            out += ["conv_1_3_4", "1"]
        elif p == "conv4" and i > 0 and parts[i - 1] == "cspsppf":
            out += ["conv_1_3_4", "2"]
        else:
            out.append(p)
        i += 1
    return out


def port_key_to_torch_key(key: str) -> str:
    """The reference key of one port ``state_dict`` key (the counterpart of
    the JAX package's ``flax_path_to_torch_key``)."""
    *parts, leaf = key.split(".")
    if not parts and leaf.endswith("_anchors"):
        return leaf
    # every conv weight/bias sits under a ``conv`` level that torch does not
    # have (ConvNorm: ``x.conv.conv.weight`` -> ``x.conv.weight``; a bare conv:
    # ``conv1.conv.weight`` -> ``conv1.weight``); BatchNorm leaves never do
    if parts and parts[-1] == "conv":
        parts.pop()
    return ".".join(_module_to_torch(parts) + [leaf])


_SKIP_PATTERNS = (
    "taper_window",
    "resampler.",
    "melspectogram_tfmr.",
    "mfcc_tfmr.",
    "num_batches_tracked",
)


def import_torch_state_dict(torch_state: Mapping[str, Any],
                            template: Mapping[str, torch.Tensor],
                            strict: bool = True) -> Dict[str, torch.Tensor]:
    """The port's state dict filled from a reference state dict.

    ``torch_state``: flat name -> tensor (or array) dict, e.g. from
    :func:`load_torch_checkpoint`. ``template``: the port model's
    ``state_dict()`` of the matching architecture (names and shapes). Raises
    ``KeyError`` on a missing key, ``ValueError`` on a shape mismatch and,
    with ``strict``, on reference keys left unconsumed.
    """
    used = set()
    out: Dict[str, torch.Tensor] = {}
    for key, ref in template.items():
        tkey = port_key_to_torch_key(key)
        if tkey not in torch_state:
            raise KeyError(f"reference checkpoint is missing '{tkey}' (needed for {key})")
        val = torch_state[tkey]
        if not torch.is_tensor(val):
            val = torch.from_numpy(np.array(val))
        if tuple(val.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for '{tkey}': reference {tuple(val.shape)} vs "
                             f"port {tuple(ref.shape)}")
        out[key] = val.detach().to("cpu", torch.float32).clone()
        used.add(tkey)
    if strict:
        leftovers = [k for k in torch_state
                     if k not in used and not any(s in k for s in _SKIP_PATTERNS)]
        if leftovers:
            raise ValueError(f"unconsumed reference checkpoint keys: {leftovers[:10]}")
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pth``/``.pth.tar`` (``{"network_params": ...}``)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return dict(payload.get("network_params", payload))

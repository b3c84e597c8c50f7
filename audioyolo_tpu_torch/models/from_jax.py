"""Weights bridge: the JAX package's flax variables -> the port's state dict.

The port names its submodules after the flax tree, so the walk needs no
table: a flax path joined with dots is the port's module path, and only the
leaf is renamed (HWIO ``kernel`` -> OIHW ``weight``, BatchNorm ``scale`` ->
``weight``, ``mean``/``var`` -> ``running_mean``/``running_var``). Works for
the train form and for the folded deploy form. Takes nested dicts of numpy
arrays (anything ``np.asarray`` accepts), so it needs no JAX import.
:func:`quant_scales_from_jax` carries a JAX ``quant`` collection (the int8
calibration, ``audioyolo_tpu/models/quant.py``) across the same way.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, tree


_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` -> port ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for collection, leaves in (("params", _PARAM_LEAF), ("batch_stats", _STAT_LEAF)):
        for path, leaf in _flatten(variables.get(collection, {})):
            *mods, name = path
            arr = np.asarray(leaf, dtype=np.float32)
            if collection == "params" and name.endswith("_anchors") and not mods:
                key = name
            elif name in leaves:
                key = ".".join(mods + [leaves[name]])
                if name == "kernel":
                    arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            else:
                raise KeyError(f"unmapped {collection} leaf {'/'.join(path)}")
            out[key] = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
    return out


def quant_scales_from_jax(quant: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``quant`` collection (``{..path..: {"s_x": scale}}``) -> the
    port's ``{conv name: s_x}`` for ``models/quant.py::set_quant``."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(quant):
        *mods, name = path
        if name != "s_x":
            raise KeyError(f"unmapped quant leaf {'/'.join(path)}")
        out[".".join(mods)] = torch.tensor(np.asarray(leaf, dtype=np.float32))
    return out

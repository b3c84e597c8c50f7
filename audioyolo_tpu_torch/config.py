"""Config system of the PyTorch port.

A copy of the JAX package's reader (``audioyolo_tpu/config.py``): the same
reference-schema YAML, the same attribute/dict view and the same derived
static shapes (frame count, grid sizes, proposal count). The port keeps its
own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import copy
import math
import os
from typing import Any, Dict, List, Union

import numpy as np
import yaml

DEFAULT_CONFIG_PATH = os.path.join("config", "config.yaml")


def _require(d: Dict[str, Any], key: str, ctx: str) -> Any:
    if key not in d:
        raise KeyError(f"config missing required key '{key}' in {ctx}")
    return d[key]


class Config:
    """Attribute/dict hybrid view over the parsed YAML tree.

    ``cfg["melspectrogram_config"]`` and ``cfg.melspectrogram_config`` are both
    supported; nested dicts are wrapped lazily. The raw dict is ``cfg.raw``.
    """

    def __init__(self, raw: Dict[str, Any]):
        object.__setattr__(self, "raw", raw)

    def __getitem__(self, key: str) -> Any:
        val = self.raw[key]
        return Config(val) if isinstance(val, dict) else val

    def __getattr__(self, key: str) -> Any:
        if key == "raw":  # not set yet: copy/pickle probe a bare instance
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __contains__(self, key: str) -> bool:
        return key in self.raw

    def get(self, key: str, default: Any = None) -> Any:
        if key in self.raw:
            return self[key]
        return default

    def keys(self):
        return self.raw.keys()

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self.raw)

    # ---- derived static quantities -------------------------------------

    @property
    def num_anchors(self) -> int:
        return int(self.raw["num_anchors"])

    @property
    def sample_duration(self) -> float:
        return float(self.raw["sample_duration"])

    @property
    def sample_rate(self) -> int:
        return int(self.raw["sample_rate"])

    @property
    def new_sample_rate(self) -> int:
        return int(self.raw["new_sample_rate"])

    @property
    def clip_samples(self) -> int:
        """Samples per clip at the dataset sample rate (22050*60)."""
        return int(round(self.sample_duration * self.sample_rate))

    @property
    def model_samples(self) -> int:
        """Samples per clip after the front-end resample (16000*60)."""
        return int(
            math.ceil(self.new_sample_rate * self.clip_samples / self.sample_rate)
        )

    @property
    def n_frames(self) -> int:
        """Spectrogram time frames for one clip (960 with the shipped config)."""
        mel = self.raw["melspectrogram_config"]
        n_fft = int(mel["n_fft"])
        hop = int(mel.get("hop_length") or n_fft)
        if mel.get("center", True):
            return 1 + self.model_samples // hop
        return 1 + (self.model_samples - n_fft) // hop

    @property
    def n_mels(self) -> int:
        return int(self.raw["melspectrogram_config"]["n_mels"])

    @property
    def grid_sizes(self) -> List[int]:
        """Temporal grid cells per detection scale: (T/8, T/16, T/32)."""
        t = self.n_frames
        return [t // 8, t // 16, t // 32]

    @property
    def total_proposals(self) -> int:
        """Anchor boxes per clip across all scales (630 with shipped config)."""
        return sum(self.grid_sizes) * self.num_anchors

    @property
    def max_targets(self) -> int:
        """Fixed target slots per clip (``tpu_config.max_targets``, 48)."""
        return int((self.raw.get("tpu_config") or {}).get("max_targets", 48))

    def anchors_array(self) -> Dict[str, np.ndarray]:
        a = self.raw["anchors"]
        return {k: np.asarray(a[k], dtype=np.float32) for k in ("sm", "md", "lg")}


def load_config(path: Union[str, Dict[str, Any], Config, None] = None) -> Config:
    """Load a YAML config (reference schema) into a :class:`Config`.

    Accepts a path, an already-parsed dict, an existing Config (pass-through),
    or None (``config/config.yaml`` relative to the working directory).
    """
    if isinstance(path, Config):
        return path
    if isinstance(path, dict):
        return Config(copy.deepcopy(path))
    path = path or DEFAULT_CONFIG_PATH
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"config at {path} did not parse to a mapping")
    _require(raw, "anchors", path)
    _require(raw, "melspectrogram_config", path)
    _require(raw, "train_config", path)
    return Config(raw)


def set_config_anchors(path: str, sm: List[float], md: List[float], lg: List[float]) -> None:
    """Write fitted anchors back into a YAML config (the anchor CLI's hook)."""
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    raw["anchors"]["sm"] = [float(x) for x in sm]
    raw["anchors"]["md"] = [float(x) for x in md]
    raw["anchors"]["lg"] = [float(x) for x in lg]
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)

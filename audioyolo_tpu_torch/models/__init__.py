"""Detector modules, the RepVGG fold and the weights bridge from JAX."""

from .detector import AudioDetectionModel, decode_scale  # noqa: F401
from .from_jax import quant_scales_from_jax, state_dict_from_jax  # noqa: F401
from .reparam import fold_repvgg  # noqa: F401

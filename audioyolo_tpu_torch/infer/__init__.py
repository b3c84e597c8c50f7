"""Inference decode and long-form streaming."""

from .decode import make_inference_fn, postprocess_detections  # noqa: F401
from .streaming import evaluate_audio, rle_merge  # noqa: F401

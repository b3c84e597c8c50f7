"""Inference decode, long-form streaming, directory inference and event mAP."""

from .decode import make_inference_fn, postprocess_detections  # noqa: F401
from .eval_map import event_average_precision, event_map  # noqa: F401
from .runner import evaluate_dir  # noqa: F401
from .streaming import evaluate_audio, evaluate_files_batched, rle_merge  # noqa: F401

"""HTTP serving endpoint of the PyTorch port (port of the root ``serve.py``).

POST a WAV (any sample rate, any duration; the streaming chunker windows it)
and get the detected ``(start, end, class)`` events as JSON. The model is
built once: folded RepVGG weights on the card, the frontend posture from the
config, packed detections copied back once per batch.

Endpoints (the same routes and JSON as the JAX server):
  GET  /health   -> {"status": "ok"}
  GET  /meta     -> class map, sample rate, clip duration, config path
  POST /detect   -> body: WAV bytes. Response:
       {"events": [{"start", "end", "class"}, ...],          RLE-merged
        "rows":   [{"start", "end", "class", "confidence"}, ...]}

Requests are served one at a time (one device, one lock).

Usage:
  python -m audioyolo_tpu_torch.serve --model_path weights.pt \
      [--config config/config.yaml] [--port 8700] [--bf16] [--int8_calib calib.wav]

``--model_path`` is a ``torch.save``d train-form state dict of the port's
``AudioDetectionModel`` (``models/from_jax.py`` converts JAX variables); it
is folded to the deploy form at load. ``--bf16`` runs the backbone and neck
in bfloat16 on the same float32 weights; ``--int8_calib`` runs the int8 body
(``models/quant.py``) at scales calibrated on the first windows of a WAV.
Files at the model rate are framed on the host (``frame_host``, or
``frame_host_int8`` under ``frontend_precision: int8``).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import torch

from .config import load_config
from .device import DeviceLike, resolve_device
from .infer.decode import make_inference_fn
from .infer.streaming import evaluate_audio, rle_merge
from .models.detector import AudioDetectionModel
from .models.reparam import fold_repvgg


def get_label_map(path: str) -> Dict[int, str]:
    with open(path, "r") as f:
        return {int(k): v for k, v in json.load(f).items()}


def build_app_state(config="config/config.yaml", *, model_path: Optional[str] = None,
                    state_dict: Optional[Dict[str, torch.Tensor]] = None,
                    class_map_path: Optional[str] = None, batch_size: int = 0,
                    iou_threshold: float = 0.1, conf_threshold: float = 0.2,
                    device: DeviceLike = None, dtype: Optional[torch.dtype] = None,
                    int8_calib: Optional[str] = None) -> dict:
    """Load the model and build the inference function once.

    Weights come from ``state_dict`` (train form, in memory) or else from
    ``model_path``. ``device`` defaults to the card; ``dtype`` is the body's
    compute dtype (``torch.bfloat16`` for ``--bf16``); ``int8_calib`` a WAV
    whose first windows calibrate the int8 body.
    """
    from .inference_cli import load_calib_batch, model_input_on
    from .models.quant import calibrate_quant, set_quant

    dev = resolve_device(device)
    cfg = load_config(config)
    tc = cfg.raw["train_config"]
    idx2class = get_label_map(
        class_map_path or os.path.join(tc["class_map_path"], "class_map.json"))
    if state_dict is None:
        if not model_path:
            raise ValueError("give a state_dict or a model_path")
        state_dict = torch.load(model_path, map_location="cpu", weights_only=True)
    model = AudioDetectionModel.from_config(cfg, num_classes=len(idx2class), deploy=True,
                                            dtype=dtype)
    fe = model.frontend
    frame_fn = None if fe.fused is None else (fe.frame_host_int8 if fe.fused_int8
                                              else fe.frame_host)
    state_dict = fold_repvgg(state_dict)
    if int8_calib:
        model.load_state_dict(state_dict)
        model.to(dev).eval()
        calib = load_calib_batch([int8_calib], cfg, frame_fn=frame_fn)
        set_quant(model, calibrate_quant(model, [model_input_on(calib, dev)]))
    keep_k = int((cfg.raw.get("tpu_config") or {}).get("nms_keep", 128))
    infer_fn = make_inference_fn(model, state_dict, iou_threshold,
                                 conf_threshold, keep_k=keep_k, packed=True, device=dev)
    return {
        "cfg": cfg,
        "idx2class": idx2class,
        "infer_fn": infer_fn,
        "frame_fn": frame_fn,
        "batch_size": batch_size or int(tc["batch_size"]),
        "lock": threading.Lock(),
        "config_path": config if isinstance(config, str) else "<in memory>",
        "resampler_cache": {},
    }


def detect_wav_bytes(state: dict, body: bytes) -> dict:
    """Run detection on in-memory WAV bytes -> JSON-ready dict."""
    cfg = state["cfg"]
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
        f.write(body)
        path = f.name
    try:
        with state["lock"]:
            rows = evaluate_audio(
                state["infer_fn"], path, "",
                input_sample_rate=int(cfg.sample_rate),
                sample_duration=float(cfg.sample_duration),
                batch_size=state["batch_size"],
                idx2class_map=state["idx2class"],
                frame_fn=state["frame_fn"],
                return_rows=True,
                _resampler_cache=state["resampler_cache"],
            )
    finally:
        os.unlink(path)
    idx2class = state["idx2class"]
    raw = [
        {"start": round(r["start"], 2), "end": round(r["end"], 2),
         "class": idx2class[r["class_idx"]], "confidence": round(r["confidence"], 4)}
        for r in rows
    ]
    events = [{"start": e["start"], "end": e["end"], "class": e["class"]}
              for e in rle_merge(raw)]
    return {"events": events, "rows": raw}


def make_handler(state: dict):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib naming)
            if self.path == "/health":
                self._json(200, {"status": "ok"})
            elif self.path == "/meta":
                cfg = state["cfg"]
                self._json(200, {
                    "classes": state["idx2class"],
                    "input_sample_rate": int(cfg.sample_rate),
                    "sample_duration": float(cfg.sample_duration),
                    "config": state["config_path"],
                })
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/detect":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0:
                    raise ValueError("empty body (expected WAV bytes)")
                self._json(200, detect_wav_bytes(state, self.rfile.read(n)))
            except Exception as e:  # report the error as JSON, keep serving
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *a):  # quiet access log
            pass

    return Handler


def serve(state: dict, host: str, port: int) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(state))


def main() -> None:
    p = argparse.ArgumentParser(description="Audio detection HTTP server (PyTorch port)")
    p.add_argument("--config", type=str, default="config/config.yaml", metavar="")
    p.add_argument("--class_map_path", type=str, default="", metavar="")
    p.add_argument("--model_path", type=str, required=True, metavar="")
    p.add_argument("--host", type=str, default="127.0.0.1", metavar="")
    p.add_argument("--port", type=int, default=8700, metavar="")
    p.add_argument("--batch_size", type=int, default=0, metavar="")
    p.add_argument("--iou_threshold", type=float, default=0.1, metavar="")
    p.add_argument("--conf_threshold", type=float, default=0.2, metavar="")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute for the detector body")
    p.add_argument("--int8_calib", type=str, default="", metavar="",
                   help="wav file to calibrate an int8 detector body on")
    args = p.parse_args()

    state = build_app_state(
        args.config, model_path=args.model_path, class_map_path=args.class_map_path or None,
        batch_size=args.batch_size, iou_threshold=args.iou_threshold,
        conf_threshold=args.conf_threshold, dtype=torch.bfloat16 if args.bf16 else None,
        int8_calib=args.int8_calib or None)
    httpd = serve(state, args.host, args.port)
    print(f"serving on http://{args.host}:{args.port} "
          f"(classes: {list(state['idx2class'].values())})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()


if __name__ == "__main__":
    main()

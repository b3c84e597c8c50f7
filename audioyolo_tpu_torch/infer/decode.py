"""Inference decode: model forward + NMS + fixed-K compaction (port of
``audioyolo_tpu/infer/decode.py``).

One function takes a batch already on the device and returns fixed-capacity
detections packed as (B, keep_k, 6) ``[confidence, objectness, class_idx,
center, width, valid]``, so the host makes one copy back per batch.
Survivors are compacted to the front by a stable sort on
``(survived, confidence)``; no shape depends on the data.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import cuda_graph
from ..ops.nms import batched_interval_nms


def detection_postprocess_graph(preds: torch.Tensor, iou_threshold: float,
                                conf_threshold: float, sample_duration: float,
                                keep_k: int) -> Dict[str, torch.Tensor]:
    """(B, K, 3+C) combined predictions -> fixed-(B, keep_k) detection dict."""
    order, keep, conf = batched_interval_nms(preds, iou_threshold, conf_threshold,
                                             sample_duration)
    composite = keep.float() * 2.0 + conf
    _, perm = torch.sort(-composite, dim=-1, stable=True)
    perm = perm[:, :keep_k]
    idx = torch.gather(order, -1, perm)  # original proposal ids
    valid = torch.gather(keep, -1, perm)
    confidence = torch.gather(conf, -1, perm)

    sel = torch.gather(preds, 1, idx[..., None].expand(-1, -1, preds.shape[-1]))
    return {
        "confidence": confidence,
        "objectness": torch.sigmoid(sel[..., 0]),
        "class_idx": torch.argmax(sel[..., 1:-2], dim=-1).to(torch.int32),
        "center": torch.clamp(sel[..., -2], 0.0, sample_duration),
        "width": torch.clamp(sel[..., -1], 0.0, sample_duration),
        "valid": valid,
    }


def pack_detections(dets: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Detection dict -> one (B, K, 6) float32 tensor."""
    return torch.stack([
        dets["confidence"], dets["objectness"], dets["class_idx"].float(),
        dets["center"], dets["width"], dets["valid"].float(),
    ], dim=-1)


def unpack_detections(arr: np.ndarray) -> Dict[str, np.ndarray]:
    arr = np.asarray(arr)
    return {
        "confidence": arr[..., 0],
        "objectness": arr[..., 1],
        "class_idx": arr[..., 2].astype(np.int32),
        "center": arr[..., 3],
        "width": arr[..., 4],
        "valid": arr[..., 5] > 0.5,
    }


def make_inference_fn(model, state_dict: Dict[str, torch.Tensor],
                      iou_threshold: float = 0.1, conf_threshold: float = 0.2,
                      keep_k: int = 128, packed: bool = True,
                      device: DeviceLike = None,
                      int8_input: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """Load ``state_dict`` into ``model``, move it to ``device`` (default: the
    card) and return ``fn(x)``. ``x`` is a (B, 1, S) waveform or (B, n_ph, G,
    F) int16/float frames already on that device (or, in the ``int8``
    frontend posture, the ``(q, scale)`` frames of ``frame_host_int8``);
    ``fn(x)`` returns the packed (B, keep_k, 6) tensor (or the detection dict
    with ``packed=False``). ``model`` is normally the ``deploy=True`` model
    with folded weights (and, for the int8 body, its scales set by
    ``models/quant.py::set_quant``).

    ``int8_input=True``: ``x`` is ``(q, scale)``, a (B, 1, S) int8 waveform
    and its (B,) float32 per-clip scales from
    ``infer/streaming.py::quantize_clips_int8``, dequantized on the device
    (``q * scale``) before the frontend.
    """
    dev = resolve_device(device)
    model.load_state_dict(state_dict)
    model.to(dev).eval()
    duration = float(model.cfg.sample_duration)

    @torch.inference_mode()
    def infer(x):
        parts = x if isinstance(x, (tuple, list)) else (x,)
        if any(t.device != dev for t in parts):
            raise ValueError(f"input is on {parts[0].device}, the model on {dev}")
        if int8_input:
            q, scale = x
            x = q.float() * scale[:, None, None]
        preds = model(x, combine_scales=True)
        dets = detection_postprocess_graph(preds, iou_threshold, conf_threshold,
                                           duration, keep_k)
        return pack_detections(dets) if packed else dets

    infer.device = dev
    infer.model = model
    return infer


def make_multi_inference_fn(model, state_dict: Dict[str, torch.Tensor], n_batches: int,
                            iou_threshold: float = 0.1, conf_threshold: float = 0.2,
                            keep_k: int = 128, packed: bool = True,
                            device: DeviceLike = None) -> Callable:
    """Like :func:`make_inference_fn`, but one dispatch runs ``n_batches``
    forward + decode passes: ``fn(sequence of N inputs) -> tuple of N
    outputs``, each input a batch on the device as ``make_inference_fn``'s
    function takes it.

    On the card the N passes are one CUDA graph per (shape, dtype) of the
    inputs, over static input buffers that each call fills with a
    device-to-device copy; the first call of a signature runs its passes
    eagerly on a side stream (warming every lazy allocation) and then
    captures; the outputs are copied out of the graph's buffers, and each
    replay advances the kernels' launch counters by the capture's launches
    (``ops/cuda_graph.py``). A capture that fails raises. On the CPU the N
    passes run one after another.
    """
    single = make_inference_fn(model, state_dict, iou_threshold, conf_threshold, keep_k=keep_k,
                               packed=packed, device=device)
    dev = single.device
    graphs: Dict[tuple, tuple] = {}

    def infer(audios):
        if len(audios) != n_batches:
            raise ValueError(
                f"make_multi_inference_fn built for {n_batches} batches per "
                f"dispatch, got {len(audios)}"
            )
        audios = [tuple(a) if isinstance(a, list) else a for a in audios]
        if dev.type != "cuda":
            return tuple(single(a) for a in audios)
        key = cuda_graph.signature(audios)
        entry = graphs.get(key)
        if entry is None:
            inputs = [cuda_graph.clone(a) for a in audios]
            graph = torch.cuda.CUDAGraph()
            outs, static, counts = cuda_graph.warm_then_capture(
                dev, graph, lambda: tuple(single(a) for a in audios),
                lambda: tuple(single(a) for a in inputs))
            graphs[key] = (graph, inputs, static, counts)
            return outs
        graph, inputs, static, counts = entry
        for buf, a in zip(inputs, audios):
            cuda_graph.copy_into(buf, a)
        graph.replay()
        cuda_graph.count_replay(counts)
        with torch.inference_mode():
            return tuple(cuda_graph.clone(o) for o in static)

    infer.device = dev
    infer.graphs = graphs
    infer.single = single  # one pass, eager: what a FLOP count can follow
    return infer


def postprocess_detections(dets: Dict[str, np.ndarray], sample_duration: float,
                           return_start_end: bool = True) -> list:
    """Host side: fixed arrays -> per-clip lists of detection rows
    ``(confidence, objectness, class_idx, start, end)`` (or center/width),
    ordered by the decoded center as the reference orders them."""
    out = []
    for i in range(dets["valid"].shape[0]):
        rows, centers = [], []
        for j in np.nonzero(dets["valid"][i])[0]:
            c, w = float(dets["center"][i, j]), float(dets["width"][i, j])
            if return_start_end:
                t0 = min(max(c - w / 2.0, 0.0), sample_duration)
                t1 = min(max(c + w / 2.0, 0.0), sample_duration)
            else:
                t0, t1 = c, w
            centers.append(c)
            rows.append((float(dets["confidence"][i, j]), float(dets["objectness"][i, j]),
                         int(dets["class_idx"][i, j]), t0, t1))
        out.append([r for _, r in sorted(zip(centers, rows), key=lambda p: p[0])])
    return out

"""Serving artifact export (port of ``audioyolo_tpu/infer/export.py``).

``torch.export`` traces the packed inference function (the forward with the
RepVGG blocks folded, decode, NMS, compaction and packing; the weights, and
the int8 scales of a calibrated body, baked in as the program's constants)
into one program per platform, each traced on its device with static shapes:
the counterpart of the JAX package's multi-platform StableHLO lowering. The
hand-written kernels are registered torch ops (``ops/mel_kernel.py``,
``ops/nms_kernel.py``), so each stays one node of the program and runs its
kernel on the card, its plain version on the CPU.

Artifact format (``.aytx``): a zip holding

- ``model.<platform>.pt2``: ``torch.export.save`` of the program traced for
  that platform (``cuda``, ``cpu``);
- ``meta.json``: the JAX package's keys and layouts (``artifact_version``,
  ``platforms``, ``input_shape`` / ``input_dtype``, flat for one input and a
  list per input for the ``(q, scale)`` pair, ``idx2class_map`` with string
  keys, ``sample_duration``, ``input_sample_rate``) and the exporter's extras.

:func:`load_serving_artifact` needs no model code and no checkpoint: it
imports the kernels' op registrations and nothing of ``models/``.
"""

from __future__ import annotations

import copy
import io
import json
import zipfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import mel_kernel, nms_kernel  # noqa: F401  (registers the kernels' ops)
from .decode import detection_postprocess_graph, pack_detections, unpack_detections

ARTIFACT_VERSION = 1
PLATFORMS = ("cuda", "cpu")
_DTYPES = {"float32": torch.float32, "int16": torch.int16, "int8": torch.int8}


class _PackedInference(torch.nn.Module):
    """The body of ``make_inference_fn(packed=True)`` as a module to export."""

    def __init__(self, model, iou_threshold: float, conf_threshold: float, keep_k: int):
        super().__init__()
        self.model = model
        self.iou_threshold, self.conf_threshold, self.keep_k = (
            float(iou_threshold), float(conf_threshold), int(keep_k))
        self.duration = float(model.cfg.sample_duration)

    def forward(self, *audio):
        x = audio if len(audio) > 1 else audio[0]
        preds = self.model(x, combine_scales=True)
        return pack_detections(detection_postprocess_graph(
            preds, self.iou_threshold, self.conf_threshold, self.duration, self.keep_k))


def _input_specs(model, batch_size: int, input_dtype: str, framed: bool,
                 frame_shape) -> Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]:
    """((shape, dtype), ...) of the entry's inputs, with JAX's rules."""
    if input_dtype == "int8":
        if not framed or frame_shape is None:
            raise ValueError("input_dtype='int8' is the framed (q, scale) "
                             "entry — pass framed=True and frame_shape")
        return ((batch_size, *frame_shape), torch.int8), ((batch_size,), torch.float32)
    if input_dtype not in ("float32", "int16"):
        raise ValueError(f"input_dtype must be float32, int16 or int8, got {input_dtype!r}")
    if framed:
        if frame_shape is None:
            raise ValueError("framed export needs frame_shape (n_ph, n_groups, frame_len)")
        shape = (batch_size, *frame_shape)
    else:
        shape = (batch_size, 1, int(model.cfg.clip_samples))
    return ((shape, _DTYPES[input_dtype]),)


def build_serving_exported(
    model,
    state_dict: Dict[str, torch.Tensor],
    batch_size: int,
    *,
    iou_threshold: float = 0.1,
    conf_threshold: float = 0.2,
    keep_k: int = 128,
    input_dtype: str = "float32",
    framed: bool = False,
    frame_shape: Optional[Tuple[int, int, int]] = None,
    platforms: Sequence[str] = PLATFORMS,
) -> Dict[str, "torch.export.ExportedProgram"]:
    """Export the packed inference function: ``{platform: ExportedProgram}``.

    ``model`` is normally the ``deploy=True`` model (with the int8 scales of
    ``models/quant.py::set_quant`` for the int8 body); ``state_dict`` its
    folded weights. ``input_dtype``: ``"float32"`` or ``"int16"`` (the PCM16
    waveform or frames, dequantized in the program), or ``"int8"`` with
    ``framed=True``: the ``(q int8 frames, per-clip float32 scale)`` entry of
    ``frame_host_int8``. ``framed=True`` exports the phase-grouped frames
    entry (``frame_shape`` = (n_ph, n_groups, frame_len) of
    ``SpectralFrontend.fused``) in place of the (B, 1, clip_samples)
    waveform. Each platform is traced on its device; ``cuda`` without a
    card raises.
    """
    specs = _input_specs(model, batch_size, input_dtype, framed, frame_shape)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"platforms must be among {PLATFORMS}, got {tuple(platforms)}")
    model.load_state_dict(state_dict)
    model.eval()
    programs = {}
    for platform in platforms:
        dev = resolve_device(platform)
        # a copy per platform: a program keeps the tensors it was traced with
        module = _PackedInference(copy.deepcopy(model).to(dev), iou_threshold, conf_threshold,
                                  keep_k).eval()
        args = tuple(torch.zeros(shape, dtype=dt, device=dev) for shape, dt in specs)
        with torch.no_grad():
            programs[platform] = torch.export.export(module, args)
    return programs


def save_serving_artifact(
    path: str,
    exported: Dict[str, "torch.export.ExportedProgram"],
    *,
    idx2class_map: Dict[int, str],
    sample_duration: float,
    input_sample_rate: int,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> None:
    """Write the ``.aytx`` zip (one program per platform + JSON metadata)."""
    first = next(iter(exported.values()))
    inputs = [spec.arg.name for spec in first.graph_signature.input_specs
              if spec.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    nodes = {n.name: n for n in first.graph.nodes if n.op == "placeholder"}
    avals = [nodes[name].meta["val"] for name in inputs]
    dtype_name = {v: k for k, v in _DTYPES.items()}
    meta = {
        "artifact_version": ARTIFACT_VERSION,
        "platforms": list(exported),
        # one entry per input: a single waveform/framed tensor, or the
        # (q int8 frames, f32 scale) pair of the framed-int8 entry
        "input_shape": (list(avals[0].shape) if len(avals) == 1
                        else [list(a.shape) for a in avals]),
        "input_dtype": (dtype_name[avals[0].dtype] if len(avals) == 1
                        else [dtype_name[a.dtype] for a in avals]),
        "idx2class_map": {str(k): v for k, v in idx2class_map.items()},
        "sample_duration": float(sample_duration),
        "input_sample_rate": int(input_sample_rate),
    }
    if extra_meta:
        meta.update(extra_meta)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for platform, program in exported.items():
            blob = io.BytesIO()
            torch.export.save(program, blob)
            # stored: deflate takes seconds per 100 MB of weights and saves little
            z.writestr(f"model.{platform}.pt2", blob.getvalue(), zipfile.ZIP_STORED)
        z.writestr("meta.json", json.dumps(meta, indent=1))
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def _input_signature(meta: Dict[str, Any]):
    """[(shape, dtype name), ...] of the artifact's inputs."""
    shapes, dtypes = meta["input_shape"], meta["input_dtype"]
    if isinstance(dtypes, str):
        return [(tuple(shapes), dtypes)]
    return [(tuple(s), d) for s, d in zip(shapes, dtypes)]


def _without_metadata_asserts(program: torch.fx.GraphModule) -> torch.fx.GraphModule:
    """Drop the ``aten._assert_tensor_metadata`` nodes ``torch.export`` puts
    before each dtype conversion. They launch nothing, but each is a host
    call on every run; the dtypes they check follow from the inputs', which
    ``infer_fn`` checks."""
    check = torch.ops.aten._assert_tensor_metadata.default
    for node in [n for n in program.graph.nodes if n.target is check and not n.users]:
        program.graph.erase_node(node)
    program.recompile()
    return program


def load_serving_artifact(
    path: str, device: DeviceLike = None,
) -> Tuple[Callable[[Any], Dict[str, np.ndarray]], Dict[str, Any]]:
    """Load an ``.aytx`` artifact -> ``(infer_fn, meta)``.

    ``device=None`` means the card; the device's type must be one of
    ``meta["platforms"]``. ``infer_fn(audio)`` takes a numpy array or a
    tensor (or the ``(q, scale)`` pair), checks each input's shape and dtype
    against ``meta`` (``ValueError`` on a mismatch), runs the program on the
    device and returns the unpacked detections dict of numpy arrays. No
    model code or checkpoint is touched: the weights live in the program.
    """
    dev = resolve_device(device)
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        if "model.stablehlo" in names:
            raise ValueError(f"{path} is the JAX package's artifact (a StableHLO program); "
                             "load it with audioyolo_tpu.infer.export.load_serving_artifact")
        meta = json.loads(z.read("meta.json"))
        ver = meta.get("artifact_version")
        if ver != ARTIFACT_VERSION:
            raise ValueError(
                f"unsupported artifact version {ver!r} (this loader handles "
                f"{ARTIFACT_VERSION}) — re-export with python -m audioyolo_tpu_torch.export_cli"
            )
        if dev.type not in meta["platforms"]:
            raise ValueError(f"the artifact holds programs for {meta['platforms']}, "
                             f"not for {dev.type}")
        blob = z.read(f"model.{dev.type}.pt2")
    meta["idx2class_map"] = {int(k): v for k, v in meta["idx2class_map"].items()}
    program = _without_metadata_asserts(torch.export.load(io.BytesIO(blob)).module())
    signature = _input_signature(meta)

    def infer_fn(audio) -> Dict[str, np.ndarray]:
        parts = audio if isinstance(audio, (tuple, list)) else (audio,)
        if len(parts) != len(signature):
            raise ValueError(f"the artifact takes {len(signature)} input(s), got {len(parts)}")
        args = []
        for i, (x, (shape, dtype)) in enumerate(zip(parts, signature)):
            t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
            if tuple(t.shape) != shape or t.dtype != _DTYPES[dtype]:
                raise ValueError(f"input {i} must be {list(shape)} {dtype}, got "
                                 f"{list(t.shape)} {str(t.dtype).replace('torch.', '')}")
            args.append(t.to(dev))
        with torch.inference_mode():  # the loaded weights require grad
            packed = program(*args)
        return unpack_detections(packed.cpu().numpy())

    infer_fn.program = program  # the loaded module: device tensors in, packed tensor out
    return infer_fn, meta

"""Directory inference, as ``python -m audioyolo_tpu_torch.inference_cli
--audio_dir D --bf16`` runs it in one process: ``build_worker`` makes the
inference function from a checkpoint, and ``infer.runner.evaluate_dir``
writes one CSV per file. The window runs whole passes over the directory,
closed loop, each pass overwriting the CSVs.

``card_busy_s_per_audio_h`` is the card's busy time over the whole window
(the union of its operations, from a profile of the card alone) per hour
of the audio of every pass; ``audio_s_per_s.batch`` (per layer) is that
audio over the time from the window's start to the end of its last pass,
on the host's clock, which follows the host's own pace.

Correctness: every window of the
last pass, and 32 windows of an earlier pass drawn from the seed, are held to
the plain reference by ``conf_gap_rel`` and ``time_gap_rel`` (the rows'
confidences and times), ``nms_wrong`` (the row set, decision by decision)
and ``empty_windows`` (``reference/detections.py``); every CSV of the last
pass must be what the reference's writer makes of the program's own rows
(``csv_mismatch``). The comparison leaves out the windows
that end in a zero-padded tail (a file's last window): there the MFCC
channel is the second dB map of rounding noise, which any two
implementations read differently (``PERF.md``); their rows still go into
the CSVs that ``csv_mismatch`` checks.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import common
from perfbench.count import mel_kernel, model_flops
from perfbench.reference import detections as D
from perfbench.reference.frontend import n_frames
from perfbench.traffic import files

KERNEL1 = ("stage_frames_kernel", "mel_power_kernel")


# the numbers of ``D.compare_windows`` that decide ``correct``: these
# against the cell's limits, the counts against 0
RATIOS = ("conf_gap_rel", "time_gap_rel", "nms_wrong_pct")
COUNTS = ("empty_windows",)
COMPARED = RATIOS + COUNTS

# the program's lower-precision postures (the control is ``int8_transfer``,
# ``inference_cli --int8 --transfer int8``), and faults planted in the
# program's NMS for the reading above ``nms_wrong_pct``'s limit: its own
# options with NMS off (``--iou_threshold 1``) or no confidence threshold,
# and every other row of each window dropped from its output
CONTROLS = {"int8": dict(int8=True),
            "int8_transfer": dict(int8=True, transfer="int8"),
            "nms_off": dict(iou=1.0),
            "no_threshold": dict(conf=0.0),
            "rows_dropped": dict(wrap=True)}


def drop_rows(out: torch.Tensor) -> torch.Tensor:
    """Every other row of each window of a packed output dropped."""
    out = out.clone()
    valid = out[..., 5] > 0.5
    out[..., 5][valid & (valid.cumsum(dim=-1) % 2 == 0)] = 0.0
    return out


class Setup:
    def __init__(self, ctx, control: Optional[str] = None):
        clock = common.Clock()
        cfg, t = ctx.cfg, ctx.mix
        self.rate = int(cfg["sample_rate"])
        self.duration = float(cfg["sample_duration"])
        self.window = int(round(self.duration * self.rate))
        self.batch = int(cfg["train_config"]["batch_size"])
        self.iou, self.conf = float(t["iou_threshold"]), float(t["conf_threshold"])
        self.keep = int(cfg["tpu_config"]["nms_keep"])
        lens = files.lengths(t["files"], ctx.seed, self.rate)
        self.audio_dir = os.path.join(ctx.tmp, "audio")
        clips = files.audio(lens, ctx.seed, self.rate, ctx.device)
        clock.lap("audio")
        self.paths = files.write_dir(self.audio_dir, clips, self.rate)
        del clips
        clock.lap("files")
        self.out_dir = os.path.join(ctx.tmp, "csv")
        # windows in the order evaluate_dir batches them: files sorted by
        # name, each file's windows in time order
        self.windows = [(p, k * self.window, n) for p, n in sorted(zip(self.paths, lens))
                        for k in range(math.ceil(n / self.window))]
        self.audio_s = sum(lens) / self.rate
        self.sd, model_path, cmap = common.checkpoint(ctx)
        clock.lap("weights")
        from audioyolo_tpu_torch.inference_cli import build_worker

        c = CONTROLS[control] if control else {}
        transfer = c.get("transfer", "int16")
        self.infer_fn, self.frame_fn = build_worker(
            cfg, model_path, cmap, c.get("iou", self.iou), c.get("conf", self.conf),
            bf16=bool(t["bf16"]), int8_calib_path=self.paths[0] if c.get("int8") else None,
            transfer=transfer, device=ctx.device)
        self.wrap = drop_rows if c.get("wrap") else None
        self.kwargs = dict(input_sample_rate=self.rate, sample_duration=self.duration,
                           batch_size=self.batch, idx2class_map=common.CLASSES,
                           frame_fn=self.frame_fn, transfer=transfer)
        self.num_concurrency = int(t["num_concurrency"])
        clock.lap("build_worker")
        # the files and the checkpoint written above reach the disk now, not
        # by writeback during the window
        os.sync()
        clock.lap("sync")
        self.clock = clock

    def one_pass(self, ctx, wrap=None) -> List[torch.Tensor]:
        """One ``evaluate_dir`` over the directory; the program's packed
        outputs, batch by batch. ``wrap`` (the fault tests) replaces the
        inference function's output."""
        from audioyolo_tpu_torch.infer.runner import evaluate_dir

        outs: List[torch.Tensor] = []

        def infer(x):
            with ctx.tracer.span("pb.batch_dir.infer_fn"):
                out = self.infer_fn(x)
            if wrap is not None:
                out = wrap(out)
            outs.append(out)
            return out

        infer.device = self.infer_fn.device
        with ctx.tracer.span("pb.batch_dir.evaluate_dir"):
            evaluate_dir(infer, self.audio_dir, self.out_dir, extension="wav",
                         num_concurrency=self.num_concurrency, verbose=False, **self.kwargs)
        return outs

    def rows(self, outs: List[torch.Tensor]) -> List[List[tuple]]:
        packed = torch.cat([o.float().cpu() for o in outs]).numpy()[: len(self.windows)]
        return D.unpack(packed, self.duration)

    def csv_mismatch(self, rows: List[List[tuple]]) -> int:
        per_file: Dict[str, List[tuple]] = {}
        for (path, start, _), win in zip(self.windows, rows):
            base = (start // self.window) * self.duration
            per_file.setdefault(path, []).extend(
                (c, k, base + s, base + e) for c, k, s, e in win)
        bad = 0
        for path in self.paths:
            name = os.path.splitext(os.path.basename(path))[0]
            out = os.path.join(self.out_dir, os.path.basename(self.audio_dir),
                               f"{name}_results.csv")
            want = D.csv_text(per_file.get(path, []), common.CLASSES)
            try:
                with open(out) as f:
                    bad += f.read() != want
            except OSError:
                bad += 1
        return bad

    def compare(self, ctx, passes: List[List[torch.Tensor]],
                witness: bool = False) -> Dict[str, float]:
        """The reference over every whole window of the last pass, and over
        32 of them in an earlier pass drawn from the seed; the numbers of
        the two, the wider kept."""
        whole = [i for i, (_, s, n) in enumerate(self.windows) if n - s >= self.window]
        ref = common.Reference(ctx, self.sd, self.batch)
        last = self.rows(passes[-1])
        got = ref.compare([last[i] for i in whole], [self.windows[i][:2] for i in whole],
                          self.iou, self.conf, self.keep, witness)
        if len(passes) > 1:
            rng = np.random.default_rng([ctx.seed, 4])
            earlier = self.rows(passes[int(rng.integers(0, len(passes) - 1))])
            pick = [whole[i] for i in np.sort(rng.choice(len(whole), min(32, len(whole)),
                                                         False))]
            more = ref.compare([earlier[i] for i in pick], [self.windows[i][:2] for i in pick],
                               self.iou, self.conf, self.keep)
            got.update({k + "_earlier": v for k, v in more.items() if k in COMPARED})
        got["csv_mismatch"] = self.csv_mismatch(last)
        got["windows_compared"], got["windows_padded"] = len(whole), len(self.windows) - len(whole)
        return got


def checks(got: Dict, limits: Dict) -> Dict[str, tuple]:
    """(value, limit) of each compared number: the last pass's and the
    earlier pass's, the worse of the two; and the CSVs."""
    out = {k: (max(got[k], got.get(k + "_earlier", 0.0)), limits[k]) for k in RATIOS}
    out.update({k: (got[k] + got.get(k + "_earlier", 0), 0) for k in COUNTS})
    out["csv_mismatch"] = (got["csv_mismatch"], 0)
    return out


def window(ctx, setup: Setup, wrap=None):
    """Closed-loop passes until ``ctx.seconds`` have gone; the traced run
    profiles whole passes from the second on, about two seconds of them,
    and the untraced run the card alone over the whole window."""
    passes: List[List[torch.Tensor]] = []
    times: List[float] = []
    traced = 0
    slice_cm: Optional[contextlib.ExitStack] = None
    with ctx.tracer.card(ctx.device):
        t0 = time.perf_counter()
        while True:
            if ctx.tracer.on and len(passes) == 1:
                slice_cm = contextlib.ExitStack()
                slice_cm.enter_context(ctx.tracer.slice())
                ts = time.perf_counter()
            tp = time.perf_counter()
            passes.append(setup.one_pass(ctx, wrap))
            times.append(time.perf_counter() - tp)
            if slice_cm is not None:
                traced += 1
                if time.perf_counter() - ts >= 2.0:
                    slice_cm.close()
                    slice_cm = None
            if time.perf_counter() - t0 >= ctx.seconds and slice_cm is None:
                break
        elapsed = time.perf_counter() - t0
    q = np.percentile(times, [0, 25, 50, 75, 100])
    print("perfbench: batch_dir pass_s min/q1/median/q3/max " + " ".join(f"{v:.4f}" for v in q),
          file=sys.stderr)
    return passes, elapsed, traced


def card_busy(ctx, passes: List[List[torch.Tensor]], audio_h: float) -> Dict[str, float]:
    """``card_busy_s_per_audio_h`` of the untraced run's whole window (none
    on the CPU or when traced). Kernel 1 runs once a batch: a profile that
    holds fewer of its launches than the window ran batches dropped
    operations, and the run stops."""
    got = ctx.tracer.card_summary
    if got is None:
        return {}
    launches = sum(n for name, n in got["counts"].items() if KERNEL1[-1] in name)
    batches = sum(len(p) for p in passes)
    if launches != batches:
        raise RuntimeError(f"the card's profile holds {launches} launches of {KERNEL1[-1]} "
                           f"for the window's {batches} batches")
    print(f"perfbench: batch_dir card busy_s={got['busy_s']!r} batches={batches} "
          f"ops={sum(got['counts'].values())}", file=sys.stderr)
    return {"card_busy_s_per_audio_h": got["busy_s"] / audio_h}


def readings(ctx, control: Optional[str] = None) -> Dict:
    """The compared numbers of one pass at the cell's own load, for setting
    limits: the program, or the program as ``CONTROLS`` names it, with the
    yardstick's own ``nms_wrong_pct`` beside them."""
    setup = Setup(ctx, control)
    setup.one_pass(ctx, setup.wrap)
    return setup.compare(ctx, [setup.one_pass(ctx, setup.wrap)], witness=True)


def run(ctx, wrap=None) -> Dict:
    setup = Setup(ctx)
    setup.one_pass(ctx)  # warm-up: builds and loads the kernels, every shape once
    setup.clock.lap("warm_pass")
    setup_s = ctx.setup_s()
    setup.clock.report("batch_dir", setup_s)
    passes, elapsed, traced = window(ctx, setup, wrap)
    peak = common.peak_bytes(ctx.device)
    got = setup.compare(ctx, passes)
    n = len(setup.windows)
    rows = sorted(int((torch.cat(p)[:n, :, 5] > 0.5).sum()) for p in passes)
    print(f"perfbench: batch_dir rows_per_pass min/median/max {rows[0]} {rows[len(rows) // 2]} "
          f"{rows[-1]}", file=sys.stderr)
    print("perfbench: batch_dir " + " ".join(f"{k}={v!r}" for k, v in got.items()
                                             if not k.startswith("_"))
          + f" passes={len(passes)} windows={len(setup.windows)}", file=sys.stderr)
    shape = mel_kernel.bound(setup.batch * n_frames(ctx.cfg),
                             int(ctx.cfg["melspectrogram_config"]["n_fft"]),
                             int(ctx.cfg["melspectrogram_config"]["n_fft"]) // 2 + 1,
                             int(ctx.cfg["melspectrogram_config"]["n_mels"]), 4)
    audio_s = len(passes) * setup.audio_s
    return {
        "metrics": {"setup_s": setup_s, **card_busy(ctx, passes, audio_s / 3600.0)},
        "attempted": len(passes) * len(setup.windows),
        "failed": 0,
        "checks": checks(got, ctx.limits),
        "memory_peak_bytes": peak,
        "facts": {"flops": model_flops.forward_flops_per_window(ctx.cfg, len(common.CLASSES))
                  * len(setup.windows) * traced,
                  "mel_bound_s": shape["seconds"], "kernel1": KERNEL1,
                  "audio_s_per_s": audio_s / elapsed},
    }

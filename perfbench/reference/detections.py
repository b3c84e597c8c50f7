"""Plain detection rows, CSVs and JSON from dense predictions, and the
comparison that decides ``correct`` for the inference cells.

Rows follow the reference repository: confidence = sigmoid(objectness) x
the largest class probability; greedy 1-D NMS in descending confidence
(a kept interval suppresses every later one whose IoU is strictly above the
threshold); the confidence filter; at most ``keep`` rows a window; start and
end = center -/+ width/2 clipped to the window, ordered by center; offsets of
60 s per window; rows sorted by (start, end), times rounded to 0.01 s, and
same-class neighbours merged (class adjacency only).
"""

from __future__ import annotations

import csv
import io
import math
from datetime import timedelta
from typing import Dict, List, Sequence

import numpy as np
import torch


CONF_MARGIN = 0.05
# a proposal's edges move by the error in its width logit times its anchor,
# so a long row's edges move further: under a bf16 body up to 0.20 s for rows
# of 10-60 s on an H100, 0.95 % of the row's length; where a nearer proposal
# stands beside it, a fixed 0.1 s would match the row to that one
REL_TOL = 0.02
GAP_CAP = 0.01
TIME_CAP = 0.1
DECISION_MARGINS = (0.05, 0.01)  # confidence, IoU


def confidences(preds: torch.Tensor) -> torch.Tensor:
    """(B, K, 3 + C) -> (B, K, C): sigmoid(objectness) x softmax(classes)."""
    return torch.sigmoid(preds[..., :1]) * torch.softmax(preds[..., 1:-2], dim=-1)


def greedy_keep(x1: np.ndarray, x2: np.ndarray, thr: float) -> np.ndarray:
    """Greedy NMS over score-ordered intervals of one window (float32)."""
    x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
    w = np.maximum(x2 - x1, np.float32(0))
    alive = np.ones(x1.shape[0], bool)
    for i in range(x1.shape[0]):
        if not alive[i]:
            continue
        inter = np.maximum(np.minimum(x2[i], x2[i + 1:]) - np.maximum(x1[i], x1[i + 1:]),
                           np.float32(0))
        iou = inter / np.maximum(w[i] + w[i + 1:] - inter, np.float32(1e-12))
        alive[i + 1:] &= ~(iou > np.float32(thr))
    return alive


def window_rows(preds: torch.Tensor, iou: float, conf_thr: float, keep: int,
                duration: float) -> List[List[tuple]]:
    """Per window, rows ``(confidence, class, start, end)`` ordered by center."""
    conf_c = confidences(preds)
    conf, cls = conf_c.max(dim=-1)
    p = preds.cpu().numpy()
    conf, cls = conf.cpu().numpy(), cls.cpu().numpy()
    out = []
    for b in range(p.shape[0]):
        c, w = p[b, :, -2], p[b, :, -1]
        x1 = np.clip(c - w / np.float32(2), 0, duration)
        x2 = np.clip(c + w / np.float32(2), 0, duration)
        order = np.argsort(-conf[b], kind="stable")
        alive = greedy_keep(x1[order], x2[order], iou) & (conf[b][order] > np.float32(conf_thr))
        kept = order[alive][:keep]
        kept = kept[np.argsort(c[kept], kind="stable")]
        out.append([(float(conf[b, j]), int(cls[b, j]), float(x1[j]), float(x2[j]))
                    for j in kept])
    return out


def _fmt(seconds: float) -> str:
    td = timedelta(seconds=round(seconds, 2))
    h, rem = divmod(td.seconds, 3600)
    m, s = divmod(rem, 60)
    text = f"{td.days} days {h:02d}:{m:02d}:{s:02d}"
    return text + (f".{td.microseconds:06d}" if td.microseconds else "")


def rle(rows: Sequence[tuple], classes: Dict[int, str]) -> List[list]:
    """Rows ``(confidence, class, start, end)`` in the order given ->
    ``[start, end, class name]`` events, times rounded to 10 ms, neighbours
    of one class merged (class adjacency only)."""
    events: List[list] = []
    for _, c, s, e in rows:
        s, e, name = round(s, 2), round(e, 2), classes[c]
        if events and events[-1][2] == name:
            events[-1][1] = e
        else:
            events.append([s, e, name])
    return events


def merged_events(rows: Sequence[tuple], classes: Dict[int, str]) -> List[list]:
    """File rows with global times -> events: sorted by (start, end), then
    :func:`rle`."""
    return rle(sorted(rows, key=lambda r: (r[2], r[3])), classes)


def csv_text(rows: Sequence[tuple], classes: Dict[int, str]) -> str:
    """The ``<name>_results.csv`` a directory run writes for these rows."""
    f = io.StringIO()
    w = csv.writer(f, lineterminator="\n")
    w.writerow(["start", "end", "class"])
    for s, e, name in merged_events(rows, classes):
        w.writerow([_fmt(s), _fmt(e), name])
    return f.getvalue()


def match(rows: Sequence[tuple], preds: torch.Tensor, duration: float, tol: float = 0.1):
    """For each program row ``(confidence, class, start, end)`` of one
    window: the reference proposal it stands for, and the confidence gap
    (|program confidence - the reference's confidence of the program's
    class|) there. That is, of the proposals whose start and end both lie
    within ``tol`` of the row's, or within ``REL_TOL`` of the row's length
    where that is more, the one whose confidence is closest (times move by
    a few tens of ms between two implementations, and proposals lie closer
    than that); the nearest one where none does."""
    if not rows:
        return np.zeros(0, np.int64), np.zeros(0)
    conf_c = confidences(preds.double()).cpu().numpy()
    x1, x2 = _edges(preds, duration)
    idx, cg = [], []
    for conf, cls, s, e in rows:
        d = np.maximum(np.abs(x1 - s), np.abs(x2 - e))
        near = np.nonzero(d <= max(tol, REL_TOL * (e - s), d.min()))[0]
        gaps = np.abs(conf_c[near, cls] - conf)
        j = int(np.argmin(gaps))
        idx.append(int(near[j]))
        cg.append(float(gaps[j]))
    return np.asarray(idx, np.int64), np.asarray(cg)


def keep_gaps(kept_prog: set, preds: torch.Tensor, iou_thr: float, conf_thr: float,
              duration: float) -> np.ndarray:
    """How far each keep-or-drop decision of the program's NMS in one
    window is from one that greedy NMS could make on the reference's
    numbers: an (N, 3) array of (kept, confidence gap, IoU gap), one row a
    proposal. Proposals are taken in the reference's order of confidence,
    each judged against the program's own earlier decisions, so a swap does
    not cascade. ``kept_prog``: the proposals the program's rows stand for
    (:func:`match`). A decision is wrong (:func:`wrong_decisions`)

    - kept: where its confidence falls short of the threshold by more than
      the confidence margin, or its IoU with an earlier kept proposal
      exceeds the IoU threshold by more than the IoU margin (the two gaps);
    - dropped: where both gaps exceed their margins. The confidence gap is
      the least of its margin over the threshold and its lead over a later
      kept proposal that overlaps it past the threshold (a swap of rank);
      the IoU gap is the shortfall of the largest IoU with an earlier kept
      proposal (infinite where none overlaps; 0 where one overlaps past
      the threshold, so that both gaps are then 0).
    """
    p = preds.double()
    conf = confidences(p).max(dim=-1).values.cpu().numpy()
    x1, x2 = _edges(p, duration)
    w = np.maximum(x2 - x1, 0)

    def iou(i, js):
        inter = np.maximum(np.minimum(x2[i], x2[js]) - np.maximum(x1[i], x1[js]), 0)
        return inter / np.maximum(w[i] + w[js] - inter, 1e-12)

    order = np.argsort(-conf, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    later_kept = np.array(sorted(kept_prog, key=lambda j: rank[j]), dtype=np.int64)
    kept: List[int] = []
    gaps = []
    for i in order:
        ov = float(iou(i, np.asarray(kept, np.int64)).max()) if kept else 0.0
        if i in kept_prog:
            gaps.append((1.0, max(conf_thr - conf[i], 0.0), max(ov - iou_thr, 0.0)))
            kept.append(int(i))
            continue
        if ov > iou_thr:
            gaps.append((0.0, 0.0, 0.0))
            continue
        gc = max(conf[i] - conf_thr, 0.0)
        lk = later_kept[rank[later_kept] > rank[i]]
        if lk.size:
            o = iou(i, lk)
            if (o > iou_thr).any():
                gc = min(gc, max(float((conf[i] - conf[lk[o > iou_thr]]).min()), 0.0))
        gaps.append((0.0, gc, iou_thr - ov if ov > 0 else np.inf))
    return np.asarray(gaps).reshape(-1, 3)


def wrong_decisions(gaps: np.ndarray, conf_margin: float, iou_margin: float) -> int:
    """The decisions of :func:`keep_gaps` that no greedy NMS on the
    reference's numbers could make within the two margins."""
    kept = gaps[:, 0] > 0.5
    over_c, over_i = gaps[:, 1] > conf_margin, gaps[:, 2] > iou_margin
    return int((kept & (over_c | over_i)).sum() + (~kept & over_c & over_i).sum())


def time_gaps(rows: Sequence[tuple], idx: np.ndarray, preds: torch.Tensor,
              duration: float) -> np.ndarray:
    """For each program row ``(confidence, class, start, end)``: the larger
    of its start and end gaps (s) to the proposal ``idx`` says it stands for."""
    if not len(rows):
        return np.zeros(0)
    x1, x2 = _edges(preds, duration)
    s = np.asarray([r[2] for r in rows])
    e = np.asarray([r[3] for r in rows])
    return np.maximum(np.abs(x1[idx] - s), np.abs(x2[idx] - e))


def _edges(preds: torch.Tensor, duration: float):
    q = preds.double().cpu().numpy()
    return (np.clip(q[:, -2] - q[:, -1] / 2, 0, duration),
            np.clip(q[:, -2] + q[:, -1] / 2, 0, duration))


def compare_windows(program: Sequence[Sequence[tuple]], preds: torch.Tensor,
                    reference: Sequence[Sequence[tuple]], iou_thr: float, conf_thr: float,
                    duration: float, tol: float = 0.1, yard=None,
                    witness: bool = False) -> Dict[str, float]:
    """The program's rows of a set of windows against the reference.

    Compared (``yard``, the yardstick's predictions of the same windows, is
    needed for the two ratios):

    - ``conf_gap_rel``: the mean confidence gap of the program's rows
      (:func:`match`) over the mean gap of the yardstick's confidence of the
      same class at the very proposals those rows stand for, each row's gap
      capped at ``GAP_CAP`` on both sides. About 1 where the program
      departs from float32 as a bf16 body does, whatever this seed's network
      makes of a rounding; the cap keeps a few rows that a near tie moves
      from outweighing the thousands that it does not.
    - ``time_gap_rel``: the same for the rows' start and end times (the
      larger gap of the two, capped at ``TIME_CAP`` s).
    - ``nms_wrong_pct``: keep-or-drop decisions (:func:`keep_gaps`) that
      no greedy NMS on the reference's numbers could make within
      ``DECISION_MARGINS`` (a row kept below the confidence threshold or
      over an earlier row past the IoU threshold, or a proposal dropped
      that stands clear of both), per 100 reference rows. This holds the
      row set: NMS skipped, rows dropped or the threshold ignored. It is a
      share and not a count held to 0, because a few proposals of some
      seeds' networks move by 0.1 in confidence or time under any bf16
      body, the yardstick's too (``witness``: ``yard_nms_wrong_pct``, the
      yardstick's own rows judged alike).
    - ``empty_windows``: windows where the program answers nothing though
      a reference row stands ``CONF_MARGIN`` or more above the threshold.

    For the record: ``nms_wrong`` (the count), ``conf_gap_mean``,
    ``conf_gap_max``, ``time_gap_s`` (the widest time gap) and
    ``count_gap`` (sum of |program rows - reference rows| over the
    reference's rows)."""
    tg, cg, kg, yg, yt, diff, total, empty = [], [], [], [], [], 0, 0, 0
    for b, rows in enumerate(program):
        idx, c = match(rows, preds[b], duration, tol)
        tg.extend(time_gaps(rows, idx, preds[b], duration).tolist())
        cg.extend(c.tolist())
        kg.append(keep_gaps(set(idx.tolist()), preds[b], iou_thr, conf_thr, duration))
        if yard is not None and len(rows):
            cls = torch.tensor([r[1] for r in rows])
            ref_c = confidences(preds[b].double())[idx, cls]
            yg.extend((confidences(yard[b].double())[idx, cls] - ref_c).abs().tolist())
            (x1, x2), (y1, y2) = _edges(preds[b], duration), _edges(yard[b], duration)
            yt.extend(np.maximum(np.abs(y1 - x1), np.abs(y2 - x2))[idx].tolist())
        empty += not rows and any(r[0] >= conf_thr + CONF_MARGIN for r in reference[b])
        diff += abs(len(rows) - len(reference[b]))
        total += len(reference[b])
    kg = np.concatenate(kg) if kg else np.zeros((0, 3))
    got = {"empty_windows": empty, "nms_wrong": wrong_decisions(kg, *DECISION_MARGINS),
           "conf_gap_mean": float(np.mean(cg or [0.0])), "conf_gap_max": max(cg or [0.0]),
           "time_gap_s": max(tg or [0.0]),
           "count_gap": diff / max(total, 1), "rows": total, "windows": len(program)}
    if yard is not None:
        got["yard_gap_mean"] = _capped_mean(yg, GAP_CAP)
        got["conf_gap_rel"] = _capped_mean(cg, GAP_CAP) / max(got["yard_gap_mean"], 1e-9)
        got["yard_time_gap_mean"] = _capped_mean(yt, TIME_CAP)
        got["time_gap_rel"] = _capped_mean(tg, TIME_CAP) / max(got["yard_time_gap_mean"], 1e-9)
    got["nms_wrong_pct"] = 100.0 * got["nms_wrong"] / max(total, 1)
    if witness and yard is not None:
        rows = window_rows(yard, iou_thr, conf_thr, yard.shape[1], duration)
        wrong = sum(wrong_decisions(keep_gaps(set(match(r, preds[b], duration, tol)[0].tolist()),
                                              preds[b], iou_thr, conf_thr, duration),
                                    *DECISION_MARGINS) for b, r in enumerate(rows))
        got["yard_nms_wrong_pct"] = 100.0 * wrong / max(total, 1)
    return got


def _capped_mean(gaps: Sequence[float], cap: float) -> float:
    return float(np.minimum(np.asarray(gaps or [0.0]), cap).mean())


def unpack(packed: np.ndarray, duration: float) -> List[List[tuple]]:
    """A (B, K, 6) packed program output -> rows per window as the port's
    host decode makes them (valid rows, ordered by center)."""
    out = []
    for win in packed:
        v = win[win[:, 5] > 0.5]
        v = v[np.argsort(v[:, 3], kind="stable")]
        out.append([(float(r[0]), int(r[2]),
                     min(max(float(r[3]) - float(r[4]) / 2.0, 0.0), duration),
                     min(max(float(r[3]) + float(r[4]) / 2.0, 0.0), duration)) for r in v])
    return out


def windows_of(frames: int, window: int) -> int:
    return int(math.ceil(frames / window))

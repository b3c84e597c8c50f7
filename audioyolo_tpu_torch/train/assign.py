"""Static-shape YOLO target assignment (port of
``audioyolo_tpu/train/assign.py``).

Every ``(batch, target_slot, anchor, offset)`` combination is one candidate
pair with a validity flag, so the loss sees one shape ``(B, N, A, 3)``
whatever the number of targets. The reference's semantics are kept:

- anchor gate ``max(w/a, a/w) < anchor_t``;
- fractional cell ``grid_c = center / duration * G``; a pair also goes to
  the left neighbour when ``grid_c % 1 < edge_t`` and ``grid_c > 1``, and to
  the right one when ``grid_i % 1 < edge_t`` and ``grid_i > 1`` with
  ``grid_i = G - grid_c``;
- cell ``int(grid_c + offset)``, truncated, then clipped to ``[0, G-1]``,
  with offsets 0, -edge_t and +edge_t.

Assignment uses the config anchors (seconds), not the learned ones, as the
reference's loss does.
"""

from __future__ import annotations

from typing import Dict

import torch


def assign_targets_to_scale(classes: torch.Tensor, centers: torch.Tensor, widths: torch.Tensor,
                            valid: torch.Tensor, grid_size: int, anchors: torch.Tensor,
                            anchor_threshold: float = 4.0, edge_threshold: float = 0.5,
                            sample_duration: float = 60.0) -> Dict[str, torch.Tensor]:
    """Dense candidate pairs for one detection scale.

    ``classes`` (B, N) int, ``centers``/``widths`` (B, N) float32 seconds,
    ``valid`` (B, N) bool, ``anchors`` (A,) float32 seconds. Returns ``cell``
    (B, N, A, 3) int64 and ``pair_valid`` (B, N, A, 3) bool; the last axis is
    the offset slot {same cell, left, right}.
    """
    b, n = classes.shape
    a = anchors.shape[0]

    ratio = widths[:, :, None] / anchors[None, None, :]
    ratio_ok = torch.maximum(ratio, 1.0 / ratio) < anchor_threshold  # (B, N, A)

    grid_c = (centers / sample_duration) * grid_size  # (B, N)
    grid_i = grid_size - grid_c
    c_mask = (torch.remainder(grid_c, 1.0) < edge_threshold) & (grid_c > 1.0)
    i_mask = (torch.remainder(grid_i, 1.0) < edge_threshold) & (grid_i > 1.0)
    offset_ok = torch.stack([torch.ones_like(c_mask), c_mask, i_mask], dim=-1)  # (B, N, 3)
    pair_valid = valid[:, :, None, None] & ratio_ok[:, :, :, None] & offset_ok[:, :, None, :]
    # grid_c + (0, -edge_t, +edge_t), rounded as the float32 sums are
    cell_f = torch.stack([grid_c, grid_c - edge_threshold, grid_c + edge_threshold],
                         dim=-1)[:, :, None, :]
    # truncation toward zero (torch ``.long()``): cell_f >= 0 on every live
    # pair, where it equals the floor; then the clip
    cell = torch.clamp(cell_f.to(torch.int64), 0, grid_size - 1).expand(b, n, a, 3)
    return {"cell": cell, "pair_valid": pair_valid}

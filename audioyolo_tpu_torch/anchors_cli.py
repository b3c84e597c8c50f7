"""Anchor prior fitting (port of the root ``compute_anchors.py``).

Usage::

    python -m audioyolo_tpu_torch.anchors_cli --annotations_path ANN.json \\
        [--annotator annotator_a] [--config config/config.yaml]

Collects every annotated event duration (flat or grouped layout), clusters
them into 9 centres with a seeded 1-D k-means, sorts and splits them 3/3/3
into the sm/md/lg anchors, and writes those back into the YAML config. Runs
on the host: there is no device work.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .config import set_config_anchors
from .data.dataset import AudioDataset
from .ops.kmeans import kmeans_1d

SEED = 42
NUM_CLUSTERS = 9


def collect_durations(annotations) -> np.ndarray:
    durations = []
    if not AudioDataset.is_grouped_annotations(annotations):
        for segments in annotations.values():
            for seg in segments.values():
                durations.append(seg["end"] - seg["start"])
    else:
        for groups in annotations.values():
            for segments in groups.values():
                for seg in segments.values():
                    durations.append(seg["end"] - seg["start"])
    return np.asarray(durations, np.float64)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Anchor segment generation (PyTorch port)")
    parser.add_argument("--annotations_path", type=str, required=True, metavar="",
                        help="JSON annotations path")
    parser.add_argument("--annotator", type=str, default="annotator_a", metavar="")
    parser.add_argument("--config", type=str, default="config/config.yaml", metavar="")
    parser.add_argument("--init", type=str, default="k-means++",
                        choices=["k-means++", "random"], metavar="")
    parser.add_argument("--n_init", type=int, default=10, metavar="")
    parser.add_argument("--max_iter", type=int, default=500, metavar="")
    parser.add_argument("--tol", type=float, default=1e-10, metavar="")
    args = parser.parse_args(argv)

    with open(args.annotations_path, "r") as f:
        annotations = json.load(f)["annotations"][args.annotator]

    centers, inertia = kmeans_1d(collect_durations(annotations), NUM_CLUSTERS, init=args.init,
                                 n_init=args.n_init, max_iter=args.max_iter, tol=args.tol,
                                 seed=SEED)
    sm, md, lg = centers[:3], centers[3:6], centers[6:]
    set_config_anchors(args.config, sm, md, lg)
    print(f"fitted anchors (inertia {inertia:.4f}):")
    print(f"  sm: {sm.tolist()}\n  md: {md.tolist()}\n  lg: {lg.tolist()}")


if __name__ == "__main__":
    main()

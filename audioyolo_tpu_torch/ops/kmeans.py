"""Small 1-D k-means for anchor prior fitting (a copy of
``audioyolo_tpu/ops/kmeans.py``, which imports no JAX).

Lloyd's algorithm with k-means++ or random initialisation, in numpy on the
host: anchor fitting clusters a few thousand scalar event durations.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _kmeanspp_init(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    centers = np.empty(k, dtype=np.float64)
    centers[0] = x[rng.integers(len(x))]
    d2 = (x - centers[0]) ** 2
    for i in range(1, k):
        probs = d2 / d2.sum() if d2.sum() > 0 else np.full(len(x), 1.0 / len(x))
        centers[i] = x[rng.choice(len(x), p=probs)]
        d2 = np.minimum(d2, (x - centers[i]) ** 2)
    return centers


def kmeans_1d(
    values: np.ndarray,
    k: int,
    init: str = "k-means++",
    n_init: int = 10,
    max_iter: int = 500,
    tol: float = 1e-10,
    seed: Optional[int] = 42,
) -> Tuple[np.ndarray, float]:
    """Cluster 1-D ``values`` into ``k`` centers.

    Returns ``(centers_sorted, inertia)`` of the best of ``n_init`` restarts.
    """
    x = np.asarray(values, dtype=np.float64).reshape(-1)
    if len(x) < k:
        raise ValueError(f"need at least {k} samples to fit {k} clusters, got {len(x)}")
    rng = np.random.default_rng(seed)

    best_centers, best_inertia = None, np.inf
    for _ in range(max(1, n_init)):
        if init == "k-means++":
            centers = _kmeanspp_init(x, k, rng)
        elif init == "random":
            centers = x[rng.choice(len(x), size=k, replace=False)].astype(np.float64)
        else:
            raise ValueError(f"unknown init '{init}'")

        prev_inertia = np.inf
        for _ in range(max_iter):
            d2 = (x[:, None] - centers[None, :]) ** 2
            assign = np.argmin(d2, axis=1)
            inertia = d2[np.arange(len(x)), assign].sum()
            for j in range(k):
                members = x[assign == j]
                if len(members):
                    centers[j] = members.mean()
                else:  # re-seed empty cluster at the worst-fit point
                    centers[j] = x[np.argmax(d2.min(axis=1))]
            if prev_inertia - inertia <= tol:
                break
            prev_inertia = inertia

        if inertia < best_inertia:
            best_inertia, best_centers = inertia, centers.copy()

    return np.sort(best_centers), float(best_inertia)

"""Synthetic datasets in the paper's Gauss1/2/3 shape — a copy of the
reference's ``utils/datasets.make_gauss`` (numpy only), so the port's
benchmarks and smoke runs draw the same points from the same seed."""

from __future__ import annotations

import numpy as np


def make_gauss(
    n: int,
    dims: int = 10,
    n_clusters: int = 20,
    spread: float = 1.0,
    separation: float = 12.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian mixture in the paper's Gauss1/2/3 shape.

    Cluster centers are drawn uniformly in a hypercube scaled so clusters are
    ``separation`` standard deviations apart on average (rejection-sampled so
    no pair is closer than that); cluster sizes come from a symmetric
    Dirichlet. Returns (points (n, dims) float64, labels (n,) int64), labels
    1-based so 0 can mean noise.
    """
    rng = np.random.default_rng(seed)
    side = separation * spread * n_clusters ** (1.0 / dims)
    centers = np.empty((n_clusters, dims))
    placed = 0
    attempts = 0
    while placed < n_clusters:
        if attempts >= 10_000:
            raise ValueError(
                f"could not place {n_clusters} centers at separation {separation}; "
                "lower n_clusters or separation"
            )
        attempts += 1
        cand = rng.uniform(0.0, side, size=dims)
        if placed == 0 or np.min(
            np.linalg.norm(centers[:placed] - cand, axis=1)
        ) >= separation * spread:
            centers[placed] = cand
            placed += 1
    weights = rng.dirichlet(np.full(n_clusters, 5.0))
    assign = rng.choice(n_clusters, size=n, p=weights)
    pts = centers[assign] + rng.normal(0.0, spread, size=(n, dims))
    return pts, assign.astype(np.int64) + 1

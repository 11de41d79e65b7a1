"""The paper's Gauss1/2/3 mixture, split so that the mixture (centres and
weights) comes from a fixed geometry seed and only the sample from the
run's seed: every seed then fits the same mixture. Keys of the
configuration's ``data``: ``n_clusters``, ``separation``, ``spread``,
``geometry_seed``."""

from __future__ import annotations

import numpy as np


def gauss_mixture(dims: int, n_clusters: int, separation: float, spread: float,
                  geometry_seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Centres and weights of the Gauss mixture: centres uniform in a cube of
    side ``separation * spread * n_clusters ** (1 / dims)``, rejection-
    sampled no closer than ``separation * spread``; weights a symmetric
    Dirichlet(5)."""
    rng = np.random.default_rng(geometry_seed)
    side = separation * spread * n_clusters ** (1.0 / dims)
    centers = np.empty((n_clusters, dims))
    placed = attempts = 0
    while placed < n_clusters:
        if attempts >= 10_000:
            raise ValueError(f"cannot place {n_clusters} centres at separation {separation}")
        attempts += 1
        cand = rng.uniform(0.0, side, size=dims)
        if placed == 0 or np.min(np.linalg.norm(centers[:placed] - cand, axis=1)) \
                >= separation * spread:
            centers[placed] = cand
            placed += 1
    return centers, rng.dirichlet(np.full(n_clusters, 5.0))


def make_gauss(n: int, centers: np.ndarray, weights: np.ndarray, spread: float,
               rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """(points (n, dims) float64, labels (n,) int64 1-based) drawn from the
    mixture of :func:`gauss_mixture`."""
    assign = rng.choice(len(centers), size=n, p=weights)
    pts = centers[assign] + rng.normal(0.0, spread, size=(n, centers.shape[1]))
    return pts, assign.astype(np.int64) + 1


def generate(config: dict, rng: np.random.Generator) -> np.ndarray:
    d = config["data"]
    centers, weights = gauss_mixture(config["dims"], d["n_clusters"], d["separation"],
                                     d["spread"], d["geometry_seed"])
    return make_gauss(config["n"], centers, weights, d["spread"], rng)[0]

"""Adjusted Rand Index with noise-as-singletons — a copy of the reference's
``utils/evaluation.py`` (numpy only)."""

from __future__ import annotations

import numpy as np


def _noise_to_singletons(labels: np.ndarray, noise_label: int = 0) -> np.ndarray:
    labels = np.asarray(labels).copy()
    noise = labels == noise_label
    if noise.any():
        base = labels.max() + 1
        labels[noise] = base + np.arange(noise.sum())
    return labels


def adjusted_rand_index(
    a: np.ndarray,
    b: np.ndarray,
    noise_as_singletons: bool = True,
    noise_label: int = 0,
) -> float:
    """ARI between two labelings; permutation-invariant, 1.0 = identical.
    With ``noise_as_singletons`` every noise object is its own cluster (the
    paper's protocol)."""
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    if a.shape != b.shape:
        raise ValueError("label arrays must have the same shape")
    if noise_as_singletons:
        a = _noise_to_singletons(a, noise_label)
        b = _noise_to_singletons(b, noise_label)
    n = a.size
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    nb = int(bi.max()) + 1

    def comb2(x):
        return x * (x - 1) / 2.0

    # Sparse contingency via paired codes: with noise-as-singletons both
    # labelings can carry ~n distinct labels.
    _, pair_counts = np.unique(ai.astype(np.int64) * nb + bi, return_counts=True)
    sum_ij = comb2(pair_counts).sum()
    sum_a = comb2(np.bincount(ai)).sum()
    sum_b = comb2(np.bincount(bi)).sum()
    total = comb2(n)
    expected = sum_a * sum_b / total if total else 0.0
    max_index = (sum_a + sum_b) / 2.0
    if max_index == expected:
        return 1.0
    return float((sum_ij - expected) / (max_index - expected))

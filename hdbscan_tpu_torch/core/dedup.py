"""Duplicate-point collapsing — weighted exact clustering over unique points,
the port of ``core/dedup.py``.

Real datasets on integer/lattice grids carry heavy duplication (the bundled
Skin set: 245,057 rows, 51,433 unique points, 4.8x). A duplicate group is a
zero-extent data bubble: collapsing it to one point with a member count
preserves the exact HDBSCAN* semantics —

- core distance: the (minPts-1)-th smallest distance over the row MULTISET
  (self included, a duplicate contributing a 0 distance per copy) equals
  the first unique-neighbor distance at which the cumulative member count
  reaches minPts - 1; it is 0 iff the group itself holds >= minPts - 1
  members;
- mutual-reachability MST: within-group edges all carry weight core_i (d=0),
  so the group contracts to one merge-forest node — exactly what the
  member-weighted merge forest does with ``point_weights=counts`` and
  ``self_levels=core`` (``core/tree.py``);
- flat labels / GLOSH broadcast back over the inverse index (duplicates share
  label and score by symmetry).

Host numpy apart from the neighbor scan: the k-best kernel with ids
(``ops/tiled.knn_core_distances``), or under ``fit_sharding=sharded`` the
ring scan (``parallel/ring.ring_knn_core_distances``, the rectangular
k-best kernel per panel).
"""

from __future__ import annotations

import numpy as np


def deduplicate(data: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(unique_rows, counts, inverse): ``data == unique_rows[inverse]``."""
    uniq, inverse, counts = np.unique(
        np.ascontiguousarray(data), axis=0, return_inverse=True, return_counts=True
    )
    return uniq, counts.astype(np.float64), inverse.astype(np.int64)


def weighted_core_distances(
    knn_d: np.ndarray,
    knn_i: np.ndarray,
    counts: np.ndarray,
    min_pts: int,
) -> np.ndarray:
    """Core distance per unique point from its k nearest UNIQUE neighbors.

    ``knn_d``/``knn_i``: (m, k) ascending distances + ids over unique points,
    self included at distance 0 (``ops.tiled.knn_core_distances`` with
    ``return_indices=True``); k >= minPts guarantees coverage because every
    unique neighbor contributes >= 1 member. ``counts``: members per unique
    point. Matches the multiset semantics above.
    """
    if min_pts <= 1:
        return np.zeros(len(counts), np.float64)
    m, k = knn_d.shape
    need = min_pts - 1  # (minPts-1)-th smallest, self included
    if k < need:
        raise ValueError(f"need k >= min_pts - 1 ({need}), got {k}")
    # Unique points cannot duplicate each other, so the cumulative member
    # count over the ascending neighbor list (self first at distance 0) is
    # counts[knn_i] summed along the row. Padding slots (id -1 / +inf
    # distance, present when k exceeds the unique-point count) contribute
    # nothing — unmasked they would wrap to counts[-1] and fake coverage.
    valid_nb = (knn_i >= 0) & np.isfinite(knn_d)
    neigh_counts = np.where(valid_nb, counts[np.clip(knn_i, 0, len(counts) - 1)], 0.0)
    cum = np.cumsum(neigh_counts, axis=1)
    reached = cum >= need
    j = np.argmax(reached, axis=1)  # first column covering minPts
    core = knn_d[np.arange(m), j]
    # Rows never reaching minPts (tiny datasets): clamp to the farthest
    # FINITE distance, matching the full-row scan's min(minPts-1, n) clamp.
    none = ~reached.any(axis=1)
    if none.any():
        finite = np.where(np.isfinite(knn_d[none]), knn_d[none], -np.inf)
        core[none] = np.max(finite, axis=1)
    return core


def global_weighted_core_distances(
    data: np.ndarray,
    counts: np.ndarray,
    min_pts: int,
    metric: str,
    row_tile: int = 1024,
    col_tile: int = 8192,
    dtype=np.float32,
    *,
    mesh=None,
    trace=None,
    fit_sharding: str = "replicated",
    device=None,
) -> np.ndarray:
    """One neighbor scan + multiset cumsum: the weighted global core
    distances (k = max(minPts, 2) unique neighbors with ids).

    Under ``fit_sharding="sharded"`` the scan is the ring over ``mesh``
    (None: every visible card); otherwise the k-best kernel on ``device``
    (None: the card). Only the (m, k) lists feeding the cumsum come back to
    the host.
    """
    from hdbscan_tpu_torch.parallel.shard import resolve_fit_sharding

    k = max(min_pts, 2)
    if resolve_fit_sharding(fit_sharding, mesh) == "sharded":
        from hdbscan_tpu_torch.parallel.ring import ring_knn_core_distances

        _, knn_d, knn_i = ring_knn_core_distances(
            data, min_pts, metric, k=k, row_tile=row_tile, col_tile=col_tile,
            dtype=dtype, return_indices=True, mesh=mesh, trace=trace,
        )
    else:
        from hdbscan_tpu_torch.ops.tiled import knn_core_distances

        _, knn_d, knn_i = knn_core_distances(
            data, min_pts, metric, k=k, row_tile=row_tile, col_tile=col_tile,
            dtype=dtype, return_indices=True, trace=trace, device=device,
        )
    return weighted_core_distances(knn_d, knn_i, counts, min_pts)


def expand_heavy_groups(
    u: np.ndarray,
    v: np.ndarray,
    w: np.ndarray,
    core: np.ndarray,
    counts: np.ndarray,
    min_cluster_size: int | float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Expand duplicate groups heavy enough to pass minClusterSize back into
    unit leaves before tree extraction.

    An atomic weighted vertex of count g >= minClusterSize diverges from the
    full-row tree exactly when its internal merge level (its core distance)
    TIES with external edge weights: full-row tie contraction dissolves the
    group into g singleton children (none big), while the weighted vertex
    stays one big child and forces a split. Expanding such vertices into g
    unit leaves joined by (g-1) edges at weight core (the literal full-row
    MST edges between coincident rows) restores exact row-level semantics;
    light groups (g < minClusterSize) are provably equivalent unexpanded.

    Host-side only. Returns (u2, v2, w2, core2, weights2); appended
    pseudo-leaves alias their base vertex (same coordinates), so row results
    broadcast from the base.
    """
    counts = np.asarray(counts, np.float64)
    heavy = np.nonzero((counts >= min_cluster_size) & (counts >= 2))[0]
    if len(heavy) == 0:
        return u, v, w, core, counts
    n = len(counts)
    extras = (counts[heavy] - 1).astype(np.int64)
    total = int(extras.sum())
    base = np.repeat(heavy, extras)  # base vertex per pseudo-leaf
    new_ids = n + np.arange(total)
    u2 = np.concatenate([u, base])
    v2 = np.concatenate([v, new_ids])
    w2 = np.concatenate([w, core[base]])
    core2 = np.concatenate([core, core[base]])
    weights2 = counts.copy()
    weights2[heavy] = 1.0
    weights2 = np.concatenate([weights2, np.ones(total)])
    return u2, v2, w2, core2, weights2

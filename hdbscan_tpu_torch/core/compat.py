"""Reference bug-compat CF math (opt-in, ``HDBSCANParams.compat_cf_int_math``)
— a copy of the reference package's ``core/compat.py`` (host numpy only).

The framework defaults to the CORRECT double math everywhere the reference's
live pipeline has integer-division or indexing bugs (SURVEY.md §7
"parity-vs-bug decisions", ``core/bubbles.py`` module docstring). This module
is the other half of that decision: faithful host-side reproductions of the
reference behaviors, for users who need output parity with a reference run
rather than with the paper's formulas. Behaviors reproduced:

- ``CombineStep.computeExtentBubble`` (``mappers/CombineStep.java:46-57``):
  extent is the MEAN of per-dimension sqrt variances, each clamped at zero —
  not the sqrt of the summed variance the correct variant uses
  (``datastructure/ClusterFeatureDataBubbles.java:200-208``).
- ``CombineStep.computeNNDistBubble`` (``CombineStep.java:42-44``): the
  exponent ``(1 / numberOfAttributes)`` is integer division — 0 for d > 1 —
  so ``nnDist == extent``; for d == 1 it degenerates to ``extent / n``.
- ``CombineStep.call``'s ``n₁ + 1`` count merge (``CombineStep.java:28``):
  under a left fold over singleton CFs (one point at a time, the shape the
  live pipeline feeds it) the count comes out CORRECT — n only undercounts
  when two already-merged partials meet, which in the reference depends on
  Spark's nondeterministic combine tree. Byte-faithful reproduction of a
  nondeterministic quantity is ill-defined; this module fixes the merge
  order to the left fold, the one deterministic reading.
- ``HdbscanDataBubbles.calculateCoreDistancesBubbles``
  (``HdbscanDataBubbles.java:75-146``): exponent collapse (``1 / dims`` and
  the integer quotients ``numNeighbors / nB``, ``aux / nB``), the
  ``indexBubbles`` buffer that is shared across the point loop and only
  overwritten at insertion positions (never shifted with ``kNNDistances``,
  so it carries stale neighbor ids), and the covering walk that indexes
  bubbles by the loop COUNTER ``i`` instead of the found neighbor ``index``
  (``HdbscanDataBubbles.java:136-142``).

Everything here is deliberately host-side NumPy: bubble counts are sample
sized (hundreds), the control flow is the point of the exercise, and keeping
it off-device means zero cost to the default path.
"""

from __future__ import annotations

import numpy as np

__all__ = ["combinestep_bubble_stats", "reference_bubble_core_distances"]

#: Java's Double.MAX_VALUE — the reference's "unset" k-NN slot sentinel
#: (``HdbscanDataBubbles.java:94``). Not inf: a real distance can equal it in
#: principle, and faithful means faithful.
_JAVA_DOUBLE_MAX = np.finfo(np.float64).max


def combinestep_bubble_stats(
    points: np.ndarray,
    assign: np.ndarray,
    num_bubbles: int,
    weights: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """CF statistics with ``CombineStep``'s live math (see module docstring).

    Same contract as :func:`hdbscan_tpu_torch.core.bubbles.bubble_stats` (host
    arrays out): points with ``assign >= num_bubbles`` are dropped (padding),
    empty bubbles get n = 0 / rep = 0. ``weights`` folds duplicate
    multiplicities into the sums (n then counts members, the left-fold
    reading of the ``n₁+1`` merge over one CF per member).
    """
    points = np.asarray(points, np.float64)
    assign = np.asarray(assign)
    d = points.shape[1]
    keep = assign < num_bubbles
    pts, asg = points[keep], assign[keep]
    w = None if weights is None else np.asarray(weights, np.float64)[keep]
    ls = np.zeros((num_bubbles, d))
    ss = np.zeros((num_bubbles, d))
    wcol = np.ones(len(pts)) if w is None else w
    np.add.at(ls, asg, pts * wcol[:, None])
    np.add.at(ss, asg, pts * pts * wcol[:, None])
    n = np.bincount(asg, weights=wcol, minlength=num_bubbles).astype(np.float64)

    n_safe = np.maximum(n, 1.0)
    rep = ls / n_safe[:, None]
    # computeExtentBubble (CombineStep.java:46-57): per-dim sqrt, negative
    # variance terms skipped, MEAN over dims (``extent / ls.length``).
    var = (2.0 * n[:, None] * ss - 2.0 * ls * ls) / np.maximum(
        n * (n - 1.0), 1.0
    )[:, None]
    extent = np.sqrt(np.maximum(var, 0.0)).sum(axis=1) / d
    extent = np.where(n > 1, extent, 0.0)
    # computeNNDistBubble (CombineStep.java:42-44): Math.pow(1/n, 1/d) with an
    # integer-division exponent — 0 for d > 1 (nnDist = extent), 1 for d == 1.
    nn_dist = extent if d > 1 else extent / n_safe
    return rep, extent, nn_dist, n


def reference_bubble_core_distances(
    dist: np.ndarray,
    n_b: np.ndarray,
    extent: np.ndarray,
    min_pts: int,
    dims: int = 2,
) -> np.ndarray:
    """``calculateCoreDistancesBubbles`` exactly as the reference executes it
    (``HdbscanDataBubbles.java:75-146``), stale buffers and all.

    Args:
      dist: (m, m) bubble-corrected distance matrix (the walk's
        ``distanceBubbles(...)`` values — precomputed; the reference computes
        them inline, same numbers).
      n_b: (m,) integer member counts.
      extent: (m,) bubble extents (``eB``).
      min_pts: the reference's ``k``.
      dims: point dimensionality — only d == 1 changes anything (the integer
        exponent ``1 // d`` is 1 there and the integer quotients survive;
        for every d > 1 it is 0 and ``pow(x, 0) == 1`` erases them).

    Returns (m,) core distances. Raises ``IndexError`` exactly where the Java
    would throw ``ArrayIndexOutOfBoundsException`` (covering walk running off
    the k-1 slot buffer — possible when total membership is short of
    ``min_pts - 1``); callers guard subset sizes the same way the Java
    pipeline's main program does.
    """
    m = dist.shape[0]
    n_b = np.asarray(n_b, np.int64)
    num_neighbors = min_pts - 1
    core = np.zeros(m)
    if min_pts == 1:
        return core
    # Shared across points — NOT reinitialized per point (the reference bug).
    index_bubbles = np.zeros(num_neighbors, np.int64)
    for point in range(m):
        knn = np.full(num_neighbors, _JAVA_DOUBLE_MAX)
        for neighbor in range(m):
            if neighbor == point:
                continue
            distance = dist[point, neighbor]
            pos = num_neighbors
            while pos >= 1 and distance < knn[pos - 1]:
                pos -= 1
            if pos < num_neighbors:
                knn[pos + 1 :] = knn[pos:-1]  # kNNDistances shifts...
                knn[pos] = distance
                index_bubbles[pos] = neighbor  # ...indexBubbles does not
        if n_b[point] >= num_neighbors:
            # Math.pow(numNeighbors / nB, 1 / d): integer exponent 0 -> 1.0
            # regardless of the (integer) quotient — pow(x, 0) == 1 in Java.
            # At d == 1 the exponent is 1 and the integer quotient survives.
            if dims == 1:
                core[point] = float(num_neighbors // n_b[point]) * extent[point]
            else:
                core[point] = extent[point]
        else:
            n_x = int(n_b[point])
            i = 0
            while n_x < num_neighbors:
                n_x += n_b[index_bubbles[i]]  # IndexError == Java's AIOOBE
                i += 1
            s = int(n_b[point])
            aux = 0
            for j in range(i):
                # The reference compares against dist(indexBubbles[j], i) —
                # ``i`` is the loop COUNTER, used as a bubble id (the
                # i-vs-index bug, HdbscanDataBubbles.java:136-142).
                distance_c = dist[index_bubbles[j], i]
                if s < num_neighbors and knn[j] < distance_c:
                    aux = num_neighbors - s
                s += n_b[index_bubbles[j]]
            # kNNDistances[i] + Math.pow(aux / nB[i], 1 / d) * eB[i]: counter
            # ``i`` again (both as slot and bubble id), exponent 0 -> + eB[i]
            # (at d == 1 the integer quotient aux // nB[i] survives).
            if dims == 1:
                core[point] = knn[i] + float(aux // n_b[i]) * extent[i]
            else:
                core[point] = knn[i] + extent[i]
    return core

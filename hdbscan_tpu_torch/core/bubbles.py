"""Data-bubble summarization — the port of ``core/bubbles.py``.

Cluster-feature statistics per bubble (``bubble_stats``), the
bubble-corrected distance matrix, the expected-neighbour bubble core
distances, noise-bubble reassignment and the inter-cluster edge mask, with
the reference's formulas (its float-correct reading of the Java CF math).

The segment sums of :func:`bubble_stats` are a fixed pairwise tree per
bubble over its members in point order (:func:`_segment_sums`), not
atomics: the CPU and the card then add in the same order and give the
same bits. On integer grids every sum is exact in float64 and equals the
reference's; on continuous data the order differs from the reference's
scatter-add in the last bits. Powers (``(1/n)^(1/d)``) of float32
statistics are taken in float64 and rounded once, as ``sqrt_rn`` does for
roots, so the two devices agree there too.
"""

from __future__ import annotations

import torch

from hdbscan_tpu_torch.core.distances import euclidean_form, pairwise_distance, sqrt_rn
from hdbscan_tpu_torch.core.knn import mutual_reachability
from hdbscan_tpu_torch.ops.lexmerge import topk_lex

__all__ = [
    "bubble_stats",
    "bubble_distance_matrix",
    "bubble_core_distances",
    "bubble_mutual_reachability",
    "reassign_noise_bubbles",
    "inter_cluster_edge_mask",
]


def _pow(base: torch.Tensor, exponent: float) -> torch.Tensor:
    if base.dtype == torch.float32:
        return torch.pow(base.double(), exponent).float()
    return torch.pow(base, exponent)


def _segment_sums(values: torch.Tensor, seg: torch.Tensor, num: int):
    """Per-segment sums of ``values`` (N, C) by ``seg`` (N,) in [0, num]
    (``num`` is dropped) and the member counts: a pairwise tree over each
    segment's members in point order. Returns ((num, C) sums, (num,) int64
    counts)."""
    dev = values.device
    counts = torch.bincount(seg, minlength=num + 1)[:num]
    order = torch.argsort(seg, stable=True)
    kept = int(counts.sum())
    sv = values[order[:kept]]
    ss = seg[order[:kept]]
    starts = torch.cumsum(counts, 0) - counts
    cnt = counts[ss]
    r = torch.arange(kept, device=dev) - starts[ss]
    pos = torch.arange(kept, device=dev)
    step = 1
    top = int(counts.max()) if num else 0
    while step < top:
        take = (r % (2 * step) == 0) & (r + step < cnt)
        partner = torch.clamp(pos + step, max=max(kept - 1, 0))
        sv = torch.where(take[:, None], sv + sv[partner], sv)
        step *= 2
    out = torch.zeros((num, values.shape[1]), dtype=values.dtype, device=dev)
    nz = counts > 0
    out[nz] = sv[starts[nz]]
    return out, counts


def bubble_stats(points: torch.Tensor, assign: torch.Tensor, num_bubbles: int):
    """CF statistics per bubble: ``rep = LS/n``; ``extent = sqrt(sum_d
    (2 n SS - 2 LS^2) / (n (n-1)))``; ``nn_dist = (1/n)^(1/d) * extent``.

    ``points`` (N, d), ``assign`` (N,) bubble id per point; ids >=
    ``num_bubbles`` (padding) are dropped. Singleton bubbles get extent =
    nn_dist = 0; empty ones n = 0 and rep = 0. Returns (rep (m, d), extent,
    nn_dist, n) with n as float counts.
    """
    d = points.shape[-1]
    seg = torch.clamp(assign.to(torch.int64), max=num_bubbles)
    sums, counts = _segment_sums(torch.cat([points, points * points], dim=1), seg, num_bubbles)
    ls, ss = sums[:, :d], sums[:, d:]
    n = counts.to(points.dtype)
    n_safe = torch.clamp(n, min=1.0)
    rep = ls / n_safe[:, None]
    var = (2.0 * n[:, None] * ss - 2.0 * ls * ls) / torch.clamp(n * (n - 1.0), min=1.0)[:, None]
    tot = var[:, 0]
    for f in range(1, d):
        tot = tot + var[:, f]
    extent = sqrt_rn(torch.clamp(tot, min=0.0))
    extent = torch.where(n > 1, extent, torch.zeros((), dtype=points.dtype, device=points.device))
    nn_dist = _pow(1.0 / n_safe, 1.0 / d) * extent
    return rep, extent, nn_dist, n


def bubble_distance_matrix(rep, extent, nn_dist, metric: str = "euclidean"):
    """(m, m) bubble-corrected distances, exact-zero diagonal: for
    non-overlapping bubbles the rep distance shrunk by both extents and
    re-expanded by both nn distances; overlapping ones collapse to
    ``max(nn_B, nn_C)``."""
    m, dims = rep.shape
    d = pairwise_distance(rep, rep, metric, euclidean_form(m, m, dims))
    e_sum = extent[:, None] + extent[None, :]
    corrected = torch.where(
        d - e_sum >= 0,
        d - e_sum + nn_dist[:, None] + nn_dist[None, :],
        torch.maximum(nn_dist[:, None], nn_dist[None, :]),
    )
    eye = torch.eye(m, dtype=torch.bool, device=rep.device)
    return torch.where(eye, torch.zeros((), dtype=d.dtype, device=rep.device), corrected)


def bubble_core_distances(dist, n_b, extent, min_pts: int, d: int, valid=None):
    """Expected-neighbour core distance per bubble: ``(k'/n_B)^(1/d) * e_B``
    when the bubble holds the k' = minPts - 1 neighbours itself, else the
    corrected distance to the covering neighbour bubble C plus
    ``(aux/n_C)^(1/d) * e_C`` for the remainder ``aux``; the farthest
    finite neighbour when nothing covers. Invalid or empty bubbles get
    +inf."""
    m = dist.shape[0]
    dt = dist.dtype
    inf = torch.tensor(float("inf"), dtype=dt, device=dist.device)
    if min_pts <= 1:
        core = torch.zeros(m, dtype=dt, device=dist.device)
        return core if valid is None else torch.where(valid, core, inf)
    k = float(min_pts - 1)
    ok = n_b > 0 if valid is None else (valid & (n_b > 0))
    knn_dist = torch.where(ok[None, :] & ok[:, None], dist, inf)
    knn_dist = torch.where(torch.eye(m, dtype=torch.bool, device=dist.device), inf, knn_dist)

    kk = int(min(m, min_pts))
    sorted_d, order = topk_lex(knn_dist, kk)
    zero = torch.zeros((), dtype=dt, device=dist.device)
    nb_sorted = torch.where(torch.isfinite(sorted_d), n_b[order], zero)
    cover = n_b[:, None] + torch.cumsum(nb_sorted, dim=1)

    inner = _pow(k / torch.clamp(n_b, min=1.0), 1.0 / d) * extent
    reached = cover >= k
    j = torch.argmax(reached.to(torch.int32), dim=1)
    any_reached = torch.any(reached, dim=1)
    last = torch.gather(order, 1, j[:, None])[:, 0]
    d_last = torch.gather(sorted_d, 1, j[:, None])[:, 0]
    cover_before = torch.where(
        j > 0, torch.gather(cover, 1, torch.clamp(j - 1, min=0)[:, None])[:, 0], n_b
    )
    aux = torch.clamp(k - cover_before, min=0.0)
    outer = d_last + _pow(aux / torch.clamp(n_b[last], min=1.0), 1.0 / d) * extent[last]
    fallback = torch.amax(torch.where(torch.isfinite(sorted_d), sorted_d, zero), dim=1)
    outer = torch.where(any_reached, outer, fallback)
    core = torch.where(n_b >= k, inner, outer)
    return torch.where(ok, core, inf)


#: MRD over bubble-corrected distances — the exact path's max-chain.
bubble_mutual_reachability = mutual_reachability


def reassign_noise_bubbles(dist, labels, valid=None):
    """Each noise bubble takes the flat label of its nearest originally
    non-noise bubble (single pass); unchanged when every bubble is noise."""
    m = dist.shape[0]
    inf = torch.tensor(float("inf"), dtype=dist.dtype, device=dist.device)
    donor = labels != 0
    if valid is not None:
        donor = donor & valid
    masked = torch.where(donor[None, :], dist, inf)
    masked = torch.where(torch.eye(m, dtype=torch.bool, device=dist.device), inf, masked)
    nearest = torch.argmin(masked, dim=1)
    return torch.where((labels == 0) & torch.any(donor), labels[nearest], labels)


def inter_cluster_edge_mask(u, v, labels):
    """Mask of MST edges crossing flat-cluster boundaries."""
    return labels[u] != labels[v]

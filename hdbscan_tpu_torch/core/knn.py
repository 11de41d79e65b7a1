"""Neighbor-graph tier resolution and the dense-block core distances — the
port of ``core/knn.py``.

Core distance semantics are the reference's: the largest of a point's
``min_pts - 1`` smallest distances over its row of the self-distance
matrix, self (distance 0) included; ``min_pts <= 1`` gives zeros. A NaN
distance takes a slot before every number, as in the reference's
``lax.top_k``.
"""

from __future__ import annotations

import torch

from hdbscan_tpu_torch.core.distances import DEFAULT_METRIC, self_distance_matrix


def resolve_index_for(params, n: int) -> tuple[str, dict]:
    """Resolve the configured neighbor-graph tier for an n-point job.

    Returns ``(index, index_opts)`` for ``ops/tiled.knn_core_distances``:
    ``index`` is "exact" or "rpforest" (``params.knn_index`` with "auto"
    resolved at ``params.knn_index_threshold`` points), and ``index_opts``
    carries the forest knobs (trees, leaf_size, rescan_rounds, seed, and
    the ``knn_backend``/``knn_precision`` pair) — empty for the exact tier.
    """
    from hdbscan_tpu_torch.ops.rpforest import resolve_knn_index

    index = resolve_knn_index(params.knn_index, n, params.knn_index_threshold)
    if index == "exact":
        return index, {}
    return index, {
        "trees": params.rpf_trees,
        "leaf_size": params.rpf_leaf_size,
        "rescan_rounds": params.rpf_rescan_rounds,
        "seed": params.seed,
        "knn_backend": params.knn_backend,
        "knn_precision": params.knn_precision,
    }


def core_distances_from_matrix(
    dist: torch.Tensor, min_pts: int, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Core distance per row of a dense (..., n, n) self-distance matrix.

    ``valid``: optional (..., n) mask of real points in a padded block —
    invalid columns never count as neighbours, invalid rows get +inf. A
    padded block with fewer than ``min_pts - 1`` valid columns clamps to
    the farthest valid distance, as an unpadded block's ``min(k, n)`` does.
    """
    n = dist.shape[-1]
    inf = torch.tensor(float("inf"), dtype=dist.dtype, device=dist.device)
    if valid is not None:
        dist = torch.where(valid[..., None, :], dist, inf)
    if min_pts <= 1:
        core = torch.zeros(dist.shape[:-1], dtype=dist.dtype, device=dist.device)
    else:
        k = min(min_pts - 1, n)
        vals = torch.topk(dist, k, dim=-1, largest=False, sorted=True).values
        core = vals[..., k - 1]
        # The reference's ``lax.top_k(-dist)`` ranks a NaN distance (a
        # zero-norm row's at cosine and pearson: x86's NaN, negated, is a
        # positive NaN) before every number, so a row's c NaNs take its
        # first c slots: the core is its (k - c)-th smallest number, NaN
        # where c >= k. torch.topk ranks NaN after every number. A row sum
        # is NaN exactly where the row holds a NaN (no distance is -inf),
        # so the count runs only on matrices that hold one.
        if torch.isnan(dist.sum(dim=-1)).any():
            nans = torch.isnan(dist).sum(dim=-1, keepdim=True)
            core = torch.gather(vals, -1, (k - 1 - nans).clamp_min(0)).squeeze(-1)
            core = torch.where(nans.squeeze(-1) >= k, torch.nan, core)
        if valid is not None:
            row_max = torch.amax(torch.where(valid[..., None, :], dist, -inf), dim=-1)
            core = torch.where(torch.isinf(core), row_max, core)
    if valid is not None:
        core = torch.where(valid, core, inf)
    return core


def mutual_reachability(dist: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """MRD[i, j] = max(dist[i, j], core[i], core[j]) over (..., n, n)."""
    return torch.maximum(dist, torch.maximum(core[..., :, None], core[..., None, :]))


def mutual_reachability_block(
    x: torch.Tensor, min_pts: int, metric: str = DEFAULT_METRIC,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(MRD matrix, core distances) of one point block (..., n, d);
    ``valid`` as in :func:`core_distances_from_matrix`."""
    dist = self_distance_matrix(x, metric)
    core = core_distances_from_matrix(dist, min_pts, valid)
    return mutual_reachability(dist, core), core

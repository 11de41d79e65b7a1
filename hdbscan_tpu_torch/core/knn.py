"""Neighbor-graph tier resolution — the port of ``core/knn.resolve_index_for``."""

from __future__ import annotations


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

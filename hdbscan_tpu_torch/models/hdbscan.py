"""Exact single-block HDBSCAN* — the port of ``models/hdbscan.py``: the
dense small-n fit, its result and the five canonical output files.

The O(n^2) work (distances, core distances, mutual reachability, Borůvka
MST) runs as plain PyTorch ops on the fit's device — the reference's block
is one XLA program with no Pallas kernel — and the condensed-tree
extraction runs on the host over the O(n) edge list
(``models/_finalize.py``). The dense (n, n) matrices bound the block: at
30,000 points one float32 matrix is 3.6 GB. The CLI takes this route for
n <= ``processing_units``; the exact fit (``models/exact.py``) and the MR
pipeline (``models/mr_hdbscan.py``) return the same result type.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from hdbscan_tpu_torch.config import HDBSCANParams
from hdbscan_tpu_torch.core import tree as tree_mod
from hdbscan_tpu_torch.core.knn import mutual_reachability_block
from hdbscan_tpu_torch.core.mst import boruvka_mst
from hdbscan_tpu_torch.ops import cuda_build


@dataclass
class HDBSCANResult:
    labels: np.ndarray  # flat partition, 0 = noise
    tree: tree_mod.CondensedTree
    core_distances: np.ndarray
    #: (u, v, w) MST without self edges. NOTE: with ``dedup_points`` the ids
    #: live in UNIQUE-vertex space — translate rows via ``dedup_inverse``.
    mst: tuple[np.ndarray, np.ndarray, np.ndarray]
    outlier_scores: np.ndarray
    infinite_stability: bool
    #: row -> unique-vertex index map when the run deduplicated (else None).
    dedup_inverse: np.ndarray | None = None


def hdbscan_block_edges(
    x: torch.Tensor, min_pts: int, metric: str = "euclidean"
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Dense block pass over the points ``x`` (n, d) on their device:
    distances -> core distances -> mutual reachability -> Borůvka MST.
    Returns the (u, v, w) MST edges and the core distances as host arrays
    (int64, int64, float64, float64)."""
    mrd, core = mutual_reachability_block(x, min_pts, metric)
    u, v, w, mask, _ = boruvka_mst(mrd)
    del mrd
    mask = mask.cpu().numpy()
    return (
        u.cpu().numpy().astype(np.int64)[mask],
        v.cpu().numpy().astype(np.int64)[mask],
        w.cpu().numpy().astype(np.float64)[mask],
        core.cpu().numpy().astype(np.float64),
    )


def fit(
    data: np.ndarray,
    params: HDBSCANParams | None = None,
    *,
    device=None,
    dtype=np.float32,
    num_constraints_satisfied: np.ndarray | None = None,
    trace=None,
) -> HDBSCANResult:
    """Exact HDBSCAN* of ``data`` ((n, d) array) as one dense block.

    Runs on the card unless ``device`` names another (``"cpu"`` for the
    tests); raises when no card is present and no device is named.
    ``dtype``: the block's working type — float32 (the reference's
    production setting) or float64 (the reference under
    ``jax_enable_x64``), on either device: no hand-written kernel runs
    here. ``trace``: optional ``trace(stage, **fields)`` callable receiving
    ``block_edges`` and the finalize's ``tree_*`` events.
    """
    params = params or HDBSCANParams()
    data = np.asarray(data, np.float64)
    n = len(data)
    if n == 0:
        raise ValueError("empty dataset")
    device = cuda_build.resolve_device(device)
    if np.dtype(dtype) not in (np.float32, np.float64):
        raise ValueError(f"dtype {np.dtype(dtype)}: the dense fit runs in float32 or float64")
    from hdbscan_tpu_torch.models._finalize import finalize_clustering

    t0 = time.monotonic()
    x = torch.as_tensor(data.astype(dtype), device=device)
    u, v, w, core = hdbscan_block_edges(x, params.min_points, params.dist_function)
    del x
    if trace is not None:
        trace("block_edges", n=n, wall_s=round(time.monotonic() - t0, 6))
    tree, labels, scores, infinite = finalize_clustering(
        n, u, v, w, core, params, num_constraints_satisfied, trace=trace, device=device
    )
    return HDBSCANResult(
        labels=labels,
        tree=tree,
        core_distances=core,
        mst=(u, v, w),
        outlier_scores=scores,
        infinite_stability=infinite,
    )


def write_outputs(result: HDBSCANResult, params: HDBSCANParams) -> dict[str, str]:
    """Emit the five canonical output files (and, for a consensus result,
    the ``<base>_consensus.json`` provenance sidecar); returns {kind:
    path}."""
    from hdbscan_tpu_torch.utils import io as io_mod

    paths = {}
    hierarchy_path = params.output_path("hierarchy")
    os.makedirs(os.path.dirname(hierarchy_path) or ".", exist_ok=True)
    offsets = io_mod.write_hierarchy_file(
        hierarchy_path, result.tree, params.compact_hierarchy
    )
    paths["hierarchy"] = hierarchy_path
    tree_path = params.output_path("tree")
    io_mod.write_tree_file(tree_path, result.tree, offsets)
    paths["tree"] = tree_path
    part_path = params.output_path("partition")
    io_mod.write_partition_file(part_path, result.labels)
    paths["partition"] = part_path
    out_path = params.output_path("outlier_scores")
    io_mod.write_outlier_scores_file(out_path, result.outlier_scores, result.core_distances)
    paths["outlier_scores"] = out_path
    vis_path = params.output_path("visualization")
    io_mod.write_visualization_file(vis_path, result.tree, result.labels)
    paths["visualization"] = vis_path
    info = getattr(result, "consensus_info", None)
    if info is not None:
        # A consensus run mixes provenances (partition and scores from the
        # draws, tree and hierarchy from the representative draw): the
        # sidecar says so beside the files.
        import json

        prov_path = os.path.join(os.path.dirname(vis_path), params.base_name + "_consensus.json")
        with open(prov_path, "w") as f:
            json.dump(info, f, indent=1)
            f.write("\n")
        paths["consensus_provenance"] = prov_path
    return paths

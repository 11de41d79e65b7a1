"""Fit result and the five canonical output files (the port of
``models/hdbscan.py``'s ``HDBSCANResult`` and ``write_outputs``).

The dense single-block ``fit`` of the reference is not ported yet
(ROADMAP A5); the exact fit (``models/exact.py``) returns this result.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from hdbscan_tpu_torch.config import HDBSCANParams
from hdbscan_tpu_torch.core import tree as tree_mod


@dataclass
class HDBSCANResult:
    labels: np.ndarray  # flat partition, 0 = noise
    tree: tree_mod.CondensedTree
    core_distances: np.ndarray
    #: (u, v, w) MST without self edges.
    mst: tuple[np.ndarray, np.ndarray, np.ndarray]
    outlier_scores: np.ndarray
    infinite_stability: bool


def write_outputs(result: HDBSCANResult, params: HDBSCANParams) -> dict[str, str]:
    """Emit the five canonical output files; returns {kind: path}."""
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
    return paths

"""Bubble-level HDBSCAN* — the local-model step of the MR pipeline, the port
of ``models/bubble_hdbscan.py``.

Per oversized subset: bubble-corrected distances -> bubble core distances
-> mutual reachability -> dense Borůvka on the fit's device, one fetch of
the MST, the condensed tree and excess-of-mass extraction on the host with
member weights, then noise-bubble reassignment and the inter-cluster edge
mask on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hdbscan_tpu_torch.core import tree as tree_mod
from hdbscan_tpu_torch.core.bubbles import (
    bubble_core_distances,
    bubble_distance_matrix,
    bubble_mutual_reachability,
    inter_cluster_edge_mask,
    reassign_noise_bubbles,
)
from hdbscan_tpu_torch.core.mst import boruvka_mst


@dataclass
class BubbleModel:
    """Result of clustering one subset's bubbles.

    ``labels``: flat cluster per bubble (0 only if the whole subset is
    noise — noise bubbles are reassigned to their nearest cluster).
    ``inter_edges``: (u, v, w) bubble-index MST edges crossing flat
    clusters. ``weights``: member count per bubble.
    """

    labels: np.ndarray
    tree: tree_mod.CondensedTree
    core: np.ndarray
    mst: tuple[np.ndarray, np.ndarray, np.ndarray]
    inter_edges: tuple[np.ndarray, np.ndarray, np.ndarray]
    weights: np.ndarray | None = None


def _bubble_device_block(rep, extent, nn_dist, n_b, num_valid: int, min_pts: int,
                         dims: int, metric: str):
    """Corrected distances -> core -> MRD -> Borůvka over padded bubbles
    (the first ``num_valid`` are real). Returns (dist, u, v, w, mask, core)."""
    m = rep.shape[0]
    valid = torch.arange(m, device=rep.device) < num_valid
    dist = bubble_distance_matrix(rep, extent, nn_dist, metric)
    core = bubble_core_distances(dist, n_b, extent, min_pts, dims, valid=valid)
    mrd = bubble_mutual_reachability(dist, core)
    u, v, w, mask, _ = boruvka_mst(mrd, num_valid)
    return dist, u, v, w, mask, core


def fit_bubbles(
    rep: torch.Tensor,
    extent: torch.Tensor,
    nn_dist: torch.Tensor,
    n_b: torch.Tensor,
    min_pts: int,
    min_cluster_size: int,
    metric: str = "euclidean",
    num_valid: int | None = None,
    compat_cf_int_math: bool = False,
) -> BubbleModel:
    """Cluster one subset's bubbles (tensors on the fit's device, possibly
    shape-padded past ``num_valid``); returns flat labels and the
    inter-cluster MST edges, all sliced to the real bubbles."""
    if compat_cf_int_math:
        raise NotImplementedError(
            "compat_cf_int_math (the reference's integer-division CF walk, "
            "core/compat.py) is not ported yet (ROADMAP A6)"
        )
    m_pad, dims = rep.shape
    m = m_pad if num_valid is None else int(num_valid)
    if m == 0:
        raise ValueError("empty bubble set")
    if m == 1:
        # A single bubble is trivially one (root) cluster, built through the
        # standard tree path so the contract holds.
        empty = np.zeros(0, np.int64)
        w1 = n_b[:1].cpu().numpy().astype(np.float64)
        forest = tree_mod.build_merge_forest(1, empty, empty, np.zeros(0), point_weights=w1)
        tree = tree_mod.condense_forest(forest, min_cluster_size, point_weights=w1)
        tree_mod.propagate_tree(tree)
        return BubbleModel(
            labels=np.ones(1, np.int64), tree=tree, core=np.zeros(1),
            mst=(empty, empty, np.zeros(0)), inter_edges=(empty, empty, np.zeros(0)),
            weights=w1,
        )
    n_b = n_b.to(rep.dtype)
    dist, u_d, v_d, w_d, mask_d, core_d = _bubble_device_block(
        rep, extent, nn_dist, n_b, m, min_pts, dims, metric
    )
    mask = mask_d.cpu().numpy()
    u = u_d.cpu().numpy()[mask]
    v = v_d.cpu().numpy()[mask]
    w = w_d.cpu().numpy().astype(np.float64)[mask]
    core_h = core_d[:m].cpu().numpy().astype(np.float64)
    weights = n_b[:m].cpu().numpy().astype(np.float64)

    tree, labels = tree_mod.extract_clusters(
        m, u, v, w, min_cluster_size, point_weights=weights, self_levels=core_h
    )
    labels_p = torch.zeros(m_pad, dtype=torch.int64, device=rep.device)
    labels_p[:m] = torch.as_tensor(labels, dtype=torch.int64, device=rep.device)
    valid = torch.arange(m_pad, device=rep.device) < m
    new = reassign_noise_bubbles(dist, labels_p, valid=valid)
    cross = (mask_d & inter_cluster_edge_mask(u_d, v_d, new)).cpu().numpy()[mask]
    labels = new[:m].cpu().numpy().astype(np.int64)
    return BubbleModel(
        labels=labels, tree=tree, core=core_h, mst=(u, v, w),
        inter_edges=(u[cross], v[cross], w[cross]), weights=weights,
    )

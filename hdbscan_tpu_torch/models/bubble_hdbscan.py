"""Bubble-level HDBSCAN* — the local-model step of the MR pipeline, the port
of ``models/bubble_hdbscan.py``.

Per oversized subset: bubble-corrected distances -> bubble core distances
-> mutual reachability -> dense Borůvka on the fit's device, one fetch of
the MST, the condensed tree and excess-of-mass extraction on the host with
member weights, then noise-bubble reassignment and the inter-cluster edge
mask on the device (:func:`_bubble_reassign_block`, which the RS sample
block of ``models/mr_hdbscan`` shares). ``compat_cf_int_math`` takes the
bubble core distances from the Java code's walk (``core/compat.py``) on
the host and rejoins the device tail (:func:`_bubble_device_block_given_core`).
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
    return _bubble_device_block_given_core(dist, core, num_valid)


def _bubble_device_block_given_core(dist, core, num_valid: int):
    """MRD + Borůvka over a corrected-distance matrix and a core vector: the
    tail of :func:`_bubble_device_block`, entered directly by the compat
    path (whose cores come from the host walk of ``core/compat.py``) and,
    over plain distances, by the MR pipeline's RS sample block. Returns
    (dist, u, v, w, mask, core)."""
    mrd = bubble_mutual_reachability(dist, core)
    u, v, w, mask, _ = boruvka_mst(mrd, num_valid)
    return dist, u, v, w, mask, core


def _bubble_reassign_block(dist, labels, u, v, mask, num_valid: int):
    """Noise reassignment and the inter-cluster edge mask over padded
    inputs: ``labels`` (m_pad,) int64 tensor with zeros on padding
    (padding never donates), ``u``/``v``/``mask`` the padded MST edges.
    Returns ((m_pad,) reassigned labels, (m_pad - 1,) bool crossing mask),
    both on the host."""
    valid = torch.arange(dist.shape[0], device=dist.device) < num_valid
    new = reassign_noise_bubbles(dist, labels, valid=valid)
    cross = mask & inter_cluster_edge_mask(u, v, new)
    return new.cpu().numpy().astype(np.int64), cross.cpu().numpy()


def _host(a) -> np.ndarray:
    """A tensor or array as a float64 host array."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, np.float64)


def _fetch_edges(u_d, v_d, w_d, mask_d):
    """The emitted MST edges of a padded block as host (u, v, w) and the
    host mask."""
    mask = mask_d.cpu().numpy()
    return (u_d.cpu().numpy()[mask], v_d.cpu().numpy()[mask],
            w_d.cpu().numpy().astype(np.float64)[mask], mask)


def fit_bubbles(
    rep: torch.Tensor,
    extent,
    nn_dist,
    n_b,
    min_pts: int,
    min_cluster_size: int,
    metric: str = "euclidean",
    num_valid: int | None = None,
    compat_cf_int_math: bool = False,
) -> BubbleModel:
    """Cluster one subset's bubbles (``rep`` a tensor on the fit's device,
    the other statistics tensors or host arrays, possibly shape-padded past
    ``num_valid``); returns flat labels and the inter-cluster MST edges,
    all sliced to the real bubbles.
    ``compat_cf_int_math`` swaps the core-distance step for the Java
    code's walk (``core/compat.reference_bubble_core_distances``) over the
    live (non-empty) bubbles."""
    m_pad, dims = rep.shape
    m = m_pad if num_valid is None else int(num_valid)
    if m == 0:
        raise ValueError("empty bubble set")
    if m == 1:
        # A single bubble is trivially one (root) cluster, built through the
        # standard tree path so the contract holds.
        empty = np.zeros(0, np.int64)
        w1 = _host(n_b)[:1]
        forest = tree_mod.build_merge_forest(1, empty, empty, np.zeros(0), point_weights=w1)
        tree = tree_mod.condense_forest(forest, min_cluster_size, point_weights=w1)
        tree_mod.propagate_tree(tree)
        return BubbleModel(
            labels=np.ones(1, np.int64), tree=tree, core=np.zeros(1),
            mst=(empty, empty, np.zeros(0)), inter_edges=(empty, empty, np.zeros(0)),
            weights=w1,
        )
    # The compat walk reads the statistics as given (float64 host arrays
    # from ``core/compat.combinestep_bubble_stats``), the device in the
    # fit's type.
    nb_h, ext_h = (_host(a)[:m] for a in (n_b, extent)) if compat_cf_int_math else (None, None)
    extent, nn_dist, n_b = (torch.as_tensor(a, dtype=rep.dtype, device=rep.device)
                            for a in (extent, nn_dist, n_b))
    if compat_cf_int_math:
        from hdbscan_tpu_torch.core import compat

        dist = bubble_distance_matrix(rep, extent, nn_dist, metric)
        # The Java code builds CFs only for samples that received points;
        # the padded pipeline also carries empty bubbles, a shape its walk
        # would crash on. Walk the live bubbles, as the default path's
        # ``ok`` mask excludes the empty ones.
        live = np.flatnonzero(nb_h > 0)
        dist_h = dist.cpu().numpy().astype(np.float64)[:m, :m]
        core_p = np.full(m_pad, np.inf)
        try:
            core_p[live] = compat.reference_bubble_core_distances(
                dist_h[np.ix_(live, live)], nb_h[live], ext_h[live], min_pts, dims
            )
        except IndexError as e:
            # The Java walk's ArrayIndexOutOfBoundsException: the covering
            # loop ran off its k - 1 slot buffer (duplicate-heavy subsets
            # can leave fewer than min_pts - 1 live bubbles).
            raise ValueError(
                "compat_cf_int_math: the reference's covering walk overran "
                f"its neighbor buffer ({m} bubbles, {len(live)} live, "
                f"min_pts={min_pts}) — the Java code throws "
                "ArrayIndexOutOfBoundsException on this shape. Lower "
                "min_pts, raise k/processing_units, or disable compat_cf"
            ) from e
        core = torch.as_tensor(core_p, dtype=rep.dtype, device=rep.device)
        dist, u_d, v_d, w_d, mask_d, core_d = _bubble_device_block_given_core(dist, core, m)
    else:
        dist, u_d, v_d, w_d, mask_d, core_d = _bubble_device_block(
            rep, extent, nn_dist, n_b, m, min_pts, dims, metric
        )
    u, v, w, mask = _fetch_edges(u_d, v_d, w_d, mask_d)
    core_h = core_d[:m].cpu().numpy().astype(np.float64)
    weights = n_b[:m].cpu().numpy().astype(np.float64)

    tree, labels = tree_mod.extract_clusters(
        m, u, v, w, min_cluster_size, point_weights=weights, self_levels=core_h
    )
    labels_p = torch.zeros(m_pad, dtype=torch.int64, device=rep.device)
    labels_p[:m] = torch.as_tensor(labels, dtype=torch.int64, device=rep.device)
    new, cross = _bubble_reassign_block(dist, labels_p, u_d, v_d, mask_d, m)
    cross = cross[mask]
    return BubbleModel(
        labels=new[:m], tree=tree, core=core_h, mst=(u, v, w),
        inter_edges=(u[cross], v[cross], w[cross]), weights=weights,
    )

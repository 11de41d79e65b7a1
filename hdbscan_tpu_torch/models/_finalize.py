"""Shared post-processing tail of every fit(): edge pool -> clustering.

Every fit ends in the same host-side sequence as in the reference — merge forest,
condensed tree, constraint counting, EOM propagation, flat labels, GLOSH —
mirroring the reference's canonical per-node pipeline tail
(SURVEY.md §3.4; ``HDBSCANStar.propagateTree``/``findProminentClusters``/
``calculateOutlierScores``, ``hdbscanstar/HDBSCANStar.java:505,567,653``).
Kept in one place so constraint/propagation fixes apply to every path.

``params.tree_backend`` selects the condense/propagate/labels engine:
``reference`` is the per-node Python walk in ``core/tree.py``, ``vectorized``
the array-level engine in ``core/tree_vec.py`` (bitwise-identical outputs),
and ``auto`` (default) picks vectorized whenever
``tree_vec.supports_inputs`` accepts the inputs, falling back to reference
otherwise (non-integral point weights). Every ``tree_*`` trace event carries
the backend that actually ran (``native``/``python``/``device`` for the
merge forest).

``params.mst_backend`` selects the merge-forest builder upstream of that,
as in the reference: ``auto``/``device`` build the forest from one device
union-find scan (``core/mst_device.build_merge_forest_device``) when the
pool passes its gate, otherwise — and for ``host`` — the host builder
(``core/tree.build_merge_forest``, C fast path) runs. The exact fit builds
its forest on the device itself and passes it in.
"""

from __future__ import annotations

import numpy as np

from hdbscan_tpu_torch.config import HDBSCANParams
from hdbscan_tpu_torch.core import tree as tree_mod
from hdbscan_tpu_torch.core import tree_vec


def resolve_tree_backend(
    params: HDBSCANParams, point_weights: np.ndarray | None
) -> str:
    """The condense/extract engine finalize will actually use."""
    backend = getattr(params, "tree_backend", "auto")
    if backend in ("reference", "vectorized"):
        return backend
    return (
        "vectorized" if tree_vec.supports_inputs(point_weights) else "reference"
    )


def serving_tables(
    tree: tree_mod.CondensedTree, labels: np.ndarray | None = None
) -> dict:
    """Prediction-time views of a propagated condensed tree — the arrays
    ``serve/artifact.ClusterModel`` persists beyond the raw tree fields
    (the reference's ``serving_tables``):

    - ``sel_anc``: per-label nearest selected ancestor-or-self (the flat-label
      jump table, ``core/tree_vec.selected_ancestors``), indexed at serve time
      with the *query's* attachment cluster;
    - ``eps_min``: per-selected-cluster minimum member exit eps ("max
      lambda", ``core/tree.cluster_eps_min``) backing membership
      probabilities;
    - ``eps_max``: per-cluster lowest descendant death (GLOSH numerator,
      ``propagate_tree``'s ``lowest_child_death``).

    ``labels``: the fit's flat labels in the tree's point space (vertex
    space for deduplicated fits); recomputed when omitted.
    """
    if tree.selected is None:
        raise ValueError("propagate_tree() must run before serving_tables()")
    return {
        "sel_anc": tree_vec.selected_ancestors(tree),
        "eps_min": tree_mod.cluster_eps_min(tree, labels),
        "eps_max": np.asarray(tree.lowest_child_death, np.float64),
    }


def finalize_clustering(
    n: int,
    u: np.ndarray,
    v: np.ndarray,
    w: np.ndarray,
    core: np.ndarray,
    params: HDBSCANParams,
    num_constraints_satisfied: np.ndarray | None = None,
    point_weights: np.ndarray | None = None,
    constraint_index_map: np.ndarray | None = None,
    trace=None,
    forest: tree_mod.MergeForest | None = None,
    device=None,
) -> tuple[tree_mod.CondensedTree, np.ndarray, np.ndarray, bool]:
    """Edge pool + core distances -> (tree, labels, outlier_scores, infinite).

    Constraint counts load from ``params.constraints_file`` when not supplied
    (both gamma and virtual-child vGamma credits feed propagation).
    ``point_weights``: member count per vertex (deduplicated pipelines).
    ``constraint_index_map``: row id -> vertex id translation for constraint
    files when vertices are deduplicated points.
    ``trace``: optional per-stage event callable — isolates the host tree
    layers (merge forest / condense / propagate / labels / GLOSH) so the
    multi-M-row runs can tell scan wall from tree wall.
    ``forest``: pre-built merge forest (the device-resident exact fit builds
    it after its single bulk fetch); when omitted, ``params.mst_backend``
    picks the builder, the device one running on ``device``.
    """
    import time as _time

    from hdbscan_tpu_torch.native import merge_forest_lib

    backend = resolve_tree_backend(params, point_weights)
    eng = tree_vec if backend == "vectorized" else tree_mod

    if forest is None:
        from hdbscan_tpu_torch.core import mst_device

        if mst_device.resolve_mst_backend(params, n) == "device" and mst_device.supports_inputs(
            w, point_weights
        ):
            forest = mst_device.build_merge_forest_device(
                n, u, v, w, point_weights=point_weights, trace=trace,
                build_children=(backend == "reference"), device=device,
            )
    if forest is None:
        t0 = _time.monotonic()
        forest = tree_mod.build_merge_forest(
            n, u, v, w, point_weights=point_weights
        )
        if trace is not None:
            trace(
                "tree_merge_forest",
                n=n,
                edges=len(u),
                backend="native" if merge_forest_lib() is not None else "python",
                wall_s=round(_time.monotonic() - t0, 6),
            )
    t0 = _time.monotonic()
    tree = eng.condense_forest(
        forest,
        params.min_cluster_size,
        point_weights=point_weights,
        self_levels=core if params.self_edges else None,
    )
    if trace is not None:
        trace(
            "tree_condense",
            clusters=len(tree.parent) - 1,
            backend=backend,
            wall_s=round(_time.monotonic() - t0, 6),
        )
    virtual_child_constraints = None
    if params.constraints_file and num_constraints_satisfied is None:
        from hdbscan_tpu_torch.core.constraints import (
            Constraint,
            count_constraints_satisfied,
            load_constraints,
        )

        cons = load_constraints(params.constraints_file)
        if constraint_index_map is not None:
            cons = [
                Constraint(
                    int(constraint_index_map[c.point_a]),
                    int(constraint_index_map[c.point_b]),
                    c.kind,
                )
                for c in cons
            ]
        num_constraints_satisfied, virtual_child_constraints = (
            count_constraints_satisfied(tree, cons)
        )
    t0 = _time.monotonic()
    infinite = eng.propagate_tree(
        tree, num_constraints_satisfied, virtual_child_constraints
    )
    if trace is not None:
        trace(
            "tree_propagate",
            backend=backend,
            wall_s=round(_time.monotonic() - t0, 6),
        )
    t0 = _time.monotonic()
    labels = eng.flat_labels(tree)
    if trace is not None:
        trace(
            "tree_labels",
            backend=backend,
            wall_s=round(_time.monotonic() - t0, 6),
        )
    t0 = _time.monotonic()
    scores = tree_mod.outlier_scores(tree, core)
    if trace is not None:
        trace(
            "tree_glosh",
            backend=backend,
            wall_s=round(_time.monotonic() - t0, 6),
        )
    return tree, labels, scores, infinite

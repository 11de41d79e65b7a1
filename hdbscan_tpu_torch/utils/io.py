"""Dataset ingest and the five canonical output files.

Ingest re-designs ``mappers/MapperDataset_github.java:12-20`` (whitespace-split
lines -> (rowIndex, double[])); both bundled datasets load with the same
reader (``数据集/dataset.txt`` space-separated, ``数据集/Skin_NonSkin.txt``
tab-separated). Output formats follow the reference's documented contract
(``main/Main.java:534-614``):

- ``<base>_hierarchy.csv``: ``<epsilon>,<label_1>,...,<label_n>`` per level
  (descending); noise = 0. Full hierarchy = every processed edge-weight level;
  compact = only levels where clusters are born or die.
- ``<base>_tree.csv``: ``<label>,<birth>,<death>,<stability>,<gamma>,
  <virtual child gamma>,<character_offset>,<parent>``.
- ``<base>_partition.csv``: one line of flat labels.
- ``<base>_outlier_scores.csv``: ``<score>,<id>`` sorted most-inlier first
  (ties by core distance then id, ``hdbscanstar/OutlierScore.java:36-50``).
- ``<base>_visualization.vis``: auxiliary summary for the visualization module.
"""

from __future__ import annotations

import numpy as np

from hdbscan_tpu_torch.core.tree import CondensedTree


def load_points(path: str, max_rows: int | None = None) -> np.ndarray:
    """Whitespace/comma tolerant float matrix loader (one object per line).

    Any comma in the first line selects CSV mode (np.loadtxt strips spaces
    around comma-separated fields); otherwise whitespace-split, which covers
    both bundled datasets (space- and tab-separated).
    """
    with open(path) as f:
        first = f.readline()
    delim = "," if "," in first else None
    return np.loadtxt(path, delimiter=delim, max_rows=max_rows, dtype=np.float64)


def hierarchy_levels(tree: CondensedTree, compact: bool) -> np.ndarray:
    """Significant epsilon levels, descending."""
    births = tree.birth[1:]
    deaths = tree.death[1:]
    if compact:
        levels = np.concatenate([births, deaths])
    else:
        levels = np.concatenate([births, deaths, tree.point_exit_level])
    levels = levels[np.isfinite(levels) & (levels > 0)]
    return np.unique(levels)[::-1]


def _ancestor_chains(
    tree: CondensedTree, labels: np.ndarray
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per label: (chain labels root-first, their births — descending along
    the chain). The single chain-walk implementation shared by the matrix
    and streaming hierarchy paths."""
    out = []
    for label in labels:
        labels_c, births_c = [], []
        c = int(label)
        while c > 0:
            labels_c.append(c)
            births_c.append(tree.birth[c])
            c = int(tree.parent[c]) if tree.parent[c] > 0 else 0
        out.append((np.array(labels_c[::-1]), np.array(births_c[::-1])))
    return out


def hierarchy_matrix(tree: CondensedTree, levels: np.ndarray) -> np.ndarray:
    """(L, n) label matrix: row r = labels after processing level ``levels[r]``.

    Label of point p at level w: 0 if p exited at a level >= w, else the
    deepest cluster on p's ancestor chain born at level >= w (clusters that
    "continue" keep their label, mirroring currentClusterLabels semantics in
    ``HdbscanDataBubbles.java:256-374``).
    """
    n = tree.n_points
    out = np.zeros((len(levels), n), np.int64)
    # One chain walk + searchsorted per DISTINCT last-cluster (not per point):
    # points sharing a last cluster share the whole label column except the
    # exit cutoff, which is vectorized below.
    uniq = np.unique(tree.point_last_cluster)
    for label, (labels_c, births_c) in zip(uniq, _ancestor_chains(tree, uniq)):
        # deepest cluster with birth >= w
        pos = np.searchsorted(-births_c, -levels, side="right") - 1
        col = labels_c[np.clip(pos, 0, len(labels_c) - 1)]
        pts = np.nonzero(tree.point_last_cluster == label)[0]
        exits = tree.point_exit_level[pts]
        exited = (exits[None, :] > 0) & (levels[:, None] <= exits[None, :])
        out[:, pts] = np.where(exited, 0, col[:, None])
    return out


def write_hierarchy_file(path: str, tree: CondensedTree, compact: bool, delimiter: str = ",") -> dict[int, int]:
    """Writes the hierarchy file; returns {cluster label: char offset of the
    first row where it appears} (the ``fileOffset`` of ``Cluster.java:165``).

    Streams one level row at a time in O(n) memory — never the (L, n) label
    matrix, which at a 1M-point FULL hierarchy (L ~ distinct edge weights)
    would be tens of GB. Levels descend, so each distinct last-cluster chain
    keeps a monotone pointer to its deepest cluster born at >= the current
    level; rows are byte-identical to the matrix path
    (:func:`hierarchy_matrix`, kept for tests/diagnostics).
    """
    levels = hierarchy_levels(tree, compact)
    offsets: dict[int, int] = {}
    pos = 0
    # One ancestor-chain walk per DISTINCT last cluster (not per point).
    uniq, chain_of_point = np.unique(tree.point_last_cluster, return_inverse=True)
    chains = _ancestor_chains(tree, uniq)
    # Event-driven pointer advance: chain element j becomes current at the
    # first (descending) level row where its birth >= the row's level —
    # precomputed with one searchsorted per chain, so the per-level work is
    # O(events at that row) instead of a Python sweep over every chain.
    cur = np.array([labels_c[0] for labels_c, _ in chains], np.int64)
    ev_row, ev_chain, ev_label = [], [], []
    for ci, (labels_c, births_c) in enumerate(chains):
        if len(labels_c) > 1:
            rows = np.searchsorted(-levels, -births_c[1:], side="left")
            ev_row.append(rows)
            ev_chain.append(np.full(len(rows), ci, np.int64))
            ev_label.append(labels_c[1:])
    if ev_row:
        ev_row = np.concatenate(ev_row)
        ev_chain = np.concatenate(ev_chain)
        ev_label = np.concatenate(ev_label)
        # stable by (row, chain depth order): deeper elements of a chain come
        # later in each chain's slice, so the deepest born-at-this-row wins.
        order = np.argsort(ev_row, kind="stable")
        ev_row, ev_chain, ev_label = ev_row[order], ev_chain[order], ev_label[order]
    else:
        ev_row = np.zeros(0, np.int64)
        ev_chain = ev_label = np.zeros(0, np.int64)
    ev_i = 0
    exits = tree.point_exit_level
    has_exit = exits > 0
    with open(path, "w") as f:
        for r, w in enumerate(levels):
            while ev_i < len(ev_row) and ev_row[ev_i] <= r:
                cur[ev_chain[ev_i]] = ev_label[ev_i]
                ev_i += 1
            row = np.where(has_exit & (w <= exits), 0, cur[chain_of_point])
            line = f"{w:.9g}" + delimiter + delimiter.join(map(str, row)) + "\n"
            for lbl in np.unique(row):
                if lbl > 0 and lbl not in offsets:
                    offsets[int(lbl)] = pos
            f.write(line)
            pos += len(line)
    return offsets


def write_tree_file(
    path: str,
    tree: CondensedTree,
    offsets: dict[int, int] | None = None,
    delimiter: str = ",",
) -> None:
    offsets = offsets or {}
    zeros = np.zeros(tree.n_clusters + 1, np.int64)
    cons = tree.num_constraints_satisfied if tree.num_constraints_satisfied is not None else zeros
    vcons = (
        tree.virtual_child_constraints
        if tree.virtual_child_constraints is not None
        else zeros
    )
    with open(path, "w") as f:
        for c in range(1, tree.n_clusters + 1):
            parent = tree.parent[c] if tree.parent[c] > 0 else 0
            row = [
                str(c),
                f"{tree.birth[c]:.9g}",
                f"{tree.death[c]:.9g}",
                f"{tree.stability[c]:.9g}",
                str(int(cons[c])),
                str(int(vcons[c])),
                str(offsets.get(c, 0)),
                str(int(parent)),
            ]
            f.write(delimiter.join(row) + "\n")


def write_partition_file(path: str, labels: np.ndarray, delimiter: str = ",") -> None:
    with open(path, "w") as f:
        f.write(delimiter.join(map(str, np.asarray(labels, np.int64))) + "\n")


def write_outlier_scores_file(
    path: str, scores: np.ndarray, core_distances: np.ndarray, delimiter: str = ","
) -> None:
    order = np.lexsort((np.arange(len(scores)), core_distances, scores))
    with open(path, "w") as f:
        for i in order:
            f.write(f"{scores[i]:.9g}{delimiter}{i}\n")


def write_visualization_file(path: str, tree: CondensedTree, labels: np.ndarray) -> None:
    """Auxiliary summary (the reference's .vis file is consumed only by an
    external visualization module; we emit a small self-describing version)."""
    import json

    sel = tree.selected if tree.selected is not None else np.zeros(1, bool)
    payload = {
        "n_points": int(tree.n_points),
        "n_clusters": int(tree.n_clusters),
        "selected": [int(c) for c in np.nonzero(sel)[0]],
        "n_noise": int(np.sum(np.asarray(labels) == 0)),
    }
    with open(path, "w") as f:
        json.dump(payload, f)
        f.write("\n")

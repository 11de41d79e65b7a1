"""Vectorized condensed-tree finalize engine (``tree_backend=vectorized``).

Array-level reimplementation of the host finalize tail in ``core/tree.py``:

- :func:`condense_forest` — condensation as a structural pass over the merge
  forest (alive-set, chain and terminal arrays via pointer doubling) plus one
  ``np.add.at`` segment-sum for stabilities, instead of the reference's
  per-node Python stack with per-exit ``subtree_points`` re-walks;
- :func:`propagate_tree` — EOM propagation as bottom-up depth rounds with
  boolean selected-set arrays (no descendant-list concatenation);
- :func:`flat_labels` — nearest-selected-ancestor pointer jumping.

Output is **bitwise identical** to the reference backend on every
``CondensedTree`` field (cuSLINK/PANDORA-style array extraction, with the
reference kept as the parity oracle — see ``tests/unit/test_tree_vec.py``).
The ordering argument: ``np.add.at`` applies repeated-index additions
sequentially in index order, so arranging the global detach-event array so
each label's events appear in the reference DFS order (chain nodes top-down =
merge-node ids descending; within a split, big kids in child order before
small kids in child order; terminal self-level events last because point ids
sort below merge ids; multi-root virtual events prepended) reproduces the
reference's float accumulation exactly. Counts are exact because detached
subtree weights equal the forest's ``sizes`` entries when point weights are
integral — :func:`supports_inputs` gates the ``auto`` backend on exactly
that.

Cluster labels must also match: the reference assigns them at split time
during a LIFO-stack DFS, so a tiny O(C) Python walk over the *cluster
skeleton* (chains + split fan-outs, not points) replays the numbering; every
per-point and per-event quantity stays vectorized.
"""

from __future__ import annotations

import numpy as np

from hdbscan_tpu_torch.core.tree import ROOT_LABEL, CondensedTree, MergeForest


def supports_inputs(point_weights) -> bool:
    """True when the vectorized backend is bitwise-safe for these inputs.

    The one assumption the event-ordering proof needs is that a detached
    subtree's weight sum equals the forest's accumulated ``sizes`` entry,
    which holds exactly for integral (finite) point weights — ones for raw
    points, member counts for deduplicated/bubble vertices. Non-integral
    weights fall back to the reference backend under ``tree_backend=auto``.
    """
    if point_weights is None:
        return True
    pw = np.asarray(point_weights, np.float64)
    return bool(np.all(np.isfinite(pw)) and np.all(pw == np.floor(pw)))


def _fixpoint_jump(jump: np.ndarray) -> np.ndarray:
    """Pointer-double ``jump`` to its fixpoint (~log2(depth) rounds).

    Runs in int32 — node ids stay far below 2**31 and halving the gather
    bandwidth roughly halves the per-round cost at production sizes.
    """
    jump = jump.astype(np.int32, copy=False)
    while True:
        nxt = jump[jump]
        if np.array_equal(nxt, jump):
            return jump
        jump = nxt


def condense_forest(
    forest: MergeForest,
    min_cluster_size: int | float,
    point_weights: np.ndarray | None = None,
    self_levels: np.ndarray | None = None,
) -> CondensedTree:
    """Array-level :func:`hdbscan_tpu_torch.core.tree.condense_forest`."""
    n = forest.n_points
    if point_weights is None:
        point_weights = np.ones(n, np.float64)
    point_weights = np.asarray(point_weights, np.float64)
    sizes = forest.sizes
    t = len(forest.dist)
    total = n + t
    ids = np.arange(total, dtype=np.int64)

    # --- CSR over active (non-absorbed) merge nodes ----------------------
    # The native builder ships the CSR directly (kids in list order); a
    # pure-Python forest falls back to flattening the lists.
    if forest.kids_csr is not None:
        kids_flat, kid_count = forest.kids_csr
        active_mask = kid_count > 0
        act_nodes = np.flatnonzero(active_mask).astype(np.int64) + n
        lens = kid_count[active_mask]
        n_kids = len(kids_flat)
    else:
        from itertools import chain

        kid_lists = [c for c in forest.children if c is not None]
        active_mask = np.fromiter(
            map(lambda c: c is not None, forest.children), bool, count=t
        )
        act_nodes = np.flatnonzero(active_mask).astype(np.int64) + n
        lens = np.fromiter(map(len, kid_lists), np.int64, count=len(kid_lists))
        n_kids = int(lens.sum())
        kids_flat = np.fromiter(
            chain.from_iterable(kid_lists), np.int64, count=n_kids
        )
    kid_owner = np.repeat(act_nodes, lens)
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    kid_pos = np.arange(n_kids, dtype=np.int64) - np.repeat(offs[:-1], lens)
    csr_off = np.full(total, -1, np.int64)
    csr_len = np.zeros(total, np.int64)
    csr_off[act_nodes] = offs[:-1]
    csr_len[act_nodes] = lens

    par = np.full(total, -1, np.int64)
    par[kids_flat] = kid_owner

    roots = np.asarray(forest.roots, np.int64)  # ascending
    big = sizes >= min_cluster_size
    single_root = len(roots) == 1
    if single_root:
        processed_roots = roots  # the lone root is walked regardless of size
    else:
        processed_roots = roots[big[roots]]
        small_roots = roots[~big[roots]]

    # --- alive set: nodes the reference traversal actually visits --------
    # A node is alive iff it and every ancestor is big (roots per the rules
    # above). Climb to the nearest bad-or-root stop via pointer doubling:
    # stopping on a bad node means some ancestor was small.
    bad = ~big
    absorbed = np.ones(t, bool)
    absorbed[act_nodes - n] = False
    bad[n:][absorbed] = True
    bad[processed_roots] = False  # walked regardless of size
    stop = _fixpoint_jump(np.where(bad | (par < 0), ids, par))
    alive = ~bad[stop]

    # --- chain structure -------------------------------------------------
    nb = np.bincount(kid_owner[big[kids_flat]], minlength=total)  # big kids
    is_start = np.zeros(total, bool)
    nonroot_alive = alive & (par >= 0)
    is_start[nonroot_alive] = nb[par[nonroot_alive]] >= 2
    is_start[processed_roots] = True
    rep = _fixpoint_jump(np.where(is_start | ~alive, ids, par))

    is_merge = ids >= n
    terminal = alive & (~is_merge | (nb != 1))
    term_nodes = np.flatnonzero(terminal)
    term_of_start = np.full(total, -1, np.int64)
    term_of_start[rep[term_nodes]] = term_nodes

    big_kid_mask = big[kids_flat]

    # --- label numbering: O(C) replay of the reference's LIFO DFS --------
    # new_cluster() hands out labels when a split is *processed*; children
    # get consecutive labels in child order and are then explored in reverse
    # (stack pop order). Multi-root pools label big roots 2.. ascending.
    label_of_start: dict[int, int] = {}
    stack: list[int] = []
    next_label = 2
    if single_root or len(processed_roots) == 1:
        if len(processed_roots):
            s0 = int(processed_roots[0])
            label_of_start[s0] = ROOT_LABEL
            stack.append(s0)
    else:
        for r in processed_roots:  # >= 2 big roots: new clusters at +inf
            label_of_start[int(r)] = next_label
            next_label += 1
            stack.append(int(r))
    while stack:
        s = stack.pop()
        T = int(term_of_start[s])
        if T >= n and nb[T] >= 2:
            lo = csr_off[T]
            sl = slice(lo, lo + csr_len[T])
            for c in kids_flat[sl][big_kid_mask[sl]]:
                label_of_start[int(c)] = next_label
                next_label += 1
                stack.append(int(c))
    C = next_label - 1

    node_label = np.zeros(total, np.int64)
    if label_of_start:
        starts_arr = np.fromiter(label_of_start.keys(), np.int64, len(label_of_start))
        labels_arr = np.fromiter(
            label_of_start.values(), np.int64, len(label_of_start)
        )
        node_label[starts_arr] = labels_arr
    chain_label = np.zeros(total, np.int64)
    alive_idx = np.flatnonzero(alive)
    chain_label[alive_idx] = node_label[rep[alive_idx]]

    # --- per-cluster arrays ----------------------------------------------
    parent_l = np.zeros(C + 1, np.int64)
    birth = np.zeros(C + 1, np.float64)
    death = np.zeros(C + 1, np.float64)
    has_children = np.zeros(C + 1, bool)
    num_members = np.zeros(C + 1, np.float64)
    parent_l[ROOT_LABEL] = -1
    birth[ROOT_LABEL] = np.inf
    num_members[ROOT_LABEL] = float(sizes[forest.roots].sum())

    if label_of_start:
        sn = starts_arr
        lb = labels_arr
        nonroot = lb != ROOT_LABEL
        psn = par[sn]  # split node that created the cluster (-1 for roots)
        from_split = nonroot & (psn >= 0)
        parent_l[lb[from_split]] = chain_label[psn[from_split]]
        birth[lb[from_split]] = forest.dist[psn[from_split] - n]
        from_pool = nonroot & (psn < 0)  # multi-root big roots
        parent_l[lb[from_pool]] = ROOT_LABEL
        birth[lb[from_pool]] = np.inf
        num_members[lb[nonroot]] = sizes[sn[nonroot]]

        # Terminal kind decides has_children and death.
        tm = term_of_start[sn]
        split_t = (tm >= n) & (nb[tm] >= 2)
        has_children[lb] = split_t
        merge_t = tm >= n
        death[lb[merge_t]] = forest.dist[tm[merge_t] - n]
        point_t = np.flatnonzero(~merge_t)
        if self_levels is not None and len(point_t):
            death[lb[point_t]] = np.asarray(self_levels, np.float64)[tm[point_t]]
        # else: a chain ending on a point without self levels never dies (0).

    if not single_root:
        if len(processed_roots) >= 2:
            has_children[ROOT_LABEL] = True  # virtual split at +inf
        if len(processed_roots) != 1:
            death[ROOT_LABEL] = np.inf  # all mass leaves at +inf

    # --- stability: one ordered np.add.at segment sum --------------------
    # Every kid of an alive merge node detaches from the node's chain label,
    # except the lone big kid the chain continues into.
    owner_alive = alive[kid_owner]
    ev_mask = owner_alive & ~((nb[kid_owner] == 1) & big_kid_mask)
    ev_node = kid_owner[ev_mask]
    ev_label = chain_label[ev_node]
    ev_count = sizes[kids_flat[ev_mask]]
    ev_level = forest.dist[ev_node - n]
    ev_small = ~big_kid_mask[ev_mask]
    ev_pos = kid_pos[ev_mask]
    # Alive point terminals detach themselves at their self level, last in
    # their chain (point ids < n < merge ids under the descending-node key).
    alive_pts = alive_idx[alive_idx < n]
    if self_levels is not None and len(alive_pts):
        sl_arr = np.asarray(self_levels, np.float64)
        ev_node = np.concatenate([ev_node, alive_pts])
        ev_label = np.concatenate([ev_label, chain_label[alive_pts]])
        ev_count = np.concatenate([ev_count, point_weights[alive_pts]])
        ev_level = np.concatenate([ev_level, sl_arr[alive_pts]])
        ev_small = np.concatenate([ev_small, np.ones(len(alive_pts), bool)])
        ev_pos = np.concatenate([ev_pos, np.zeros(len(alive_pts), np.int64)])
    order = np.lexsort((ev_pos, ev_small, -ev_node))
    ev_label, ev_count, ev_level = ev_label[order], ev_count[order], ev_level[order]
    if not single_root:
        # Virtual root split, processed before everything else: small roots
        # exit into ROOT at +inf, then (>= 2 big) each big root detaches.
        v_nodes = [small_roots]
        if len(processed_roots) >= 2:
            v_nodes.append(processed_roots)
        v_nodes = np.concatenate(v_nodes)
        ev_label = np.concatenate(
            [np.full(len(v_nodes), ROOT_LABEL, np.int64), ev_label]
        )
        ev_count = np.concatenate([sizes[v_nodes], ev_count])
        ev_level = np.concatenate([np.full(len(v_nodes), np.inf), ev_level])

    with np.errstate(divide="ignore", invalid="ignore"):
        inv_level = np.where(ev_level == 0, np.inf, 1.0 / ev_level)
        b = birth[ev_label]
        inv_birth = np.where(np.isinf(b), 0.0, np.where(b == 0, np.inf, 1.0 / b))
        contrib = ev_count * (inv_level - inv_birth)
    stability = np.zeros(C + 1, np.float64)
    np.add.at(stability, ev_label, contrib)

    # --- per-point exit records ------------------------------------------
    point_exit_level = np.zeros(n, np.float64)
    point_last_cluster = np.full(n, ROOT_LABEL, np.int64)
    # Dead points exit where their topmost dead ancestor hangs off an alive
    # node (or at +inf into ROOT when that ancestor is an unprocessed root).
    stop_dead = alive | (par < 0) | alive[np.maximum(par, 0)]
    top_dead = _fixpoint_jump(np.where(stop_dead, ids, par))
    dead_pts = np.flatnonzero(~alive[:n])
    if len(dead_pts):
        ta = top_dead[dead_pts]
        exit_par = par[ta]
        pooled = exit_par < 0
        point_exit_level[dead_pts[pooled]] = np.inf
        inpar = dead_pts[~pooled]
        xp = exit_par[~pooled]
        point_exit_level[inpar] = forest.dist[xp - n]
        point_last_cluster[inpar] = chain_label[xp]
    if len(alive_pts):
        point_last_cluster[alive_pts] = chain_label[alive_pts]
        if self_levels is not None:
            point_exit_level[alive_pts] = np.asarray(self_levels, np.float64)[
                alive_pts
            ]

    return CondensedTree(
        n_points=n,
        parent=parent_l,
        birth=birth,
        death=death,
        stability=stability,
        has_children=has_children,
        num_members=num_members,
        point_exit_level=point_exit_level,
        point_last_cluster=point_last_cluster,
    )


def _depths(parent: np.ndarray) -> np.ndarray:
    """Per-label depth (root = 0) via pointer doubling on the parent array."""
    idx = np.arange(len(parent), dtype=np.int64)
    jump = np.where(parent > 0, parent, idx)
    depth = (parent > 0).astype(np.int64)
    while True:
        nxt = depth + depth[jump]
        if np.array_equal(nxt, depth):
            return depth
        depth = nxt
        jump = jump[jump]


def propagate_tree(
    tree: CondensedTree,
    num_constraints_satisfied: np.ndarray | None = None,
    virtual_child_constraints: np.ndarray | None = None,
) -> bool:
    """Array-level :func:`hdbscan_tpu_torch.core.tree.propagate_tree`.

    Bottom-up depth rounds: all children of a label share one depth, and
    within a round the ``np.add.at`` index arrays are ordered by label
    descending, which is exactly the per-parent accumulation order of the
    reference's descending-label loop — so propagated stabilities match
    bitwise. Selection is the boolean form of the descendant-list mechanics:
    a label is selected iff it wins against its own subtree and no proper
    non-root ancestor also wins.
    """
    c = tree.n_clusters
    if num_constraints_satisfied is None:
        num_constraints_satisfied = np.zeros(c + 1, np.int64)
    prop_stab = np.zeros(c + 1, np.float64)
    if virtual_child_constraints is None:
        prop_cons = np.zeros(c + 1, np.int64)
    else:
        prop_cons = np.asarray(virtual_child_constraints, np.int64).copy()
    lowest_death = np.full(c + 1, np.inf)
    parent = tree.parent
    depth = _depths(parent)

    labels = np.arange(1, c + 1, dtype=np.int64)
    order = np.lexsort((-labels, -depth[labels]))  # depth desc, label desc
    labels = labels[order]
    bounds = np.flatnonzero(np.diff(depth[labels])) + 1
    groups = np.split(labels, bounds)

    self_wins = np.zeros(c + 1, bool)
    for grp in groups:  # deepest first; parents always in a later round
        fix = lowest_death[grp] == np.inf
        lowest_death[grp[fix]] = tree.death[grp[fix]]
        up = parent[grp]
        m = up > 0
        lbl, up = grp[m], up[m]
        if not len(lbl):
            continue
        own_cons = num_constraints_satisfied[lbl]
        own_stab = tree.stability[lbl]
        wins = (
            ~tree.has_children[lbl]
            | (own_cons > prop_cons[lbl])
            | ((own_cons == prop_cons[lbl]) & (own_stab >= prop_stab[lbl]))
        )
        self_wins[lbl] = wins
        np.add.at(prop_cons, up, np.where(wins, own_cons, prop_cons[lbl]))
        np.add.at(prop_stab, up, np.where(wins, own_stab, prop_stab[lbl]))
        np.minimum.at(lowest_death, up, lowest_death[lbl])

    # blocked[L]: some proper non-root ancestor self-wins (its subtree list
    # never reaches the root's descendant set). Top-down rounds.
    blocked = np.zeros(c + 1, bool)
    for grp in groups[::-1]:
        up = parent[grp]
        m = up > 0
        lbl, up = grp[m], up[m]
        blocked[lbl] = blocked[up] | (self_wins[up] & (parent[up] > 0))
    selected = self_wins & ~blocked & (parent > 0)

    tree.propagated_stability = prop_stab
    tree.lowest_child_death = lowest_death
    tree.num_constraints_satisfied = num_constraints_satisfied
    tree.virtual_child_constraints = virtual_child_constraints
    tree.selected = selected
    return tree.infinite_stability


def selected_ancestors(tree: CondensedTree) -> np.ndarray:
    """Per-label nearest selected ancestor-or-self (0 = noise) via pointer
    doubling — the jump table behind :func:`flat_labels`, exposed on its own
    because serving (``serve/predict.py``) indexes it with *query* attachment
    clusters rather than the training points' last clusters."""
    if tree.selected is None:
        raise ValueError("propagate_tree() must run before selected_ancestors()")
    c = tree.n_clusters
    idx = np.arange(c + 1, dtype=np.int64)
    jump = np.where(tree.selected, idx, np.where(tree.parent > 0, tree.parent, 0))
    return _fixpoint_jump(jump).astype(np.int64)


def flat_labels(tree: CondensedTree) -> np.ndarray:
    """Array-level :func:`hdbscan_tpu_torch.core.tree.flat_labels`."""
    return selected_ancestors(tree)[tree.point_last_cluster]

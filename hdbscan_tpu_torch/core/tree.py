"""Condensed cluster tree, stability, EOM flat extraction, GLOSH (host side).

Re-design of the reference's hierarchy/cluster-tree layer:

- ``HdbscanDataBubbles.constructClusterTree`` (``databubbles/HdbscanDataBubbles.java:256-374``):
  top-down edge removal in weight-tie groups, BFS component discovery,
  member-weighted minClusterSize, multi-way splits, ``detachPoints`` stability.
- ``Cluster.detachPoints`` / ``Cluster.propagate``
  (``hdbscanstar/Cluster.java:80-88,98-142``): stability
  ``sum(n) * (1/level - 1/birthLevel)`` and excess-of-mass propagation with
  constraint priority and parent-wins ties.
- ``HDBSCANStar.propagateTree`` / ``findProminentClusters`` /
  ``calculateOutlierScores`` (``hdbscanstar/HDBSCANStar.java:505,567,653``).

The irregular, data-dependent tree extraction stays on host (numpy + python),
operating on the MST edge list produced by the device Borůvka kernel — the
inputs are O(n), not O(n^2). Device work ends at the edge list.

Equivalence note: instead of literally removing edges heaviest-to-lightest and
BFS-ing components (O(n * levels)), we build the single-linkage merge forest
bottom-up with union-find, contract equal-weight merge chains into multi-way
nodes, and condense top-down over that forest. Level-wise component structure
of a graph is identical either way, and tie groups are handled exactly (merge
nodes at equal weight that touch are one multi-way split), so the condensed
tree equals the reference's — independent of MST tie-breaking.

Deliberate bug fixes vs the reference (SURVEY.md §7 "parity decisions"):
- tie groups that split one cluster into several components process each
  component once (the reference re-BFS-es a component once per affected vertex,
  ``HdbscanDataBubbles.java:307-312``, duplicating detaches);
- flat extraction follows the correct ``Cluster.propagate`` EOM (the live
  bubble variant ``findProminentClustersAndClassificationNoiseBubbles``
  drops leaf clusters from its solution set and lets shallow clusters
  overwrite deep ones, ``HdbscanDataBubbles.java:377-504``);
- the root cluster's birth level is +inf (1/birth = 0) rather than NaN
  (``HdbscanDataBubbles.java:276``), so root stability is well defined.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NOISE = 0  # reference noise label (currentClusterLabels[v] = 0)
ROOT_LABEL = 1  # reference root cluster label (HdbscanDataBubbles.java:276)


# ---------------------------------------------------------------------------
# Single-linkage merge forest (union-find Kruskal + tie contraction)
# ---------------------------------------------------------------------------


@dataclass
class MergeForest:
    """Multi-way single-linkage merge forest over n points.

    Internal node ids are ``n + t``; ``children[t]`` lists the node ids merged
    at distance ``dist[t]``. Equal-weight merges that touch are contracted into
    one multi-way node, which makes the forest invariant to MST tie order.
    """

    n_points: int
    children: list  # list[list[int]]
    dist: np.ndarray  # (t,) float64
    roots: list  # node ids of the final components
    sizes: np.ndarray  # (n + t,) weighted member count per node
    #: Optional CSR twin of ``children`` from the native builder:
    #: ``(kid_flat, kid_count)`` with ``kid_count[t] == 0`` for absorbed
    #: nodes and kids in list order. ``core/tree_vec.py`` consumes it
    #: directly; ``None`` (pure-Python build) falls back to flattening the
    #: lists.
    kids_csr: tuple | None = None


#: Relative tolerance for grouping equal-weight edges into one hierarchy
#: level. Mathematically-tied distances (grid data, duplicate points) round
#: differently depending on summation order — e.g. sqrt(0.07) from two Iris
#: pairs differs at 1e-12 — and exact float equality (the reference's
#: ``mst.getEdgeWeightAtIndex(i) == currentEdgeWeight``,
#: ``HdbscanDataBubbles.java:284``) then splits a true tie into two levels,
#: creating spurious zero-stability clusters. SURVEY.md §7 "hard parts"
#: decision: epsilon tie-grouping, anchored at the first weight of a group.
TIE_RTOL = 1e-9


def _tied(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b))


def build_merge_forest(
    n: int,
    u: np.ndarray,
    v: np.ndarray,
    w: np.ndarray,
    point_weights: np.ndarray | None = None,
    tie_rtol: float = TIE_RTOL,
) -> MergeForest:
    """Kruskal over an arbitrary edge pool (cycle edges skipped).

    Accepts the merged multi-level edge pool of the distributed pipeline
    (local MSTs + inter-cluster edges, ``main/Main.java:304-348`` analog), not
    just a clean MST.
    """
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    w = np.asarray(w, np.float64)
    if point_weights is None:
        point_weights = np.ones(n, np.int64)
    order = np.lexsort((v, u, w))
    u, v, w = u[order], v[order], w[order]

    from hdbscan_tpu_torch.native import merge_forest_lib

    lib = merge_forest_lib()
    if lib is not None:
        return _build_merge_forest_native(lib, n, u, v, w, point_weights, tie_rtol)

    max_nodes = n + len(w)
    parent = np.arange(max_nodes, dtype=np.int64)  # union-find over node ids
    top = np.arange(n, dtype=np.int64)  # root of the merge-tree per UF root
    sizes = np.zeros(max_nodes, np.float64)
    sizes[:n] = point_weights
    children: list = []
    dists: list = []
    anchors: list = []  # first (smallest) weight of each node's tie group
    next_node = n

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(len(w)):
        ra, rb = find(u[i]), find(v[i])
        if ra == rb:
            continue
        ta, tb = top[ra], top[rb]
        wi = float(w[i])
        kids = []
        anchor = wi
        for t in (ta, tb):
            # Compare against the child's group ANCHOR (first weight of its
            # tie group), not its own weight — pairwise comparison would let
            # chains of near-ties drift past the tolerance.
            if t >= n and _tied(anchors[t - n], wi, tie_rtol):
                kids.extend(children[t - n])  # contract equal-weight chain
                anchor = min(anchor, anchors[t - n])
                children[t - n] = None  # absorbed
            else:
                kids.append(t)
        node = next_node
        next_node += 1
        children.append(kids)
        dists.append(wi)
        anchors.append(anchor)
        sizes[node] = sizes[ta] + sizes[tb]
        parent[rb] = ra
        top[ra] = node

    roots = sorted({top[find(p)] for p in range(n)})
    t = next_node - n
    return MergeForest(
        n_points=n,
        children=children[:t],
        dist=np.asarray(dists, np.float64),
        roots=list(roots),
        sizes=sizes[: n + t],
    )


def _build_merge_forest_native(lib, n, u, v, w, point_weights, tie_rtol):
    """C fast path of :func:`build_merge_forest` (same semantics; the per-edge
    union/tie-contraction loop dominates host time at 100k+ edges)."""
    import ctypes

    m = len(w)
    pw = np.ascontiguousarray(point_weights, np.float64)
    parent = np.empty(n, np.int64)  # the C side unions POINT roots only
    top = np.empty(n, np.int64)
    sizes = np.empty(n + m, np.float64)
    dist = np.empty(max(m, 1), np.float64)
    anchor = np.empty(max(m, 1), np.float64)
    absorbed = np.zeros(max(m, 1), np.uint8)
    child_head = np.empty(max(m, 1), np.int64)
    child_tail = np.empty(max(m, 1), np.int64)
    child_next = np.empty(n + m, np.int64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    i64, f64, u8 = ctypes.c_int64, ctypes.c_double, ctypes.c_uint8
    t_count = lib.build_merge_forest_c(
        n, m,
        p(np.ascontiguousarray(u), i64), p(np.ascontiguousarray(v), i64),
        p(np.ascontiguousarray(w), f64), p(pw, f64), float(tie_rtol),
        p(parent, i64), p(top, i64), p(sizes, f64),
        p(dist, f64), p(anchor, f64), p(absorbed, u8),
        p(child_head, i64), p(child_tail, i64), p(child_next, i64),
    )
    # Flatten the intrusive child lists in C (CSR in list order), then cut
    # the Python lists from one tolist() pass — the per-kid Python walk this
    # replaces dominated wrapper time at 100k+ points.
    kid_flat = np.empty(n + m, np.int64)
    kid_count = np.empty(max(t_count, 1), np.int64)
    n_kids = lib.flatten_children_c(
        t_count, p(absorbed, u8), p(child_head, i64), p(child_next, i64),
        p(kid_flat, i64), p(kid_count, i64),
    )
    kid_flat = kid_flat[:n_kids]
    kid_count = kid_count[:t_count]
    flat_list = kid_flat.tolist()
    offs = np.zeros(t_count + 1, np.int64)
    np.cumsum(kid_count, out=offs[1:])
    children: list = [
        flat_list[offs[t]:offs[t + 1]] if not absorbed[t] else None
        for t in range(t_count)
    ]
    # roots: flatten the POINT union-find (the C side unions point roots
    # only; entries past n are uninitialized), then take each component
    # root's merge-tree top.
    pref = parent[:n].copy()
    while True:
        q = pref[pref]
        if np.array_equal(q, pref):
            break
        pref = q
    roots = sorted({int(top[r]) for r in np.unique(pref)})
    return MergeForest(
        n_points=n,
        children=children,
        dist=dist[:t_count].copy(),
        roots=roots,
        sizes=sizes[: n + t_count],
        kids_csr=(kid_flat, kid_count),
    )


# ---------------------------------------------------------------------------
# Condensed cluster tree
# ---------------------------------------------------------------------------


@dataclass
class CondensedTree:
    """The simplified cluster tree plus per-point exit records.

    Cluster arrays are indexed by ``label`` (0 unused, 1 = root), mirroring
    the reference's label scheme (``nextClusterLabel`` starting at 2,
    ``HdbscanDataBubbles.java:259``).
    """

    n_points: int
    parent: np.ndarray  # (C+1,) label of parent, -1 for root, 0 unused slot
    birth: np.ndarray  # (C+1,) eps at which cluster appeared
    death: np.ndarray  # (C+1,) eps at which it died (0 = never died)
    stability: np.ndarray  # (C+1,)
    has_children: np.ndarray  # (C+1,) bool
    num_members: np.ndarray  # (C+1,) weighted member count at birth
    point_exit_level: np.ndarray  # (n,) eps at which each point became noise (0 = never)
    point_last_cluster: np.ndarray  # (n,) deepest cluster label the point belonged to
    # filled by propagate():
    propagated_stability: np.ndarray | None = None
    lowest_child_death: np.ndarray | None = None
    num_constraints_satisfied: np.ndarray | None = None
    virtual_child_constraints: np.ndarray | None = None  # vGamma column
    selected: np.ndarray | None = field(default=None)  # (C+1,) bool after propagate

    @property
    def n_clusters(self) -> int:
        return len(self.parent) - 1

    @property
    def infinite_stability(self) -> bool:
        return bool(np.any(np.isinf(self.stability[1:])))


def condense_forest(
    forest: MergeForest,
    min_cluster_size: int | float,
    point_weights: np.ndarray | None = None,
    self_levels: np.ndarray | None = None,
) -> CondensedTree:
    """Top-down condensation of the merge forest.

    ``point_weights``: member count per vertex (``nB`` in the reference) —
    ones for raw points, bubble member counts for the bubble tree
    (``countMembers += nB[v]``, ``HdbscanDataBubbles.java:330-338``).
    ``self_levels``: per-point self-edge levels (core distances,
    ``HDBSCANStar.java:196-203``); only consulted when a cluster narrows to a
    single vertex that still meets ``min_cluster_size`` (possible with
    ``min_cluster_size == 1`` or member weights), matching the reference's
    self-edge removal semantics.
    """
    n = forest.n_points
    if point_weights is None:
        point_weights = np.ones(n, np.float64)
    point_weights = np.asarray(point_weights, np.float64)
    sizes = forest.sizes

    # Cluster storage, 1-indexed by label.
    parent_l = [0, -1]
    birth = [0.0, np.inf]
    death = [0.0, 0.0]
    stability = [0.0, 0.0]
    has_children = [False, False]
    num_members = [0.0, float(sizes[forest.roots].sum())]
    n_alive_points = {ROOT_LABEL: num_members[ROOT_LABEL]}

    point_exit_level = np.zeros(n, np.float64)
    point_last_cluster = np.full(n, ROOT_LABEL, np.int64)

    def subtree_points(node: int) -> list:
        out, stack = [], [node]
        while stack:
            x = stack.pop()
            if x < n:
                out.append(x)
            else:
                stack.extend(forest.children[x - n])
        return out

    def detach(label: int, count: float, level: float) -> None:
        # Cluster.detachPoints (hdbscanstar/Cluster.java:80-88). Zero levels
        # (duplicate points) follow Java's IEEE semantics: 1/0 = +inf, which
        # surfaces as the reference's infinite-stability warning
        # (HDBSCANStar.java:40-47) rather than an error.
        inv_level = np.inf if level == 0 else 1.0 / level
        b = birth[label]
        inv_birth = 0.0 if np.isinf(b) else (np.inf if b == 0 else 1.0 / b)
        stability[label] += count * (inv_level - inv_birth)
        n_alive_points[label] -= count
        if n_alive_points[label] <= 0:
            death[label] = level

    def exit_points(node: int, label: int, level: float) -> None:
        pts = subtree_points(node)
        for p in pts:
            point_exit_level[p] = level
            point_last_cluster[p] = label
        detach(label, float(point_weights[pts].sum()), level)

    def new_cluster(parent_label: int, birth_level: float, size: float) -> int:
        label = len(parent_l)
        parent_l.append(parent_label)
        birth.append(birth_level)
        death.append(0.0)
        stability.append(0.0)
        has_children.append(False)
        num_members.append(float(size))
        n_alive_points[label] = float(size)
        has_children[parent_label] = True
        detach(parent_label, float(size), birth_level)
        return label

    # Work stack of (node, cluster_label).
    if len(forest.roots) == 1:
        stack = [(forest.roots[0], ROOT_LABEL)]
    else:
        # Disconnected edge pool: the root "splits" into the components at
        # eps = +inf. min_cluster_size still applies to each component.
        stack = []
        big = [r for r in forest.roots if sizes[r] >= min_cluster_size]
        small = [r for r in forest.roots if sizes[r] < min_cluster_size]
        for r in small:
            exit_points(r, ROOT_LABEL, np.inf)
        if len(big) == 1:
            stack.append((big[0], ROOT_LABEL))
        else:
            for r in big:
                stack.append((r, new_cluster(ROOT_LABEL, np.inf, float(sizes[r]))))

    while stack:
        node, label = stack.pop()
        if node < n:
            # Cluster narrowed to one vertex: dies at its self-edge level.
            point_last_cluster[node] = label
            if self_levels is not None:
                lvl = float(self_levels[node])
                point_exit_level[node] = lvl
                detach(label, float(point_weights[node]), lvl)
            continue
        t = node - n
        delta = float(forest.dist[t])
        kids = forest.children[t]
        big = [c for c in kids if sizes[c] >= min_cluster_size]
        small = [c for c in kids if sizes[c] < min_cluster_size]

        if len(big) >= 2:
            # True split (newClusters.size() >= 2, HdbscanDataBubbles.java:353):
            # each big component becomes a new cluster born at delta.
            for c in big:
                stack.append((c, new_cluster(label, delta, float(sizes[c]))))
            for c in small:
                exit_points(c, label, delta)
        elif len(big) == 1:
            # Cluster continues into the lone big component.
            for c in small:
                exit_points(c, label, delta)
            stack.append((big[0], label))
        else:
            # Cluster shatters: everything exits, cluster dies at delta.
            for c in kids:
                exit_points(c, label, delta)

    return CondensedTree(
        n_points=n,
        parent=np.asarray(parent_l, np.int64),
        birth=np.asarray(birth, np.float64),
        death=np.asarray(death, np.float64),
        stability=np.asarray(stability, np.float64),
        has_children=np.asarray(has_children, bool),
        num_members=np.asarray(num_members, np.float64),
        point_exit_level=point_exit_level,
        point_last_cluster=point_last_cluster,
    )


# ---------------------------------------------------------------------------
# Propagation (EOM) and flat extraction
# ---------------------------------------------------------------------------


def propagate_tree(
    tree: CondensedTree,
    num_constraints_satisfied: np.ndarray | None = None,
    virtual_child_constraints: np.ndarray | None = None,
) -> bool:
    """``HDBSCANStar.propagateTree`` (``HDBSCANStar.java:505-540``).

    Processes labels in descending order (children before parents — child
    labels are always larger), applying ``Cluster.propagate``
    (``Cluster.java:98-142``): constraint satisfaction dominates; stability
    breaks ties with the parent winning equality; the lowest descendant death
    level is propagated for GLOSH. Returns the infinite-stability flag.

    ``virtual_child_constraints``: per-cluster credits earned by the virtual
    (noise) child — the reference adds these straight into
    ``propagatedNumConstraintsSatisfied`` (``Cluster.java:157-159``), so they
    compete against the cluster's own count and flow upward only when the
    descendants win.
    """
    c = tree.n_clusters
    if num_constraints_satisfied is None:
        num_constraints_satisfied = np.zeros(c + 1, np.int64)
    prop_stab = np.zeros(c + 1, np.float64)
    if virtual_child_constraints is None:
        prop_cons = np.zeros(c + 1, np.int64)
    else:
        prop_cons = np.asarray(virtual_child_constraints, np.int64).copy()
    lowest_death = np.full(c + 1, np.inf)  # Double.MAX_VALUE analog
    # Winning-descendant bookkeeping as per-cluster linked lists
    # (head/tail/next) instead of list-of-lists: the reference's
    # ``descendants[par].extend(descendants[label])`` copies every surviving
    # label once per tree level — quadratic on deep cluster chains. Each
    # label sits in at most one list and each list is spliced into its unique
    # parent exactly once, so an O(1) splice is equivalent.
    head = np.full(c + 1, -1, np.int64)
    tail = np.full(c + 1, -1, np.int64)
    nxt = np.full(c + 1, -1, np.int64)

    for label in range(c, 0, -1):
        par = tree.parent[label]
        if lowest_death[label] == np.inf:
            lowest_death[label] = tree.death[label]
        if par <= 0:
            continue
        lowest_death[par] = min(lowest_death[par], lowest_death[label])
        own_cons = num_constraints_satisfied[label]
        own_stab = tree.stability[label]
        self_wins = (
            not tree.has_children[label]
            or own_cons > prop_cons[label]
            or (own_cons == prop_cons[label] and own_stab >= prop_stab[label])
        )
        if self_wins:
            prop_cons[par] += own_cons
            prop_stab[par] += own_stab
            if head[par] < 0:
                head[par] = label
            else:
                nxt[tail[par]] = label
            tail[par] = label
        else:
            prop_cons[par] += prop_cons[label]
            prop_stab[par] += prop_stab[label]
            if head[label] >= 0:  # splice the subtree's winner list upward
                if head[par] < 0:
                    head[par] = head[label]
                else:
                    nxt[tail[par]] = head[label]
                tail[par] = tail[label]

    selected = np.zeros(c + 1, bool)
    if c >= 1:
        node = head[ROOT_LABEL]
        while node >= 0:
            selected[node] = True
            node = nxt[node]

    tree.propagated_stability = prop_stab
    tree.lowest_child_death = lowest_death
    tree.num_constraints_satisfied = num_constraints_satisfied
    tree.virtual_child_constraints = virtual_child_constraints
    tree.selected = selected
    return tree.infinite_stability


def flat_labels(tree: CondensedTree) -> np.ndarray:
    """``HDBSCANStar.findProminentClusters`` (``HDBSCANStar.java:567-625``).

    A point gets a selected cluster's label iff it was a member of that
    cluster at the cluster's birth — i.e. the selected cluster is an ancestor
    (or equal) of the point's deepest cluster. Noise = 0. Equivalent to the
    reference's hierarchy-file offset mechanism, without the file.
    """
    if tree.selected is None:
        raise ValueError("propagate_tree() must run before flat_labels()")
    c = tree.n_clusters
    # For each cluster label, the selected ancestor-or-self (or 0): labels are
    # topologically ordered (parent < child), one ascending pass suffices.
    sel_anc = np.zeros(c + 1, np.int64)
    for label in range(1, c + 1):
        if tree.selected[label]:
            sel_anc[label] = label
        else:
            par = tree.parent[label]
            sel_anc[label] = sel_anc[par] if par > 0 else 0
    return sel_anc[tree.point_last_cluster]


def outlier_scores(tree: CondensedTree, core_distances: np.ndarray) -> np.ndarray:
    """GLOSH — ``HDBSCANStar.calculateOutlierScores`` (``HDBSCANStar.java:653-686``).

    score(p) = 1 - eps_max / eps(p), with eps(p) the level at which p became
    noise and eps_max the lowest death level among descendants of p's last
    cluster; 0 when eps(p) == 0. ``core_distances`` are carried for the
    sorted output record (``OutlierScore.java:36-50``), not the score itself.
    """
    if tree.lowest_child_death is None:
        raise ValueError("propagate_tree() must run before outlier_scores()")
    eps = tree.point_exit_level
    eps_max = tree.lowest_child_death[tree.point_last_cluster]
    with np.errstate(divide="ignore", invalid="ignore"):
        score = np.where(eps != 0, 1.0 - eps_max / eps, 0.0)
    return score


def cluster_eps_min(
    tree: CondensedTree, labels: np.ndarray | None = None
) -> np.ndarray:
    """Per-cluster minimum point exit eps — the "max lambda" record of the
    serving artifact (``serve/artifact.py``), in this repo's eps-level
    representation: ``eps_min[c]`` is the lowest level at which any flat
    member of selected cluster ``c`` exited (``lambda_max = 1/eps_min``).
    Membership probability of a query attaching at level ``eps_q`` is
    ``min(1, eps_min[c] / eps_q)`` — 1.0 at the cluster's densest point,
    falling toward the fringe, exactly the reference semantics of
    ``probabilities_`` rendered in eps space. Zero for label 0 and for
    unselected labels (no flat members).

    ``labels``: flat labels over the tree's point space (vertex space for
    deduplicated fits); recomputed via :func:`flat_labels` when omitted.
    """
    if tree.selected is None:
        raise ValueError("propagate_tree() must run before cluster_eps_min()")
    if labels is None:
        labels = flat_labels(tree)
    c = tree.n_clusters
    eps_min = np.full(c + 1, np.inf)
    mask = labels > 0
    np.minimum.at(eps_min, labels[mask], tree.point_exit_level[mask])
    eps_min[~np.isfinite(eps_min)] = 0.0
    eps_min[0] = 0.0
    return eps_min


def extract_clusters(
    n: int,
    u: np.ndarray,
    v: np.ndarray,
    w: np.ndarray,
    min_cluster_size: int | float,
    point_weights: np.ndarray | None = None,
    self_levels: np.ndarray | None = None,
    num_constraints_satisfied: np.ndarray | None = None,
    virtual_child_constraints: np.ndarray | None = None,
) -> tuple[CondensedTree, np.ndarray]:
    """Edge pool -> (propagated condensed tree, flat labels). One-call helper."""
    forest = build_merge_forest(n, u, v, w, point_weights)
    tree = condense_forest(forest, min_cluster_size, point_weights, self_levels)
    propagate_tree(tree, num_constraints_satisfied, virtual_child_constraints)
    return tree, flat_labels(tree)

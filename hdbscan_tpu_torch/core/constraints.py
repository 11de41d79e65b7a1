"""Must-link / cannot-link constraints (semi-supervised extraction).

Capability parity with the reference's constraint machinery
(``hdbscanstar/Constraint.java:17-23``, ``HDBSCANStar.calculateNumConstraintsSatisfied``
``hdbscanstar/HDBSCANStar.java:738-789``, virtual-child accounting
``hdbscanstar/Cluster.java:145-171``) — advertised in the live help text
(``main/Main.java:590-597``) but never wired into the live driver; here it is
first-class.

Semantics (derived from the reference's per-iteration credit): a cluster is
credited exactly once, at its creation level —

- must-link (a, b): if both points are members of cluster C at C's birth
  (C is an ancestor-or-self of both points' deepest clusters), C earns +2.
- cannot-link (a, b): each side's cluster C earns +1 at birth when the other
  point is NOT a member of C then (different cluster or already noise).
- cannot-link with a noise endpoint: the credit goes to the *virtual child*
  of the cluster the point went noise from (``Cluster.java:145-171``) — kept
  in a separate per-cluster array (the ``vGamma`` column of the tree file),
  matching the reference's separate bookkeeping. The reference counts a
  virtual child only when its owner appears among the "parents of new
  clusters" (``HDBSCANStar.java:744-750``) — i.e. only clusters that
  actually *split* are credited; a cluster that shattered or narrowed away
  never is. A point whose last cluster split necessarily went noise at or
  before the split, so membership in the virtual child reduces to
  ``point_last_cluster == C and has_children[C]``.

The root cluster is pre-credited before the hierarchy loop in the reference
(``HDBSCANStar.java:241-244``, all points labeled 1): must-links earn root +2
each, cannot-links nothing. Root is also a parent of new clusters, so its
virtual child can be credited.

File format (``main/Main.java:590-597``): CSV lines
``<idx_a>,<idx_b>,<ml|cl>``, zero-indexed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hdbscan_tpu_torch.core.tree import CondensedTree

MUST_LINK = "ml"
CANNOT_LINK = "cl"


@dataclass(frozen=True)
class Constraint:
    point_a: int
    point_b: int
    kind: str  # "ml" | "cl"

    def __post_init__(self):
        if self.kind not in (MUST_LINK, CANNOT_LINK):
            raise ValueError(f"constraint type must be 'ml' or 'cl', got {self.kind!r}")


def load_constraints(path: str) -> list[Constraint]:
    """Parse the reference's constraint CSV (``a,b,ml`` / ``a,b,cl``)."""
    out = []
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != 3:
                raise ValueError(f"{path}:{line_no}: expected 'a,b,ml|cl', got {line!r}")
            out.append(Constraint(int(parts[0]), int(parts[1]), parts[2].lower()))
    return out


def _lca_vectorized(parent: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Lowest common ancestor for label-pair arrays via binary lifting.

    ``parent[c] < c`` holds by construction of the condensed tree's labeling
    (children are created after their parent), ``parent[root] <= 0``. Cost:
    an (K, C) ancestor table with K = ceil(log2 max_depth), then O(K) vector
    ops per pair array — millions of constraints resolve in milliseconds.
    """
    c_count = len(parent) - 1
    depth = np.zeros(c_count + 1, np.int64)
    up0 = np.arange(c_count + 1, dtype=np.int64)
    for c in range(2, c_count + 1):
        p = int(parent[c])
        if p > 0:
            depth[c] = depth[p] + 1
            up0[c] = p
    k_levels = max(1, int(depth.max()).bit_length())
    up = np.empty((k_levels, c_count + 1), np.int64)
    up[0] = up0
    for k in range(1, k_levels):
        up[k] = up[k - 1][up[k - 1]]

    a = a.copy()
    b = b.copy()
    # Equalize depths (lift the deeper side by the depth difference, one
    # binary digit per table level).
    diff = depth[a] - depth[b]
    ha = np.maximum(diff, 0)
    hb = np.maximum(-diff, 0)
    for k in range(k_levels):
        bit = 1 << k
        a = np.where(ha & bit != 0, up[k][a], a)
        b = np.where(hb & bit != 0, up[k][b], b)
    # Simultaneous binary descent: keep lifting both while ancestors differ.
    neq = a != b
    for k in range(k_levels - 1, -1, -1):
        lift = neq & (up[k][a] != up[k][b])
        a = np.where(lift, up[k][a], a)
        b = np.where(lift, up[k][b], b)
    return np.where(neq, up[0][a], a)


def count_constraints_satisfied(
    tree: CondensedTree, constraints: list[Constraint]
) -> tuple[np.ndarray, np.ndarray]:
    """Per-cluster (num_constraints_satisfied, virtual_child_constraints).

    Feed the first array to ``propagate_tree`` (constraint satisfaction
    dominates stability in EOM competition, ``Cluster.java:114-142``); the
    second is the tree file's vGamma column.

    Fully vectorized: the per-constraint ancestor-chain walks reduce to LCA
    algebra. A must-link credits every label on chain(a) ∩ chain(b) =
    ancestors-or-self of LCA — +2 placed at the LCA. A cannot-link credits
    chain(a) Δ chain(b) — +1 at each endpoint's deepest cluster, −2 at the
    LCA (root always cancels, matching the reference's pre-loop crediting,
    ``HDBSCANStar.java:241-244``). One bottom-up subtree-sum then turns the
    point credits into per-label chain sums. O(P·log D + C) total instead of
    O(P·D) chain walks.
    """
    c_count = tree.n_clusters
    num = np.zeros(c_count + 1, np.int64)
    vnum = np.zeros(c_count + 1, np.int64)
    if not constraints:
        return num, vnum
    last = tree.point_last_cluster
    pa = np.array([c.point_a for c in constraints], np.int64)
    pb = np.array([c.point_b for c in constraints], np.int64)
    is_ml = np.array([c.kind == MUST_LINK for c in constraints], bool)
    la, lb = last[pa], last[pb]
    lca = _lca_vectorized(tree.parent, la, lb)

    # Credits placed at tree nodes; the subtree-sum below distributes each
    # credit to every ancestor-or-self label.
    credit = np.zeros(c_count + 1, np.int64)
    np.add.at(credit, lca[is_ml], 2)
    cl = ~is_ml
    np.add.at(credit, la[cl], 1)
    np.add.at(credit, lb[cl], 1)
    np.add.at(credit, lca[cl], -2)
    # parent[c] < c, so one descending pass accumulates whole subtrees.
    for c in range(c_count, 1, -1):
        p = int(tree.parent[c])
        if p > 0:
            credit[p] += credit[c]
    num = credit
    num[0] = 0

    # Noise endpoints credit the virtual child of the cluster the point went
    # noise from (its deepest cluster) — but only if that cluster split,
    # mirroring the reference's parents-of-new-clusters scoping
    # (HDBSCANStar.java:744-750,765-781).
    ends = np.concatenate([la[cl], lb[cl]])
    ends = ends[tree.has_children[ends]]
    np.add.at(vnum, ends, 1)
    vnum[0] = 0
    return num, vnum

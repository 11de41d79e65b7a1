"""Shared host-side union-find primitives.

The distributed merge layers (tiled Borůvka, glue harvest, pooled-edge MST,
merge forest) all union components between device rounds; these helpers are
the single implementation (SURVEY.md §2.C row P9's host side).
"""

from __future__ import annotations

import numpy as np


def find(parent: np.ndarray, x: int) -> int:
    """Path-halving find."""
    while parent[x] != x:
        parent[x] = parent[parent[x]]
        x = parent[x]
    return x


def flatten_parents(parent: np.ndarray) -> np.ndarray:
    """Vectorized full path compression: pointer jumping to fixpoint.

    Returns an array where every entry points directly at its root — the
    component relabeling fed back to the device between Borůvka rounds.
    """
    p = parent
    while True:
        q = p[p]
        if np.array_equal(q, p):
            return q
        p = q


def contract_min_edges(
    comp: np.ndarray, cand_j: np.ndarray, cand_w: np.ndarray
) -> tuple[np.ndarray, np.ndarray, int]:
    """One fully vectorized Borůvka contraction round (no per-edge Python).

    ``comp``: (n,) component label per vertex (any int labels).
    ``cand_j``/``cand_w``: per-vertex best outgoing candidate (target vertex,
    weight), ``cand_j = -1`` where the vertex has none.

    Per component, the winning candidate is the minimum by the SHARED key
    (w, min(i,j), max(i,j)) — both endpoints of a physical edge compute the
    same key, which makes the selection deterministic across tilings. The
    winners form a functional graph over components; its cycles (usually
    2-cycles, but weight ties can make them longer because per-vertex
    candidates pre-filter by a different tie-break) are resolved by pointer
    doubling: every component lands on its group's cycle, the cycle's minimum
    label becomes the group root, and every non-root component's winning edge
    joins the forest — exactly group_size - 1 edges per contraction group.

    Returns ``(emit, comp_new, n_comp_new)``: the vertex ids whose candidate
    edges join the MST this round (edge = (i, cand_j[i], cand_w[i])), the new
    per-vertex component labels (representative OLD labels, so callers can
    keep feeding them back), and the new component count.
    """
    uc, cidx = np.unique(comp, return_inverse=True)
    c_count = len(uc)
    if c_count <= 1:
        return np.zeros(0, np.int64), comp, c_count

    ids = np.nonzero(cand_j >= 0)[0]
    a = cidx[ids]
    b = cidx[cand_j[ids]]
    cross = a != b
    ids, a, b = ids[cross], a[cross], b[cross]

    t = np.arange(c_count, dtype=np.int64)
    edge_of = np.full(c_count, -1, np.int64)
    if len(ids):
        j = cand_j[ids]
        lo = np.minimum(ids, j)
        hi = np.maximum(ids, j)
        order = np.lexsort((hi, lo, cand_w[ids], a))
        first = np.concatenate([[True], np.diff(a[order]) != 0])
        sel = order[first]  # winning candidate row per component, in ids-space
        t[a[sel]] = b[sel]
        edge_of[a[sel]] = sel

    # Pointer doubling: land every component on its group's cycle while
    # accumulating the minimum label over the forward orbit. After K rounds
    # with 2^K >= c_count, s[c] is on the cycle and mn[x] (for x on the
    # cycle) is the cycle-wide minimum — the canonical group root.
    mn = np.arange(c_count, dtype=np.int64)
    s = t
    for _ in range(max(1, int(c_count).bit_length())):
        mn = np.minimum(mn, mn[s])
        s = s[s]
    rep = mn[s]
    is_root = rep == np.arange(c_count)

    emit_c = np.nonzero(~is_root & (edge_of >= 0))[0]
    emit = ids[edge_of[emit_c]]
    comp_new = uc[rep][cidx]
    return emit, comp_new, int(is_root.sum())

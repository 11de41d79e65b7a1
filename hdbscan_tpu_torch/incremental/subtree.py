"""Dirty-subtree finalize: hierarchy extraction scoped to what changed — a
host-only copy of ``hdbscan_tpu/incremental/subtree.py``.

The merge forest is built by a strictly sequential Kruskal fold
(``core/tree.build_merge_forest``), so between two maintenance steps the
canonical edge lists share a (usually long) identical prefix, and the
fold's state after that prefix is identical too (PANDORA's
dendrogram-update argument, arxiv 2401.06089, in its sequential shape).
:class:`ResumableForestBuilder` checkpoints the fold state at a handful of
positions and, on the next finalize, resumes from the deepest checkpoint
at or below the first changed edge — only the dirty suffix of merge nodes
is rebuilt. The result is BITWISE a from-scratch
``tree.build_merge_forest`` (same loop, same union-find compression
schedule, same tie contraction).

Internal merge-node ids are ``n + t`` and ``n`` grows between steps, so
restored checkpoints re-base their id space vectorized (point ids are
stable; internal ids shift by the insert count) — see
:meth:`ResumableForestBuilder._restore`.

Downstream of the forest the condense / propagate / flat-label passes run
over the full tree (``core/tree_vec.py``); :class:`DirtySubtreeFinalizer`
diffs per-cluster stabilities against the previous tree and reports the
changed-cluster count in the ``subtree_finalize`` trace event.

:func:`finalize_from_mst` is the shared canonical tail of the maintained
path and the tests' from-scratch side. It runs on the host (host forest +
the shared finalize tail, ``models/_finalize.finalize_clustering``).
"""

from __future__ import annotations

import time

import numpy as np

from hdbscan_tpu_torch.core import tree as tree_mod
from hdbscan_tpu_torch.incremental.insert import MaintainFallback

__all__ = [
    "ResumableForestBuilder",
    "DirtySubtreeFinalizer",
    "finalize_from_mst",
]


def finalize_from_mst(n, lo, hi, w, core, params, trace=None):
    """Canonical MST -> (tree, labels, scores, infinite), on the host.

    Builds the merge forest on host (native C loop when available, the
    pure-python fold otherwise) and runs the shared finalize tail
    (``models/_finalize.finalize_clustering``) with the forest pre-built,
    which keeps the device MST path out of the picture entirely.
    """
    from hdbscan_tpu_torch.models._finalize import finalize_clustering

    forest = tree_mod.build_merge_forest(n, lo, hi, w)
    return finalize_clustering(
        n, lo, hi, w, core, params, trace=trace, forest=forest
    )


class ResumableForestBuilder:
    """Merge-forest fold with resumable checkpoints.

    ``build(lo, hi, w)`` returns a ``MergeForest`` bitwise-identical to
    ``tree.build_merge_forest(n, lo, hi, w)`` (unit point weights). The
    first call pays the full fold; subsequent calls diff the canonical
    edge triples against the previous build, restore the deepest
    checkpoint at or below the first change, and replay only from there.
    ``last_stats`` reports the resume position and dirty node counts for
    the ``subtree_finalize`` event.
    """

    def __init__(self, checkpoints: int = 8, tie_rtol: float = tree_mod.TIE_RTOL):
        self.checkpoint_slots = max(1, int(checkpoints))
        self.tie_rtol = float(tie_rtol)
        self._prev: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
        self._ckpts: list[dict] = []
        self.last_stats: dict = {}

    # -- checkpoint plumbing ----------------------------------------------

    def _capture(self, pos, n, parent, top, sizes, children, dists, anchors,
                 next_node) -> dict:
        t = next_node - n
        return {
            "pos": int(pos),
            "n": int(n),
            "t": int(t),
            "parent_pts": parent[:n].copy(),
            "parent_int": parent[n:next_node].copy(),
            "top": top.copy(),
            "sizes_int": sizes[n:next_node].copy(),
            "children": children[:],  # kid lists are never mutated in place
            "dists": dists[:],
            "anchors": anchors[:],
        }

    @staticmethod
    def _shift(vals: np.ndarray, n0: int, delta: int) -> np.ndarray:
        return np.where(vals < n0, vals, vals + delta)

    def _restore(self, ck: dict, n: int, max_nodes: int):
        """Re-materialize fold state in the CURRENT id space (points
        0..n-1, internals from n): internal ids recorded at checkpoint
        time (taken at ``n0 <= n``) shift by ``n - n0``."""
        n0, t = ck["n"], ck["t"]
        delta = n - n0
        parent = np.arange(max_nodes, dtype=np.int64)
        parent[:n0] = self._shift(ck["parent_pts"], n0, delta)
        parent[n : n + t] = self._shift(ck["parent_int"], n0, delta)
        top = np.arange(n, dtype=np.int64)
        top[:n0] = self._shift(ck["top"], n0, delta)
        sizes = np.zeros(max_nodes, np.float64)
        sizes[:n] = 1.0
        sizes[n : n + t] = ck["sizes_int"]
        if delta:
            children = [
                None if kids is None
                else [k if k < n0 else k + delta for k in kids]
                for kids in ck["children"]
            ]
        else:
            children = [None if k is None else list(k) for k in ck["children"]]
        return parent, top, sizes, children, ck["dists"][:], ck["anchors"][:]

    def _first_diff(self, lo, hi, w) -> int:
        if self._prev is None:
            return 0
        plo, phi, pw = self._prev
        m = min(len(plo), len(lo))
        neq = (plo[:m] != lo[:m]) | (phi[:m] != hi[:m]) | (pw[:m] != w[:m])
        hits = np.nonzero(neq)[0]
        return int(hits[0]) if len(hits) else m

    # -- the fold ----------------------------------------------------------

    def build(self, n: int, lo, hi, w) -> tree_mod.MergeForest:
        t_start = time.perf_counter()
        lo = np.asarray(lo, np.int64)
        hi = np.asarray(hi, np.int64)
        w = np.asarray(w, np.float64)
        order = np.lexsort((hi, lo, w))
        lo, hi, w = lo[order], hi[order], w[order]
        m = len(w)
        max_nodes = n + m
        r = self._first_diff(lo, hi, w)
        usable = [c for c in self._ckpts if c["pos"] <= r]
        kept = usable[:]
        start = 0
        if usable:
            ck = max(usable, key=lambda c: c["pos"])
            start = ck["pos"]
            parent, top, sizes, children, dists, anchors = self._restore(
                ck, n, max_nodes
            )
            next_node = n + ck["t"]
        else:
            parent = np.arange(max_nodes, dtype=np.int64)
            top = np.arange(n, dtype=np.int64)
            sizes = np.zeros(max_nodes, np.float64)
            sizes[:n] = 1.0
            children, dists, anchors = [], [], []
            next_node = n

        # Fresh checkpoint targets strictly above the resume point.
        step = max(1, m // self.checkpoint_slots)
        targets = {p for p in range(step, m, step) if p > start}

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        rtol = self.tie_rtol
        for i in range(start, m):
            if i in targets:
                kept.append(
                    self._capture(i, n, parent, top, sizes, children,
                                  dists, anchors, next_node)
                )
            ra, rb = find(lo[i]), find(hi[i])
            if ra == rb:
                continue
            ta, tb = top[ra], top[rb]
            wi = float(w[i])
            kids = []
            anchor = wi
            for t in (ta, tb):
                if t >= n and tree_mod._tied(anchors[t - n], wi, rtol):
                    kids.extend(children[t - n])
                    anchor = min(anchor, anchors[t - n])
                    children[t - n] = None
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

        roots = sorted({int(top[find(p)]) for p in range(n)})
        t_total = next_node - n
        self._prev = (lo, hi, w)
        # Keep at most checkpoint_slots, deepest-spread (drop the shallowest
        # surplus — deep checkpoints are the ones that save replay).
        kept.sort(key=lambda c: c["pos"])
        self._ckpts = kept[-self.checkpoint_slots:]
        self.last_stats = {
            "edges": m,
            "resume_pos": start,
            "first_diff": r,
            "nodes_total": t_total,
            "nodes_dirty": t_total if start == 0 else t_total - (
                next((c["t"] for c in kept if c["pos"] == start), 0)
            ),
            "dirty_frac": (m - start) / m if m else 0.0,
            "wall_s": time.perf_counter() - t_start,
        }
        return tree_mod.MergeForest(
            n_points=n,
            children=children[:t_total],
            dist=np.asarray(dists, np.float64),
            roots=roots,
            sizes=sizes[: n + t_total],
        )


class DirtySubtreeFinalizer:
    """Maintained-MST -> served clustering with dirty-subtree reuse.

    Wraps :class:`ResumableForestBuilder` + the shared finalize tail and
    reconciles stability deltas against the previous tree. ``finalize``
    raises :class:`~hdbscan_tpu_torch.incremental.insert.MaintainFallback` when
    the dirty node share exceeds ``dirty_max_frac`` — at that point a
    full re-fit is the cheaper (and circuit-gated) path.
    """

    def __init__(self, params, dirty_max_frac: float = 1.0, tracer=None,
                 name: str = "maintainer"):
        self.params = params
        self.dirty_max_frac = float(dirty_max_frac)
        self.tracer = tracer
        self.name = str(name)
        self.builder = ResumableForestBuilder()
        self._prev_stability: np.ndarray | None = None
        self.finalizes = 0

    def finalize(self, n, lo, hi, w, core):
        """Returns ``(tree, labels, scores, infinite)`` for the maintained
        tree; bitwise what :func:`finalize_from_mst` returns for the same
        arrays (the parity suite pins this)."""
        from hdbscan_tpu_torch.models._finalize import finalize_clustering

        t0 = time.perf_counter()
        forest = self.builder.build(n, lo, hi, w)
        stats = self.builder.last_stats
        if stats["dirty_frac"] > self.dirty_max_frac and stats["resume_pos"]:
            # Only trip AFTER a first successful build: resume_pos == 0 is
            # the bootstrap (everything is "dirty" by construction).
            raise MaintainFallback(
                f"finalize dirty fraction {stats['dirty_frac']:.3f} exceeds "
                f"maintain_dirty_max_frac={self.dirty_max_frac}"
            )
        tree, labels, scores, infinite = finalize_clustering(
            n, lo, hi, w, core, self.params, trace=None, forest=forest
        )
        prev = self._prev_stability
        stab = np.asarray(tree.stability, np.float64)
        if prev is None:
            changed = tree.n_clusters
        else:
            m = min(len(prev), len(stab))
            changed = int(np.count_nonzero(prev[:m] != stab[:m]))
            changed += abs(len(prev) - len(stab))
        self._prev_stability = stab.copy()
        self.finalizes += 1
        wall_s = time.perf_counter() - t0
        if self.tracer is not None:
            self.tracer(
                "subtree_finalize",
                maintainer=self.name,
                n=int(n),
                nodes_total=int(stats["nodes_total"]),
                nodes_dirty=int(stats["nodes_dirty"]),
                dirty_frac=round(float(stats["dirty_frac"]), 6),
                clusters=int(tree.n_clusters),
                changed_clusters=int(changed),
                wall_s=round(wall_s, 6),
            )
        return tree, labels, scores, infinite

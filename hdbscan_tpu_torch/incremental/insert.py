"""Online MST maintenance: absorb novel points without a re-fit — a
host-only copy of ``hdbscan_tpu/incremental/insert.py``.

:class:`HierarchyMaintainer` holds the fit's mutual-reachability MST plus
each point's k-NN row and, per novel point, performs a *bounded* update:

1. **Candidate query** — the stored random-projection planes of the ``/2``
   model artifact route the point to one leaf per tree (T visited leaves,
   ``ops/rpforest.leaf_members_np``); leaf members plus every
   previously-inserted point form the candidate set. Without a stored
   forest the query is exhaustive — the *exact* mode the parity tests use.
2. **Core updates** — the new point enters the k-NN row of every candidate
   within its current core radius; cores only *decrease* on insertion, so
   every mutual-reachability weight only decreases. The exact candidate
   edge set for the next splice is therefore: all new-vertex edges, plus
   each affected neighbor's row edges whose raw distance sat strictly
   inside the old core (a decreased non-tree edge ``(a, c)`` needs
   ``d_ac < core_c_old``, which puts ``a`` inside ``c``'s stored row).
3. **Deferred splice** — pending edges accumulate in an edit journal and
   :meth:`splice` folds them into the maintained tree at cadence: tree
   edges re-weight vectorized from their stored raw distances, the first
   affected position ``f`` bounds the provably-unchanged prefix, prefix
   components seed a vectorized Borůvka over the suffix pool (the cuSLINK
   edge-replacement shape, arxiv 2306.16354), and the arrays
   re-canonicalize under the repo's total order ``(w, lo, hi)``.

Exactness: with exhaustive candidates the maintained edge set is the
canonical MST of the full mutual-reachability graph after every splice.
With the bounded rp-forest query the tree is approximate at scale.

Every float here is computed as the reference computes it (float32
differences, squares and roots through numpy, widened to float64), so the
maintainer is bitwise the reference's: recovery replay
(``stream/wal.py``) is a deterministic fold over the novel-row sequence —
same rows, same order, same splice cadence ⇒ the same :meth:`state_dict`
digests in either package. The bootstrap without stored neighbor rows
(:func:`host_knn_rows`, :func:`host_mst`) is O(n² d) on the host.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from hdbscan_tpu_torch.utils.unionfind import contract_min_edges

__all__ = [
    "HierarchyMaintainer",
    "MaintainFallback",
    "f32_distances",
    "host_knn_rows",
    "host_mst",
]


class MaintainFallback(RuntimeError):
    """A maintenance step exceeded its contract (dirty fraction over
    ``maintain_dirty_max_frac``, lost connectivity, or an internal
    invariant trip). The server demotes the stream to the circuit-gated
    full re-fit and keeps serving the pinned generation meanwhile."""


def f32_distances(q, pts) -> np.ndarray:
    """Euclidean distances from one query row to ``pts`` in float32 math.

    Mirrors the device scans' difference-form kernel at their default
    ``dtype=np.float32`` (``core/distances._sq_euclidean``): float32
    subtraction, float32 square/accumulate, float32 sqrt, widened to
    float64 on return — bitwise-equal to the device values on
    lattice-valued data (the parity-eligibility gate), last-ulp close
    elsewhere.
    """
    q32 = np.asarray(q, np.float32)
    p32 = np.atleast_2d(np.asarray(pts, np.float32))
    diff = p32 - q32[None, :]
    d2 = np.einsum("md,md->m", diff, diff)
    return np.sqrt(d2).astype(np.float64)


def host_knn_rows(
    data, min_pts: int, block: int = 1024
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exhaustive host k-NN rows under the repo's core-distance convention.

    Returns ``(core, knn_d, knn_i)``: per point the ``k = min(min_pts - 1,
    n)`` smallest (distance, id) pairs *including self at distance 0*,
    ascending under the established lex tie-break, and ``core = knn_d[:,
    k-1]`` — the same contract as ``ops/tiled.knn_core_distances`` with
    ``return_indices``. O(n² d) in numpy: the bootstrap path for models
    that carry no neighbor rows (document the cost at the call site).
    """
    data32 = np.asarray(data, np.float32)
    n = len(data32)
    k = min(max(min_pts - 1, 1), n)
    knn_d = np.empty((n, k), np.float64)
    knn_i = np.empty((n, k), np.int64)
    ids = np.arange(n, dtype=np.int64)
    for a in range(0, n, block):
        b = min(a + block, n)
        diff = data32[a:b, None, :] - data32[None, :, :]
        dm = np.sqrt(np.einsum("mnd,mnd->mn", diff, diff)).astype(np.float64)
        order = np.lexsort(
            (np.broadcast_to(ids, dm.shape), dm), axis=-1
        )[:, :k]
        knn_d[a:b] = np.take_along_axis(dm, order, axis=-1)
        knn_i[a:b] = order
    return knn_d[:, k - 1].copy(), knn_d, knn_i


def host_mst(
    data, core
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Exact mutual-reachability MST on host (Prim under the total order).

    Every comparison uses the repo's canonical edge key ``(w, lo, hi)``,
    so the returned edge SET is the unique canonical MST — identical to
    the device Borůvka's (``models/exact.mst_edges``) on any input whose
    distances agree. O(n² d) numpy; bootstrap-only (model artifacts carry
    no MST). Returns ``(lo, hi, d_raw, w)`` in canonical sorted order.
    """
    data32 = np.asarray(data, np.float32)
    core = np.asarray(core, np.float64)
    n = len(data32)
    if n <= 1:
        z = np.zeros(0)
        return z.astype(np.int64), z.astype(np.int64), z, z
    idx = np.arange(n, dtype=np.int64)
    in_tree = np.zeros(n, bool)
    best_w = np.full(n, np.inf)
    best_d = np.full(n, np.inf)
    best_src = np.full(n, -1, np.int64)
    lo_out = np.empty(n - 1, np.int64)
    hi_out = np.empty(n - 1, np.int64)
    d_out = np.empty(n - 1, np.float64)
    w_out = np.empty(n - 1, np.float64)
    cur = 0
    in_tree[0] = True
    for step in range(n - 1):
        d = f32_distances(data32[cur], data32)
        w = np.maximum(d, np.maximum(core, core[cur]))
        k1 = np.minimum(cur, idx)
        k2 = np.maximum(cur, idx)
        b1 = np.minimum(best_src, idx)
        b2 = np.maximum(best_src, idx)
        better = (w < best_w) | (
            (w == best_w) & ((k1 < b1) | ((k1 == b1) & (k2 < b2)))
        )
        upd = better & ~in_tree
        best_w[upd] = w[upd]
        best_d[upd] = d[upd]
        best_src[upd] = cur
        out = np.nonzero(~in_tree)[0]
        o1 = np.minimum(best_src[out], out)
        o2 = np.maximum(best_src[out], out)
        sel = out[np.lexsort((o2, o1, best_w[out]))[0]]
        src = best_src[sel]
        lo_out[step] = min(src, sel)
        hi_out[step] = max(src, sel)
        d_out[step] = best_d[sel]
        w_out[step] = best_w[sel]
        in_tree[sel] = True
        cur = int(sel)
    order = np.lexsort((hi_out, lo_out, w_out))
    return lo_out[order], hi_out[order], d_out[order], w_out[order]


def _forest_components(n: int, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Component label (minimum member vertex id) per vertex for a FOREST
    edge set — vectorized min-label hooking + pointer jumping, O(E log n)
    numpy with no per-edge Python (the splice-prefix seeding pass)."""
    comp = np.arange(n, dtype=np.int64)
    if len(lo) == 0:
        return comp
    for _ in range(max(1, 2 * int(n).bit_length())):
        cl, ch = comp[lo], comp[hi]
        if np.array_equal(cl, ch):
            break
        a = np.minimum(cl, ch)
        b = np.maximum(cl, ch)
        np.minimum.at(comp, b, a)
        while True:
            c2 = comp[comp]
            if np.array_equal(c2, comp):
                break
            comp = c2
    return comp


def _merge_sorted_suffix(
    plo: np.ndarray, phi: np.ndarray, pd: np.ndarray, pw: np.ndarray,
    slo: np.ndarray, shi: np.ndarray, sd: np.ndarray, sw: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Merge a canonically-sorted suffix into a canonically-sorted prefix.

    Both inputs are sorted by the repo's total edge order ``(w, lo, hi)``;
    the output is the sorted concatenation — bitwise what
    ``np.lexsort((hi, lo, w))`` over the union produces, because tree edge
    keys are unique (a (lo, hi) pair occurs at most once, and equal pairs
    would carry equal weights). Cost is O(p + s log p) instead of the
    O((p+s) log (p+s)) full re-sort: splices that touch a short journal
    suffix no longer pay a full-tree sort.

    Weight ties ACROSS the two inputs are real (mutual-reachability
    weights collapse onto shared core distances), so equal-``w`` runs are
    refined by the packed ``(lo, hi)`` pair key before placement.
    """
    p, s = len(pw), len(sw)
    if s == 0:
        return plo, phi, pd, pw
    if p == 0:
        return slo, shi, sd, sw
    pos = np.searchsorted(pw, sw, side="left")
    end = np.searchsorted(pw, sw, side="right")
    tie = np.nonzero(pos < end)[0]
    if len(tie):
        # uint64 pair pack: lo, hi are vertex ids < 2**32.
        pack_p = plo.astype(np.uint64) << np.uint64(32)
        pack_p |= phi.astype(np.uint64)
        pack_s = (slo[tie].astype(np.uint64) << np.uint64(32)) | shi[
            tie
        ].astype(np.uint64)
        for j, a, b, q in zip(tie, pos[tie], end[tie], pack_s):
            pos[j] = a + np.searchsorted(pack_p[a:b], q)
    out_pos = pos + np.arange(s)
    mask = np.ones(p + s, bool)
    mask[out_pos] = False

    def put(pv, sv):
        out = np.empty(p + s, pv.dtype)
        out[mask] = pv
        out[out_pos] = sv
        return out

    return put(plo, slo), put(phi, shi), put(pd, sd), put(pw, sw)


def _seeded_pool_mst(
    comp0: np.ndarray, lo: np.ndarray, hi: np.ndarray, w: np.ndarray
) -> np.ndarray:
    """Borůvka over an edge pool with PRE-SEEDED components; returns the
    indices (into the input pool) of the accepted edges.

    ``models/exact.pool_mst`` re-done with (a) a seed component vector —
    the already-decided splice prefix — and (b) edge-INDEX returns so the
    caller keeps raw distances attached. Selection is per-component
    minimum under the canonical total order ``(w, lo, hi)``, so the
    accepted set is exactly the canonical MST's suffix.
    """
    n = len(comp0)
    comp = comp0.copy()
    order = np.lexsort((hi, lo, w))
    su, sv, sw = lo[order], hi[order], w[order]
    accepted: list[np.ndarray] = []
    for _ in range(64):
        cu, cv = comp[su], comp[sv]
        out = np.nonzero(cu != cv)[0]
        if len(out) == 0:
            break
        cc = np.concatenate([cu[out], cv[out]])
        ee = np.tile(out, 2)
        ord2 = np.lexsort((ee, cc))
        cc_, ee_ = cc[ord2], ee[ord2]
        first = np.concatenate([[True], np.diff(cc_) != 0])
        reps, picks = cc_[first], ee_[first]
        cand_j = np.full(n, -1, np.int64)
        cand_w = np.zeros(n, np.float64)
        edge_map = np.full(n, -1, np.int64)
        other = np.where(cu[picks] == reps, cv[picks], cu[picks])
        cand_j[reps] = other
        cand_w[reps] = sw[picks]
        edge_map[reps] = picks
        emit, comp, _ = contract_min_edges(comp, cand_j, cand_w)
        if len(emit) == 0:
            break
        accepted.append(order[edge_map[emit]])
    if not accepted:
        return np.zeros(0, np.int64)
    return np.concatenate(accepted)


class HierarchyMaintainer:
    """Maintained mutual-reachability MST + k-NN rows for one model.

    Parameters
    ----------
    data:
        (n, d) float64 training rows of the served model.
    min_pts:
        The fit's ``min_points`` (fixes the k-NN row width ``k =
        min_pts - 1`` and the core-distance column).
    knn_d / knn_i / core:
        Optional pre-computed neighbor rows under the repo convention
        (self included at distance 0, ``(d, id)`` lex ascending). Omit to
        pay the O(n² d) exhaustive host bootstrap (:func:`host_knn_rows`).
    mst:
        Optional ``(u, v)`` edge arrays of the fit's MST (weights are
        re-derived from stored raw distances + cores). Omit to pay the
        O(n² d) host Prim bootstrap (:func:`host_mst`).
    rpf:
        The model artifact's packed rp-forest dict (``serve/artifact``
        schema ``/2``) — bounds each insert's candidate query to T visited
        leaves. ``None`` = exhaustive candidates (exact; parity mode).
    budget_ms:
        Per-insert wall budget; an overrun only *counts* (``over_budget``
        outcome) — it never changes state, so WAL replay stays a
        deterministic fold regardless of recovery-machine speed.
    dirty_max_frac:
        Splice suffix share ``(m - f) / m`` above which the step refuses
        and raises :class:`MaintainFallback` (the re-fit is cheaper).
    """

    def __init__(
        self,
        data,
        *,
        min_pts: int,
        metric: str = "euclidean",
        knn_d=None,
        knn_i=None,
        core=None,
        mst=None,
        rpf=None,
        budget_ms: float = 0.0,
        dirty_max_frac: float = 1.0,
        refresh_every: int = 64,
        tracer=None,
        metrics=None,
        name: str = "maintainer",
    ):
        if metric != "euclidean":
            raise ValueError(
                "incremental maintenance supports metric 'euclidean' only, "
                f"got {metric!r} (other metrics fall back to re-fit)"
            )
        data = np.asarray(data, np.float64)
        if data.ndim != 2:
            raise ValueError(f"data must be (n, d), got shape {data.shape}")
        n, d = data.shape
        self.k = min(max(int(min_pts) - 1, 1), n)
        if n < 2:
            raise ValueError(f"bootstrap needs n >= 2, got {n}")
        self.min_pts = int(min_pts)
        self.dims = d
        self.n0 = n
        self.n = n
        self.rpf = rpf
        self.budget_ms = float(budget_ms)
        self.dirty_max_frac = float(dirty_max_frac)
        self.refresh_every = max(1, int(refresh_every))
        self.tracer = tracer
        self.name = str(name)
        cap = max(16, 1 << int(n - 1).bit_length() << 1)
        self._cap = cap
        self.data = np.zeros((cap, d), np.float64)
        self.data32 = np.zeros((cap, d), np.float32)
        self.data[:n] = data
        self.data32[:n] = data.astype(np.float32)
        if knn_d is None or knn_i is None:
            core, knn_d, knn_i = host_knn_rows(data, self.min_pts)
        knn_d = np.asarray(knn_d, np.float64)
        knn_i = np.asarray(knn_i, np.int64)
        if knn_d.shape[1] < self.k:
            raise ValueError(
                f"knn rows must be >= {self.k} wide, got {knn_d.shape}"
            )
        self.nbr_d = np.full((cap, self.k), np.inf, np.float64)
        self.nbr_i = np.full((cap, self.k), -1, np.int64)
        self.nbr_d[:n] = knn_d[:, : self.k]
        self.nbr_i[:n] = knn_i[:, : self.k]
        self.core = np.full(cap, np.inf, np.float64)
        self.core[:n] = (
            np.asarray(core, np.float64)
            if core is not None
            else knn_d[:, self.k - 1]
        )
        if mst is None:
            lo, hi, d_raw, w = host_mst(data, self.core[:n])
        else:
            u, v = np.asarray(mst[0], np.int64), np.asarray(mst[1], np.int64)
            lo, hi = np.minimum(u, v), np.maximum(u, v)
            d_raw = self._edge_dists(lo, hi)
            w = np.maximum(d_raw, np.maximum(self.core[lo], self.core[hi]))
            order = np.lexsort((hi, lo, w))
            lo, hi, d_raw, w = lo[order], hi[order], d_raw[order], w[order]
        self.m_lo, self.m_hi = lo, hi
        self.m_d, self.m_w = d_raw, w
        # Pending candidate edges (the edit journal's working set) —
        # flushed and deduped by the next splice.
        self._pend_lo: list[np.ndarray] = []
        self._pend_hi: list[np.ndarray] = []
        self._pend_d: list[np.ndarray] = []
        self.inserts = 0
        self.splices = 0
        self.spliced_edges = 0
        self.evicted_edges = 0
        self.candidates_total = 0
        self.over_budget = 0
        self._since_splice = 0
        self._journal_sha = hashlib.sha256()
        self.journal_len = 0
        self._m_maintain = None
        if metrics is not None:
            self._m_maintain = metrics.counter(
                "hdbscan_tpu_maintain_total",
                "Incremental maintenance steps by outcome "
                "(inserted/spliced/refresh/over_budget/fallback).",
                ("outcome",),
            )

    # -- plumbing ----------------------------------------------------------

    def _edge_dists(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        a, b = self.data32[lo], self.data32[hi]
        diff = a - b
        return np.sqrt(np.einsum("md,md->m", diff, diff)).astype(np.float64)

    def _ensure_capacity(self, need: int) -> None:
        if need <= self._cap:
            return
        cap = self._cap
        while cap < need:
            cap *= 2
        for attr, fill in (
            ("data", 0.0),
            ("data32", 0.0),
            ("nbr_d", np.inf),
            ("nbr_i", -1),
            ("core", np.inf),
        ):
            old = getattr(self, attr)
            new = np.full((cap, *old.shape[1:]), fill, old.dtype)
            new[: len(old)] = old
            setattr(self, attr, new)
        self._cap = cap

    def _journal(self, *entry) -> None:
        self._journal_sha.update(repr(entry).encode())
        self.journal_len += 1

    def _count(self, outcome: str) -> None:
        if self._m_maintain is not None:
            self._m_maintain.inc(outcome=outcome)

    def _candidates(self, i: int) -> np.ndarray:
        """Candidate ids for a point at row ``i`` (already stored)."""
        if self.rpf is None:
            return np.arange(i, dtype=np.int64)
        # Lazy import: ops.rpforest pulls in torch; the exhaustive mode
        # (rpf=None) needs only numpy.
        from hdbscan_tpu_torch.ops.rpforest import leaf_members_np

        leaves = leaf_members_np(self.rpf, self.data32[i])
        # Stored leaf members only reference the ORIGINAL fit rows; every
        # point inserted since bootstrap joins the candidate set so novel
        # mass stays connectable.
        cand = np.unique(
            np.concatenate([leaves, np.arange(self.n0, i, dtype=np.int64)])
        )
        return cand[cand != i]

    # -- the per-point bounded update -------------------------------------

    def insert(self, x) -> dict:
        """Absorb one novel point: bounded candidate query, k-NN row and
        core updates, pending-edge bookkeeping. O(candidates · d) — the
        tree itself is untouched until the next :meth:`splice`."""
        t0 = time.perf_counter()
        x = np.asarray(x, np.float64).reshape(-1)
        if len(x) != self.dims:
            raise ValueError(f"expected {self.dims}-d point, got {len(x)}-d")
        i = self.n
        self._ensure_capacity(i + 1)
        self.data[i] = x
        self.data32[i] = x.astype(np.float32)
        self.n = i + 1
        cand = self._candidates(i)
        d = f32_distances(self.data32[i], self.data32[cand])
        k = self.k
        # The new point's row: k smallest (d, id) among candidates + self.
        ids_all = np.concatenate([cand, [i]])
        d_all = np.concatenate([d, [0.0]])
        order = np.lexsort((ids_all, d_all))[:k]
        width = len(order)
        self.nbr_d[i, :width] = d_all[order]
        self.nbr_i[i, :width] = ids_all[order]
        self.core[i] = self.nbr_d[i, k - 1]
        # Affected neighbors: the new point lands strictly inside their
        # core radius (ties keep rows unchanged — the new id is largest,
        # so on an exact distance tie it sorts last among equals).
        aff = np.nonzero(d < self.core[cand])[0]
        for j in aff:
            c = int(cand[j])
            dc = float(d[j])
            # Decreased-edge candidates from c's OLD row: raw distance
            # strictly under the old core (see module docstring).
            row_d, row_i = self.nbr_d[c], self.nbr_i[c]
            old_core = self.core[c]
            keep = (row_d < old_core) & (row_i >= 0) & (row_i != c)
            if np.any(keep):
                a_ids = row_i[keep]
                self._pend_lo.append(np.minimum(a_ids, c))
                self._pend_hi.append(np.maximum(a_ids, c))
                self._pend_d.append(row_d[keep].copy())
            pos = int(np.searchsorted(row_d, dc, side="right"))
            self.nbr_d[c] = np.concatenate(
                [row_d[:pos], [dc], row_d[pos : k - 1]]
            )
            self.nbr_i[c] = np.concatenate(
                [row_i[:pos], [i], row_i[pos : k - 1]]
            )
            self.core[c] = self.nbr_d[c, k - 1]
        # New-vertex candidate edges: every candidate (exhaustive mode
        # makes the splice exact; rp-forest mode bounds it).
        if len(cand):
            self._pend_lo.append(np.minimum(cand, i))
            self._pend_hi.append(np.maximum(cand, i))
            self._pend_d.append(d)
        self.inserts += 1
        self._since_splice += 1
        self.candidates_total += len(cand)
        self._journal("i", i, len(cand), len(aff))
        wall_ms = (time.perf_counter() - t0) * 1e3
        over = bool(self.budget_ms and wall_ms > self.budget_ms)
        if over:
            self.over_budget += 1
            self._count("over_budget")
        else:
            self._count("inserted")
        return {
            "id": i,
            "candidates": int(len(cand)),
            "affected": int(len(aff)),
            "wall_ms": wall_ms,
            "over_budget": over,
        }

    @property
    def pending_edges(self) -> int:
        return int(sum(len(a) for a in self._pend_lo))

    # -- the cadence splice ------------------------------------------------

    def splice(self) -> dict:
        """Fold pending candidate edges + decreased cores into the tree.

        Cycle-edge replacement at pool scale: re-weight, bound the
        provably-stable prefix, seed its components, Borůvka the suffix
        pool, re-canonicalize. Raises :class:`MaintainFallback` when the
        dirty suffix share exceeds ``dirty_max_frac`` (checked *before*
        any mutation) or connectivity is lost.
        """
        t0 = time.perf_counter()
        n, m = self.n, len(self.m_lo)
        edges_prev = m
        if self._pend_lo:
            clo = np.concatenate(self._pend_lo)
            chi = np.concatenate(self._pend_hi)
            cd = np.concatenate(self._pend_d)
            # Dedup by (lo, hi); identical pairs carry identical raw d.
            ordp = np.lexsort((cd, chi, clo))
            clo, chi, cd = clo[ordp], chi[ordp], cd[ordp]
            first = np.concatenate(
                [[True], (np.diff(clo) != 0) | (np.diff(chi) != 0)]
            )
            clo, chi, cd = clo[first], chi[first], cd[first]
        else:
            clo = chi = np.zeros(0, np.int64)
            cd = np.zeros(0, np.float64)
        cw = np.maximum(cd, np.maximum(self.core[clo], self.core[chi]))
        new_w = np.maximum(
            self.m_d, np.maximum(self.core[self.m_lo], self.core[self.m_hi])
        )
        changed = np.nonzero(new_w != self.m_w)[0]
        f = m
        if len(changed):
            f = int(changed[0])
        if len(cw):
            f = min(f, int(np.searchsorted(self.m_w, cw.min(), side="left")))
        dirty_frac = (m - f) / m if m else 0.0
        if m and dirty_frac > self.dirty_max_frac:
            raise MaintainFallback(
                f"splice dirty fraction {dirty_frac:.3f} exceeds "
                f"maintain_dirty_max_frac={self.dirty_max_frac} "
                f"(suffix {m - f} of {m} edges)"
            )
        comp = _forest_components(n, self.m_lo[:f], self.m_hi[:f])
        pool_lo = np.concatenate([self.m_lo[f:], clo])
        pool_hi = np.concatenate([self.m_hi[f:], chi])
        pool_d = np.concatenate([self.m_d[f:], cd])
        pool_w = np.concatenate([new_w[f:], cw])
        # Dedup candidate pairs that duplicate suffix tree edges (same
        # pair ⇒ same raw d ⇒ same weight; keep the tree copy).
        ordq = np.lexsort((pool_w, pool_hi, pool_lo))
        dup = np.zeros(len(ordq), bool)
        if len(ordq) > 1:
            same = (np.diff(pool_lo[ordq]) == 0) & (
                np.diff(pool_hi[ordq]) == 0
            )
            dup[1:] = same
        keep = np.ones(len(pool_lo), bool)
        keep[ordq[dup]] = False
        pool_lo, pool_hi = pool_lo[keep], pool_hi[keep]
        pool_d, pool_w = pool_d[keep], pool_w[keep]
        acc = _seeded_pool_mst(comp, pool_lo, pool_hi, pool_w)
        if f + len(acc) != n - 1:
            raise MaintainFallback(
                f"splice lost connectivity: prefix {f} + accepted "
                f"{len(acc)} != {n - 1} expected tree edges"
            )
        old_pairs = self.m_lo[f:] * (1 << 32) + self.m_hi[f:]
        new_pairs = pool_lo[acc] * (1 << 32) + pool_hi[acc]
        spliced = int(len(np.setdiff1d(new_pairs, old_pairs)))
        evicted = int(len(np.setdiff1d(old_pairs, new_pairs)))
        # Stable-prefix re-canonicalization: the prefix [:f] has unchanged
        # weights by construction (f <= first re-weighted index), so its
        # canonical (w, lo, hi) order is intact — sort only the accepted
        # suffix and merge it in. Bitwise the old full
        # ``np.lexsort((nhi, nlo, nw))`` over all n-1 edges (see
        # :func:`_merge_sorted_suffix`), without the O(n log n) resort.
        slo, shi = pool_lo[acc], pool_hi[acc]
        sd, sw = pool_d[acc], pool_w[acc]
        sord = np.lexsort((shi, slo, sw))
        self.m_lo, self.m_hi, self.m_d, self.m_w = _merge_sorted_suffix(
            self.m_lo[:f], self.m_hi[:f], self.m_d[:f], new_w[:f],
            slo[sord], shi[sord], sd[sord], sw[sord],
        )
        self._pend_lo, self._pend_hi, self._pend_d = [], [], []
        inserts = self._since_splice
        self._since_splice = 0
        self.splices += 1
        self.spliced_edges += spliced
        self.evicted_edges += evicted
        self._journal("s", f, spliced, evicted, len(self.m_lo))
        wall_s = time.perf_counter() - t0
        self._count("spliced")
        if self.tracer is not None:
            self.tracer(
                "mst_splice",
                maintainer=self.name,
                n=int(n),
                inserts=int(inserts),
                candidates=int(len(clo)),
                dirty_frac=round(float(dirty_frac), 6),
                spliced=spliced,
                evicted=evicted,
                edges_prev=int(edges_prev),
                edges=int(len(self.m_lo)),
                wall_s=round(wall_s, 6),
            )
        return {
            "n": int(n),
            "inserts": int(inserts),
            "candidates": int(len(clo)),
            "dirty_frac": float(dirty_frac),
            "spliced": spliced,
            "evicted": evicted,
            "edges_prev": int(edges_prev),
            "edges": int(len(self.m_lo)),
            "wall_s": wall_s,
        }

    # -- views / durability ------------------------------------------------

    def mst_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Canonical ``(lo, hi, w)`` views of the maintained tree (copies)."""
        return self.m_lo.copy(), self.m_hi.copy(), self.m_w.copy()

    def state_dict(self) -> dict:
        """Deterministic watermark of the maintainer: counters + sha256
        digests of the edit journal and the canonical MST arrays. Two
        maintainers that consumed the same novel-row sequence from the
        same bootstrap agree on every field — the WAL snapshot persists
        this dict so recovery can VERIFY its bitwise replay."""
        mst_sha = hashlib.sha256()
        for a in (self.m_lo, self.m_hi, self.m_d, self.m_w):
            mst_sha.update(np.ascontiguousarray(a).tobytes())
        return {
            "n": int(self.n),
            "inserts": int(self.inserts),
            "splices": int(self.splices),
            "spliced_edges": int(self.spliced_edges),
            "evicted_edges": int(self.evicted_edges),
            "pending_edges": self.pending_edges,
            "journal_len": int(self.journal_len),
            "journal_sha": self._journal_sha.hexdigest(),
            "mst_sha": mst_sha.hexdigest(),
        }

    def rebuild(self, rows, verify_at: tuple[int, dict] | None = None) -> int:
        """Replay a novel-row sequence through insert + cadence splices —
        the WAL recovery fold. ``verify_at=(inserts, state)`` checks the
        maintainer's :meth:`state_dict` digests against a persisted
        watermark when the replay passes that insert count; a mismatch
        raises :class:`MaintainFallback` (recovery then demotes to
        re-fit instead of serving a silently-diverged hierarchy)."""
        count = 0
        for row in rows:
            self.insert(row)
            count += 1
            if self._since_splice >= self.refresh_every:
                self.splice()
            if verify_at is not None and self.inserts == verify_at[0]:
                want = verify_at[1]
                got = self.state_dict()
                for key in ("journal_sha", "mst_sha"):
                    if want.get(key) and got[key] != want[key]:
                        raise MaintainFallback(
                            f"recovery replay diverged at insert "
                            f"{self.inserts}: {key} {got[key][:12]}… != "
                            f"persisted {str(want[key])[:12]}…"
                        )
        return count

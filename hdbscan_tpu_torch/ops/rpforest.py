"""Random-projection-forest approximate k-NN — the port of
``hdbscan_tpu/ops/rpforest.py``.

T random-projection trees partition the points into leaves of at most
``leaf_size``; each leaf scans itself densely, the per-tree candidate lists
merge under the (distance, id) lex order, and bounded neighbor-of-neighbor
rescans repair recall at leaf boundaries. ``knn_index`` picks the tier
("exact", "rpforest", or "auto": rpforest from ``knn_index_threshold``
points on).

The build runs on the tensors' device: level l splits all 2^l nodes at
once — every point's node normal gathered, a projection accumulated feature
by feature in float32 (the order XLA's CPU ``einsum`` takes at 3 <= d <= 8,
where the port's forest equals the reference's bitwise), a stable lexsort
by (node, projection), and a rank split at the static segment midpoint.
Normals come from the reference's numpy generator and seed, so a seed
reproduces the reference's forest.

The query has two routes with one result at f32:

* the unfused route here (:func:`_leaf_scan`, the dedup merge, and
  :func:`_rescan_chunk`) — plain PyTorch, for CPU tensors;
* the fused route (``ops/cuda_forest``): kernels B5-B7 on the card, their
  plain versions on the CPU. On the card every ``knn_backend`` takes it;
  ``knn_precision=bf16`` applies under ``knn_backend=fused`` only.

Trace events, with the reference's names and fields: ``knn_index_build``,
``knn_index_query`` (with a sampled ``recall_at_k``), ``knn_index_rescan``
(one per round; the ``improved`` count stays on the device until the round
ends) and ``knn_fused_forest``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from hdbscan_tpu_torch.core.distances import METRICS, euclidean_form, pairwise_distance
from hdbscan_tpu_torch.ops import cuda_build
from hdbscan_tpu_torch.ops import cuda_forest as cf
from hdbscan_tpu_torch.ops.lexmerge import dedup_lex_merge, lex_kbest

#: The ``knn_index`` vocabulary (``HDBSCANParams.knn_index``).
KNN_INDEXES = ("auto", "exact", "rpforest")

#: ``knn_index="auto"`` takes the forest from this many points on.
AUTO_INDEX_THRESHOLD = 1 << 18  # 262144

#: Candidate-panel elements (rows x k^2 x d) per rescan chunk.
_RESCAN_ELEM_BUDGET = 1 << 24

#: Leaves per leaf-scan batch keep the (B, Lmax, Lmax) distance block under
#: this many elements (the kernel never writes it; the budget keeps the
#: reference's batching and launch count).
_LEAF_ELEM_BUDGET = 1 << 25

#: Rows per block of the sampled-recall scan.
_RECALL_BLOCK = 32


def resolve_knn_index(knn_index: str, n: int, threshold: int = AUTO_INDEX_THRESHOLD) -> str:
    """"exact" and "rpforest" force; "auto" picks rpforest at
    ``n >= threshold`` and the exact scans below it."""
    if knn_index not in KNN_INDEXES:
        raise ValueError(f"knn_index must be one of {KNN_INDEXES}, got {knn_index!r}")
    if knn_index == "auto":
        return "rpforest" if n >= threshold else "exact"
    return knn_index


def forest_depth(n: int, leaf_size: int) -> int:
    """Smallest depth whose largest leaf (= ceil(n / 2^depth)) fits."""
    depth = 0
    while -(-n >> depth) > leaf_size and (1 << depth) < n:
        depth += 1
    return depth


def _level_segments(n: int, depth: int) -> list[list[tuple[int, int]]]:
    """Per-level (start, end) position segments; level l has 2^l nodes, and
    a segment of m points splits at rank ceil(m/2)."""
    levels = [[(0, n)]]
    for _ in range(depth):
        nxt = []
        for s, e in levels[-1]:
            h = s + ((e - s) + 1) // 2
            nxt += [(s, h), (h, e)]
        levels.append(nxt)
    return levels


def _heap_base(level: int) -> int:
    return (1 << level) - 1


@dataclass(frozen=True)
class RPForest:
    """One built forest: heap-indexed routing planes (node j of level l at
    ``2^l - 1 + j``) and per-tree leaf membership, leaves padded to the
    widest by repeating their last member. Numpy arrays, as the
    reference's."""

    n: int
    d: int
    trees: int
    depth: int
    leaf_size: int  # configured cap (post-clamp)
    normals: np.ndarray  # (T, 2^depth - 1, d) float32
    thresholds: np.ndarray  # (T, 2^depth - 1) float32
    members: np.ndarray  # (T, L, Lmax) int32, L = 2^depth
    leaf_mask: np.ndarray  # (L, Lmax) bool, the same for every tree

    @property
    def num_leaves(self) -> int:
        return 1 << self.depth

    @property
    def max_leaf(self) -> int:
        return self.members.shape[2]


def forest_from_numpy(*, n, d, trees, depth, leaf_size, normals, thresholds,
                      members, leaf_mask) -> RPForest:
    """The port's :class:`RPForest` from the reference's fields (numpy
    arrays, e.g. ``dataclasses.asdict`` of a reference forest)."""
    forest = RPForest(
        n=int(n), d=int(d), trees=int(trees), depth=int(depth), leaf_size=int(leaf_size),
        normals=np.asarray(normals, np.float32),
        thresholds=np.asarray(thresholds, np.float32),
        members=np.asarray(members, np.int32),
        leaf_mask=np.asarray(leaf_mask, bool),
    )
    leaves = forest.num_leaves
    if forest.members.shape[:2] != (forest.trees, leaves) or forest.leaf_mask.shape != (
        leaves, forest.max_leaf
    ):
        raise ValueError(
            f"members {forest.members.shape} / leaf_mask {forest.leaf_mask.shape} do not "
            f"fit {forest.trees} trees of {leaves} leaves"
        )
    if forest.members.size and not 0 <= forest.members.min() <= forest.members.max() < forest.n:
        raise ValueError(f"members hold ids outside [0, {forest.n})")
    return forest


def _geometry(n: int, depth: int, device):
    """Per level: each position's node, the split's two neighbour ranks,
    and whether the node splits (size >= 2), as device tensors."""
    geom = []
    for segs in _level_segments(n, depth)[:depth]:
        s = np.array([a for a, _ in segs], np.int64)
        e = np.array([b for _, b in segs], np.int64)
        size = e - s
        h = s + (size + 1) // 2
        lo = np.where(size > 0, np.maximum(h - 1, s), 0)
        hi = np.where(size > 0, np.minimum(h, e - 1), 0)
        pos_node = np.repeat(np.arange(len(segs), dtype=np.int64), size)
        geom.append(tuple(
            torch.as_tensor(a, device=device) for a in (pos_node, lo, hi, size >= 2)
        ))
    return geom


def _project(x: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """Row-wise dot products, features accumulated one at a time."""
    acc = x[:, 0] * plane[:, 0]
    for f in range(1, x.shape[1]):
        acc = acc + x[:, f] * plane[:, f]
    return acc


def _build_one_tree(data: torch.Tensor, normals: torch.Tensor, geom):
    """One tree's balanced rank-split build: the final point permutation
    (leaves contiguous) and the heap-ordered split thresholds."""
    n = data.shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=data.device)
    parts = []
    for level, (pos_node, lo, hi, splittable) in enumerate(geom):
        plane = normals[_heap_base(level) + pos_node]
        proj = _project(data[perm], plane)
        order = torch.sort(proj, stable=True).indices
        order = order[torch.sort(pos_node[order], stable=True).indices]
        perm = perm[order]
        ps = proj[order]
        mid = 0.5 * (ps[lo] + ps[hi])
        parts.append(torch.where(splittable, mid, torch.full_like(mid, float("inf"))))
    thresholds = torch.cat(parts) if parts else torch.zeros(0, dtype=data.dtype)
    return perm, thresholds


def build_forest(data, trees: int = 4, leaf_size: int = 1024, seed: int = 0,
                 dtype=np.float32, trace=None, device=None) -> RPForest:
    """Build T random-projection trees over ``data`` on ``device`` (the card
    unless the caller names another). Normals are unit Gaussian directions
    per node from ``np.random.default_rng(SeedSequence([seed, n, depth]))``,
    as in the reference. Emits one ``knn_index_build`` event."""
    t0 = time.monotonic()
    device = cuda_build.resolve_device(device)
    data = np.asarray(data)
    n, d = data.shape
    if trees < 1:
        raise ValueError(f"trees must be >= 1, got {trees}")
    if leaf_size < 2:
        raise ValueError(f"leaf_size must be >= 2, got {leaf_size}")
    depth = forest_depth(n, leaf_size)
    rng = np.random.default_rng(np.random.SeedSequence([seed, n, depth]))
    num_nodes = _heap_base(depth)
    normals = rng.standard_normal((trees, max(num_nodes, 1), d))
    normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)
    normals = normals.astype(dtype)
    data_dev = torch.as_tensor(data.astype(dtype), device=device)
    geom = _geometry(n, depth, device)

    leaves = _level_segments(n, depth)[depth]
    lmax = max(e - s for s, e in leaves)
    pos_idx = np.zeros((len(leaves), lmax), np.int64)
    leaf_mask = np.zeros((len(leaves), lmax), bool)
    for j, (s, e) in enumerate(leaves):
        pos_idx[j, : e - s] = np.arange(s, e)
        pos_idx[j, e - s :] = e - 1  # pad by repeating the last position
        leaf_mask[j, : e - s] = True
    pos_dev = torch.as_tensor(pos_idx, device=device)

    members = np.zeros((trees, len(leaves), lmax), np.int32)
    thresholds = np.zeros((trees, max(num_nodes, 1)), dtype)
    for t in range(trees):
        perm, thr = _build_one_tree(data_dev, torch.as_tensor(normals[t], device=device), geom)
        members[t] = perm[pos_dev].to(torch.int32).cpu().numpy()
        if num_nodes:
            thresholds[t, :num_nodes] = thr.cpu().numpy()
    forest = RPForest(n=n, d=d, trees=trees, depth=depth, leaf_size=leaf_size,
                      normals=normals, thresholds=thresholds, members=members,
                      leaf_mask=leaf_mask)
    if trace is not None:
        trace("knn_index_build", wall_s=time.monotonic() - t0, trees=trees, depth=depth,
              leaf_size=leaf_size, max_leaf=lmax, n=n, d=d)
    return forest


# ---------------------------------------------------------------------------
# Leaf scans and the candidate merge.


def leaf_batches(forest: RPForest, device):
    """The leaf batches of one tree's scan, ``(start, stop, real)``:
    leaves [start, stop) keep the (B, Lmax, Lmax) block within
    ``_LEAF_ELEM_BUDGET``; ``real`` indexes the batch's flattened real
    slots (padded slots repeat a member and are dropped)."""
    lmax = forest.max_leaf
    batch = max(1, _LEAF_ELEM_BUDGET // (lmax * lmax))
    out = []
    for a in range(0, forest.num_leaves, batch):
        b = min(a + batch, forest.num_leaves)
        real = np.flatnonzero(forest.leaf_mask[a:b].reshape(-1))
        out.append((a, b, torch.as_tensor(real, device=device)))
    return out


def _leaf_scan(data, members, mask, kk: int, metric: str, sentinel: int):
    """Dense k-NN of every leaf of a batch against itself: (B, Lmax, kk)
    ascending (distance, id) lists of global ids, masked columns at
    (+inf, ``sentinel``) — the plain leaf scan, B5's plain version."""
    lmax, d = members.shape[1], data.shape[1]
    form = euclidean_form(lmax, lmax, d) if metric == "euclidean" else None
    return cf.forest_leaf_topk_plain(data, members, mask, kk, metric, form, "f32", sentinel)


def trace_query(trace, data_dev, forest: RPForest, best_i, kk: int, metric: str,
                recall_sample: int, t0: float) -> None:
    """The ``knn_index_query`` event of either query route."""
    fields = dict(n=forest.n, k=kk, trees=forest.trees, candidates=forest.trees * kk)
    if recall_sample:
        recall, rows = _sampled_recall(data_dev[: forest.n], best_i, kk, metric, recall_sample)
        fields["recall_at_k"] = recall
        fields["recall_rows"] = rows
    trace("knn_index_query", wall_s=time.monotonic() - t0, **fields)


def forest_knn(data_dev, forest: RPForest, k: int, metric: str = "euclidean", trace=None,
               recall_sample: int = 256, backend: str = "xla", precision: str = "f32"):
    """Approximate neighbor lists from the built forest: (n, kk) ascending
    (distance, id), kk = min(k, max leaf).

    Per tree, the leaf batches are scanned and copied back to point-major
    order; then one dedup lex merge across the T per-tree lists. A CUDA
    tensor, or ``backend="fused"``, takes the fused route
    (``cuda_forest.forest_knn_fused``: kernels B5 and B6 on the card).
    Emits ``knn_index_query`` with a sampled ``recall_at_k``.
    """
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")
    if backend == "fused" or data_dev.device.type == "cuda":
        return cf.forest_knn_fused(data_dev, forest, k, metric, precision=precision,
                                   trace=trace, recall_sample=recall_sample)
    t0 = time.monotonic()
    n, lmax = forest.n, forest.max_leaf
    kk = min(k, lmax)
    sentinel = n
    dev = data_dev.device
    members = torch.as_tensor(forest.members, device=dev)
    mask = torch.as_tensor(forest.leaf_mask, device=dev)
    per_d, per_i = [], []
    for t in range(forest.trees):
        out_d = torch.full((n, kk), float("inf"), dtype=data_dev.dtype, device=dev)
        out_i = torch.full((n, kk), sentinel, dtype=torch.int32, device=dev)
        for a, b, real in leaf_batches(forest, dev):
            nd, ni = _leaf_scan(data_dev, members[t, a:b], mask[a:b], kk, metric, sentinel)
            rows = members[t, a:b].reshape(-1)[real].long()
            out_d[rows] = nd.reshape(-1, kk)[real]
            out_i[rows] = ni.reshape(-1, kk)[real]
        per_d.append(out_d)
        per_i.append(out_i)
    best_d, best_i = dedup_lex_merge(torch.cat(per_d, 1), torch.cat(per_i, 1), kk, sentinel)
    if trace is not None:
        trace_query(trace, data_dev, forest, best_i, kk, metric, recall_sample, t0)
    return best_d, best_i


def _expand(best_i, bi, k: int, sentinel: int):
    """The neighbor-of-neighbor candidate ids of rows ``bi`` (m, k): the
    k lists of their k neighbors, (m, k^2), sentinel where the neighbor
    slot is empty."""
    m = bi.shape[0]
    cand = best_i[bi.clamp(0, sentinel - 1).long()].reshape(m, k * k)
    empty = (bi == sentinel).repeat_interleave(k, dim=1)
    return torch.where(empty, sentinel, cand).to(torch.int32)


def _rescan_chunk(data, q, bd, bi, cand, k: int, metric: str, sentinel: int):
    """One unfused rescan chunk: distances to the whole (m, k^2) candidate
    panel, then the dedup lex merge of running lists and panel."""
    cpts = data[cand.clamp(0, sentinel - 1).long()]
    cd = cf.rows_dist(q, cpts, metric, precision="f32")
    cd = torch.where(cand == sentinel, torch.tensor(float("inf"), device=data.device), cd)
    return dedup_lex_merge(torch.cat([bd, cd], 1), torch.cat([bi, cand], 1), k, sentinel)


def run_rescan(data_dev, best_d, best_i, k: int, rnd: int, rescan_rounds: int,
               sentinel: int, trace, chunk_fn):
    """One rescan round over all rows in chunks of the reference's size
    (``_RESCAN_ELEM_BUDGET``), ``chunk_fn(q, bd, bi, cand)`` merging each
    chunk; the count of rows whose k-th distance improved stays on the
    device and is read once, for the ``knn_index_rescan`` event."""
    t0 = time.monotonic()
    n_rows, d = best_d.shape[0], data_dev.shape[1]
    chunk = min(n_rows, max(64, _RESCAN_ELEM_BUDGET // max(1, k * k * d)))
    parts_d, parts_i = [], []
    improved = torch.zeros((), dtype=torch.int64, device=best_d.device)
    for a in range(0, n_rows, chunk):
        b = min(a + chunk, n_rows)
        bd, bi = best_d[a:b], best_i[a:b]
        nd, ni = chunk_fn(data_dev[a:b], bd, bi, _expand(best_i, bi, k, sentinel))
        improved += (nd[:, k - 1] < bd[:, k - 1]).sum()
        parts_d.append(nd)
        parts_i.append(ni)
    best_d, best_i = torch.cat(parts_d), torch.cat(parts_i)
    if trace is not None:
        trace("knn_index_rescan", wall_s=time.monotonic() - t0, round=rnd,
              rescan_rounds=rescan_rounds, improved=int(improved), n=sentinel, k=k)
    return best_d, best_i


def rescan_round(data_dev, best_d, best_i, k: int, metric: str, rnd: int,
                 rescan_rounds: int, sentinel: int | None = None, trace=None,
                 backend: str = "xla", precision: str = "f32"):
    """One neighbor-of-neighbor round over all rows: every row's candidates
    are its neighbors' lists, merged into its own. A CUDA tensor, or
    ``backend="fused"``, takes ``cuda_forest.rescan_round_fused`` (kernel
    B7 on the card)."""
    if backend == "fused" or data_dev.device.type == "cuda":
        return cf.rescan_round_fused(data_dev, best_d, best_i, k, metric, rnd, rescan_rounds,
                                     sentinel=sentinel, precision=precision, trace=trace)
    sentinel = data_dev.shape[0] if sentinel is None else sentinel

    def chunk_fn(q, bd, bi, cand):
        return _rescan_chunk(data_dev, q, bd, bi, cand, k, metric, sentinel)

    return run_rescan(data_dev, best_d, best_i, k, rnd, rescan_rounds, sentinel, trace,
                      chunk_fn)


def _sampled_recall(data_dev, best_i, k: int, metric: str, sample: int):
    """Mean per-row recall@k of ``best_i`` against an exact scan of
    ``sample`` evenly spaced rows (ids by the (distance, id) order, in the
    euclidean form the reference takes for the whole (rows, n) block)."""
    n, d = data_dev.shape
    rows = np.unique(np.linspace(0, n - 1, num=min(sample, n), dtype=np.int64))
    form = euclidean_form(len(rows), n, d) if metric == "euclidean" else None
    exact = []
    for a in range(0, len(rows), _RECALL_BLOCK):
        blk = torch.as_tensor(rows[a : a + _RECALL_BLOCK], device=data_dev.device)
        dist = pairwise_distance(data_dev[blk], data_dev, metric, form)
        exact.append(lex_kbest(dist, k)[1].cpu().numpy())
    exact = np.concatenate(exact)
    approx = best_i[torch.as_tensor(rows, device=best_i.device)].cpu().numpy()
    hits = sum(len(np.intersect1d(exact[r], approx[r])) for r in range(len(rows)))
    return float(hits) / float(len(rows) * k), int(len(rows))


# ---------------------------------------------------------------------------
# The core-distance entry point (the ``ops/tiled`` return contract).


def rpforest_core_distances(
    data,
    min_pts: int,
    metric: str = "euclidean",
    k: int | None = None,
    *,
    trees: int = 4,
    leaf_size: int = 1024,
    rescan_rounds: int = 1,
    seed: int = 0,
    dtype=np.float32,
    return_indices: bool = False,
    fetch_knn: bool = True,
    trace=None,
    recall_sample: int = 256,
    forest: RPForest | None = None,
    knn_backend: str = "auto",
    knn_precision: str = "f32",
    device=None,
):
    """Approximate core distances through the forest, in the contract of
    ``ops/tiled.knn_core_distances``: ``(core, knn)`` — float64 (n,) core
    (the min_pts-th smallest distance, self included; zeros at
    ``min_pts <= 1``) and float64 (n, k) ascending distances — with the
    (n, k) int64 ids appended under ``return_indices``; ``(core, None)``
    with ``fetch_knn=False``.

    ``leaf_size`` is clamped to ``>= 2k + 2`` so every leaf supplies k
    candidates including self. ``forest`` reuses a built forest (e.g. the
    reference's, through :func:`forest_from_numpy`).

    Routes: on the card the kernels run at every ``knn_backend`` and
    metric (pearson over rows centred once, ``cuda_build.kernel_points``,
    while the forest's hyperplanes split the raw rows), past k or d = 128
    in their wide mode (and the call raises where they cannot: not
    float32). Off the card ``knn_backend="fused"``
    takes the fused route's plain versions where
    ``cuda_forest.fused_forest_eligible``, else the unfused route; both
    agree bitwise at f32. ``knn_precision="bf16"`` (euclidean,
    ``knn_backend="fused"``, inside the fused gate; f32 past it, as the
    reference's unfused route) runs the query and the rescans at
    an over-provisioned width ``min(2k, 128, n)`` with bf16 distance tiles,
    then one exact float32 refine keeps the best k. One
    ``knn_fused_forest`` event records a fused run (``interpret`` is True
    where the plain versions ran in place of the kernels).
    """
    device = cuda_build.resolve_device(device)
    data = np.asarray(data)
    n, d = data.shape
    k_eff = min(max(k or 0, max(min_pts - 1, 1)), n)
    leaf_size = min(max(leaf_size, 2 * k_eff + 2, 8), max(n, 2))
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")
    if knn_precision == "bf16" and metric != "euclidean":
        raise ValueError("knn_precision='bf16' supports euclidean only (bf16 distance tiles)")
    on_card = device.type == "cuda"
    eligible = cf.fused_forest_eligible(n, d, k_eff, metric, dtype)
    if on_card:
        cf.check_card_shape(d, k_eff, metric, dtype, knn_precision)
        use_fused = True
    else:
        use_fused = knn_backend == "fused" and eligible
    # bf16 tiles only inside the fused gate; past it the f32 kernels compute
    # the reference's unfused route (the two routes agree bitwise at f32).
    precision = knn_precision if knn_backend == "fused" and eligible else "f32"
    backend = "fused" if use_fused else "xla"
    if forest is None:
        forest = build_forest(data, trees=trees, leaf_size=leaf_size, seed=seed, dtype=dtype,
                              trace=trace, device=device)
    data_dev = torch.as_tensor(data.astype(dtype), device=device)
    # The kernels take pearson's rows centred once; the forest was built on
    # the raw rows.
    if use_fused:
        data_dev, metric = cuda_build.kernel_points(data_dev, metric)
    k_run = min(2 * k_eff, cf.LANES, n) if precision == "bf16" else k_eff
    t_fused = time.monotonic()
    best_d, best_i = forest_knn(data_dev, forest, k_run, metric, trace=trace,
                                recall_sample=recall_sample, backend=backend,
                                precision=precision)
    for rnd in range(rescan_rounds):
        best_d, best_i = rescan_round(data_dev, best_d, best_i, k_run, metric, rnd,
                                      rescan_rounds, sentinel=n, trace=trace,
                                      backend=backend, precision=precision)
    refine_rows = 0
    if precision == "bf16":
        best_d, best_i = cf.refine_f32(data_dev, best_d, best_i, metric, n)
        refine_rows = int(best_d.shape[0])
        best_d, best_i = best_d[:, :k_eff], best_i[:, :k_eff]
    if use_fused and trace is not None:
        if on_card:
            torch.cuda.synchronize(device)
        trace("knn_fused_forest", wall_s=time.monotonic() - t_fused, n=n, k=k_eff,
              trees=forest.trees, leaf_tiles=forest.trees * forest.num_leaves,
              refine_rows=refine_rows, precision=precision, interpret=not on_card)
    col = min(min_pts - 1, n) - 1
    if not fetch_knn and not return_indices:
        if min_pts <= 1:
            return np.zeros(n, np.float64), None
        return best_d[:, col].cpu().numpy().astype(np.float64), None
    knn = best_d.cpu().numpy().astype(np.float64)
    core = np.zeros(n, np.float64) if min_pts <= 1 else knn[:, col].copy()
    if return_indices:
        return core, knn, best_i.cpu().numpy().astype(np.int64)
    return core, knn


def rpforest_core_distances_rows(data, row_ids, min_pts: int, metric: str = "euclidean", *,
                                 trees: int = 4, leaf_size: int = 1024, rescan_rounds: int = 1,
                                 seed: int = 0, dtype=np.float32, trace=None,
                                 knn_backend: str = "auto", knn_precision: str = "f32",
                                 device=None):
    """Approximate core distances of the SELECTED rows (the contract of
    ``ops/tiled.knn_core_distances_rows``: (m,) float64): one forest pass
    over the whole set (B5-B7 on the card), then a slice by rows — the
    forest indexes every point either way, and the rows' neighbour-of-
    neighbour rescans need the whole graph."""
    core, _ = rpforest_core_distances(
        data, min_pts, metric, trees=trees, leaf_size=leaf_size,
        rescan_rounds=rescan_rounds, seed=seed, dtype=dtype, fetch_knn=False, trace=trace,
        recall_sample=0, knn_backend=knn_backend, knn_precision=knn_precision, device=device,
    )
    return core[np.asarray(row_ids)]

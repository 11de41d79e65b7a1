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

The query is one loop over row shards (one device is one shard): the leaf
scans through B5 (``ops/cuda_forest``; its plain version for CPU tensors),
then two routes with one result at f32:

* the fused route: the trees folded by B6 and the rescans reduced by B7
  (their plain versions on the CPU). On the card every ``knn_backend``
  takes it; ``knn_precision=bf16`` applies under ``knn_backend=fused``
  only;
* the unfused route, for CPU tensors: one dedup merge of the trees and
  whole-panel rescans (:func:`_rescan_chunk`), plain PyTorch.

Trace events, with the reference's names and fields: ``knn_index_build``,
``knn_index_query`` (with a sampled ``recall_at_k``), ``knn_index_rescan``
(one per round; the ``improved`` count stays on the device until the round
ends) and ``knn_fused_forest``.

:func:`leaf_members_np` routes one point on the host through a stored
forest (the incremental maintainer's candidate query).
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
from hdbscan_tpu_torch.parallel.mesh import block_shards, fetch

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


def _normals(seed: int, n: int, depth: int, trees: int, d: int) -> np.ndarray:
    """(T, max(2^depth - 1, 1), d) float64 unit Gaussian routing normals from
    ``np.random.default_rng(SeedSequence([seed, n, depth]))``, the
    reference's draw (the sharded forest passes its shard size as n)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, n, depth]))
    normals = rng.standard_normal((trees, max(_heap_base(depth), 1), d))
    normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)
    return normals


def _leaf_layout(n: int, depth: int) -> tuple[np.ndarray, np.ndarray]:
    """The leaves' positions in a tree's permutation, (L, Lmax) int64, a
    leaf padded by repeating its last position, and the (L, Lmax) mask of
    its real slots."""
    leaves = _level_segments(n, depth)[depth]
    lmax = max(e - s for s, e in leaves)
    pos_idx = np.zeros((len(leaves), lmax), np.int64)
    leaf_mask = np.zeros((len(leaves), lmax), bool)
    for j, (s, e) in enumerate(leaves):
        pos_idx[j, : e - s] = np.arange(s, e)
        pos_idx[j, e - s :] = e - 1
        leaf_mask[j, : e - s] = True
    return pos_idx, leaf_mask


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
    num_nodes = _heap_base(depth)
    normals = _normals(seed, n, depth, trees, d).astype(dtype)
    data_dev = torch.as_tensor(data.astype(dtype), device=device)
    geom = _geometry(n, depth, device)
    pos_idx, leaf_mask = _leaf_layout(n, depth)
    lmax = pos_idx.shape[1]
    pos_dev = torch.as_tensor(pos_idx, device=device)

    from hdbscan_tpu_torch import obs

    members = np.zeros((trees, len(pos_idx), lmax), np.int32)
    thresholds = np.zeros((trees, max(num_nodes, 1)), dtype)
    with obs.mem_phase("knn_index_build"), obs.task("rpforest_build", total=trees) as hb:
        for t in range(trees):
            perm, thr = _build_one_tree(data_dev, torch.as_tensor(normals[t], device=device),
                                        geom)
            members[t] = perm[pos_dev].to(torch.int32).cpu().numpy()
            if num_nodes:
                thresholds[t, :num_nodes] = thr.cpu().numpy()
            hb.beat(t + 1)
    forest = RPForest(n=n, d=d, trees=trees, depth=depth, leaf_size=leaf_size,
                      normals=normals, thresholds=thresholds, members=members,
                      leaf_mask=leaf_mask)
    if trace is not None:
        trace("knn_index_build", wall_s=time.monotonic() - t0, trees=trees, depth=depth,
              leaf_size=leaf_size, max_leaf=lmax, n=n, d=d)
    return forest


# ---------------------------------------------------------------------------
# Leaf scans and the candidate merge.


def _leaf_plan(forest: RPForest, devices) -> list:
    """One tree's leaf scans: the leaf batches that keep the (B, Lmax, Lmax)
    block within ``_LEAF_ELEM_BUDGET``, each batch's leaves cut into one
    contiguous slice a shard of ``devices`` (``mesh.block_shards``; one
    device keeps the whole batch). Returns ``(start, stop, device, real)``
    a non-empty slice: leaves [start, stop) and ``real``, the slice's
    flattened real slots on the device (padded slots repeat a member and
    are dropped)."""
    lmax = forest.max_leaf
    batch = max(1, _LEAF_ELEM_BUDGET // (lmax * lmax))
    out = []
    for a in range(0, forest.num_leaves, batch):
        b = min(a + batch, forest.num_leaves)
        for la, lb, dev in block_shards(devices, b - a):
            if la < lb:
                real = np.flatnonzero(forest.leaf_mask[a + la : a + lb].reshape(-1))
                out.append((a + la, a + lb, dev, torch.as_tensor(real, device=dev)))
    return out


def leaf_batches(forest: RPForest, device):
    """The leaf batches of one tree's scan on one device, ``(start, stop,
    real)`` (:func:`_leaf_plan`)."""
    return [(a, b, real) for a, b, _, real in _leaf_plan(forest, [torch.device(device)])]


def trace_query(trace, data_dev, forest: RPForest, best_i, kk: int, metric: str,
                recall_sample: int, t0: float) -> None:
    """The ``knn_index_query`` event of the forest query."""
    fields = dict(n=forest.n, k=kk, trees=forest.trees, candidates=forest.trees * kk)
    if recall_sample:
        recall, rows = _sampled_recall(data_dev[: forest.n], best_i, kk, metric, recall_sample)
        fields["recall_at_k"] = recall
        fields["recall_rows"] = rows
    trace("knn_index_query", wall_s=time.monotonic() - t0, **fields)


def _fused(backend: str, device) -> bool:
    """Whether the fold and the rescans take the kernels' route on
    ``device``: always on a card, off it under ``backend="fused"``."""
    return backend == "fused" or torch.device(device).type == "cuda"


def forest_knn(data_dev, forest: RPForest, k: int, metric: str = "euclidean", trace=None,
               recall_sample: int = 256, backend: str = "xla", precision: str = "f32"):
    """Approximate neighbor lists from the built forest on one device:
    (n, kk) ascending (distance, id), kk = min(k, max leaf)
    (:func:`forest_knn_shards` over one row shard)."""
    dev = data_dev.device
    [lists] = forest_knn_shards({dev: data_dev}, [(0, forest.n, dev)], forest, k, metric,
                                trace=trace, recall_sample=recall_sample, backend=backend,
                                precision=precision)
    return lists


def forest_knn_shards(data_on: dict, rows, forest: RPForest, k: int, metric: str = "euclidean",
                      *, trace=None, recall_sample: int = 256, backend: str = "xla",
                      precision: str = "f32"):
    """The forest query over row shards: ``rows`` lists each shard's
    ``(lo, hi, device)`` (``mesh.block_shards`` of n; one device is
    ``[(0, n, device)]``), ``data_on`` maps each distinct device to the
    data on it. Returns each row shard's (hi - lo, kk) lists, ascending
    (distance, id), kk = min(k, max leaf).

    Per tree, each leaf batch's leaves are cut into one slice a shard
    (:func:`_leaf_plan`) and scanned on the shard's device by B5
    (``cuda_forest.forest_leaf_topk``; its plain version for CPU tensors),
    the real slots copied into the per-tree lists of the row shard that
    owns them. Each row shard then folds its T lists: B6
    (``cuda_forest.forest_merge``) on the kernels' route (:func:`_fused`),
    else one dedup lex merge. Every op is per leaf or per row, so the lists
    equal the one-device query's bitwise. Emits ``knn_index_query`` with a
    sampled ``recall_at_k``.
    """
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")
    t0 = time.monotonic()
    n, lmax, trees = forest.n, forest.max_leaf, forest.trees
    kk = min(k, lmax)
    sentinel = n
    form = cf.euclid_form(lmax, lmax, forest.d)
    members = {dev: torch.as_tensor(forest.members, device=dev) for dev in data_on}
    mask = {dev: torch.as_tensor(forest.leaf_mask, device=dev) for dev in data_on}
    dtype = next(iter(data_on.values())).dtype
    stacks = [(torch.full((trees, hi - lo, kk), float("inf"), dtype=dtype, device=dev),
               torch.full((trees, hi - lo, kk), sentinel, dtype=torch.int32, device=dev))
              for lo, hi, dev in rows]
    plan = _leaf_plan(forest, [dev for _, _, dev in rows])
    for t in range(trees):
        for a, b, dev, real in plan:
            mem = members[dev][t, a:b]
            nd, ni = cf.forest_leaf_topk(data_on[dev], mem, mask[dev][a:b], kk, metric=metric,
                                         form=form, precision=precision, sentinel=sentinel)
            ids = mem.reshape(-1)[real].long()
            nd, ni = nd.reshape(-1, kk)[real], ni.reshape(-1, kk)[real]
            for (lo, hi, rdev), (sd, si) in zip(rows, stacks):
                at, vd, vi = ids, nd, ni
                if (lo, hi) != (0, n):  # the rows this shard owns
                    sel = torch.nonzero((ids >= lo) & (ids < hi)).squeeze(1)
                    at, vd, vi = ids[sel] - lo, nd[sel], ni[sel]
                at = at.to(rdev)
                sd[t].index_copy_(0, at, vd.to(rdev))
                si[t].index_copy_(0, at, vi.to(rdev))
    lists = []
    for (lo, hi, dev), (sd, si) in zip(rows, stacks):
        if hi == lo:
            lists.append((sd[0], si[0]))
        elif _fused(backend, dev):
            lists.append(cf.forest_merge(sd, si, kk, sentinel))
        else:
            m = hi - lo
            lists.append(dedup_lex_merge(sd.permute(1, 0, 2).reshape(m, trees * kk),
                                         si.permute(1, 0, 2).reshape(m, trees * kk),
                                         kk, sentinel))
    for dev in data_on:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if trace is not None:
        root = rows[0][2]
        best_i = _gather([bi for _, bi in lists], root)
        trace_query(trace, data_on[root], forest, best_i, kk, metric, recall_sample, t0)
    return lists


def _gather(parts, device):
    """Row shards' tensors concatenated on ``device`` (one shard as is)."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])


def _expand(best_i, bi, k: int, sentinel: int):
    """The neighbor-of-neighbor candidate ids of rows ``bi`` (m, k): the
    k lists of their k neighbors, (m, k^2), sentinel where the neighbor
    slot is empty."""
    m = bi.shape[0]
    cand = best_i[bi.clamp(0, sentinel - 1).long()].reshape(m, k * k)
    empty = (bi == sentinel).repeat_interleave(k, dim=1)
    return torch.where(empty, sentinel, cand).to(torch.int32)


def _rescan_chunk(data, q, bd, bi, cand, k: int, metric: str, sentinel: int, fused: bool,
                  precision: str):
    """One rescan chunk: the candidate panel reduced to k a row by B7
    (``cuda_forest.forest_rescan_topk``) on the kernels' route, else its
    distances taken whole; then the dedup lex merge of running lists and
    panel."""
    if fused:
        cd, cand = cf.forest_rescan_topk(q, data, cand, k, metric=metric, precision=precision,
                                         sentinel=sentinel)
    else:
        cpts = data[cand.clamp(0, sentinel - 1).long()]
        cd = cf.rows_dist(q, cpts, metric, precision="f32")
        cd = torch.where(cand == sentinel, torch.tensor(float("inf"), device=data.device), cd)
    return dedup_lex_merge(torch.cat([bd, cd], 1), torch.cat([bi, cand], 1), k, sentinel)


def rescan_round(data_dev, best_d, best_i, k: int, metric: str, rnd: int,
                 rescan_rounds: int, sentinel: int | None = None, trace=None,
                 backend: str = "xla", precision: str = "f32"):
    """One neighbor-of-neighbor round on one device
    (:func:`rescan_round_shards` over one row shard)."""
    dev = data_dev.device
    sentinel = data_dev.shape[0] if sentinel is None else sentinel
    [lists] = rescan_round_shards({dev: data_dev}, [(0, best_d.shape[0], dev)],
                                  [(best_d, best_i)], k, metric, rnd, rescan_rounds, sentinel,
                                  trace=trace, backend=backend, precision=precision)
    return lists


def rescan_round_shards(data_on: dict, rows, lists, k: int, metric: str, rnd: int,
                        rescan_rounds: int, sentinel: int, *, trace=None, backend: str = "xla",
                        precision: str = "f32"):
    """One neighbor-of-neighbor round over row shards (``rows`` and
    ``data_on`` as for :func:`forest_knn_shards`, ``lists`` each shard's):
    every row's candidates are its neighbors' lists, gathered from every
    shard, merged into its own by :func:`_rescan_chunk` (B7 on the
    kernels' route) in chunks of the reference's size
    (``_RESCAN_ELEM_BUDGET``). The count of rows whose k-th distance
    improved stays on the device and is read once, for the
    ``knn_index_rescan`` event. Returns each shard's new lists."""
    t0 = time.monotonic()
    root = rows[0][2]
    all_i = _gather([bi for _, bi in lists], root)
    all_on = {dev: all_i.to(dev) for dev in data_on}
    d = next(iter(data_on.values())).shape[1]
    chunk = max(64, _RESCAN_ELEM_BUDGET // max(1, k * k * d))
    out, improved = [], torch.zeros((), dtype=torch.int64, device=root)
    for (lo, hi, dev), (bd, bi) in zip(rows, lists):
        data, fused = data_on[dev], _fused(backend, dev)
        parts_d, parts_i = [], []
        for a in range(0, hi - lo, chunk):
            b = min(a + chunk, hi - lo)
            cd, ci = bd[a:b], bi[a:b]
            nd, ni = _rescan_chunk(data, data[lo + a : lo + b], cd, ci,
                                   _expand(all_on[dev], ci, k, sentinel), k, metric, sentinel,
                                   fused, precision)
            improved += (nd[:, k - 1] < cd[:, k - 1]).sum().to(root)
            parts_d.append(nd)
            parts_i.append(ni)
        out.append((torch.cat(parts_d), torch.cat(parts_i)) if parts_d else (bd, bi))
    if trace is not None:
        trace("knn_index_rescan", wall_s=time.monotonic() - t0, round=rnd,
              rescan_rounds=rescan_rounds, improved=int(improved), n=sentinel, k=k)
    return out


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
# Routing queries down a stored forest (serving).


def route_queries(queries: torch.Tensor, normals: torch.Tensor, thresholds: torch.Tensor,
                  depth: int) -> torch.Tensor:
    """Leaf id per query: ``depth`` gather + dot + compare steps down the
    heap-indexed planes, projections >= threshold going right (the
    rank-split midpoint recorded at build time). ``normals`` (T, 2^depth -
    1, d) and ``thresholds`` (T, 2^depth - 1) route every tree at once into
    (T, B) int64 leaves; without the T axis, one tree into (B,). The
    projection accumulates the features one at a time (:func:`_project`'s
    order, the reference's ``jnp.einsum`` at 3 <= d <= 8). Used by
    ``serve/predict`` to query a stored forest."""
    one = normals.dim() == 2
    if one:
        normals, thresholds = normals[None], thresholds[None]
    trees, b = normals.shape[0], queries.shape[0]
    tree = torch.arange(trees, device=queries.device)[:, None]
    node = torch.zeros((trees, b), dtype=torch.int64, device=queries.device)
    for level in range(depth):
        heap = _heap_base(level) + node
        plane = normals[tree, heap]  # (T, B, d)
        proj = queries[None, :, 0] * plane[..., 0]
        for f in range(1, queries.shape[1]):
            proj = proj + queries[None, :, f] * plane[..., f]
        node = node * 2 + (proj >= thresholds[tree, heap]).long()
    return node[0] if one else node


def leaf_members_np(rpf, x) -> np.ndarray:
    """Candidate member ids for ONE point: the numpy mirror of
    :func:`route_queries` over every tree, returning the union of the T
    visited leaves' members (sorted unique int64).

    ``rpf`` is either a built :class:`RPForest` or the ``serve/artifact``
    packed dict (same field names). The incremental maintainer
    (``incremental/insert.py``) routes each novel point against the
    model's stored planes on the host: one dot + compare per level per
    tree, O(trees · depth · d) per point.
    """
    get = (lambda k: getattr(rpf, k)) if isinstance(rpf, RPForest) else rpf.__getitem__
    normals = np.asarray(get("normals"))
    thresholds = np.asarray(get("thresholds"))
    members = get("members")
    leaf_mask = get("leaf_mask")
    depth = int(get("depth"))
    x32 = np.asarray(x, normals.dtype).reshape(-1)
    parts = []
    for t in range(int(get("trees"))):
        node = 0
        for level in range(depth):
            heap = _heap_base(level) + node
            proj = normals[t, heap] @ x32
            node = node * 2 + int(proj >= thresholds[t, heap])
        parts.append(members[t, node][leaf_mask[node]].astype(np.int64))
    if not parts:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate(parts))


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
    mesh=None,
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

    ``mesh`` (the ``scan_backend=ring`` composition, the reference's
    sharded ``forest_knn``): the forest is built once on the first shard's
    device, the data lies on every distinct device, the leaf scans are cut
    over the shards and the rows fold and rescan on their row shard
    (:func:`forest_knn_shards`, rows split as ``mesh.block_shards`` splits
    n), equal to the one-device run bitwise. Over two or more shards the
    query runs at f32 whatever ``knn_precision`` asks, as the reference's,
    whose fused route is single-device.
    """
    data = np.asarray(data)
    n, d = data.shape
    k_eff = min(max(k or 0, max(min_pts - 1, 1)), n)
    leaf_size = min(max(leaf_size, 2 * k_eff + 2, 8), max(n, 2))
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")
    if knn_precision == "bf16" and metric != "euclidean":
        raise ValueError("knn_precision='bf16' supports euclidean only (bf16 distance tiles)")
    from hdbscan_tpu_torch.parallel.mesh import refuse_multiprocess

    refuse_multiprocess(mesh, "the rp-forest (knn_index=rpforest)")
    devices = mesh.devices if mesh is not None else (cuda_build.resolve_device(device),)
    root = devices[0]
    on_card = root.type == "cuda"  # a mesh never mixes the CPU and cards
    eligible = cf.fused_forest_eligible(n, d, k_eff, metric, dtype)
    # bf16 tiles only inside the fused gate and on one device; past it the
    # f32 kernels compute the reference's unfused route (the two routes
    # agree bitwise at f32).
    precision = (knn_precision if knn_backend == "fused" and eligible and len(devices) == 1
                 else "f32")
    if on_card:
        cf.check_card_shape(d, k_eff, metric, dtype, precision)
    use_fused = on_card or (knn_backend == "fused" and eligible)
    backend = "fused" if use_fused else "xla"
    if forest is None:
        forest = build_forest(data, trees=trees, leaf_size=leaf_size, seed=seed, dtype=dtype,
                              trace=trace, device=root)
    data_on, run_metric = {}, metric
    for dev in dict.fromkeys(devices):
        x = torch.as_tensor(data.astype(dtype), device=dev)
        # The kernels take pearson's rows centred once; the forest was
        # built on the raw rows.
        if use_fused:
            x, run_metric = cuda_build.kernel_points(x, metric)
        data_on[dev] = x
    metric = run_metric
    rows = block_shards(devices, n)
    k_run = min(2 * k_eff, cf.LANES, n) if precision == "bf16" else k_eff
    t_fused = time.monotonic()
    lists = forest_knn_shards(data_on, rows, forest, k_run, metric, trace=trace,
                              recall_sample=recall_sample, backend=backend, precision=precision)
    for rnd in range(rescan_rounds):
        lists = rescan_round_shards(data_on, rows, lists, k_run, metric, rnd, rescan_rounds, n,
                                    trace=trace, backend=backend, precision=precision)
    refine_rows = 0
    if precision == "bf16":  # one device
        best_d, best_i = cf.refine_f32(data_on[root], *lists[0], metric, n)
        refine_rows = int(best_d.shape[0])
        lists = [(best_d[:, :k_eff], best_i[:, :k_eff])]
    if use_fused and trace is not None:
        if on_card:
            for dev in data_on:
                torch.cuda.synchronize(dev)
        trace("knn_fused_forest", wall_s=time.monotonic() - t_fused, n=n, k=k_eff,
              trees=forest.trees, leaf_tiles=forest.trees * forest.num_leaves,
              refine_rows=refine_rows, precision=precision, interpret=not on_card)
    col = min(min_pts - 1, n) - 1
    if not fetch_knn and not return_indices:
        if min_pts <= 1:
            return np.zeros(n, np.float64), None
        return fetch([bd[:, col] for bd, _ in lists]).astype(np.float64), None
    knn = fetch([bd for bd, _ in lists]).astype(np.float64)
    core = np.zeros(n, np.float64) if min_pts <= 1 else knn[:, col].copy()
    if return_indices:
        return core, knn, fetch([bi for _, bi in lists]).astype(np.int64)
    return core, knn


def rpforest_core_distances_rows(data, row_ids, min_pts: int, metric: str = "euclidean", *,
                                 trees: int = 4, leaf_size: int = 1024, rescan_rounds: int = 1,
                                 seed: int = 0, dtype=np.float32, trace=None,
                                 knn_backend: str = "auto", knn_precision: str = "f32",
                                 device=None, mesh=None):
    """Approximate core distances of the SELECTED rows (the contract of
    ``ops/tiled.knn_core_distances_rows``: (m,) float64): one forest pass
    over the whole set (B5-B7 on the card; over ``mesh`` when given), then
    a slice by rows — the forest indexes every point either way, and the
    rows' neighbour-of-neighbour rescans need the whole graph."""
    core, _ = rpforest_core_distances(
        data, min_pts, metric, trees=trees, leaf_size=leaf_size,
        rescan_rounds=rescan_rounds, seed=seed, dtype=dtype, fetch_knn=False, trace=trace,
        recall_sample=0, knn_backend=knn_backend, knn_precision=knn_precision, device=device,
        mesh=mesh,
    )
    return core[np.asarray(row_ids)]

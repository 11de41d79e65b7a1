"""The sharded exact fit — the port of ``parallel/shard.py``'s exact tier:
ring core distances, the sharded device Borůvka rounds and the host-round
sharded scanner.

The reference runs every sharded Borůvka round inside one ``shard_map``
``while_loop`` (``_shard_mst_fn``). The port runs the same rounds as a host
loop over a single-process mesh (``parallel/mesh.Mesh``), one scalar read
per round driving it, as the single-device ``boruvka_mst_device`` does. A
round:

1. scan (:meth:`_Shards.scan`) — every shard ``me`` keeps its row shard,
   core distances and labels resident and scans the panels in ring order
   ``(me - s) % D`` through the panel segment-min kernel
   (``ops/cuda_segmin.min_outgoing_panel``, B9); a panel-local winner
   becomes global and enters under the explicit (w, j) lexicographic
   update, so the arrival order cannot change the winner;
2. reduction (:meth:`_Shards.winners`) — each shard's scatter-min partials
   over the label space are min-reduced across shards on the first
   shard's device, key by key: weight, then lo and hi over the rows still
   tied (the key of ``utils/unionfind.contract_min_edges`` and of
   ``core/mst_device._contract_round``, whose row and target follow from
   (lo, hi): the edge leaves the component from its in-component end);
3. contraction — ``core/mst_device._collapse_labels`` (the same
   pointer-doubling collapse) and the slot emission into edge buffers in
   ascending-label order with +inf self-loop padding, so the edges equal the
   single-device engine's slot for slot; the new labels go back to every
   shard's device.

:class:`ShardBoruvkaScanner` (``mst_backend=host`` under
``fit_sharding=sharded``) runs step 1 alone per round and hands the (n,)
per-point winners to the host contraction; ``parallel/ring.
RingBoruvkaScanner`` runs steps 1 and 2 over the dense component labels.

The forest tier's sharded twin is :func:`shard_forest_core_distances`:
per-shard tree builds and a ring exchange of candidate panels through the
rescan top-k kernel (B7), with no full data copy on any shard or rank;
:func:`shard_core_distances_rows` is the MR boundary rescan's entry. The
reference pins its sharded state with JAX partition rules; the port's
tensors simply lie where :data:`PARTITION_RULES` says, the table the run
manifest records (:func:`partition_rule_table`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hdbscan_tpu_torch import obs
from hdbscan_tpu_torch.core.distances import euclidean_form
from hdbscan_tpu_torch.parallel.mesh import (
    all_reduce,
    comm_snapshot,
    device_count,
    fetch,
    fetch_many,
    get_mesh,
    ring_shift,
    spans_cards,
)
from hdbscan_tpu_torch.parallel.ring import _ring_geometry, _shard_rows

#: Valid ``fit_sharding`` values (``config.HDBSCANParams.fit_sharding``).
FIT_SHARDINGS = ("auto", "replicated", "sharded")

_INT32_MAX = torch.iinfo(torch.int32).max

#: Where the sharded fit's state lies, as (state, placement): the record
#: the run manifest carries (``utils/telemetry.run_manifest``).
PARTITION_RULES = (
    ("rows, cores, global ids", "one row shard on each shard's device, in its owner's process"),
    ("component labels", "whole, once on each distinct device of each rank"),
    ("visiting panel", "copied to the resident shard's device for one scan; between ranks "
                       "by the ring step's send/receive"),
    ("per-component winners", "reduced on each rank's first device, then all-reduced (MIN) "
                              "across ranks"),
    ("edge buffers u, v, w", "whole on each rank's first device; over one process split "
                             "by shard after"),
)


def partition_rule_table() -> list[dict]:
    """JSON-serializable :data:`PARTITION_RULES` for the run manifest (the
    reference's key names)."""
    return [{"path": state, "spec": placement} for state, placement in PARTITION_RULES]


def resolve_fit_sharding(fit_sharding: str, mesh) -> str:
    """Map the ``fit_sharding`` knob to the program: "replicated" and
    "sharded" are literal; "auto" picks the sharded program only on a mesh
    of two or more distinct CUDA devices (the reference's multi-device TPU
    rule), so one card and CPU meshes keep the single-device fit."""
    if fit_sharding not in FIT_SHARDINGS:
        raise ValueError(
            f"unknown fit_sharding {fit_sharding!r}: auto | replicated | sharded"
        )
    if fit_sharding != "auto":
        return fit_sharding
    return "sharded" if spans_cards(mesh) else "replicated"


def shard_core_distances(
    data: np.ndarray,
    min_pts: int,
    metric: str = "euclidean",
    *,
    row_tile: int = 1024,
    col_tile: int = 8192,
    dtype=np.float32,
    mesh=None,
    trace=None,
    knn_backend: str = "auto",
    index: str = "exact",
    index_opts: dict | None = None,
) -> np.ndarray:
    """Core distances under the sharded program, (n,) float64: the ring
    k-NN scan with only the k-th column fetched, or at
    ``index="rpforest"`` the row-sharded forest
    (:func:`shard_forest_core_distances`)."""
    from hdbscan_tpu_torch.parallel.ring import ring_knn_core_distances

    mesh = mesh if mesh is not None else get_mesh()
    if index == "rpforest":
        return shard_forest_core_distances(data, min_pts, metric, dtype=dtype, mesh=mesh,
                                           trace=trace, **(index_opts or {}))
    if index != "exact":
        raise ValueError(f"unknown knn index {index!r}")
    core, _ = ring_knn_core_distances(
        data, min_pts, metric, row_tile=row_tile, col_tile=col_tile, dtype=dtype,
        fetch_knn=False, mesh=mesh, trace=trace, knn_backend=knn_backend,
    )
    return core


def shard_core_distances_rows(
    data: np.ndarray,
    row_ids: np.ndarray,
    min_pts: int,
    metric: str = "euclidean",
    *,
    dtype=np.float32,
    mesh=None,
    trace=None,
    index: str = "exact",
    index_opts: dict | None = None,
) -> np.ndarray:
    """Core distances of the SELECTED rows under the sharded program (the
    MR boundary rescan's contract: (m,) float64 aligned with ``row_ids``):
    the ring rows scan (``parallel/ring.ring_knn_core_distances_rows``), or
    at ``index="rpforest"`` one sharded forest pass sliced by rows."""
    mesh = mesh if mesh is not None else get_mesh()
    row_ids = np.asarray(row_ids)
    if index == "rpforest":
        core = shard_forest_core_distances(data, min_pts, metric, dtype=dtype, mesh=mesh,
                                           trace=trace, recall_sample=0, **(index_opts or {}))
        return core[row_ids]
    if index != "exact":
        raise ValueError(f"unknown knn index {index!r}")
    from hdbscan_tpu_torch.parallel.ring import ring_knn_core_distances_rows

    return ring_knn_core_distances_rows(data, row_ids, min_pts, metric, dtype=dtype, mesh=mesh,
                                        trace=trace)


def _shard_geometry(n: int, n_dev: int) -> tuple[int, int]:
    """The sharded forest's rows per shard and padded total: ``shard =
    ceil(n / n_dev)``, no tile rounding, so the fewer than ``n_dev`` pad
    rows (zeros, as the reference pads) lie on the last shards."""
    shard = -(-n // n_dev)
    return shard, shard * n_dev


def _host_recall(data: np.ndarray, rows: np.ndarray, sample_i: np.ndarray, k: int):
    """Sampled recall@k of the lists ``sample_i`` of ``rows`` (evenly
    spaced, ``ops/rpforest.recall_rows``) against a host numpy brute-force
    scan (euclidean), the reference's oracle: exact ids by (distance, id).
    The k-th distance comes from a partition and only the rows at or under
    it are sorted: the reference's ids, without sorting all n."""
    n = len(data)
    hits = 0
    for r, got in zip(rows, sample_i):
        dist = np.linalg.norm(data - data[r], axis=1)
        near = np.flatnonzero(dist <= np.partition(dist, k - 1)[k - 1])
        exact = near[np.lexsort((near, dist[near]))][:k]
        hits += len(np.intersect1d(exact, got[got < n]))
    return float(hits) / float(len(rows) * k), int(len(rows))


def shard_forest_core_distances(
    data: np.ndarray,
    min_pts: int,
    metric: str = "euclidean",
    k: int | None = None,
    *,
    trees: int = 4,
    leaf_size: int = 1024,
    seed: int = 0,
    dtype=np.float32,
    mesh=None,
    trace=None,
    recall_sample: int = 256,
    knn_precision: str = "f32",
    **_ignored,
) -> np.ndarray:
    """Row-sharded rp-forest core distances, (n,) float64 (the
    ``fetch_knn=False`` contract; zeros at ``min_pts <= 1``) — the
    reference's per-shard tree builds and ring panel exchange.

    Geometry (the reference's, copied exactly): ``shard = ceil(n / D)``
    rows a shard, zero pad rows on the last shards; ``leaf_size`` clamped
    at the shard's scale; the normals, shared by every shard, from
    ``np.random.default_rng(SeedSequence([seed, shard, depth]))``, so
    another D builds other trees. Each shard builds T trees over its own
    padded rows (``ops/rpforest._build_one_tree``) on its device.

    Exchange: every shard seeds its rows' lists with itself at distance 0,
    then visits its own panel and the panels ``(me - s) % D``. A visit
    routes the resident rows down the visiting shard's trees
    (``ops/rpforest.route_queries``), takes the reached leaves' real
    members (T x max-leaf panel-local candidates a row, one B7 launch a
    chunk of rows within the rescan's element budget,
    ``ops/cuda_forest.forest_rescan_topk``, with the visiting panel as its
    data and the panel's row count as its sentinel), offsets the ids to
    global ones and folds the k best into the running lists under
    ``ops/lexmerge.dedup_lex_merge``. That merge keeps each id at its
    smallest offered distance, so the seed and a computed self-distance
    resolve as the reference's per-tree merges resolve them. There is no
    neighbour-of-neighbour rescan: this tier is its own approximation,
    held to the reference's own sharded run, and to recall.

    Over a multi-process mesh a rank uploads and builds only its own
    shards (every rank knows each shard's geometry without asking); each
    ring step hands the visiting panels over together through
    ``parallel/mesh.ring_shift`` (rows, leaf members and thresholds, whose
    leading lengths differ), and the k-th column and the recall ids come
    back through ``fetch``, so every rank returns the one-process cores.

    ``knn_precision="bf16"`` (euclidean) runs B7's bf16 tiles, centred on
    8-row query tiles where the reference centres each shard's block: held
    to recall and ARI only. ``**_ignored`` takes the replicated tier's
    other knobs (``rescan_rounds``, ``knn_backend``). Trace events:
    ``shard_knn_build``, ``shard_panel_sweep`` (with ``ring_device_wall``
    events) and ``shard_knn_exchange`` with a sampled host ``recall_at_k``
    (euclidean).
    """
    from hdbscan_tpu_torch.core.distances import METRICS
    from hdbscan_tpu_torch.ops.cuda_forest import (
        RESCAN_ROW_TILE,
        euclid_form,
        forest_rescan_topk,
    )
    from hdbscan_tpu_torch.ops.lexmerge import dedup_lex_merge
    from hdbscan_tpu_torch.ops.rpforest import (
        _RESCAN_ELEM_BUDGET,
        _build_one_tree,
        _geometry,
        _heap_base,
        _leaf_layout,
        _normals,
        forest_depth,
        recall_rows,
        route_queries,
    )
    from hdbscan_tpu_torch.parallel.ring import _emit_ring_trace, _handover, _per_device_walls

    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")
    if knn_precision not in ("f32", "bf16"):
        raise ValueError(f"unknown knn_precision {knn_precision!r}: f32 | bf16")
    if knn_precision == "bf16" and metric != "euclidean":
        raise ValueError(f"knn_precision='bf16' supports euclidean only (got metric={metric!r})")
    data = np.asarray(data)
    n, d = data.shape
    mesh = mesh if mesh is not None else get_mesh()
    n_dev = device_count(mesh)
    devs, local = mesh.devices, mesh.local_shards()
    k_eff = min(max(k or 0, max(min_pts - 1, 1)), n)
    shard, n_pad = _shard_geometry(n, n_dev)
    leaf_size = min(max(leaf_size, 2 * k_eff + 2, 8), max(shard, 2))
    depth = forest_depth(shard, leaf_size)
    pos_idx, leaf_mask = _leaf_layout(shard, depth)
    n_leaves, lmax = pos_idx.shape
    num_nodes = _heap_base(depth)
    normals = _normals(seed, shard, depth, trees, d).astype(dtype)
    x = np.zeros((n_pad, d), dtype)
    x[:n] = data

    # Every rank knows each shard's geometry; it uploads and builds only its
    # own shards.
    t_up = time.monotonic()
    rows = {s: torch.as_tensor(x[s * shard : (s + 1) * shard], device=devs[s]) for s in local}
    normals_on = {dev: torch.as_tensor(normals, device=dev) for dev in mesh.distinct()}
    upload_s = time.monotonic() - t_up

    # Per shard: T trees over its own rows, with their leaves' members
    # (panel-local ids) and heap thresholds.
    t0 = time.monotonic()
    geom_on = {dev: _geometry(shard, depth, dev) for dev in mesh.distinct()}
    pos_on = {dev: torch.as_tensor(pos_idx, device=dev) for dev in mesh.distinct()}
    members, thresholds = {}, {}
    for s in local:
        dev = devs[s]
        mem = torch.empty((trees, n_leaves, lmax), dtype=torch.int32, device=dev)
        thr = torch.zeros((trees, max(num_nodes, 1)), dtype=rows[s].dtype, device=dev)
        for t in range(trees):
            perm, th = _build_one_tree(rows[s], normals_on[dev][t], geom_on[dev])
            mem[t] = perm[pos_on[dev]].to(torch.int32)
            thr[t, :num_nodes] = th
        members[s] = mem
        thresholds[s] = thr
    if trace is not None:
        trace("shard_knn_build", wall_s=round(time.monotonic() - t0, 6), fused=False,
              devices=n_dev, trees=trees, depth=depth, leaf_size=leaf_size, max_leaf=lmax,
              n=n, d=d)

    from hdbscan_tpu_torch.utils.flops import counter as _flops

    # Each query visits T leaves in each of D shards: T * D * Lmax candidates.
    _flops.add_scan(n_pad * trees * n_dev, lmax, d)
    # One B7 launch a visit when the candidate panel keeps the distance form
    # of one tree's leaf (the reference computes a leaf at a time), else
    # one a tree.
    same_form = (metric != "euclidean"
                 or euclid_form(1, trees * lmax, d) == euclid_form(1, lmax, d))
    groups = [list(range(trees))] if same_form else [[t] for t in range(trees)]
    snap = comm_snapshot()
    with obs.mem_phase("shard_knn_scan"), obs.task("shard_knn_scan", total=len(local)) as hb:
        t0 = time.monotonic()
        real = [max(0, min(shard, n - s * shard)) for s in range(n_dev)]
        lists = {}
        for me in local:
            m, dev = real[me], devs[me]
            if m == 0:
                continue
            bd = torch.full((m, k_eff), float("inf"), dtype=rows[me].dtype, device=dev)
            bi = torch.full((m, k_eff), n, dtype=torch.int32, device=dev)
            bd[:, 0] = 0.0  # self at distance 0
            bi[:, 0] = torch.arange(me * shard, me * shard + m, dtype=torch.int32, device=dev)
            lists[me] = (bd, bi)
        mask_on = {dev: torch.as_tensor(leaf_mask, device=dev) for dev in mesh.distinct()}
        # A visit's query rows go in equal chunks, of whole bf16 row tiles,
        # whose candidate panel keeps within the rescan's element budget: rows
        # x T x max-leaf ids on the card (B7 gathers no rows), times d where the
        # plain version gathers the candidates' coordinates. Every step is per
        # row, so the chunking does not change the lists.
        per_row = trees * lmax * (d if devs[0].type == "cpu" else 1)
        cap = max(RESCAN_ROW_TILE, _RESCAN_ELEM_BUDGET // per_row)
        n_chunks = -(-max(real) // cap)
        chunk = -(-max(real) // max(n_chunks, 1) // RESCAN_ROW_TILE) * RESCAN_ROW_TILE
        # Step-outer: one ring step hands every visiting panel over at once
        # (its rows, its trees' leaf members and heap thresholds; a padding
        # shard's too), so every rank takes every step, in the same order.
        panels = {s: (rows[s], members[s], thresholds[s]) for s in local}
        lengths = [(shard, trees, trees)] * n_dev
        for step in range(n_dev):
            visiting = ring_shift(mesh, panels, step, lengths)
            for me in lists:
                dev = devs[me]
                src = (me - step) % n_dev
                off = src * shard
                panel, mem_src, thr_src = visiting[me]
                parts_d, parts_i = [], []
                for a in range(0, real[me], chunk):
                    q = rows[me][a : min(a + chunk, real[me])]
                    node = route_queries(q, normals_on[dev], thr_src, depth)
                    bd, bi = lists[me][0][a : a + chunk], lists[me][1][a : a + chunk]
                    for grp in groups:
                        cand = torch.cat([mem_src[t][node[t]] for t in grp], 1)
                        ok = torch.cat([mask_on[dev][node[t]] for t in grp], 1) & (cand + off < n)
                        cids = torch.where(ok, cand, shard).to(torch.int32)
                        td, ti = forest_rescan_topk(q, panel, cids, k_eff, metric,
                                                    precision=knn_precision, sentinel=shard)
                        ti = torch.where(ti == shard, n, ti + off).to(torch.int32)
                        bd, bi = dedup_lex_merge(torch.cat([bd, td], 1), torch.cat([bi, ti], 1),
                                                 k_eff, n)
                    parts_d.append(bd)
                    parts_i.append(bi)
                lists[me] = (torch.cat(parts_d), torch.cat(parts_i))
        walls = _per_device_walls(mesh, t0, beat=hb.beat)
        wall = time.monotonic() - t0
    # One visiting panel a step: the shard's points plus its trees' leaf
    # members and heap thresholds.
    itemsize = np.dtype(dtype).itemsize
    panel_bytes = (shard * d * itemsize + trees * n_leaves * lmax * 4
                   + trees * num_nodes * itemsize)
    _emit_ring_trace(
        trace, "shard_panel_sweep", wall, walls, n_dev, 0, rows=n, trees=trees, shard=shard,
        upload_s=upload_s, flops=2.0 * n_pad * trees * n_dev * lmax * d,
        **_handover(mesh, snap, (n_dev - 1) * panel_bytes),
    )
    kth_col = min(max(min_pts - 1, 1), n) - 1
    t0 = time.monotonic()
    kth = fetch({s: bd[:, kth_col] for s, (bd, _) in lists.items()}, mesh).astype(np.float64)
    if trace is not None:
        fields = dict(n=n, k=k_eff, trees=trees, devices=n_dev,
                      candidates=trees * n_dev * lmax)
        # Every rank of a fit passes a trace or none, so every rank joins
        # this fetch of the sampled rows' ids or none does.
        if recall_sample and metric == "euclidean":
            at = recall_rows(n, recall_sample)
            ids = fetch({s: bi[torch.as_tensor(at[(at >= s * shard) & (at < s * shard + real[s])]
                                               - s * shard, device=bi.device)]
                         for s, (_, bi) in lists.items()}, mesh).astype(np.int64)
            recall, rows_used = _host_recall(data, at, ids, k_eff)
            fields["recall_at_k"] = recall
            fields["recall_rows"] = rows_used
        trace("shard_knn_exchange", wall_s=round(time.monotonic() - t0, 6), **fields)
    if min_pts <= 1:
        return np.zeros(n, np.float64)
    return kth


class _Shards:
    """The row shards of one Borůvka run over ``mesh``: each local shard's
    points, core distances and global row ids on its device, and the
    per-round panel scan and per-component reduction that every sharded
    Borůvka engine shares (:class:`ShardBoruvkaScanner`, ``parallel/ring.
    RingBoruvkaScanner`` and :func:`shard_boruvka_mst`). Over a
    multi-process mesh a rank holds only its own shards; the panels of
    other ranks' shards arrive through ``parallel/mesh.ring_shift`` and the
    per-component keys reduce through ``parallel/mesh.all_reduce``."""

    def __init__(self, data, core, metric, row_tile, col_tile, dtype, mesh):
        self.n, self.d = np.shape(data)
        self.metric = metric
        self.mesh = mesh if mesh is not None else get_mesh()
        self.n_dev = device_count(self.mesh)
        self.devs = self.mesh.devices
        self.root = self.mesh.root
        self.distinct = self.mesh.distinct()
        self.row_tile, self.col_tile, self.shard, self.n_pad = _ring_geometry(
            self.n, self.n_dev, row_tile, col_tile
        )
        self.form = (euclidean_form(self.row_tile, self.col_tile, self.d)
                     if metric == "euclidean" else None)
        self.parts = _shard_rows(self.n, self.shard, self.n_dev)
        self.local = self.mesh.local_shards()
        self.live = [s for s in self.local if self.parts[s][1] > 0]
        x = np.asarray(data, dtype)
        c = np.asarray(core, dtype)
        self.rows, self.cores, self.gid = {}, {}, {}
        for s in self.local:
            (o, m), dev = self.parts[s], self.devs[s]
            self.rows[s] = torch.as_tensor(x[o : o + m], device=dev)
            self.cores[s] = torch.as_tensor(c[o : o + m], device=dev)
            self.gid[s] = torch.arange(o, o + m, dtype=torch.int32, device=dev)
        self.dtype = self.rows[self.local[0]].dtype

    def put_labels(self, labels) -> dict:
        """An (n,) int32 label vector (host array or tensor) on every
        distinct device of this rank."""
        t = torch.as_tensor(labels)
        return {dev: t.to(dev) for dev in self.distinct}

    def scan(self, labels_on: dict) -> dict:
        """One round's panel scan: every local shard ``me`` against the
        panels in ring order ``(me - s) % D`` through the panel segment-min
        kernel (B9), each panel-local winner made global and entered under
        the explicit (w, j) lexicographic update, so the arrival order
        cannot change it. A step hands the panels over together
        (``parallel/mesh.ring_shift``); the labels are whole on every
        device, so only points and cores travel. Returns {local shard:
        ((m,) best_w, (m,) int32 best_j)} with global column ids, (+inf,
        -1) where no outgoing edge exists."""
        from hdbscan_tpu_torch.ops.cuda_segmin import min_outgoing_panel

        out = {}
        for me in self.local:
            dev, m = self.devs[me], self.parts[me][1]
            out[me] = (torch.full((m,), float("inf"), dtype=self.dtype, device=dev),
                       torch.full((m,), -1, dtype=torch.int32, device=dev))
        panels = {s: (self.rows[s], self.cores[s]) for s in self.local}
        for step in range(self.n_dev):
            visiting = ring_shift(self.mesh, panels, step, [m for _, m in self.parts])
            for me in self.live:
                dev, (off_me, m) = self.devs[me], self.parts[me]
                src = (me - step) % self.n_dev
                off, cnt = self.parts[src]
                if cnt == 0:
                    continue
                labels = labels_on[dev]
                p_rows, p_cores = visiting[me]
                pw, pj = min_outgoing_panel(
                    self.rows[me], self.cores[me], labels[off_me : off_me + m],
                    torch.ones(m, dtype=torch.bool, device=dev),
                    p_rows, p_cores, labels[off : off + cnt],
                    torch.ones(cnt, dtype=torch.bool, device=dev), self.metric,
                    self.row_tile, self.col_tile, form=self.form, col_offset=off,
                )
                bw, bj = out[me]
                tj = torch.where(pj >= 0, pj + off, 0)
                upd = (pw < bw) | ((pw == bw) & (tj < bj))
                out[me] = (torch.where(upd, pw, bw), torch.where(upd, tj, bj))
        return out

    def winners(self, cands: dict, labels_on: dict, n_seg: int):
        """Per-component winners of one round's candidates: the minimum by
        the shared key (w, lo = min(i, j), hi = max(i, j)) of
        ``utils/unionfind.contract_min_edges``, each shard's scatter-min
        partials over the ``n_seg`` labels min-reduced across this rank's
        shards on its first device, then across ranks
        (``parallel/mesh.all_reduce``), key by key with the tie filters
        between them, so the winner is the one-process winner bitwise.
        Returns (w, lo, hi) (n_seg,) on that device, (+inf, INT32_MAX,
        INT32_MAX) for a label without a candidate, and the number of
        candidates over every rank (a 0-d tensor)."""
        from hdbscan_tpu_torch.core.mst_device import _seg_min_into

        st = []
        for me, (bw, bj) in cands.items():
            dev, (off, m) = self.devs[me], self.parts[me]
            has = bj >= 0
            lab = torch.where(has, labels_on[dev][off : off + m], n_seg)
            bj_c = torch.where(has, bj, 0)
            st.append(dict(dev=dev, has=has, lab=lab, w=bw,
                           kr_c=torch.clamp(lab, 0, n_seg - 1),
                           lo=torch.minimum(self.gid[me], bj_c),
                           hi=torch.maximum(self.gid[me], bj_c)))

        def seg_min(key, fill, dtype):
            parts = [_seg_min_into(n_seg, s["lab"], s[key], fill) for s in st]
            return _reduce(parts or [torch.full((n_seg,), fill, dtype=dtype, device=self.root)],
                           self.root, self.distinct, self.mesh)

        w = seg_min("w", float("inf"), self.dtype)
        for s in st:
            s["lab"] = torch.where(s["w"] == w[s["dev"]][s["kr_c"]], s["lab"], n_seg)
        lo = seg_min("lo", _INT32_MAX, torch.int32)
        for s in st:
            s["lab"] = torch.where(s["lo"] == lo[s["dev"]][s["kr_c"]], s["lab"], n_seg)
        hi = seg_min("hi", _INT32_MAX, torch.int32)
        n_cand = sum((s["has"].sum().to(self.root) for s in st),
                     torch.zeros((), dtype=torch.int64, device=self.root))
        n_cand = all_reduce(n_cand, self.mesh, op="sum")
        return w[self.root], lo[self.root], hi[self.root], n_cand

    def close(self) -> None:
        """Drop the shards' device tensors now."""
        self.rows = self.cores = self.gid = {}


class ShardBoruvkaScanner:
    """Fully row-sharded drop-in for ``ops/tiled.BoruvkaScanner`` (the
    reference's ``ShardBoruvkaScanner``): the same ``min_outgoing(comp) ->
    (best_w, best_j)`` contract and the same per-point arrays, but points,
    cores and labels live per shard on the mesh (``mesh=None``: every
    visible card) and each round is :meth:`_Shards.scan`, B9 per shard and
    visiting panel. The (n,) winners come back to the host contraction
    every round. ``trace`` gets one ``shard_boruvka_scan`` event per round
    (with per-shard ``ring_device_wall`` events)."""

    def __init__(self, data: np.ndarray, core: np.ndarray, metric: str = "euclidean",
                 row_tile: int = 1024, col_tile: int = 8192, dtype=np.float32,
                 mesh=None, trace=None):
        self._sh = _Shards(data, core, metric, row_tile, col_tile, dtype, mesh)
        self.n, self.d, self.n_dev = self._sh.n, self._sh.d, self._sh.n_dev
        self.trace = trace
        self._itemsize = np.dtype(dtype).itemsize
        self._round = 0
        self.walls = (0.0, 0.0)  # the last round's (scan s, fetch s)

    def close(self) -> None:
        """Release the scanner's device row shards now."""
        self._sh.close()

    def min_outgoing(self, comp: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Per-point (best_w float64, best_j int64): the minimum outgoing
        mutual-reachability edge of every point's component seen from that
        point, (w, j)-lex, (+inf, -1) where none."""
        from hdbscan_tpu_torch.parallel.ring import (
            _emit_ring_trace,
            _handover,
            _per_device_walls,
        )
        from hdbscan_tpu_torch.utils.flops import counter as _flops

        sh = self._sh
        _flops.add_scan(sh.n_pad, sh.n_pad, self.d, row_tile=sh.row_tile)
        comp = np.asarray(comp)
        snap = comm_snapshot()
        with obs.mem_phase("shard_boruvka_scan"), obs.task(
            "shard_boruvka_scan", total=len(sh.local)
        ) as hb:
            # The reference donates the label panel here and keeps the
            # sampler out of the window (obs.donation_guard).
            with obs.donation_guard():
                t_up = time.monotonic()
                labels_on = sh.put_labels(comp.astype(np.int32))
                t0 = time.monotonic()
                upload_s = t0 - t_up
                cands = sh.scan(labels_on)
                walls = _per_device_walls(sh.mesh, t0, beat=hb.beat)
            wall = time.monotonic() - t0
        t_f = time.monotonic()
        bw, bj = fetch_many(cands, sh.mesh)
        bw, bj = bw.astype(np.float64), bj.astype(np.int64)
        fetch_s = time.monotonic() - t_f
        self.walls = (wall, fetch_s)
        # Two panels per hand-over: the row shard with its cores, and the
        # int32 component labels.
        comm_bytes = (self.n_dev - 1) * sh.shard * ((self.d + 1) * self._itemsize + 4)
        _emit_ring_trace(
            self.trace, "shard_boruvka_scan", wall, walls, self.n_dev, self._round,
            n_comp=int(len(np.unique(comp))), candidates=int(np.sum(bj >= 0)),
            upload_s=upload_s, fetch_s=fetch_s, flops=2.0 * sh.n_pad * sh.n_pad * self.d,
            **_handover(sh.mesh, snap, comm_bytes),
        )
        self._round += 1
        return bw, bj


def _reduce(parts, root, devices, mesh=None):
    """Elementwise minimum of per-shard partials on this rank's first
    device, then across ranks (``parallel/mesh.all_reduce``), handed back
    to every distinct device of this rank."""
    out = None
    for p in parts:
        p = p.to(root)
        out = p if out is None else torch.minimum(out, p)
    out = all_reduce(out, mesh, op="min")
    return {dev: out.to(dev) for dev in devices}


def shard_boruvka_mst(
    data: np.ndarray,
    core: np.ndarray,
    metric: str = "euclidean",
    row_tile: int = 1024,
    col_tile: int = 8192,
    dtype=np.float32,
    mesh=None,
    max_rounds: int = 64,
    trace=None,
):
    """Every sharded Borůvka round over ``mesh`` (module docstring).

    Returns a dict shaped like ``core/mst_device.boruvka_mst_device``'s:
    "u", "v", "w" are lists of per-shard tensors, shard ``s`` holding
    positions ``[s * shard, (s + 1) * shard)`` of the (n - 1,) edge buffers
    on its device (concatenated in shard order they are the single-device
    buffers, +inf self-loops past the count). Over a multi-process mesh
    every rank contracts the all-reduced winners alike, so its loop's
    decisions agree with its peers' and it holds the whole buffers: each
    list is then the one (n - 1,) buffer on this rank's first device. Host
    values "count", "rounds", "round_syncs", "stat_comp", "stat_edges",
    "shard". ``trace`` gets one ``mst_round`` event per round, marked
    ``sharded``.
    """
    from hdbscan_tpu_torch.core.mst_device import _collapse_labels

    # The reference donates the uploaded rows to its program and keeps the
    # sampler out of the upload window (obs.donation_guard).
    with obs.donation_guard():
        sh = _Shards(data, core, metric, row_tile, col_tile, dtype, mesh)
    n, root = sh.n, sh.root
    buf = max(n - 1, 1)
    eu = torch.zeros(buf + 1, dtype=torch.int32, device=root)
    ev = torch.zeros(buf + 1, dtype=torch.int32, device=root)
    ew = torch.full((buf + 1,), float("inf"), dtype=sh.dtype, device=root)
    comp = torch.arange(n, dtype=torch.int32, device=root)
    label_ids = torch.arange(n, dtype=torch.int32, device=root)
    valid_all = torch.ones(n, dtype=torch.bool, device=root)
    stat_comp = np.zeros(max_rounds, np.int32)
    stat_edges = np.zeros(max_rounds, np.int32)
    count = rounds = syncs = 0
    n_comp = n
    progress = True
    while rounds < max_rounds and n_comp > 1 and progress:
        labels_on = sh.put_labels(comp)
        # 1. scan: each shard against the panels in ring order; 2. the
        # per-component (w, lo, hi) reduction across shards.
        w, lo, hi, _ = sh.winners(sh.scan(labels_on), labels_on, n)
        # 3. contraction and emission on the first shard's device: a
        # label's winning edge leaves from its in-component endpoint.
        has_edge = lo < _INT32_MAX
        lo_c, hi_c = torch.clamp(lo, 0, n - 1), torch.clamp(hi, 0, n - 1)
        win_row = torch.where(comp[lo_c.long()] == label_ids, lo_c, hi_c)
        win_j = lo_c + hi_c - win_row
        emit_mask, rep, n_comp_t, added_t = _collapse_labels(
            comp, valid_all, has_edge, comp[win_j.long()], n
        )
        pos = count + torch.cumsum(emit_mask.to(torch.int32), 0) - 1
        slot = torch.where(emit_mask, pos, buf).to(torch.int64)
        eu[slot] = win_row
        ev[slot] = win_j
        ew[slot] = w
        comp = rep[comp.long()]
        # The round's one device->host read: it drives the loop.
        n_comp, added = torch.stack([n_comp_t, added_t]).tolist()
        syncs += 1
        stat_comp[rounds] = n_comp
        stat_edges[rounds] = added
        count += added
        progress = added > 0
        if trace is not None:
            trace("mst_round", round=rounds, components=n_comp, edges_added=added,
                  sharded=True)
        rounds += 1

    def split(t):
        if sh.mesh.multiprocess:  # every rank holds the whole buffers already
            return [t[:buf]]
        return [t[min(o, buf) : min(o + sh.shard, buf)].to(dev)
                for (o, _), dev in zip(sh.parts, sh.devs)]

    return {
        "u": split(eu), "v": split(ev), "w": split(ew),
        "count": count, "rounds": rounds, "round_syncs": syncs,
        "stat_comp": stat_comp, "stat_edges": stat_edges, "shard": sh.shard,
    }

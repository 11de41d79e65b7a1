"""Exact HDBSCAN* at scale on the card — the port of ``models/exact.py``.

The device route (``fit`` -> ``_fit_device``), phase by phase:

1. core distances (``ops/tiled.knn_core_distances``), fetched as float64
   like the reference's: the exact tier is one k-best kernel launch
   (``ops/cuda_knn``); the rp-forest tier (``knn_index=rpforest``, or
   ``auto`` from ``knn_index_threshold`` points on) builds the forest and
   runs the forest kernels (``ops/rpforest`` -> ``ops/cuda_forest``);
2. Borůvka rounds on the device (``core/mst_device.boruvka_mst_device``):
   one segment-min kernel launch plus the scatter-min contraction per
   round, one (components, edges) scalar read per round to drive the loop;
3. the union-find event scan (``forest_events_device``: three stable sorts
   and the ``uf_scan`` kernel);
4. one bulk device->host fetch of the event stream and the MST, then the
   vectorized merge-forest reconstruction and the shared finalize tail
   (condensed tree, EOM, labels, GLOSH) on the host.

``fit_sharding=sharded`` runs the same contract over a mesh of shards
(``parallel/mesh.Mesh``): ring core distances (``parallel/shard.
shard_core_distances``), the sharded Borůvka rounds (``parallel/shard.
shard_boruvka_mst``, the panel segment-min kernel per shard and visiting
panel), then the shard edge buffers gathered onto the first shard's device
in global order for one union-find event scan, and one bulk fetch.

The host-round route (``mst_backend=host``, or ``scan_backend=ring``
without sharding) is :func:`mst_edges`: the same core distances, then
Borůvka rounds contracted on the host (:func:`mst_edges_from_core`) over
one of three scanners with the same per-round edges — ``ops/tiled.
BoruvkaScanner`` (one segment-min launch a round), ``parallel/ring.
RingBoruvkaScanner`` or ``parallel/shard.ShardBoruvkaScanner`` (B9 per
shard and panel) — and the shared finalize. ``dedup_points`` collapses
duplicate rows first (:func:`_fit_dedup`, ``core/dedup.py``).
:func:`mst_edges_random_blocks` is the paper's Random Blocks method over
the dense block program (``parallel/blocks``) and :func:`pool_mst`.

``dtype``: float32, or float64 on the CPU, where every stage runs its
plain version in that type as the reference's XLA scans do. The kernels
are float32 only, like the reference's Pallas kernels
(``hdbscan_tpu/ops/pallas_segmin.py`` ``_pallas_eligible``): float64 with
the card raises ``ValueError`` at the entry, before any work.

At ``knn_index=rpforest`` the sharded fit's cores come from the
row-sharded forest (``parallel/shard.shard_forest_core_distances``: its own
approximation, per-shard trees and a ring exchange through B7), and the
ring route's from the forest over the mesh (``ops/rpforest``, equal to the
one-device forest).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hdbscan_tpu_torch import obs
from hdbscan_tpu_torch.config import HDBSCANParams
from hdbscan_tpu_torch.models.hdbscan import HDBSCANResult
from hdbscan_tpu_torch.ops import cuda_build


def _engine(fit_sharding: str, scan_backend: str, mesh, device):
    """The scan engine of a run — "sharded", "ring" or "host" — resolved
    once from the two knobs and the caller's mesh, with the mesh it runs on
    (none given: every visible card, or one shard on ``device`` when that
    is not a card) and the host scanner's device (None: the mesh's first
    shard's). Callees get the engine back as literal knobs
    (:data:`_KNOBS`), so a default mesh of several cards cannot turn a ring
    run into a sharded one."""
    from hdbscan_tpu_torch.ops.tiled import scan_mesh
    from hdbscan_tpu_torch.parallel.ring import resolve_scan_backend
    from hdbscan_tpu_torch.parallel.shard import resolve_fit_sharding

    if device is None and mesh is not None:
        device = mesh.root
    if resolve_fit_sharding(fit_sharding, mesh) == "sharded":
        engine = "sharded"
    elif resolve_scan_backend(scan_backend, mesh) == "ring":
        engine = "ring"
    else:
        engine = "host"
    if engine != "host" and mesh is None:
        device = cuda_build.resolve_device(device)
        mesh = scan_mesh(None, device)
    return engine, mesh, device


#: Each engine as the (fit_sharding, scan_backend) knobs that select it.
_KNOBS = {
    "sharded": dict(fit_sharding="sharded", scan_backend="host"),
    "ring": dict(fit_sharding="replicated", scan_backend="ring"),
    "host": dict(fit_sharding="replicated", scan_backend="host"),
}


def mst_edges(
    data: np.ndarray,
    min_pts: int,
    metric: str = "euclidean",
    row_tile: int = 1024,
    col_tile: int = 8192,
    dtype=np.float32,
    max_rounds: int = 64,
    mesh=None,
    trace=None,
    knn_backend: str = "auto",
    scan_backend: str = "auto",
    index: str = "exact",
    index_opts: dict | None = None,
    fit_sharding: str = "auto",
    *,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Blocked Borůvka: (u, v, w) exact mutual-reachability MST + core
    distances, with the rounds contracted on the host.

    ``knn_backend`` selects the core-distance scan (``ops/tiled.
    knn_core_distances``); ``scan_backend`` the engine for both the core
    scan and the rounds — "host" (the k-best kernel and
    ``ops/tiled.BoruvkaScanner`` on ``device``) or "ring" (the ring k-NN
    scan and ``parallel/ring.RingBoruvkaScanner`` over ``mesh``), "auto"
    picking ring on a mesh of two or more cards; ``fit_sharding="sharded"``
    takes ``parallel/shard.shard_core_distances`` and
    ``ShardBoruvkaScanner``. The edges are the same across scanners.
    ``index``/``index_opts`` (``core/knn.resolve_index_for``) swap the core
    scan for the rp-forest tier; the rounds stay exact. ``device`` None:
    the first shard's device of ``mesh``, else the card.
    """
    from hdbscan_tpu_torch.ops.tiled import knn_core_distances
    from hdbscan_tpu_torch.utils.flops import counter as _flops
    from hdbscan_tpu_torch.utils.flops import phase_stats

    n = len(data)
    engine, mesh, device = _engine(fit_sharding, scan_backend, mesh, device)
    t0 = time.monotonic()
    fsnap = _flops.snapshot()
    with obs.mem_phase("core_distances"):
        if engine == "sharded":
            from hdbscan_tpu_torch.parallel.shard import shard_core_distances

            core = shard_core_distances(
                data, min_pts, metric, row_tile=row_tile, col_tile=col_tile, dtype=dtype,
                mesh=mesh, trace=trace, knn_backend=knn_backend, index=index,
                index_opts=index_opts,
            )
        elif engine == "ring":
            from hdbscan_tpu_torch.parallel.ring import ring_knn_core_distances

            core, _ = ring_knn_core_distances(
                data, min_pts, metric, row_tile=row_tile, col_tile=col_tile, dtype=dtype,
                fetch_knn=False, mesh=mesh, trace=trace, knn_backend=knn_backend,
                index=index, index_opts=index_opts,
            )
        else:
            core, _ = knn_core_distances(
                data, min_pts, metric, row_tile=row_tile, col_tile=col_tile, dtype=dtype,
                fetch_knn=False, backend=knn_backend, index=index, index_opts=index_opts,
                trace=trace, device=device,
            )
    if trace is not None:
        wall = time.monotonic() - t0
        trace("core_distances", n=n, wall_s=round(wall, 6), **phase_stats(fsnap, wall))
    u, v, w = mst_edges_from_core(
        data, core, metric, row_tile=row_tile, col_tile=col_tile, dtype=dtype,
        max_rounds=max_rounds, mesh=mesh, trace=trace, device=device, **_KNOBS[engine],
    )
    return u, v, w, core


def mst_edges_from_core(
    data: np.ndarray,
    core: np.ndarray,
    metric: str = "euclidean",
    row_tile: int = 1024,
    col_tile: int = 8192,
    dtype=np.float32,
    max_rounds: int = 64,
    mesh=None,
    trace=None,
    scan_backend: str = "auto",
    fit_sharding: str = "auto",
    *,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The Borůvka round loop of :func:`mst_edges` for pre-computed core
    distances (the dedup route supplies multiset-weighted cores).

    Per round the scanner gives every point (or, for the ring, every
    component) its lightest outgoing candidate and the host contraction
    (``utils/unionfind.contract_min_edges``, by (w, lo, hi)) merges the
    components. ``trace`` gets one ``boruvka_round`` event per round (with
    the scan, fetch and contraction walls) and one ``boruvka_mst``.
    """
    from hdbscan_tpu_torch.ops.tiled import BoruvkaScanner
    from hdbscan_tpu_torch.parallel.ring import RingBoruvkaScanner
    from hdbscan_tpu_torch.parallel.shard import ShardBoruvkaScanner
    from hdbscan_tpu_torch.utils.flops import counter as _flops
    from hdbscan_tpu_torch.utils.flops import phase_stats
    from hdbscan_tpu_torch.utils.unionfind import contract_min_edges

    n = len(data)
    engine, mesh, device = _engine(fit_sharding, scan_backend, mesh, device)
    t0 = time.monotonic()
    fsnap = _flops.snapshot()
    if engine == "host":
        scanner = BoruvkaScanner(data, core, metric, row_tile, col_tile, dtype=dtype,
                                 device=cuda_build.resolve_device(device))
    else:
        cls = ShardBoruvkaScanner if engine == "sharded" else RingBoruvkaScanner
        scanner = cls(data, core, metric, row_tile=row_tile, col_tile=col_tile, dtype=dtype,
                      mesh=mesh, trace=trace)
    comp = np.arange(n, dtype=np.int64)
    eu, ev, ew = [], [], []
    n_comp = n
    rounds = 0
    try:
        # Heartbeat progress: the emitted-edge fraction (n - 1 edges
        # complete the tree), monotone since n_comp only shrinks.
        with obs.mem_phase("boruvka_mst"), obs.task("boruvka", total=max(n - 1, 1)) as hb:
            for rnd in range(max_rounds):
                if n_comp <= 1:
                    break
                bw, bj = scanner.min_outgoing(comp)
                t1 = time.monotonic()
                emit, comp, n_comp = contract_min_edges(comp, bj, bw)
                if len(emit) == 0:
                    break  # disconnected pool (cannot happen for a full metric space)
                eu.append(emit)
                ev.append(bj[emit])
                ew.append(bw[emit])
                rounds = rnd + 1
                hb.beat(n - n_comp)
                if trace is not None:
                    scan_s, fetch_s = scanner.walls
                    trace("boruvka_round", round=rnd, components=n_comp, edges_added=len(emit),
                          scan_s=round(scan_s, 6), fetch_s=round(fetch_s, 6),
                          contract_s=round(time.monotonic() - t1, 6))
    finally:
        close = getattr(scanner, "close", None)
        if close is not None:
            close()
    if trace is not None:
        wall = time.monotonic() - t0
        trace("boruvka_mst", rounds=rounds, edges=int(sum(len(e) for e in eu)),
              wall_s=round(wall, 6), **phase_stats(fsnap, wall))
    return (
        np.concatenate(eu) if eu else np.zeros(0, np.int64),
        np.concatenate(ev) if ev else np.zeros(0, np.int64),
        np.concatenate(ew) if ew else np.zeros(0, np.float64),
    )


def pool_mst(
    u: np.ndarray, v: np.ndarray, w: np.ndarray, n: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized host Borůvka over an explicit edge pool (the reference's
    ``pool_mst``): each round computes every component's minimum incident
    pool edge with numpy segment operations and unions them all at once —
    O(E) work per round, <= ceil(log2 n) rounds. Returns the MST (u, v, w)
    of the pooled multigraph."""
    from hdbscan_tpu_torch.utils.unionfind import contract_min_edges

    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    w = np.asarray(w, np.float64)
    comp = np.arange(n, dtype=np.int64)
    su, sv, sw = [], [], []
    # Pre-sort edges once by (w, u, v) for deterministic per-component mins.
    order = np.lexsort((v, u, w))
    u, v, w = u[order], v[order], w[order]
    for _ in range(64):
        cu, cv = comp[u], comp[v]
        out = np.nonzero(cu != cv)[0]
        if len(out) == 0:
            break
        # First pool edge (in sorted order) per component, from either side;
        # the winner becomes that component's candidate, attached to its
        # representative vertex (comp labels ARE root vertex ids here).
        cc = np.concatenate([cu[out], cv[out]])
        ee = np.tile(out, 2)
        ord2 = np.lexsort((ee, cc))
        cc_, ee_ = cc[ord2], ee[ord2]
        first = np.concatenate([[True], np.diff(cc_) != 0])
        reps, picks = cc_[first], ee_[first]
        cand_j = np.full(n, -1, np.int64)
        cand_w = np.zeros(n, np.float64)
        edge_map = np.full(n, -1, np.int64)
        # Point each rep at the OTHER side's rep vertex.
        other = np.where(cu[picks] == reps, cv[picks], cu[picks])
        cand_j[reps] = other
        cand_w[reps] = w[picks]
        edge_map[reps] = picks
        emit, comp, _ = contract_min_edges(comp, cand_j, cand_w)
        if len(emit) == 0:
            break
        e = edge_map[emit]
        su.append(u[e])
        sv.append(v[e])
        sw.append(w[e])
    return (
        np.concatenate(su) if su else np.zeros(0, np.int64),
        np.concatenate(sv) if sv else np.zeros(0, np.int64),
        np.concatenate(sw) if sw else np.zeros(0, np.float64),
    )


def mst_edges_random_blocks(
    data: np.ndarray,
    min_pts: int,
    metric: str = "euclidean",
    n_parts: int = 8,
    seed: int = 0,
    row_tile: int = 1024,
    col_tile: int = 8192,
    dtype=np.float32,
    max_block: int = 8192,
    trace=None,
    knn_backend: str = "auto",
    *,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The Random Blocks exact method (the paper's RB).

    1. Global core distances in one scan (the k-best kernel).
    2. The dataset is randomly split into ``n_parts`` parts (a numpy
       permutation from ``seed``); every PAIR of parts forms a block, so
       every point pair co-occurs in exactly one block. Each block's MST
       under global-core mutual reachability comes from the dense block
       program (``parallel/blocks.run_packed_blocks``, plain PyTorch ops on
       ``device``).
    3. The pooled block MSTs merge with :func:`pool_mst`. A union of MSTs
       over an edge-covering family contains the true MST, so the result is
       the exact mutual-reachability MST.

    ``n_parts`` rises until a pair-block holds at most ``max_block``
    points. Blocks are packed and run in chunks of ~256 MiB of packed
    input, the running MST pooled after each chunk. ``trace`` gets one
    ``core_distances`` event, a ``block_fit`` event per chunk and one
    ``block_msts`` event per chunk (its block and pool walls).
    """
    from hdbscan_tpu_torch.ops.tiled import _next_pow2, knn_core_distances
    from hdbscan_tpu_torch.parallel.blocks import pack_blocks, run_packed_blocks
    from hdbscan_tpu_torch.utils.flops import counter as _flops
    from hdbscan_tpu_torch.utils.flops import phase_stats

    device = cuda_build.resolve_device(device)
    n = len(data)
    t0 = time.monotonic()
    fsnap = _flops.snapshot()
    core, _ = knn_core_distances(
        data, min_pts, metric, row_tile=row_tile, col_tile=col_tile, dtype=dtype,
        fetch_knn=False, backend=knn_backend, device=device,
    )
    if trace is not None:
        wall = time.monotonic() - t0
        trace("core_distances", n=n, wall_s=round(wall, 6), **phase_stats(fsnap, wall))

    # A pair-block holds ~2n/n_parts points and its dense MRD matrix must fit
    # the device: raise n_parts until blocks respect max_block.
    n_parts = max(n_parts, -(-2 * n // max_block))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    parts = np.array_split(perm, n_parts)
    if n_parts == 1:
        blocks = [parts[0]]
    else:
        blocks = [
            np.concatenate([parts[i], parts[j]])
            for i in range(n_parts)
            for j in range(i + 1, n_parts)
        ]
    cap = _next_pow2(max(len(b) for b in blocks))
    b = len(blocks)
    # Pack and launch in streamed chunks, pooling the running MST after
    # each, so host memory stays O(n + chunk) whatever the block count. The
    # chunk budget counts the three packed arrays (x, core, point_index).
    per_block = cap * (data.shape[1] * np.dtype(dtype).itemsize + 16)
    chunk = max(1, int(2**28 // per_block))
    data_c = data.astype(dtype, copy=False)
    ku = kv = kw = None
    for lo in range(0, b, chunk):
        t0 = time.monotonic()
        packed = pack_blocks(data_c, blocks[lo : lo + chunk], cap, core=core)
        eu, ev, ew, _ = run_packed_blocks(packed, min_pts, metric, device=device,
                                          dtype=dtype, trace=trace)
        t1 = time.monotonic()
        if ku is not None:
            eu = np.concatenate([ku, eu])
            ev = np.concatenate([kv, ev])
            ew = np.concatenate([kw, ew])
        ku, kv, kw = pool_mst(eu, ev, ew, n)
        if trace is not None:
            t2 = time.monotonic()
            trace("block_msts", blocks=min(lo + chunk, b), total_blocks=b,
                  pool_edges=len(eu), block_s=round(t1 - t0, 6),
                  pool_s=round(t2 - t1, 6), wall_s=round(t2 - t0, 6))
    return ku, kv, kw, core


def fit(
    data: np.ndarray,
    params: HDBSCANParams | None = None,
    *,
    device=None,
    mesh=None,
    row_tile: int = 1024,
    col_tile: int = 8192,
    dtype=np.float32,
    trace=None,
    num_constraints_satisfied: np.ndarray | None = None,
) -> HDBSCANResult:
    """Exact HDBSCAN* of ``data`` ((n, d) array) under ``params``.

    Runs on the card unless ``device`` names another (``"cpu"`` runs every
    kernel's plain PyTorch version); raises when no card is present and no
    device is named. ``row_tile``/``col_tile`` are the reference's tiles:
    they pick the euclidean distance form it would use. ``trace``: optional
    ``trace(stage, **fields)`` callable receiving the reference's stage
    events (``core_distances``, ``mst_round``, ``host_sync``,
    ``boruvka_mst``, ``tree_*``) plus ``forest_events``, and on the
    rp-forest tier ``knn_index_build``, ``knn_index_query``,
    ``knn_index_rescan`` and ``knn_fused_forest``.

    ``mesh`` (``parallel/mesh.get_mesh``) is the mesh of the sharded fit:
    ``fit_sharding=sharded`` runs on it (default: every visible card, or
    one shard on ``device`` when that is not a card), ``auto`` picks it on
    a mesh of two or more cards. The sharded fit adds ``ring_knn_scan``,
    ``ring_device_wall`` and ``shard_mst_device`` events, and its
    ``mst_round`` events carry ``sharded: true``.

    Routes, in the reference's order: ``dedup_points`` first
    (:func:`_fit_dedup`); then the device route above unless
    ``mst_backend=host`` or an unsharded ``scan_backend`` resolving to
    ``ring`` (the same default mesh) sends the fit down the host-round
    route (:func:`mst_edges`, ``boruvka_round`` events; the ring and
    sharded scanners add ``ring_boruvka_scan`` / ``shard_boruvka_scan``).
    A non-sharded mesh with the host scanner runs it on ``mesh.root``.
    """
    from hdbscan_tpu_torch.core.mst_device import resolve_mst_backend
    from hdbscan_tpu_torch.ops.tiled import check_dtype

    params = params or HDBSCANParams()
    data = np.asarray(data, np.float64)
    n = len(data)
    if n == 0:
        raise ValueError("empty dataset")
    if device is None and mesh is not None:
        device = mesh.root
    device = cuda_build.resolve_device(device)
    check_dtype(dtype, device)
    engine, mesh, _ = _engine(params.fit_sharding, params.scan_backend, mesh, device)
    kw = dict(row_tile=row_tile, col_tile=col_tile, dtype=dtype,
              num_constraints_satisfied=num_constraints_satisfied, trace=trace)
    if params.dedup_points:
        return _fit_dedup(data, params, engine, device=device, mesh=mesh, **kw)
    sharded = engine == "sharded"
    if resolve_mst_backend(params, n) == "device" and engine != "ring":
        return _fit_device(data, params, device=mesh.root if sharded else device,
                           mesh=mesh if sharded else None, **kw)
    from hdbscan_tpu_torch.core.knn import resolve_index_for
    from hdbscan_tpu_torch.models._finalize import finalize_clustering

    index, index_opts = resolve_index_for(params, n)
    u, v, w, core = mst_edges(
        data, params.min_points, params.dist_function, row_tile=row_tile,
        col_tile=col_tile, dtype=dtype, mesh=mesh, trace=trace,
        knn_backend=params.knn_backend, index=index, index_opts=index_opts,
        device=device, **_KNOBS[engine],
    )
    tree, labels, scores, infinite = finalize_clustering(
        n, u, v, w, core, params, num_constraints_satisfied, trace=trace, device=device,
    )
    return HDBSCANResult(
        labels=labels,
        tree=tree,
        core_distances=core,
        mst=(u, v, w),
        outlier_scores=scores,
        infinite_stability=infinite,
    )


def _fit_dedup(
    data: np.ndarray,
    params: HDBSCANParams,
    engine: str,
    *,
    device,
    mesh=None,
    row_tile: int,
    col_tile: int,
    dtype,
    num_constraints_satisfied,
    trace,
) -> HDBSCANResult:
    """Exact HDBSCAN* over deduplicated weighted points (``core/dedup.py``):
    the scans run at unique-point scale (the weighted core distances, then
    the host-round Borůvka over the unique points), groups heavy enough to
    pass ``min_cluster_size`` expand back into unit leaves, and the
    member-weighted finalize broadcasts labels and scores over the inverse
    index. Constraint row ids map through the inverse before counting.
    ``engine`` is :func:`_engine`'s; ``trace`` gets a ``dedup`` event
    besides the route's own."""
    from hdbscan_tpu_torch.core.dedup import (
        deduplicate,
        expand_heavy_groups,
        global_weighted_core_distances,
    )
    from hdbscan_tpu_torch.models._finalize import finalize_clustering

    n = len(data)
    uniq, counts, inverse = deduplicate(data)
    if trace is not None:
        trace("dedup", rows=n, unique=len(uniq))
    t0 = time.monotonic()
    core_u = global_weighted_core_distances(
        uniq, counts, params.min_points, params.dist_function, row_tile=row_tile,
        col_tile=col_tile, dtype=dtype, mesh=mesh, trace=trace,
        fit_sharding=_KNOBS[engine]["fit_sharding"], device=device,
    )
    if trace is not None:
        trace("core_distances", n=len(uniq), wall_s=round(time.monotonic() - t0, 6))
    u, v, w = mst_edges_from_core(
        uniq, core_u, params.dist_function, row_tile=row_tile, col_tile=col_tile,
        dtype=dtype, mesh=mesh, trace=trace, device=device, **_KNOBS[engine],
    )
    # Tree extraction over the expanded vertex set (expand_heavy_groups:
    # groups heavy enough to pass minClusterSize must dissolve under tie
    # contraction exactly like their full-row counterparts).
    u2, v2, w2, core2, weights2 = expand_heavy_groups(
        u, v, w, core_u, counts, params.min_cluster_size
    )
    tree, labels_x, scores_x, infinite = finalize_clustering(
        len(weights2), u2, v2, w2, core2, params, num_constraints_satisfied,
        point_weights=weights2, constraint_index_map=inverse, trace=trace, device=device,
    )
    m = len(uniq)
    return HDBSCANResult(
        labels=labels_x[:m][inverse],
        tree=tree,
        core_distances=core_u[inverse],
        mst=(u, v, w),  # unique-vertex space
        outlier_scores=scores_x[:m][inverse],
        infinite_stability=infinite,
        dedup_inverse=inverse,
    )


#: The types :func:`_fetch` carries, with their host types.
_HOST_TYPES = {torch.float64: np.float64, torch.int64: np.int64,
               torch.float32: np.float32, torch.int32: np.int32}


def _fetch(tensors: dict) -> dict:
    """Device tensors to host numpy in ONE transfer: their bytes side by
    side (8-byte types first, so every array lies aligned), each read back
    at its own offset in its own type. A type not in :data:`_HOST_TYPES`
    is refused."""
    for k, t in tensors.items():
        if t.dtype not in _HOST_TYPES:
            raise ValueError(f"_fetch: {k} has type {t.dtype}, not one of {list(_HOST_TYPES)}")
    names = sorted(tensors, key=lambda k: -tensors[k].element_size())
    flat = torch.cat([tensors[k].contiguous().reshape(-1).view(torch.uint8) for k in names])
    host = flat.cpu().numpy()
    out, off = {}, 0
    for k in names:
        t = tensors[k]
        nbytes = t.numel() * t.element_size()
        out[k] = host[off : off + nbytes].view(_HOST_TYPES[t.dtype])
        off += nbytes
    return out


def _fit_device(
    data: np.ndarray,
    params: HDBSCANParams,
    *,
    device,
    mesh=None,
    row_tile: int,
    col_tile: int,
    dtype,
    num_constraints_satisfied,
    trace,
) -> HDBSCANResult:
    from hdbscan_tpu_torch.core.mst_device import (
        assemble_merge_forest,
        assert_rounds_converged,
        boruvka_mst_device,
        forest_events_device,
    )
    from hdbscan_tpu_torch.core.knn import resolve_index_for
    from hdbscan_tpu_torch.models._finalize import (
        finalize_clustering,
        resolve_tree_backend,
    )
    from hdbscan_tpu_torch.ops.tiled import knn_core_distances

    from hdbscan_tpu_torch.utils.flops import counter as _flops
    from hdbscan_tpu_torch.utils.flops import phase_stats

    n = len(data)
    index, index_opts = resolve_index_for(params, n)
    t0 = time.monotonic()
    fsnap = _flops.snapshot()
    with obs.mem_phase("core_distances"):
        if mesh is not None:
            from hdbscan_tpu_torch.parallel.shard import shard_core_distances

            core = shard_core_distances(
                data, params.min_points, params.dist_function, row_tile=row_tile,
                col_tile=col_tile, dtype=dtype, mesh=mesh, trace=trace,
                knn_backend=params.knn_backend, index=index, index_opts=index_opts,
            )
        else:
            core, _ = knn_core_distances(
                data, params.min_points, params.dist_function,
                row_tile=row_tile, col_tile=col_tile, dtype=dtype, fetch_knn=False,
                backend=params.knn_backend, index=index, index_opts=index_opts,
                trace=trace, device=device,
            )
    if trace is not None:
        wall = time.monotonic() - t0
        trace("core_distances", n=n, wall_s=round(wall, 6), **phase_stats(fsnap, wall))

    t0 = time.monotonic()
    with obs.mem_phase("boruvka_mst_device"), obs.task("boruvka_device", total=1):
        if mesh is not None:
            from hdbscan_tpu_torch.parallel.ring import _per_device_walls
            from hdbscan_tpu_torch.parallel.shard import shard_boruvka_mst

            res = shard_boruvka_mst(
                data, core, params.dist_function, row_tile=row_tile, col_tile=col_tile,
                dtype=dtype, mesh=mesh, trace=trace,
            )
            walls = _per_device_walls(mesh, t0)
            mst_wall = time.monotonic() - t0
            # The union-find scan is sequential over the global edge order:
            # the shard edge buffers gather onto the first shard's device, in
            # shard order, for one scan there.
            for key in ("u", "v", "w"):
                res[key] = torch.cat([t.to(device) for t in res[key]])
        else:
            res = boruvka_mst_device(
                data, core, params.dist_function, row_tile=row_tile,
                col_tile=col_tile, dtype=dtype, device=device, trace=trace,
            )
        rounds_wall = time.monotonic() - t0
        t1 = time.monotonic()
        # Padded (+inf, self-loop) tail rows pass through the scan as
        # non-merges.
        events = forest_events_device(res["u"], res["v"], res["w"], n)
        if trace is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)  # an honest phase wall when tracing
            trace("forest_events", edges=int(res["u"].shape[0]),
                  wall_s=round(time.monotonic() - t1, 6))
        t1 = time.monotonic()
        fetched = _fetch({
            "sw": events["sw"], "ra": events["ra"], "rb": events["rb"],
            "u": res["u"], "v": res["v"], "w": res["w"],
        })
        sync_wall = time.monotonic() - t1
    rounds, count = res["rounds"], res["count"]
    assert_rounds_converged(
        rounds, count, n, stat_comp=res["stat_comp"], stat_edges=res["stat_edges"],
        where="shard_boruvka_mst" if mesh is not None else "boruvka_mst_device",
    )
    if mesh is not None:
        # One wall a shard for every round: the timeline replays it as
        # modelled per-round rows, the fetch on the last.
        from hdbscan_tpu_torch.parallel.mesh import device_count
        from hdbscan_tpu_torch.parallel.ring import _emit_modeled_rounds

        n_dev, shard, d = device_count(mesh), res["shard"], data.shape[1]
        n_pad = shard * n_dev
        itemsize = np.dtype(dtype).itemsize
        _emit_modeled_rounds(
            trace, "shard_mst_device", mst_wall, walls, n_dev, max(rounds, 1),
            fetch_s=sync_wall,
            comm_bytes=max(rounds, 1) * (n_dev - 1) * (shard * (d + 1) * itemsize + shard * 4),
            flops=2.0 * max(rounds, 1) * float(n_pad) * n_pad * d, n=n, shard=shard,
        )
    if trace is not None:
        trace(
            "host_sync",
            arrays=len(fetched),
            bytes=int(sum(a.nbytes for a in fetched.values())),
            wall_s=round(sync_wall, 6),
        )
        trace(
            "boruvka_mst",
            rounds=rounds,
            edges=count,
            round_syncs=res["round_syncs"],
            rounds_wall_s=round(rounds_wall, 6),
            wall_s=round(time.monotonic() - t0, 6),
        )
    u = np.asarray(fetched["u"][:count], np.int64)
    v = np.asarray(fetched["v"][:count], np.int64)
    w = np.asarray(fetched["w"][:count], np.float64)

    t1 = time.monotonic()
    tree_backend = resolve_tree_backend(params, None)
    forest = assemble_merge_forest(
        n,
        {"sw": fetched["sw"], "ra": fetched["ra"], "rb": fetched["rb"]},
        build_children=(tree_backend == "reference"),
    )
    if trace is not None:
        trace(
            "tree_build_device",
            n=n,
            edges=count,
            nodes=-1 if forest is None else len(forest.dist),
            backend="device",
            fallback=forest is None,
            wall_s=round(time.monotonic() - t1, 6),
        )
    # forest=None (near-tied unequal weights): finalize builds it on the host.
    tree, labels, scores, infinite = finalize_clustering(
        n, u, v, w, core, params, num_constraints_satisfied, trace=trace,
        forest=forest, device=device,
    )
    return HDBSCANResult(
        labels=labels,
        tree=tree,
        core_distances=core,
        mst=(u, v, w),
        outlier_scores=scores,
        infinite_stability=infinite,
    )

"""Exact HDBSCAN* at scale on the card — the port of ``models/exact.py``'s
device route (``fit`` -> ``_fit_device``).

The fit, phase by phase:

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

Routes of the reference that are not ported yet raise
``NotImplementedError`` naming their ROADMAP entry.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hdbscan_tpu_torch.config import HDBSCANParams
from hdbscan_tpu_torch.models.hdbscan import HDBSCANResult
from hdbscan_tpu_torch.ops import cuda_build


def _check_ported(params: HDBSCANParams, n: int, sharded: bool) -> None:
    from hdbscan_tpu_torch.core.knn import resolve_index_for
    from hdbscan_tpu_torch.core.mst_device import resolve_mst_backend

    if params.dedup_points:
        raise NotImplementedError(
            "dedup_points is not ported yet (ROADMAP A3: _fit_dedup, core/dedup.py)"
        )
    if resolve_mst_backend(params, n) == "host":
        raise NotImplementedError(
            "mst_backend=host (the host-round exact route) is not ported yet (ROADMAP A3)"
        )
    if sharded and resolve_index_for(params, n)[0] == "rpforest":
        raise NotImplementedError(
            "the sharded fit's rp-forest tier (fit_sharding=sharded with "
            "knn_index=rpforest) is not ported yet (ROADMAP A9)"
        )
    if not sharded and params.scan_backend == "ring":
        raise NotImplementedError(
            "scan_backend=ring (ring scans with host-round Borůvka contraction) "
            "is not ported yet (ROADMAP A3, A9)"
        )


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
    """
    from hdbscan_tpu_torch.parallel.mesh import get_mesh
    from hdbscan_tpu_torch.parallel.shard import resolve_fit_sharding

    params = params or HDBSCANParams()
    data = np.asarray(data, np.float64)
    n = len(data)
    if n == 0:
        raise ValueError("empty dataset")
    if device is None and mesh is not None:
        device = mesh.root
    device = cuda_build.resolve_device(device)
    sharded = resolve_fit_sharding(params.fit_sharding, mesh) == "sharded"
    _check_ported(params, n, sharded)
    if sharded and mesh is None:
        mesh = get_mesh() if device.type == "cuda" else get_mesh([device])
    return _fit_device(
        data, params, device=mesh.root if sharded else device,
        mesh=mesh if sharded else None, row_tile=row_tile, col_tile=col_tile,
        dtype=dtype, num_constraints_satisfied=num_constraints_satisfied, trace=trace,
    )


def _fetch(tensors: dict) -> dict:
    """All 32-bit device tensors to host numpy in ONE transfer."""
    names = list(tensors)
    flat = torch.cat([tensors[k].reshape(-1).view(torch.int32) for k in names])
    host = flat.cpu().numpy()
    out, off = {}, 0
    for k in names:
        t = tensors[k]
        size = t.numel()
        np_dtype = np.float32 if t.dtype == torch.float32 else np.int32
        out[k] = host[off : off + size].view(np_dtype)
        off += size
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

    n = len(data)
    index, index_opts = resolve_index_for(params, n)
    t0 = time.monotonic()
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
        trace("core_distances", n=n, wall_s=round(time.monotonic() - t0, 6))

    t0 = time.monotonic()
    if mesh is not None:
        from hdbscan_tpu_torch.parallel.mesh import device_count
        from hdbscan_tpu_torch.parallel.ring import _emit_ring_trace, _per_device_walls
        from hdbscan_tpu_torch.parallel.shard import shard_boruvka_mst

        res = shard_boruvka_mst(
            data, core, params.dist_function, row_tile=row_tile, col_tile=col_tile,
            dtype=dtype, mesh=mesh, trace=trace,
        )
        walls = _per_device_walls(mesh, t0)
        _emit_ring_trace(
            trace, "shard_mst_device", time.monotonic() - t0, walls, device_count(mesh),
            0, rounds=res["rounds"], n=n, shard=res["shard"],
        )
        # The union-find scan is sequential over the global edge order: the
        # shard edge buffers gather onto the first shard's device, in shard
        # order, for one scan there.
        for key in ("u", "v", "w"):
            res[key] = torch.cat([t.to(device) for t in res[key]])
    else:
        res = boruvka_mst_device(
            data, core, params.dist_function, row_tile=row_tile,
            col_tile=col_tile, dtype=dtype, device=device, trace=trace,
        )
    rounds_wall = time.monotonic() - t0
    t1 = time.monotonic()
    # Padded (+inf, self-loop) tail rows pass through the scan as non-merges.
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

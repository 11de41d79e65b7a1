"""Ring-systolic sharded k-NN scan — the port of ``parallel/ring.py``,
exact tier.

Every shard of the mesh (``parallel/mesh.Mesh``) owns one contiguous row
shard; the row shards themselves are the column panels, and each visits
every shard once, in the ring order of the reference (shard ``me`` sees the
panels of ``me, me - 1, ...``, exactly ``n_dev - 1`` hand-overs per sweep).
A panel moves to the resident shard's device with ``Tensor.to`` (nothing
moves when both shards share a card). Per visiting panel one launch of the
rectangular k-best kernel (``ops/cuda_knn.knn_kbest_panel``, B2) scans the
resident rows against it, and the per-panel lists merge under the explicit
(distance, id) lexicographic key (:func:`_lex_merge_k`), so the result does
not depend on the arrival order.

Parity with the reference's CPU ring: core distances are bitwise on integer
grids. The reference's guarded tile scan skips a tile when no distance is
strictly below a row's k-th, which under the rotated arrival order can keep
another id than the lex merge on an exact distance tie at the k-th slot; the
values agree.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
entry: the ring Borůvka scanner (:class:`RingBoruvkaScanner`, A3 and A9),
the rows scan (:func:`ring_knn_core_distances_rows`, A6 and A9) and the
sharded rp-forest branch (A9).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hdbscan_tpu_torch.core.distances import euclidean_form
from hdbscan_tpu_torch.ops.lexmerge import lexsort_rows
from hdbscan_tpu_torch.ops.tiled import _next_pow2, _round_up
from hdbscan_tpu_torch.parallel.mesh import device_count, fetch, get_mesh


def _ring_geometry(n: int, n_dev: int, row_tile: int, col_tile: int):
    """Clamp tiles and size the per-shard row block (the reference's):
    ``(row_tile, col_tile, shard, n_pad)`` with ``n_pad = shard * n_dev``;
    the column tile clamps to the pow2 round-up of the per-shard row
    count, because a panel is one row shard."""
    row_tile = _next_pow2(max(8, min(row_tile, n)))
    per_dev = -(-n // n_dev)
    col_tile = _next_pow2(max(128, min(col_tile, n)))
    col_tile = min(col_tile, _next_pow2(max(128, per_dev)))
    col_tile = max(col_tile, row_tile)
    shard = _round_up(per_dev, col_tile)
    return row_tile, col_tile, shard, shard * n_dev


def _shard_rows(n: int, shard: int, n_dev: int) -> list[tuple[int, int]]:
    """(offset, real rows) of every shard; trailing shards may hold none
    (the reference's pad rows are never materialized)."""
    return [(s * shard, max(0, min(shard, n - s * shard))) for s in range(n_dev)]


def _lex_merge_k(best_d, best_i, tile_d, tile_i, k: int):
    """Merge two (r, k) candidate lists into the k smallest by the explicit
    lexicographic key (distance, column id): arrival-order independent."""
    cat_d = torch.cat([best_d, tile_d], dim=1)
    cat_i = torch.cat([best_i, tile_i], dim=1)
    order = lexsort_rows(cat_d, cat_i)[:, :k]
    return torch.gather(cat_d, 1, order), torch.gather(cat_i, 1, order)


def _per_device_walls(mesh, t0: float) -> list[tuple[int, float]]:
    """Per-shard completion walls: wait for each shard's device in turn and
    timestamp as it finishes (the single-controller approximation of
    per-device timelines the reference takes)."""
    walls = []
    for s, dev in enumerate(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls.append((s, time.monotonic() - t0))
    return walls


def _emit_ring_trace(trace, stage: str, wall: float, walls, n_dev: int, rnd: int,
                     **fields) -> None:
    """One summary event (devices, and ``ppermute_steps = devices - 1``
    panel hand-overs per sweep) plus one ``ring_device_wall`` per shard."""
    if trace is None:
        return
    trace(stage, wall_s=round(wall, 6), devices=n_dev, ppermute_steps=n_dev - 1,
          round=rnd, **fields)
    for s, w in walls:
        trace("ring_device_wall", wall_s=round(w, 6), device=s, ring_stage=stage, round=rnd)


def ring_knn_core_distances(
    data: np.ndarray,
    min_pts: int,
    metric: str = "euclidean",
    k: int | None = None,
    row_tile: int = 1024,
    col_tile: int = 8192,
    dtype=np.float32,
    return_indices: bool = False,
    fetch_knn: bool = True,
    mesh=None,
    trace=None,
    knn_backend: str = "auto",
    index: str = "exact",
    index_opts: dict | None = None,
):
    """Ring-sharded exact core distances, the contract of
    ``ops/tiled.knn_core_distances``: ``(core, knn)``, ``(core, knn, idx)``
    with ``return_indices``, or ``(core, None)`` with ``fetch_knn=False``
    (only the k-th column leaves the shards).

    The euclidean form is the one the reference's ring tiles take
    (:func:`_ring_geometry`), or the dot form for ``knn_backend="fused"``
    within the fused kernel's gate (k and d <= 128).
    Emits one ``ring_knn_scan`` event with per-shard walls.
    """
    from hdbscan_tpu_torch.ops.cuda_knn import knn_kbest_panel
    from hdbscan_tpu_torch.utils.flops import counter as _flops

    if index == "rpforest":
        raise NotImplementedError(
            "the mesh-sharded rp-forest (shard_forest_core_distances) is not "
            "ported yet (ROADMAP A9)"
        )
    if index != "exact":
        raise ValueError(f"unknown knn index {index!r}")
    if np.dtype(dtype) != np.float32:
        raise ValueError(f"the k-best kernel computes in float32, got dtype {dtype}")
    n, d = np.shape(data)
    k = max(k or 0, max(min_pts - 1, 1))
    mesh = mesh if mesh is not None else get_mesh()
    n_dev = device_count(mesh)
    row_tile, col_tile, shard, n_pad = _ring_geometry(n, n_dev, row_tile, col_tile)
    if metric != "euclidean":
        form = None
    elif knn_backend == "fused" and k <= 128 and d <= 128:  # the fused kernel's lanes
        form = "dot"
    else:
        form = euclidean_form(row_tile, col_tile, d)
    parts = _shard_rows(n, shard, n_dev)
    x = np.asarray(data, np.float32)
    t_up = time.monotonic()
    rows = [torch.as_tensor(x[o : o + m], device=dev)
            for (o, m), dev in zip(parts, mesh.devices)]
    upload_s = time.monotonic() - t_up
    _flops.add_scan(n_pad, n_pad, d, row_tile=row_tile)
    t0 = time.monotonic()
    lists = []
    for me, dev in enumerate(mesh.devices):
        m = parts[me][1]
        bd = torch.full((m, k), float("inf"), dtype=torch.float32, device=dev)
        bi = torch.full((m, k), -1, dtype=torch.int32, device=dev)
        for step in range(n_dev):
            src = (me - step) % n_dev
            off, c = parts[src]
            if m == 0 or c == 0:
                continue
            td, ti = knn_kbest_panel(rows[me], rows[src].to(dev), k, metric, form,
                                     id_offset=off)
            bd, bi = _lex_merge_k(bd, bi, td, ti, k)
        lists.append((bd, bi))
    walls = _per_device_walls(mesh, t0)
    wall = time.monotonic() - t0
    fetch_knn = fetch_knn or return_indices
    kth_col = min(max(min_pts - 1, 1), n) - 1
    t_f = time.monotonic()
    if fetch_knn:
        knn = fetch([bd for bd, _ in lists]).astype(np.float64)
        idx = fetch([bi for _, bi in lists]).astype(np.int64) if return_indices else None
    else:
        kth = fetch([bd[:, kth_col] for bd, _ in lists]).astype(np.float64)
    fetch_s = time.monotonic() - t_f
    _emit_ring_trace(
        trace, "ring_knn_scan", wall, walls, n_dev, 0, rows=n, shard=shard,
        upload_s=round(upload_s, 6), fetch_s=round(fetch_s, 6),
        comm_bytes=(n_dev - 1) * shard * d * 4,
    )
    if not fetch_knn:
        return (np.zeros(n, np.float64) if min_pts <= 1 else kth), None
    core = np.zeros(n, np.float64) if min_pts <= 1 else knn[:, kth_col].copy()
    if return_indices:
        return core, knn, idx
    return core, knn


def ring_knn_core_distances_rows(*args, **kwargs):
    """The ring rows scan (the MR boundary rescan's sharded twin)."""
    raise NotImplementedError(
        "the ring rows scan (ring_knn_core_distances_rows) is not ported yet "
        "(ROADMAP A6, A9)"
    )


class RingBoruvkaScanner:
    """The ring Borůvka scanner with per-round host contraction."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the ring Borůvka scanner (RingBoruvkaScanner, host-round "
            "contraction) is not ported yet (ROADMAP A3, A9)"
        )

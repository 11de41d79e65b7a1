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

:class:`RingBoruvkaScanner` runs host-contracted Borůvka rounds over the
same shards (``scan_backend=ring``); :func:`resolve_scan_backend` maps the
knob to it.

:func:`ring_knn_core_distances_rows` is the rows scan of the MR boundary
rescan (query rows sharded on their own, the point set's shards
circulating as column panels), and ``index="rpforest"`` sends both entries
to the rp-forest over the mesh (``ops/rpforest``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hdbscan_tpu_torch import obs
from hdbscan_tpu_torch.core.distances import euclidean_form
from hdbscan_tpu_torch.ops.lexmerge import lexsort_rows
from hdbscan_tpu_torch.ops.tiled import _next_pow2, _round_up, check_dtype
from hdbscan_tpu_torch.parallel.mesh import (
    comm_snapshot,
    device_count,
    fetch,
    get_mesh,
    ring_shift,
    spans_cards,
)

#: Valid ``scan_backend`` values (``config.HDBSCANParams.scan_backend``).
SCAN_BACKENDS = ("auto", "host", "ring")


def resolve_scan_backend(scan_backend: str, mesh) -> str:
    """Map a ``scan_backend`` knob value to the engine: "host" and "ring"
    are literal; "auto" picks the ring only on a mesh of two or more
    distinct CUDA devices (``parallel/mesh.spans_cards``), so one card and
    CPU meshes keep the host scanner."""
    if scan_backend not in SCAN_BACKENDS:
        raise ValueError(f"unknown scan_backend {scan_backend!r}: auto | host | ring")
    if scan_backend != "auto":
        return scan_backend
    return "ring" if spans_cards(mesh) else "host"


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


def _per_device_walls(mesh, t0: float, beat=None) -> list[tuple[int, float]]:
    """Per-shard completion walls of this rank's shards: wait for each
    shard's device in turn and timestamp as it finishes (the
    single-controller approximation of per-device timelines the reference
    takes). On one card the first wait covers every shard's queued work, so
    the walls come out nearly equal. ``beat(done)`` (an ``obs`` heartbeat)
    fires as each shard lands. Only this rank's devices are waited on: the
    walls are measurements, and no decision of the fit reads them.

    Fault site: ``phase_stall`` fires at most once a call here and sleeps
    ``delay_s`` before the last shard's timestamp — a deterministic
    one-shard straggler for the skew detector (``obs/timeline.py``)."""
    from hdbscan_tpu_torch.fault import inject

    walls = []
    spec = inject.maybe_fire("phase_stall")
    local = mesh.local_shards()
    for i, s in enumerate(local):
        dev = mesh.devices[s]
        if spec is not None and s == local[-1] and spec.delay_s > 0:
            time.sleep(spec.delay_s)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls.append((s, time.monotonic() - t0))
        if beat is not None:
            beat(i + 1)
    return walls


def _emit_ring_trace(trace, stage: str, wall: float, walls, n_dev: int, rnd: int, *,
                     upload_s: float = 0.0, fetch_s: float = 0.0, comm_bytes: int = 0,
                     flops: float = 0.0, **fields) -> None:
    """One summary event (devices, and ``ppermute_steps = devices - 1``
    panel hand-overs per sweep) plus one ``ring_device_wall`` per shard.

    Also the one seam feeding the installed
    :class:`~hdbscan_tpu_torch.obs.timeline.TimelineRecorder`: the measured
    per-shard walls plus the host segments (``upload_s``/``fetch_s``), the
    round's traffic (``comm_bytes`` one shard moved) and its total
    ``flops`` become per-shard ``device_timeline`` events, and the round's
    skew stats ride the summary event. Recording happens even when
    ``trace`` is None — the recorder still feeds the report and
    ``/healthz``."""
    from hdbscan_tpu_torch import obs

    tl = obs.timeline()
    stats = None
    if tl is not None:
        stats = tl.record_round(stage, rnd, walls, upload_s=upload_s, fetch_s=fetch_s,
                                comm_bytes=comm_bytes, flops=flops, trace=trace)
    _emit_summary(trace, stage, wall, walls, n_dev, stats, comm_bytes, rnd, round=rnd,
                  **fields)


def _emit_modeled_rounds(trace, stage: str, wall: float, walls, n_dev: int, rounds: int, *,
                         upload_s: float = 0.0, fetch_s: float = 0.0, comm_bytes: int = 0,
                         flops: float = 0.0, **fields) -> None:
    """:func:`_emit_ring_trace` for a multi-round program measured once: the
    sharded device Borůvka (``parallel/shard.shard_boruvka_mst``) gives one
    wall per shard for all its rounds. The installed recorder replays it as
    ``rounds`` modelled per-round rows
    (:meth:`~hdbscan_tpu_torch.obs.timeline.TimelineRecorder.record_modeled_rounds`),
    and ONE summary event lands with the total wall and a ``rounds`` field."""
    from hdbscan_tpu_torch import obs

    tl = obs.timeline()
    stats = None
    if tl is not None:
        stats = tl.record_modeled_rounds(stage, rounds, walls, upload_s=upload_s,
                                         fetch_s=fetch_s, comm_bytes=comm_bytes, flops=flops,
                                         trace=trace)
    _emit_summary(trace, stage, wall, walls, n_dev, stats, comm_bytes, 0, rounds=int(rounds),
                  **fields)


def _emit_summary(trace, stage, wall, walls, n_dev, stats, comm_bytes, rnd, **fields) -> None:
    """The summary event (with the recorder's skew stats when one ran) and
    the per-shard ``ring_device_wall`` events, tagged ``round=rnd``."""
    if trace is None:
        return
    if stats is not None:
        fields = dict(fields, skew=stats["skew"], max_device_wall_s=stats["max_wall_s"],
                      median_device_wall_s=stats["median_wall_s"])
    if comm_bytes:
        fields.setdefault("comm_bytes", int(comm_bytes))
    trace(stage, wall_s=round(wall, 6), devices=n_dev, ppermute_steps=n_dev - 1, **fields)
    for s, w in walls:
        trace("ring_device_wall", wall_s=round(w, 6), device=s, ring_stage=stage, round=rnd)


def _ring_lists(queries: dict, cols: dict, parts, k: int, metric: str, form, col_tile: int,
                mesh):
    """The ring sweep: every local shard ``me``'s query rows ``queries[me]``
    against the column panels in ring order ``(me - s) % D``, one launch of
    the rectangular k-best kernel (B2) a panel, the lists merged under the
    (distance, id) key (:func:`_lex_merge_k`); ``cols`` maps each local
    shard to its panel, a panel of another rank's shard arriving through
    ``parallel/mesh.ring_shift``, and ``parts`` gives each panel's (global
    offset, rows). Returns {local shard: ((m, k) distances, (m, k) int32
    ids)}; a shard without query rows launches nothing."""
    from hdbscan_tpu_torch.ops.cuda_knn import knn_kbest_panel

    n_dev = len(mesh.devices)
    lists = {}
    for me, q in queries.items():
        dev = mesh.devices[me]
        lists[me] = (torch.full((q.shape[0], k), float("inf"), dtype=q.dtype, device=dev),
                     torch.full((q.shape[0], k), -1, dtype=torch.int32, device=dev))
    for step in range(n_dev):
        visiting = ring_shift(mesh, {s: (c,) for s, c in cols.items()}, step,
                              [c for _, c in parts])
        for me, q in queries.items():
            src = (me - step) % n_dev
            off, c = parts[src]
            if q.shape[0] == 0 or c == 0:
                continue
            td, ti = knn_kbest_panel(q, visiting[me][0], k, metric, form, id_offset=off,
                                     col_tile=col_tile)
            lists[me] = _lex_merge_k(*lists[me], td, ti, k)
    return lists


def _handover(mesh, snap, modeled: int) -> dict:
    """The ``comm_bytes`` of a ring trace: what the mesh's helpers handed
    to other ranks since ``snap`` (``parallel/mesh.comm_snapshot``) with
    their wall as ``handover_s``, on a multi-process mesh; the modelled
    panel bytes of one controller otherwise."""
    if not mesh.multiprocess:
        return {"comm_bytes": modeled}
    nbytes, wall = comm_snapshot()
    return {"comm_bytes": nbytes - snap[0], "handover_s": round(wall - snap[1], 6)}


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
    ``index="rpforest"`` runs the rp-forest over the same mesh instead
    (``ops/rpforest.rpforest_core_distances``, equal to its one-device
    run), ``index_opts`` its knobs.
    """
    from hdbscan_tpu_torch.utils.flops import counter as _flops

    mesh = mesh if mesh is not None else get_mesh()
    if index == "rpforest":
        from hdbscan_tpu_torch.ops.rpforest import rpforest_core_distances

        return rpforest_core_distances(
            data, min_pts, metric, k, dtype=dtype, return_indices=return_indices,
            fetch_knn=fetch_knn, trace=trace, mesh=mesh, **(index_opts or {}),
        )
    if index != "exact":
        raise ValueError(f"unknown knn index {index!r}")
    n, d = np.shape(data)
    k = max(k or 0, max(min_pts - 1, 1))
    check_dtype(dtype, mesh.root)
    n_dev = device_count(mesh)
    row_tile, col_tile, shard, n_pad = _ring_geometry(n, n_dev, row_tile, col_tile)
    if metric != "euclidean":
        form = None
    elif knn_backend == "fused" and k <= 128 and d <= 128:  # the fused kernel's lanes
        form = "dot"
    else:
        form = euclidean_form(row_tile, col_tile, d)
    parts = _shard_rows(n, shard, n_dev)
    x = np.asarray(data, dtype)
    snap = comm_snapshot()
    t_up = time.monotonic()
    rows = {s: torch.as_tensor(x[parts[s][0] : parts[s][0] + parts[s][1]],
                               device=mesh.devices[s])
            for s in mesh.local_shards()}
    upload_s = time.monotonic() - t_up
    _flops.add_scan(n_pad, n_pad, d, row_tile=row_tile)
    with obs.mem_phase("ring_knn_scan"), obs.task("ring_knn_scan",
                                                  total=len(rows)) as hb:
        t0 = time.monotonic()
        lists = _ring_lists(rows, rows, parts, k, metric, form, col_tile, mesh)
        walls = _per_device_walls(mesh, t0, beat=hb.beat)
        wall = time.monotonic() - t0
    fetch_knn = fetch_knn or return_indices
    kth_col = min(max(min_pts - 1, 1), n) - 1
    t_f = time.monotonic()
    if fetch_knn:
        knn = fetch({s: bd for s, (bd, _) in lists.items()}, mesh).astype(np.float64)
        idx = (fetch({s: bi for s, (_, bi) in lists.items()}, mesh).astype(np.int64)
               if return_indices else None)
    else:
        kth = fetch({s: bd[:, kth_col] for s, (bd, _) in lists.items()}, mesh).astype(np.float64)
    fetch_s = time.monotonic() - t_f
    _emit_ring_trace(
        trace, "ring_knn_scan", wall, walls, n_dev, 0, rows=n, shard=shard,
        upload_s=upload_s, fetch_s=fetch_s, flops=2.0 * n_pad * n_pad * d,
        **_handover(mesh, snap, (n_dev - 1) * shard * d * 4),
    )
    if not fetch_knn:
        return (np.zeros(n, np.float64) if min_pts <= 1 else kth), None
    core = np.zeros(n, np.float64) if min_pts <= 1 else knn[:, kth_col].copy()
    if return_indices:
        return core, knn, idx
    return core, knn


def ring_knn_core_distances_rows(
    data: np.ndarray,
    row_ids: np.ndarray,
    min_pts: int,
    metric: str = "euclidean",
    row_tile: int = 1024,
    col_tile: int = 8192,
    dtype=np.float32,
    mesh=None,
    trace=None,
    index: str = "exact",
    index_opts: dict | None = None,
) -> np.ndarray:
    """Ring-sharded core distances of the SELECTED rows (the MR boundary
    rescan; the contract of ``ops/tiled.knn_core_distances_rows``, (m,)
    float64 aligned with ``row_ids``).

    The m query rows shard on their own, ``q_shard = round_up(max(ceil(m /
    D), row_tile), row_tile)`` rows a shard (the reference's padding, never
    materialized), while the whole point set's row shards circulate as the
    column panels (:func:`_ring_geometry`): per shard holding queries and
    per visiting panel one launch of the rectangular k-best kernel (B2),
    the lists merged under the (distance, id) key. A shard with no query
    row launches nothing; only the k-th column leaves the shards. At
    ``index="rpforest"`` the rows come from one forest pass over the mesh
    (``ops/rpforest.rpforest_core_distances_rows``). Emits one
    ``ring_rows_scan`` event with per-shard walls.
    """
    from hdbscan_tpu_torch.utils.flops import counter as _flops

    n, d = np.shape(data)
    row_ids = np.asarray(row_ids)
    m = len(row_ids)
    if m == 0:
        return np.zeros(0, np.float64)
    mesh = mesh if mesh is not None else get_mesh()
    if index == "rpforest":
        from hdbscan_tpu_torch.ops.rpforest import rpforest_core_distances_rows

        return rpforest_core_distances_rows(data, row_ids, min_pts, metric, dtype=dtype,
                                            trace=trace, mesh=mesh, **(index_opts or {}))
    if index != "exact":
        raise ValueError(f"unknown knn index {index!r}")
    check_dtype(dtype, mesh.root)
    k = max(min_pts - 1, 1)
    n_dev = device_count(mesh)
    row_tile, col_tile, shard, n_pad = _ring_geometry(n, n_dev, row_tile, col_tile)
    q_shard = _round_up(max(-(-m // n_dev), row_tile), row_tile)
    form = euclidean_form(row_tile, col_tile, d) if metric == "euclidean" else None
    parts = _shard_rows(n, shard, n_dev)
    qparts = _shard_rows(m, q_shard, n_dev)
    x = np.asarray(data, dtype)
    snap = comm_snapshot()
    t_up = time.monotonic()
    local = mesh.local_shards()
    cols = {s: torch.as_tensor(x[parts[s][0] : parts[s][0] + parts[s][1]],
                               device=mesh.devices[s]) for s in local}
    qs = {s: torch.as_tensor(x[row_ids[qparts[s][0] : qparts[s][0] + qparts[s][1]]],
                             device=mesh.devices[s]) for s in local}
    upload_s = time.monotonic() - t_up
    _flops.add_scan(q_shard * n_dev, n_pad, d, row_tile=row_tile)
    kth_col = min(k, n) - 1
    with obs.mem_phase("ring_rows_scan"), obs.task("ring_rows_scan", total=len(local)) as hb:
        t0 = time.monotonic()
        lists = _ring_lists(qs, cols, parts, k, metric, form, col_tile, mesh)
        walls = _per_device_walls(mesh, t0, beat=hb.beat)
        wall = time.monotonic() - t0
    t_f = time.monotonic()
    out = fetch({s: bd[:, kth_col] for s, (bd, _) in lists.items()}, mesh).astype(np.float64)
    fetch_s = time.monotonic() - t_f
    _emit_ring_trace(
        trace, "ring_rows_scan", wall, walls, n_dev, 0, rows=m, cols=n, shard=shard,
        upload_s=upload_s, fetch_s=fetch_s, flops=2.0 * q_shard * n_dev * n_pad * d,
        **_handover(mesh, snap, (n_dev - 1) * shard * d * np.dtype(dtype).itemsize),
    )
    if min_pts <= 1:
        return np.zeros(m, np.float64)
    return out


class RingBoruvkaScanner:
    """Ring-sharded drop-in for ``ops/tiled.BoruvkaScanner`` (the
    reference's ``RingBoruvkaScanner``): the same ``min_outgoing(comp) ->
    (best_w, best_j)`` contract and the same edges after
    ``utils/unionfind.contract_min_edges``, but the points shard over the
    mesh (``mesh=None``: every visible card) and only the (n_comp,) reduced
    winners come back each round.

    A round is ``parallel/shard._Shards.scan`` (B9 per shard and visiting
    panel, the panels in ring order under the explicit (w, j) update) over
    the dense component labels, then ``_Shards.winners``, the per-component
    minimum by the contraction's own key (w, lo, hi) across shards. Each
    component's one winner is scattered onto its in-component endpoint, so
    the returned per-point arrays carry one candidate per component and the
    host contraction emits the host scanner's edges round for round.
    ``trace`` gets one ``ring_boruvka_scan`` event per round (with
    per-shard ``ring_device_wall`` events).
    """

    def __init__(self, data: np.ndarray, core: np.ndarray, metric: str = "euclidean",
                 row_tile: int = 1024, col_tile: int = 8192, dtype=np.float32,
                 mesh=None, trace=None):
        from hdbscan_tpu_torch.parallel.shard import _Shards

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
        """(best_w float64, best_j int64) per point — (+inf, -1) except each
        component's winning outgoing edge, scattered onto its in-component
        endpoint."""
        from hdbscan_tpu_torch.utils.flops import counter as _flops

        sh = self._sh
        _flops.add_scan(sh.n_pad, sh.n_pad, self.d, row_tile=sh.row_tile)
        uniq, dense = np.unique(np.asarray(comp), return_inverse=True)
        n_comp = len(uniq)
        snap = comm_snapshot()
        t_up = time.monotonic()
        labels_on = sh.put_labels(dense.astype(np.int32))
        upload_s = time.monotonic() - t_up
        with obs.mem_phase("ring_boruvka_scan"), obs.task(
            "ring_boruvka_scan", total=len(sh.local)
        ) as hb:
            t0 = time.monotonic()
            w, lo, hi, n_cand = sh.winners(sh.scan(labels_on), labels_on, n_comp)
            walls = _per_device_walls(sh.mesh, t0, beat=hb.beat)
            wall = time.monotonic() - t0
        t_f = time.monotonic()
        w = w.cpu().numpy().astype(np.float64)
        lo, hi = torch.stack([lo, hi]).cpu().numpy().astype(np.int64)
        cand = int(n_cand)
        fetch_s = time.monotonic() - t_f
        self.walls = (wall, fetch_s)
        # The row shard with its cores circulates each round.
        comm_bytes = (self.n_dev - 1) * sh.shard * (self.d + 1) * self._itemsize
        _emit_ring_trace(
            self.trace, "ring_boruvka_scan", wall, walls, self.n_dev, self._round,
            n_comp=n_comp, candidates=cand, upload_s=upload_s, fetch_s=fetch_s,
            flops=2.0 * sh.n_pad * sh.n_pad * self.d,
            **_handover(sh.mesh, snap, comm_bytes),
        )
        self._round += 1
        bw = np.full(self.n, np.inf, np.float64)
        bj = np.full(self.n, -1, np.int64)
        fin = np.isfinite(w)
        if fin.any():
            lo_f, hi_f = lo[fin], hi[fin]
            cids = np.flatnonzero(fin)
            # The winner's in-component endpoint emits it (host semantics:
            # the vertex whose candidate won the component).
            u = np.where(dense[lo_f] == cids, lo_f, hi_f)
            bw[u] = w[fin]
            bj[u] = lo_f + hi_f - u
        return bw, bj

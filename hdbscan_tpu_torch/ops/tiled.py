"""Large-N scans of the exact fit: k-NN core distances and the Borůvka
per-row min-outgoing reduction — the port of ``ops/tiled.py``.

The reference tiles both scans into (row_tile, col_tile) blocks for XLA and
picks the euclidean distance form per tile shape. On the card both are
hand-written kernels that walk every column per row (``ops/cuda_knn``,
``ops/cuda_segmin``); the tile sizes survive only to choose the distance
form the reference would use at the caller's tiles (:func:`scan_form`), so
the port computes the same distances.

:func:`_min_outgoing_scan` is the plain PyTorch version of the segment-min
kernel; :func:`knn_core_distances` is the core-distance entry point and
:func:`knn_core_distances_rows` its selected-rows twin (the MR boundary
rescan without block pruning);
:class:`BoruvkaScanner` and :func:`boruvka_glue_edges` run host-contracted
Borůvka rounds over that kernel (the exact fit's host-round route, the MR
pipeline's glue and refine harvests); the glue takes the ring and sharded
scanners of ``parallel/`` over a mesh as well.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hdbscan_tpu_torch.core.distances import euclidean_form, pairwise_distance

#: Plain segment-min: rows per block so one (rows, n) weight block stays
#: under this many elements.
_PLAIN_BLOCK_ELEMS = 1 << 26

#: Dimensionality from which ``backend="auto"`` takes the k-smallest kernel
#: B3 for euclidean data on the card (the reference's ``_PALLAS_MIN_D``,
#: its TPU crossover).
_PALLAS_MIN_D = 24


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _tile_sizes(n: int, row_tile: int, col_tile: int) -> tuple[int, int, int]:
    """The reference's tile clamp: pow2 tiles (so row_tile | col_tile),
    minimums 8 x 128, and the n_pad its scans pad to (n rounded up to the
    column tile). The port's kernels mask the ragged edge and never pad."""
    row_tile = _next_pow2(max(8, min(row_tile, n)))
    col_tile = _next_pow2(max(128, min(col_tile, n)))
    col_tile = max(col_tile, row_tile)
    return row_tile, col_tile, _round_up(n, col_tile)


def check_dtype(dtype, device) -> None:
    """The scans' dtypes: float32 everywhere, float64 on the CPU too (the
    plain versions run in the asked type, as the reference's XLA scans
    do). The kernels, like the reference's Pallas kernels, are float32
    only: float64 for the card raises here, before any work."""
    if np.dtype(dtype) == np.float32:
        return
    if np.dtype(dtype) != np.float64 or torch.device(device).type != "cpu":
        raise ValueError(
            f"dtype {np.dtype(dtype)} on {device}: the kernels compute in float32 "
            "(float64 runs only on the CPU, through the plain versions)"
        )


def scan_form(n: int, d: int, metric: str, row_tile: int, col_tile: int):
    """Euclidean form the reference's XLA scans take for n points at the
    caller's tiles (after :func:`_tile_sizes` clamps them); None for the
    other metrics."""
    if metric != "euclidean":
        return None
    rt, ct, _ = _tile_sizes(n, row_tile, col_tile)
    return euclidean_form(rt, ct, d)


def knn_core_distances(
    data: np.ndarray,
    min_pts: int,
    metric: str = "euclidean",
    k: int | None = None,
    row_tile: int = 1024,
    col_tile: int = 8192,
    dtype=np.float32,
    return_indices: bool = False,
    backend: str = "auto",
    fetch_knn: bool = True,
    index: str = "exact",
    index_opts: dict | None = None,
    trace=None,
    device=None,
):
    """Core distances (and the k-NN list): the exact tier through the k-best
    kernel, or the rp-forest tier.

    Same return contract as the reference: ``(core, knn)``; ``(core, None)``
    with ``fetch_knn=False``; ``(core, knn, idx)`` with ``return_indices``.
    ``core[i]`` is the ``min_pts``-th smallest distance from i, self
    included, as float64.

    ``backend``: "xla" runs the k-best kernel in the distance form the
    reference's XLA scan takes at these tiles; "fused" runs it in the fused
    TPU kernel's dot form within that kernel's gate (euclidean, k and d <=
    128) and in the XLA scan's form past it, as the reference falls back;
    "pallas" runs the no-ids k-smallest kernel B3 in
    its dot form (``ops/cuda_knn_smallest.knn_core_distances_pallas``, on
    the CPU its plain version), which needs euclidean, d <= 128, k <= 128
    and no ids. "auto" takes B3 where the reference's ``auto`` takes it on
    a TPU — euclidean data of d >= 24 at the default tiles and dtype, no
    ids — when the points go to a CUDA device, and the XLA scan's form
    everywhere else (the CPU included, as the reference off-TPU).

    ``index`` is the resolved tier (``core/knn.resolve_index_for``):
    "rpforest" runs ``ops/rpforest.rpforest_core_distances`` with
    ``index_opts`` (trees, leaf_size, rescan_rounds, seed, knn_backend,
    knn_precision) and ``trace``, in the same return contract; ``backend``
    and the tiles govern the exact tier only.
    """
    if index == "rpforest":
        from hdbscan_tpu_torch.ops.rpforest import rpforest_core_distances

        return rpforest_core_distances(
            data, min_pts, metric, k, dtype=dtype, return_indices=return_indices,
            fetch_knn=fetch_knn, trace=trace, device=device, **(index_opts or {}),
        )
    if index != "exact":
        raise ValueError(f"unknown index {index!r}: exact | rpforest")
    if backend not in ("auto", "xla", "pallas", "fused"):
        raise ValueError(f"unknown backend {backend!r}: auto | xla | pallas | fused")
    from hdbscan_tpu_torch.ops import cuda_build

    check_dtype(dtype, cuda_build.resolve_device(device))
    from hdbscan_tpu_torch.ops.cuda_knn import kbest_core_distances
    from hdbscan_tpu_torch.ops.cuda_knn_smallest import LANES, knn_core_distances_pallas

    n, d = np.shape(data)
    k = max(k or 0, max(min_pts - 1, 1))
    eligible = metric == "euclidean" and not return_indices and k <= LANES and d <= LANES
    if backend == "pallas" and not eligible:
        raise ValueError(
            "backend='pallas' needs euclidean metric, d <= 128, k <= 128 and "
            "return_indices=False"
        )
    if backend == "pallas" or (
        backend == "auto" and eligible and d >= _PALLAS_MIN_D
        and (row_tile, col_tile) == (1024, 8192) and np.dtype(dtype) == np.float32
        and cuda_build.resolve_device(device).type == "cuda"
    ):
        return knn_core_distances_pallas(
            data, min_pts, k=k, form="dot", fetch_knn=fetch_knn, device=device
        )
    # Like the reference, "fused" runs the fused kernel's dot form only
    # within its gate (euclidean, k and d within the 128 lanes) and the XLA
    # scan's contract elsewhere; the k-best kernel takes both, past 128 in
    # its wide mode.
    if backend == "fused" and metric == "euclidean" and k <= LANES and d <= LANES:
        form = "dot"
    else:
        form = scan_form(n, d, metric, row_tile, col_tile)
    return kbest_core_distances(
        data, min_pts, k, metric, form, fetch_knn, return_indices, device,
        col_tile=_tile_sizes(n, row_tile, col_tile)[1], dtype=dtype,
    )


def knn_core_distances_rows(
    data: np.ndarray,
    row_ids: np.ndarray,
    min_pts: int,
    metric: str = "euclidean",
    row_tile: int = 1024,
    col_tile: int = 8192,
    dtype=np.float32,
    backend: str = "xla",
    index: str = "exact",
    index_opts: dict | None = None,
    trace=None,
    device=None,
) -> np.ndarray:
    """Exact core distances of the SELECTED rows ``row_ids`` against the
    whole set (the MR boundary rescan without block pruning): (m,) float64,
    aligned with ``row_ids``, zeros at ``min_pts <= 1``.

    One launch of the rectangular k-best kernel
    (``ops/cuda_knn.knn_kbest_panel``, its plain version on the CPU) scans
    the rows against every column, k = max(min_pts - 1, 1); the core is
    column ``min(k, n) - 1`` of the list. ``backend="fused"`` takes the
    fused TPU kernel's dot form within its gate (euclidean, k and d <= 128,
    float32), every other case the XLA scan's form at these tiles; zero-norm
    columns at cosine and pearson follow that scan's tile rule at its
    column tile. ``index="rpforest"`` slices the rows out of one forest
    pass over the whole set (``ops/rpforest.rpforest_core_distances_rows``).
    ``dtype`` defaults to float32 whatever the fit's type, as in the
    reference.
    """
    if index == "rpforest":
        from hdbscan_tpu_torch.ops.rpforest import rpforest_core_distances_rows

        return rpforest_core_distances_rows(
            data, row_ids, min_pts, metric, dtype=dtype, trace=trace, device=device,
            **(index_opts or {}),
        )
    if index != "exact":
        raise ValueError(f"unknown index {index!r}: exact | rpforest")
    from hdbscan_tpu_torch.ops import cuda_build
    from hdbscan_tpu_torch.ops.cuda_knn import knn_kbest_panel
    from hdbscan_tpu_torch.ops.cuda_knn_smallest import LANES

    device = cuda_build.resolve_device(device)
    check_dtype(dtype, device)
    n, d = np.shape(data)
    m = len(row_ids)
    if m == 0:
        return np.zeros(0, np.float64)
    k = max(min_pts - 1, 1)
    if (backend == "fused" and metric == "euclidean" and k <= LANES and d <= LANES
            and np.dtype(dtype) == np.float32):
        form = "dot"
    else:
        form = scan_form(n, d, metric, row_tile, col_tile)
    x = torch.as_tensor(np.asarray(data, dtype), device=device)
    q = torch.as_tensor(np.asarray(data[row_ids], dtype), device=device)
    from hdbscan_tpu_torch.utils.flops import counter as _flops

    rt, ct, n_pad = _tile_sizes(n, row_tile, col_tile)
    _flops.add_scan(_round_up(m, rt), n_pad, d, row_tile=rt)
    dd, _ = knn_kbest_panel(q, x, k, metric, form, col_tile=ct)
    if min_pts <= 1:
        return np.zeros(m, np.float64)
    return dd[:, min(k, n) - 1].cpu().numpy().astype(np.float64)


class BoruvkaScanner:
    """Device-resident state for repeated Borůvka rounds over one dataset
    (the reference's ``BoruvkaScanner`` without a mesh): the points and
    core distances stay on the device in ``dtype`` (float64 only on the
    CPU), only the (n,) component labels go up and the per-row winners come
    back each round. Every round is one launch of the segment-min kernel
    (``ops/cuda_segmin``; its plain version on the CPU), in the distance
    form the reference's tiles pick. ``walls`` holds the last round's
    (scan s, fetch s)."""

    def __init__(self, data: np.ndarray, core: np.ndarray, metric: str = "euclidean",
                 row_tile: int = 1024, col_tile: int = 8192, *, device, dtype=np.float32):
        self.n, self.d = np.shape(data)
        self.metric = metric
        self.row_tile, self.col_tile = row_tile, col_tile
        self.device = torch.device(device)
        check_dtype(dtype, self.device)
        self._data = torch.as_tensor(np.asarray(data, dtype), device=device)
        self._core = torch.as_tensor(np.asarray(core, dtype), device=device)
        self._valid = torch.ones(self.n, dtype=torch.bool, device=device)
        self.walls = (0.0, 0.0)

    def min_outgoing(self, comp: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(best_w float64, best_j int64) per point: the lightest edge
        leaving the point's component, (+inf, -1) where none."""
        import time

        from hdbscan_tpu_torch.ops.cuda_segmin import min_outgoing_all_rows
        from hdbscan_tpu_torch.utils.flops import counter as _flops

        _, _, n_pad = _tile_sizes(self.n, self.row_tile, self.col_tile)
        _flops.add_scan(n_pad, n_pad, self.d, row_tile=self.row_tile)
        t0 = time.monotonic()
        comp_t = torch.as_tensor(np.asarray(comp, np.int32), device=self.device)
        bw, bj = min_outgoing_all_rows(
            self._data, self._core, comp_t, self._valid, self.metric,
            self.row_tile, self.col_tile,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.monotonic()
        bw, bj = bw.cpu().numpy().astype(np.float64), bj.cpu().numpy().astype(np.int64)
        self.walls = (t1 - t0, time.monotonic() - t1)
        return bw, bj


def boruvka_glue_edges(
    data: np.ndarray,
    groups: np.ndarray,
    metric: str = "euclidean",
    core: np.ndarray | None = None,
    row_tile: int = 1024,
    col_tile: int = 8192,
    max_rounds: int = 64,
    scan_backend: str = "host",
    fit_sharding: str = "replicated",
    trace=None,
    *,
    device,
    mesh=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact inter-group MST "glue" edges: Borůvka rounds seeded with
    ``groups`` as components, run to connectivity (the reference's
    ``boruvka_glue_edges``). Every harvested edge is a true MST edge of
    ``data`` under mutual reachability (plain distance when ``core`` is
    None). Returns (u, v, w) in local indices of ``data``, tie-broken by
    (w, u, v) through ``utils/unionfind.contract_min_edges``.

    The engine, in the reference's order: ``fit_sharding`` resolving
    "sharded" takes ``parallel/shard.ShardBoruvkaScanner`` over ``mesh``,
    else ``scan_backend`` resolving "ring" ``parallel/ring.
    RingBoruvkaScanner`` (both: B9 per shard and visiting panel; with no
    mesh, every visible card, or one shard on ``device`` off the card),
    else :class:`BoruvkaScanner` on ``device``. The edges are the same
    across engines."""
    from hdbscan_tpu_torch.parallel.ring import RingBoruvkaScanner, resolve_scan_backend
    from hdbscan_tpu_torch.parallel.shard import ShardBoruvkaScanner, resolve_fit_sharding
    from hdbscan_tpu_torch.utils.unionfind import contract_min_edges

    n = len(data)
    if core is None:
        core = np.zeros(n)
    dense = np.unique(np.asarray(groups, np.int64), return_inverse=True)[1]
    n_comp = int(dense.max()) + 1
    if n_comp == 1:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float64)
    if resolve_fit_sharding(fit_sharding, mesh) == "sharded":
        scanner = ShardBoruvkaScanner(data, core, metric, row_tile, col_tile,
                                      mesh=scan_mesh(mesh, device), trace=trace)
    elif resolve_scan_backend(scan_backend, mesh) == "ring":
        scanner = RingBoruvkaScanner(data, core, metric, row_tile, col_tile,
                                     mesh=scan_mesh(mesh, device), trace=trace)
    else:
        scanner = BoruvkaScanner(data, core, metric, row_tile, col_tile, device=device)
    # Seed components with the groups (first member = representative).
    order0 = np.argsort(dense, kind="stable")
    firsts = np.concatenate([[True], np.diff(dense[order0]) != 0])
    comp = order0[firsts][dense]
    eu, ev, ew = [], [], []
    for _ in range(max_rounds):
        if n_comp <= 1:
            break
        bw, bj = scanner.min_outgoing(comp)
        emit, comp, n_comp = contract_min_edges(comp, bj, bw)
        if len(emit) == 0:
            break
        eu.append(emit)
        ev.append(bj[emit])
        ew.append(bw[emit])
    close = getattr(scanner, "close", None)
    if close is not None:  # the sharded scanners' row shards go now
        close()
    return (
        np.concatenate(eu) if eu else np.zeros(0, np.int64),
        np.concatenate(ev) if ev else np.zeros(0, np.int64),
        np.concatenate(ew) if ew else np.zeros(0, np.float64),
    )


def scan_mesh(mesh, device):
    """The mesh a ring or sharded scan runs on: ``mesh`` when given, else
    every visible card, or one shard on ``device`` when that is not a
    card; in a wired process (``parallel/distributed``) the global mesh of
    every rank's ``device``."""
    from hdbscan_tpu_torch.parallel.distributed import already_initialized
    from hdbscan_tpu_torch.parallel.mesh import get_mesh

    if mesh is not None:
        return mesh
    device = torch.device(device)
    if device.type == "cuda" and not already_initialized():
        return get_mesh()
    return get_mesh([device])


def _min_outgoing_panel_scan(rows, core_r, comp_r, valid_r, panel, core_c, comp_c,
                             valid_c, metric: str, form: str | None,
                             col_tile: int | None = None, col_offset: int = 0):
    """Plain PyTorch Borůvka scan of resident ``rows`` against a column
    ``panel``: per row, the minimum mutual-reachability edge to a valid
    panel column in another component.

    ``rows`` (r, d) / ``panel`` (c, d) float32 (float64 on the CPU) with
    their (core, comp int32, valid bool) vectors. Returns ((r,) best_w, (r,)
    int32 best_j): ``best_j`` is the lowest panel column reaching the row
    minimum (``torch.min`` returns the first minimal index), (+inf, -1)
    where no outgoing edge exists or the row is not valid.

    ``col_tile``: the reference scan's column tile (global column =
    ``col_offset`` + panel column). Its per-tile minimum propagates a NaN
    weight (a zero-norm point at cosine) and keeps a tile's minimum only
    under a strict ``<``, so a row takes nothing from a tile where one of
    its outgoing weights is NaN; this scan drops those tiles alike.
    """
    r, c = rows.shape[0], panel.shape[0]
    best_w = torch.full((r,), float("inf"), dtype=rows.dtype, device=rows.device)
    best_j = torch.full((r,), -1, dtype=torch.int32, device=rows.device)
    if c == 0:
        return best_w, best_j
    block = max(1, _PLAIN_BLOCK_ELEMS // c)
    inf = torch.tensor(float("inf"), dtype=rows.dtype, device=rows.device)
    for a in range(0, r, block):
        b = min(a + block, r)
        dist = pairwise_distance(rows[a:b], panel, metric, form)
        w = torch.maximum(dist, torch.maximum(core_r[a:b, None], core_c[None, :]))
        out = (comp_r[a:b, None] != comp_c[None, :]) & valid_c[None, :] & valid_r[a:b, None]
        w = torch.where(out, w, inf)
        nan = torch.isnan(w)
        if col_tile is not None and bool(nan.any()):
            tiles = ((col_offset + torch.arange(c, device=w.device)) // col_tile).expand(b - a, c)
            hit = torch.zeros((b - a, int(tiles[0, -1]) + 1), dtype=torch.int32, device=w.device)
            hit = hit.scatter_reduce(1, tiles, nan.to(torch.int32), "amax")
            w = torch.where(torch.gather(hit, 1, tiles) > 0, inf, w)
        tw, tj = torch.min(w, dim=1)
        best_w[a:b] = tw
        best_j[a:b] = torch.where(torch.isfinite(tw), tj.to(torch.int32), -1)
    return best_w, best_j


def _min_outgoing_scan(data, core, comp, valid, metric: str, form: str | None,
                       col_tile: int | None = None):
    """Plain PyTorch Borůvka scan over all rows (the square case of
    :func:`_min_outgoing_panel_scan`): ``data`` (n, d) float32, ``core``
    (n,) float32, ``comp`` (n,) int32 labels, ``valid`` (n,) bool; returns
    ((n,) best_w, (n,) int32 best_j)."""
    return _min_outgoing_panel_scan(
        data, core, comp, valid, data, core, comp, valid, metric, form, col_tile
    )

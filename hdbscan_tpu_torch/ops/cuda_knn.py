"""K2 ``knn_kbest``: the fused k-NN scan on the card, square and
rectangular, and its plain version.

The port of the TPU kernel ``hdbscan_tpu/ops/pallas_knn.py``
``knn_fused_pallas`` and of the XLA scan ``ops/tiled._knn_core_scan``:
every query row's k nearest columns as (distance, id), ascending in the
(distance, id) lexicographic order of ``ops/lexmerge``. Every k >= 1 and
d >= 1.

The kernel is ``csrc/knn_kbest.cu``; its header has the design. It is bound
by the pair distances on the FP32 pipes, and what holds it back is latency,
so the design keeps warps resident. At d <= 32 a thread holds 2 rows (1
past k = 16, where a block's lists would pass 32 KB) and takes two columns
a step (above, 1 and 1), each column's features read once from shared
memory. Its lists lie in shared memory, k slots a row; an insert finds its
slot by bisection and moves the entries behind it in batches. A root is
taken only for a pair under a row's admission bound. Where the row
blocks alone are fewer than about four an SM, the columns are cut into
spans over a second grid axis, and a second pass merges a row's span lists
in order: :func:`_scratch` allocates their scratch here, and the merged
list is the single scan's, bit for bit. Past k or d = 128 the kernel runs
its wide mode: features in chunks, the list in the output row.

:func:`knn_kbest` scans every row of a point set against all of them, self
included; :func:`knn_kbest_panel` scans query rows against one column panel
whose ids start at an offset — what the ring k-NN scan
(``parallel/ring.py``) runs for every visiting panel, the port of the
reference's per-panel ``knn_fused_pallas(q, xt, colmask)`` launch. Each
launches the kernel for a CUDA tensor and runs its plain version for a CPU
tensor; nothing else picks the route.

Cosine and pearson (metric code 6; pearson's rows centred once by the
wrapper, ``cuda_build.kernel_points``) follow the reference's XLA scan
(``ops/tiled._knn_core_scan``) where a point has zero norm: its distances
are NaN, and ``lax.top_k`` over a column tile ranks the NaN first (the
negated NaN of 1 - 0 / 0 is the largest float in its total order), so in
that tile it takes one of the kk = min(k, tile) slots, and the merge then
drops it behind every number. Given ``col_tile`` (the reference's tile
width), :func:`_zero_pieces` cuts the columns where a tile holds m
zero-norm columns: the runs of other tiles keep k slots, such a tile kk - m;
each piece is one rectangular launch, and the kernel's merge pass
(``knn_kbest_merge``) folds the pieces' lists in column order into the
lex k-best of their union, the reference's list. A zero-norm row's
distances are all NaN, and NaN passes no admission test: its list stays
(+inf, -1), as the reference's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hdbscan_tpu_torch.core.distances import pairwise_distance, zero_rows
from hdbscan_tpu_torch.ops import cuda_build
from hdbscan_tpu_torch.ops.lexmerge import lex_kbest, merge_sorted_k

#: Plain version: rows per block so one (rows, columns) distance block
#: stays under this many elements.
_PLAIN_BLOCK_ELEMS = 1 << 26


def _panel_plain(q: torch.Tensor, x: torch.Tensor, k: int, metric: str, form: str | None,
                 id_offset: int):
    """Plain PyTorch k-best of query rows ``q`` against the columns ``x``:
    row blocks against all columns, exact lex selection
    (``ops/lexmerge.lex_kbest``), column ids shifted by ``id_offset``."""
    n, m = q.shape[0], x.shape[0]
    out_d = torch.empty((n, k), dtype=q.dtype, device=q.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=q.device)
    block = max(1, _PLAIN_BLOCK_ELEMS // max(m, 1))
    for a in range(0, n, block):
        dist = pairwise_distance(q[a : a + block], x, metric, form)
        bd, bi = lex_kbest(dist, k)
        out_d[a : a + block] = bd
        out_i[a : a + block] = torch.where(bi >= 0, bi + id_offset, bi)
    return out_d, out_i


def knn_kbest_panel_plain(q: torch.Tensor, x: torch.Tensor, k: int,
                          metric: str = "euclidean", form: str | None = "diff",
                          id_offset: int = 0, col_tile: int | None = None):
    """Plain version of :func:`knn_kbest_panel` (no ``n_cols``): the same
    pieces where ``col_tile`` makes the zero-norm rule apply, each a plain
    k-best, merged by stable merges."""
    q, _ = cuda_build.kernel_points(q, metric)
    x, metric = cuda_build.kernel_points(x, metric)
    pieces = _zero_pieces(x, metric, k, col_tile, id_offset)
    if pieces is not None:
        return _by_pieces(q, x, k, metric, form, pieces, id_offset, plain=True)
    return _panel_plain(q, x, k, metric, form, id_offset)


def knn_kbest_plain(x: torch.Tensor, k: int, metric: str = "euclidean",
                    form: str | None = "diff", col_tile: int | None = None):
    """Plain PyTorch k-best of every row of ``x`` against all of ``x``."""
    return knn_kbest_panel_plain(x, x, k, metric, form, 0, col_tile)


def _check(name: str, q: torch.Tensor, x: torch.Tensor, k: int) -> None:
    """Shapes and types: float32, or float64 on the CPU (the plain version
    runs in the asked type there, as the reference's XLA scan does)."""
    types = (torch.float32, torch.float64) if q.device.type == "cpu" else (torch.float32,)
    for t in (q, x):
        if t.dim() != 2 or t.dtype not in types or t.dtype != q.dtype:
            raise ValueError(f"{name}: expected (n, d) float32, got {tuple(t.shape)} {t.dtype}")
    if q.shape[1] != x.shape[1]:
        raise ValueError(f"{name}: queries and columns differ in d")
    if k < 1 or q.shape[1] < 1:
        raise ValueError(f"{name}: needs k >= 1 and d >= 1, got k={k}, d={q.shape[1]}")


def _scratch(dev, nq: int, nx: int, d: int, k: int, ids: bool):
    """The column splits of one launch (``knn_kbest_splits`` of the kernel)
    and the scratch pointers for its span lists: ``splits x nq x k``
    distances (and ids with ``ids``), null where it does not split."""
    splits = cuda_build.function("knn_kbest.cu", "knn_kbest_splits", [ctypes.c_int] * 5)(
        nq, nx, d, k, int(ids))
    if splits == 1:
        return splits, (), (0, 0)
    sd = torch.empty(splits * nq * k, dtype=torch.float32, device=dev)
    si = torch.empty(splits * nq * k, dtype=torch.int32, device=dev) if ids else None
    return splits, (sd, si), (sd.data_ptr(), si.data_ptr() if ids else 0)


def _zero_pieces(x: torch.Tensor, metric: str, k: int, col_tile: int | None,
                 id_offset: int):
    """The column pieces of the reference's NaN rule (module docstring):
    [(start, stop, slots)] in column order, local to ``x`` (global id =
    ``id_offset`` + local), tiles of ``col_tile`` global columns; None where
    no column has zero norm (one launch suffices). One host read."""
    if col_tile is None or metric not in ("cosine", "pearson"):
        return None
    z = zero_rows(x, metric)
    if not bool(z.any()):
        return None
    pos = torch.nonzero(z).flatten().cpu().numpy() + id_offset
    tiles, counts = np.unique(pos // col_tile, return_counts=True)
    kk, m = min(k, col_tile), x.shape[0]
    pieces, a = [], 0
    for t, c in zip(tiles.tolist(), counts.tolist()):
        t0 = max(0, t * col_tile - id_offset)
        t1 = min(m, (t + 1) * col_tile - id_offset)
        if t0 > a:
            pieces.append((a, t0, k))
        if kk > c:
            pieces.append((t0, t1, kk - c))
        a = t1
    if a < m:
        pieces.append((a, m, k))
    return pieces


def _merge_lists(lists, k: int, plain: bool):
    """The pieces' (rows, k) lists, in column order, into one lex k-best
    list: a fold of stable merges (``lexmerge.merge_sorted_k``) in the plain
    version, else the kernel's merge pass."""
    bd, bi = lists[0]
    if plain:
        for td, ti in lists[1:]:
            bd, bi = merge_sorted_k(bd, bi, td, ti, k)
        return bd, bi
    dev = cuda_build.launch_device("knn_kbest_merge", *(t for pair in lists for t in pair))
    nq = bd.shape[0]
    pd = torch.stack([d.t() for d, _ in lists]).contiguous()  # [piece][slot][row]
    pi = torch.stack([i.t() for _, i in lists]).contiguous()
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    cuda_build.launch("knn_kbest_merge", dev, pd.data_ptr(), pi.data_ptr(), len(lists), nq, k,
                      out_d.data_ptr(), out_i.data_ptr())
    return out_d, out_i


def _by_pieces(q, x, k: int, metric: str, form, pieces, id_offset: int, plain: bool):
    """One rectangular k-best a piece (its slots, padded to k with (+inf,
    -1)), merged in column order: plain versions, or kernel launches."""
    lists = []
    for a, b, slots in pieces:
        if plain:
            td, ti = _panel_plain(q, x[a:b], slots, metric, form, id_offset + a)
        else:
            td, ti = knn_kbest_panel(q, x[a:b], slots, metric, form, id_offset + a)
        if slots < k:
            pad = (q.shape[0], k - slots)
            td = torch.cat([td, torch.full(pad, float("inf"), dtype=td.dtype, device=td.device)], 1)
            ti = torch.cat([ti, torch.full(pad, -1, dtype=ti.dtype, device=ti.device)], 1)
        lists.append((td, ti))
    if not lists:  # every tile's zero-norm columns take all its slots
        return (torch.full((q.shape[0], k), float("inf"), dtype=q.dtype, device=q.device),
                torch.full((q.shape[0], k), -1, dtype=torch.int32, device=q.device))
    return _merge_lists(lists, k, plain)


def knn_kbest(x: torch.Tensor, k: int, metric: str = "euclidean",
              form: str | None = "diff", col_tile: int | None = None):
    """(n, d) float32 points -> ((n, k) float32 distances, (n, k) int32 ids),
    each row's k nearest columns by (distance, id), (+inf, -1) past n.

    ``form`` is the euclidean distance form ("diff" or "dot"), ignored by
    the other metrics. ``col_tile``: the reference scan's column tile, whose
    NaN rule cosine and pearson follow where a point has zero norm (module
    docstring). A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (and raises if it cannot).
    """
    _check("knn_kbest", x, x, k)
    if x.device.type == "cpu":
        return knn_kbest_plain(x, k, metric, form, col_tile)
    x, metric = cuda_build.kernel_points(x, metric)
    pieces = _zero_pieces(x, metric, k, col_tile, 0)
    if pieces is not None:
        return _by_pieces(x, x, k, metric, form, pieces, 0, plain=False)
    dev = cuda_build.launch_device("knn_kbest", x)
    n, d = x.shape
    code = cuda_build.metric_code(metric, form)
    x = x.contiguous()
    out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
    splits, _bufs, ptrs = _scratch(dev, n, n, d, k, ids=True)
    cuda_build.launch(
        "knn_kbest", dev, x.data_ptr(), n, d, k, code, splits, *ptrs, out_d.data_ptr(),
        out_i.data_ptr(), wide=max(k, d) > cuda_build.WIDE,
    )
    return out_d, out_i


def knn_kbest_panel(q: torch.Tensor, x: torch.Tensor, k: int, metric: str = "euclidean",
                    form: str | None = "diff", id_offset: int = 0,
                    n_cols: int | None = None, col_tile: int | None = None):
    """Query rows ``q`` (r, d) against a column panel ``x`` (c, d) whose
    column t has the global id ``id_offset + t``; ids at or past ``n_cols``
    (padding) are not scanned. Returns ((r, k) float32 distances, (r, k)
    int32 global ids), each row's k nearest panel columns by (distance, id),
    (+inf, -1) in slots the panel cannot fill. ``col_tile``: as
    :func:`knn_kbest`'s, tiles counted from global id 0."""
    _check("knn_kbest_panel", q, x, k)
    if n_cols is not None:
        x = x[: max(0, min(x.shape[0], n_cols - id_offset))]
    if q.device.type == "cpu":
        return knn_kbest_panel_plain(q, x, k, metric, form, id_offset, col_tile)
    q, _ = cuda_build.kernel_points(q, metric)
    x, metric = cuda_build.kernel_points(x, metric)
    pieces = _zero_pieces(x, metric, k, col_tile, id_offset)
    if pieces is not None:
        return _by_pieces(q, x, k, metric, form, pieces, id_offset, plain=False)
    dev = cuda_build.launch_device("knn_kbest_panel", q, x)
    (r, d), c = q.shape, x.shape[0]
    code = cuda_build.metric_code(metric, form)
    q, x = q.contiguous(), x.contiguous()
    out_d = torch.empty((r, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((r, k), dtype=torch.int32, device=dev)
    splits, _bufs, ptrs = _scratch(dev, r, c, d, k, ids=True)
    cuda_build.launch(
        "knn_kbest_panel", dev, q.data_ptr(), r, x.data_ptr(), c, d, k, code, id_offset,
        splits, *ptrs, out_d.data_ptr(), out_i.data_ptr(), wide=max(k, d) > cuda_build.WIDE,
    )
    return out_d, out_i


def kbest_core_distances(data: np.ndarray, min_pts: int, k: int, metric: str,
                         form: str | None, fetch_knn: bool, return_indices: bool,
                         device=None, col_tile: int | None = None, dtype=np.float32):
    """One k-best launch over host ``data`` (cast to ``dtype``), returned
    under the reference's core-distance contract: ``(core, knn)``,
    ``(core, None)`` with ``fetch_knn=False``, or ``(core, knn, idx)`` with
    ``return_indices``. ``core`` is column ``min(max(min_pts - 1, 1), n) -
    1`` of the k-best distances as float64 (zeros for ``min_pts <= 1``).
    ``col_tile``: the reference scan's column tile (:func:`knn_kbest`)."""
    n = len(data)
    x = torch.as_tensor(np.asarray(data, dtype), device=cuda_build.resolve_device(device))
    dd, ii = knn_kbest(x, k, metric, form, col_tile)
    if min_pts <= 1:
        core = np.zeros(n, np.float64)
    else:
        core = dd[:, min(max(min_pts - 1, 1), n) - 1].cpu().numpy().astype(np.float64)
    if not (fetch_knn or return_indices):
        return core, None
    knn = dd.cpu().numpy().astype(np.float64)
    if return_indices:
        return core, knn, ii.cpu().numpy().astype(np.int64)
    return core, knn


def knn_core_distances_fused(
    data: np.ndarray,
    min_pts: int,
    k: int | None = None,
    fetch_knn: bool = True,
    return_indices: bool = False,
    device=None,
):
    """Port of ``pallas_knn.knn_core_distances_fused`` (``order="scan"``):
    the k-best in the fused TPU kernel's full-f32 dot form, with the same
    return contract — ``(core, knn)``, ``(core, None)`` with
    ``fetch_knn=False``, or ``(core, knn, idx)`` with ``return_indices``.
    """
    k = max(k or 0, max(min_pts - 1, 1))
    return kbest_core_distances(
        data, min_pts, k, "euclidean", "dot", fetch_knn, return_indices, device
    )

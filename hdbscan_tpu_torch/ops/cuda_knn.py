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
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hdbscan_tpu_torch.core.distances import pairwise_distance
from hdbscan_tpu_torch.ops import cuda_build
from hdbscan_tpu_torch.ops.lexmerge import lex_kbest

#: Plain version: rows per block so one (rows, columns) distance block
#: stays under this many elements.
_PLAIN_BLOCK_ELEMS = 1 << 26


def knn_kbest_panel_plain(q: torch.Tensor, x: torch.Tensor, k: int,
                          metric: str = "euclidean", form: str | None = "diff",
                          id_offset: int = 0):
    """Plain PyTorch k-best of query rows ``q`` against the columns ``x``:
    row blocks against all columns, exact lex selection
    (``ops/lexmerge.lex_kbest``), column ids shifted by ``id_offset``."""
    n, m = q.shape[0], x.shape[0]
    out_d = torch.empty((n, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=q.device)
    block = max(1, _PLAIN_BLOCK_ELEMS // max(m, 1))
    for a in range(0, n, block):
        dist = pairwise_distance(q[a : a + block], x, metric, form)
        bd, bi = lex_kbest(dist, k)
        out_d[a : a + block] = bd
        out_i[a : a + block] = torch.where(bi >= 0, bi + id_offset, bi)
    return out_d, out_i


def knn_kbest_plain(x: torch.Tensor, k: int, metric: str = "euclidean",
                    form: str | None = "diff"):
    """Plain PyTorch k-best of every row of ``x`` against all of ``x``."""
    return knn_kbest_panel_plain(x, x, k, metric, form)


def _check(name: str, q: torch.Tensor, x: torch.Tensor, k: int) -> None:
    for t in (q, x):
        if t.dim() != 2 or t.dtype != torch.float32:
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


def knn_kbest(x: torch.Tensor, k: int, metric: str = "euclidean",
              form: str | None = "diff"):
    """(n, d) float32 points -> ((n, k) float32 distances, (n, k) int32 ids),
    each row's k nearest columns by (distance, id), (+inf, -1) past n.

    ``form`` is the euclidean distance form ("diff" or "dot"), ignored by
    the other metrics. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (and raises if it cannot).
    """
    _check("knn_kbest", x, x, k)
    if x.device.type == "cpu":
        return knn_kbest_plain(x, k, metric, form)
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
                    n_cols: int | None = None):
    """Query rows ``q`` (r, d) against a column panel ``x`` (c, d) whose
    column t has the global id ``id_offset + t``; ids at or past ``n_cols``
    (padding) are not scanned. Returns ((r, k) float32 distances, (r, k)
    int32 global ids), each row's k nearest panel columns by (distance, id),
    (+inf, -1) in slots the panel cannot fill."""
    _check("knn_kbest_panel", q, x, k)
    if n_cols is not None:
        x = x[: max(0, min(x.shape[0], n_cols - id_offset))]
    if q.device.type == "cpu":
        return knn_kbest_panel_plain(q, x, k, metric, form, id_offset)
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
                         device=None):
    """One k-best launch over host ``data``, returned under the reference's
    core-distance contract: ``(core, knn)``, ``(core, None)`` with
    ``fetch_knn=False``, or ``(core, knn, idx)`` with ``return_indices``.
    ``core`` is column ``min(max(min_pts - 1, 1), n) - 1`` of the k-best
    distances as float64 (zeros for ``min_pts <= 1``)."""
    n = len(data)
    x = torch.as_tensor(np.asarray(data, np.float32), device=cuda_build.resolve_device(device))
    dd, ii = knn_kbest(x, k, metric, form)
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

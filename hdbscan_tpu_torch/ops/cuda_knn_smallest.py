"""B3 ``knn_smallest``: the k smallest squared euclidean distances of every
row, without ids, on the card — and its plain version.

The port of the TPU kernel ``hdbscan_tpu/ops/pallas_knn.py``
``knn_smallest_pallas`` (``_knn_kernel``) and of its entry point
``knn_core_distances_pallas``: per row, the k smallest squared distances
to all points, self included, ascending, in the difference form (one
feature at a time, exact on duplicates) or the dot form
``max(|x|^2 + |y|^2 - 2 x.y, 0)``. The reference's ``knn_backend=auto``
takes it for euclidean data at d >= 24 on a TPU (``ops/tiled.py:315-353``);
the port takes it there when the points are on the card.

Route: a mode of the k-best kernel (``csrc/knn_kbest.cu``), not a second
body, built without ids (a compile-time flag: its lists hold values only).
The metric codes 4 and 5 (``cuda_build.SQ_EUCLID_CODES``) select on the
squared distance with no root. A column enters a row's list only when
strictly smaller than the current k-th value, after every entry of equal
value: that keeps exactly the k smallest values with their multiplicity,
equal values in column order, whatever the column order of the scan. So
the reference's diagonal schedule and whole-tile skip, which change only
which tiles it merges, are not carried over. What bounds it is the pair
distances on the FP32 pipes. A thread holds 2 rows at d <= 32 (1 above,
or past k = 32), its lists of k values in shared memory; where the row blocks alone do not
fill the card, column spans are merged in order in a second pass, stable on
equal values, with scratch allocated here (``cuda_knn._scratch``). The norms
and the cross term accumulate feature by feature in ascending order, the
arithmetic the K2 dot form already holds bitwise to its plain version.

:func:`knn_core_distances_pallas` keeps the reference's contract: ``(core,
knn)`` or ``(core, None)``, the square root taken in float64 on the host
from the float32 squared distance, the ``d >= 64`` column-tile rule, the
``k``/``d`` <= 128 refusals, and ``order="diag"``'s Morton permutation of
the rows (a copy of the reference's :func:`morton_order`) with the
unpermute after the scan.
"""

from __future__ import annotations

import numpy as np
import torch

from hdbscan_tpu_torch.core.distances import _sq_euclidean
from hdbscan_tpu_torch.ops import cuda_build
from hdbscan_tpu_torch.ops.cuda_knn import _scratch

#: The reference kernel's default tiles and its 128-lane feature and k axes.
ROW_TILE = 256
COL_TILE = 2048
LANES = 128

#: Plain version: rows per block so one (rows, n) squared-distance block
#: stays under this many elements.
_PLAIN_BLOCK_ELEMS = 1 << 26


def morton_order(data: np.ndarray, max_dims: int = 21) -> np.ndarray:
    """Host z-curve (Morton) sort permutation (a copy of the reference's):
    each of the first ``max_dims`` features quantized to ``63 // d`` bits,
    the bits interleaved into one uint64 key, a stable argsort."""
    x = np.asarray(data, np.float64)
    d = min(x.shape[1], max_dims)
    x = x[:, :d]
    b = max(1, 63 // d)
    lo, hi = x.min(axis=0), x.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    q = ((x - lo) / span * ((1 << b) - 1)).astype(np.uint64)
    bits = np.arange(b, dtype=np.uint64)
    out_shift = (bits[None, :] * np.uint64(d) + np.arange(d, dtype=np.uint64)[:, None])
    code = np.empty(len(x), np.uint64)
    chunk = max(1, (128 << 20) // (d * b * 8))
    for lo_i in range(0, len(x), chunk):
        qc = q[lo_i : lo_i + chunk]
        spread = ((qc[:, :, None] >> bits[None, None, :]) & np.uint64(1)) << out_shift
        code[lo_i : lo_i + chunk] = np.bitwise_or.reduce(spread.reshape(len(qc), -1), axis=1)
    return np.argsort(code, kind="stable")


def knn_smallest_plain(x: torch.Tensor, k: int, form: str = "diff",
                       q: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch B3: row blocks of squared distances against all rows
    (``core/distances._sq_euclidean``, the kernel's arithmetic), the k
    smallest values per row ascending, +inf past n. ``q`` takes those rows
    only (leading rows of ``x``, by default all of them)."""
    n = x.shape[0]
    q = x if q is None else q
    out = torch.full((q.shape[0], k), float("inf"), dtype=torch.float32, device=x.device)
    kk = min(k, n)
    block = max(1, _PLAIN_BLOCK_ELEMS // max(n, 1))
    for a in range(0, q.shape[0], block):
        d2 = _sq_euclidean(q[a : a + block], x, form)
        out[a : a + block, :kk] = torch.topk(d2, kk, dim=1, largest=False, sorted=True).values
    return out


def knn_smallest(x: torch.Tensor, k: int, form: str = "diff") -> torch.Tensor:
    """(n, d) float32 points -> (n, k) float32: each row's k smallest
    squared euclidean distances (self included), ascending, +inf past n.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (and raises if it cannot).
    """
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"knn_smallest: expected (n, d) float32, got {tuple(x.shape)} {x.dtype}")
    n, d = x.shape
    if not 1 <= k <= LANES:
        raise ValueError(f"knn_smallest supports 1 <= k <= {LANES}, got {k}")
    if not 1 <= d <= LANES:
        raise ValueError(f"knn_smallest supports 1 <= d <= {LANES}, got {d}")
    if form not in cuda_build.SQ_EUCLID_CODES:
        raise ValueError(f"unknown euclidean form {form!r}: diff | dot")
    if x.device.type == "cpu":
        return knn_smallest_plain(x, k, form)
    dev = cuda_build.launch_device("knn_smallest", x)
    x = x.contiguous()
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    splits, _bufs, ptrs = _scratch(dev, n, n, d, k, ids=False)
    cuda_build.launch(
        "knn_smallest", dev, x.data_ptr(), n, d, k, cuda_build.SQ_EUCLID_CODES[form], splits,
        ptrs[0], out.data_ptr(),
    )
    return out


def knn_core_distances_pallas(
    data: np.ndarray,
    min_pts: int,
    k: int | None = None,
    row_tile: int = ROW_TILE,
    col_tile: int = COL_TILE,
    order: str = "diag",
    form: str = "diff",
    fetch_knn: bool = True,
    device=None,
):
    """Core distances through B3 (euclidean only): ``(core, knn)`` with
    ``knn`` the k smallest distances per point ascending, self included,
    and ``core`` the ``min_pts``-th smallest; ``(core, None)`` with
    ``fetch_knn=False``, which fetches only the k-th column. Distances are
    the float64 roots of the kernel's float32 squared distances.

    ``order="diag"`` sorts the rows by :func:`morton_order` before the scan
    and permutes the results back (the reference's schedule; the values do
    not depend on it), ``"scan"`` keeps the input order. The tiles are the
    reference kernel's; they set its schedule and its FLOP accounting only.
    """
    from hdbscan_tpu_torch.utils.flops import counter as _flops

    n, d = np.shape(data)
    if d > LANES:
        raise ValueError(f"pallas knn kernel supports d <= {LANES}, got {d}")
    k = max(k or 0, max(min_pts - 1, 1))
    if k > LANES:
        raise ValueError(f"pallas knn kernel supports k <= {LANES}, got {k}")
    if order not in ("diag", "scan"):
        raise ValueError(f"unknown column order {order!r}: diag | scan")
    if d >= 64 and col_tile > 1024:
        col_tile = 1024  # the reference's VMEM rule at high d
    data = np.asarray(data)
    perm = None
    if order == "diag":
        perm = morton_order(data)
        data = data[perm]
    n_pad = max(col_tile, row_tile)
    while n_pad < n:
        n_pad *= 2
    _flops.add_scan(n_pad, n_pad, d, row_tile=row_tile)
    x = torch.as_tensor(np.asarray(data, np.float32), device=cuda_build.resolve_device(device))
    d2 = knn_smallest(x, k, form)

    def unpermute(a):
        if perm is None:
            return a
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n)
        return a[inv]

    if not fetch_knn:
        kth_col = min(max(min_pts - 1, 1), n) - 1
        kth = np.sqrt(np.maximum(d2[:, kth_col].cpu().numpy().astype(np.float64), 0.0))
        core = np.zeros(n, np.float64) if min_pts <= 1 else unpermute(kth)
        return core, None
    knn = unpermute(np.sqrt(np.maximum(d2.cpu().numpy().astype(np.float64), 0.0)))
    if min_pts <= 1:
        core = np.zeros(n, np.float64)
    else:
        core = knn[:, min(min_pts - 1, n) - 1].copy()
    return core, knn

"""K2 ``knn_kbest``: the fused k-NN scan on the card, and its plain version.

The port of the TPU kernel ``hdbscan_tpu/ops/pallas_knn.py``
``knn_fused_pallas`` and of the XLA scan ``ops/tiled._knn_core_scan``:
every row's k nearest columns as (distance, id), ascending in the
(distance, id) lexicographic order of ``ops/lexmerge``, self included. The
kernel is ``csrc/knn_kbest.cu`` (one thread per row, a sorted k-list in
registers, columns in ascending tiles through shared memory; see its header
for the design and what bounds it).

:func:`knn_kbest` launches the kernel for a CUDA tensor and runs
:func:`knn_kbest_plain` for a CPU tensor; nothing else picks the route.
"""

from __future__ import annotations

import numpy as np
import torch

from hdbscan_tpu_torch.core.distances import pairwise_distance
from hdbscan_tpu_torch.ops import cuda_build
from hdbscan_tpu_torch.ops.lexmerge import lex_kbest

#: Largest k and feature count the kernel is built for (the reference's
#: 128-lane limit of the fused TPU kernel).
MAX_K = 128
MAX_D = 128

#: Plain version: rows per block so one (rows, n) distance block stays
#: under this many elements.
_PLAIN_BLOCK_ELEMS = 1 << 26


def knn_kbest_plain(x: torch.Tensor, k: int, metric: str = "euclidean",
                    form: str | None = "diff"):
    """Plain PyTorch k-best: row blocks against all columns, exact lex
    selection (``ops/lexmerge.lex_kbest``)."""
    n = x.shape[0]
    out_d = torch.empty((n, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=x.device)
    block = max(1, _PLAIN_BLOCK_ELEMS // max(n, 1))
    for a in range(0, n, block):
        dist = pairwise_distance(x[a : a + block], x, metric, form)
        out_d[a : a + block], out_i[a : a + block] = lex_kbest(dist, k)
    return out_d, out_i


def knn_kbest(x: torch.Tensor, k: int, metric: str = "euclidean",
              form: str | None = "diff"):
    """(n, d) float32 points -> ((n, k) float32 distances, (n, k) int32 ids),
    each row's k nearest columns by (distance, id), (+inf, -1) past n.

    ``form`` is the euclidean distance form ("diff" or "dot"), ignored by
    the other metrics. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (and raises if it cannot).
    """
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"knn_kbest: expected (n, d) float32, got {tuple(x.shape)} {x.dtype}")
    n, d = x.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_kbest supports 1 <= k <= {MAX_K}, got {k}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"knn_kbest supports 1 <= d <= {MAX_D}, got {d}")
    if x.device.type == "cpu":
        return knn_kbest_plain(x, k, metric, form)
    cuda_build.require_cuda(x, "knn_kbest")
    code = cuda_build.metric_code(metric, form)
    x = x.contiguous()
    out_d = torch.empty((n, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=x.device)
    cuda_build.launch(
        "knn_kbest", x.data_ptr(), n, d, k, code, out_d.data_ptr(), out_i.data_ptr()
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

"""K1 ``segmin``: the Borůvka per-row min-outgoing-edge kernel on the card.

The port of the TPU kernel ``hdbscan_tpu/ops/pallas_segmin.py``
``min_outgoing_pallas``: per row i, the minimum over valid columns j in
another component of ``max(d(i, j), core_i, core_j)``, the lowest such j on
ties, ``(+inf, -1)`` where none exists. The kernel is ``csrc/segmin.cu``
(one thread per row, columns in ascending tiles through shared memory,
strict ``<`` update; see its header for the design and what bounds it).
Its plain PyTorch version is ``ops/tiled._min_outgoing_scan``, the
counterpart of the reference's XLA oracle, re-exported here.

:func:`min_outgoing_all_rows` is what every Borůvka round calls: the
kernel for CUDA tensors, the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from hdbscan_tpu_torch.ops import cuda_build
from hdbscan_tpu_torch.ops.tiled import _min_outgoing_scan, scan_form

#: The plain version of the kernel.
min_outgoing_plain = _min_outgoing_scan

#: Largest feature count the kernel is built for.
MAX_D = 128


def segmin(data, core, comp, valid, metric: str = "euclidean",
           form: str | None = "diff"):
    """One launch of the segment-min kernel over all rows.

    ``data`` (n, d) float32, ``core`` (n,) float32, ``comp`` (n,) int32,
    ``valid`` (n,) bool, all on one CUDA device. Returns ((n,) float32
    best_w, (n,) int32 best_j).
    """
    for t, name in ((data, "data"), (core, "core"), (comp, "comp"), (valid, "valid")):
        cuda_build.require_cuda(t, f"segmin {name}")
    if data.dim() != 2:
        raise ValueError(f"segmin: data must be (n, d), got {tuple(data.shape)}")
    n, d = data.shape
    if any(t.shape != (n,) for t in (core, comp, valid)):
        raise ValueError("segmin: core, comp and valid must have shape (n,)")
    if data.dtype != torch.float32 or core.dtype != torch.float32:
        raise ValueError("segmin: data and core must be float32")
    if comp.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError("segmin: comp must be int32 and valid bool")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"segmin supports 1 <= d <= {MAX_D}, got {d}")
    code = cuda_build.metric_code(metric, form)
    data, core, comp = data.contiguous(), core.contiguous(), comp.contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    best_w = torch.empty(n, dtype=torch.float32, device=data.device)
    best_j = torch.empty(n, dtype=torch.int32, device=data.device)
    cuda_build.launch(
        "segmin", data.data_ptr(), core.data_ptr(), comp.data_ptr(),
        valid_u8.data_ptr(), n, d, code, best_w.data_ptr(), best_j.data_ptr(),
    )
    return best_w, best_j


def min_outgoing_all_rows(data, core, comp, valid, metric: str,
                          row_tile: int, col_tile: int):
    """One Borůvka round's candidates for every row, in the distance form
    the reference takes at the caller's tiles: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    form = scan_form(data.shape[0], data.shape[1], metric, row_tile, col_tile)
    if data.device.type == "cpu":
        return min_outgoing_plain(data, core, comp, valid, metric, form)
    return segmin(data, core, comp, valid, metric, form)

"""K1 ``segmin`` and B9 ``segmin_panel``: the Borůvka per-row
min-outgoing-edge kernel on the card, square and rectangular.

The port of the TPU kernels ``hdbscan_tpu/ops/pallas_segmin.py``
``min_outgoing_pallas`` and ``min_outgoing_panel`` (one ``_segmin_kernel``,
launched on a square and on a rectangle): per row i, the minimum over valid
columns j in another component of ``max(d(i, j), core_i, core_j)``, the
lowest such j on ties, ``(+inf, -1)`` where none exists, for any d. The
kernel is ``csrc/segmin.cu`` (column spans over a second grid axis combined
in a second pass, several rows a thread against columns through shared
memory, roots only for winners, a chunked feature loop past d = 128; see
its header for the design and what bounds it). The square launch passes
the same arrays as rows and columns; the panel launch takes a resident row
set and a visiting column panel, each with its own core, label and
validity vectors, and returns panel-local column ids. The plain PyTorch
versions are ``ops/tiled._min_outgoing_scan`` and ``ops/tiled._min_outgoing_panel_scan``,
re-exported here.

:func:`min_outgoing_all_rows` is what every single-device Borůvka round
calls and :func:`min_outgoing_panel` what every shard of the sharded rounds
calls per visiting panel: the kernel for CUDA tensors, the plain version
for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from hdbscan_tpu_torch.core.distances import euclidean_form
from hdbscan_tpu_torch.ops import cuda_build
from hdbscan_tpu_torch.ops.tiled import (
    _min_outgoing_panel_scan,
    _min_outgoing_scan,
    scan_form,
)

#: The plain versions of the kernel, square and rectangular.
min_outgoing_plain = _min_outgoing_scan
min_outgoing_panel_plain = _min_outgoing_panel_scan

#: The reference kernel's feature padding: operands are zero-padded to a
#: multiple of the TPU's 128 lanes before the distance tile is formed.
LANES = 128


def _check(name, x, core, comp, valid) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name}: points must be (n, d), got {tuple(x.shape)}")
    n = x.shape[0]
    if any(t.shape != (n,) for t in (core, comp, valid)):
        raise ValueError(f"{name}: core, comp and valid must have shape (n,)")
    if x.dtype != torch.float32 or core.dtype != torch.float32:
        raise ValueError(f"{name}: points and core must be float32")
    if comp.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError(f"{name}: comp must be int32 and valid bool")
    if x.shape[1] < 1:
        raise ValueError(f"{name}: points need d >= 1")


def _launch(name, dev, rows, cols, code):
    """One launch of the kernel: ``rows`` and ``cols`` are (points, core,
    comp, valid as uint8) on ``dev``, ``cols`` None for the square launch.
    The partials of the kernel's column spans go to scratch allocated here
    when it splits the columns."""
    r, d = rows[0].shape
    c = r if cols is None else cols[0].shape[0]
    splits = cuda_build.function("segmin.cu", "segmin_splits", [ctypes.c_int] * 3)(r, c, d)
    best_w = torch.empty(r, dtype=torch.float32, device=dev)
    best_j = torch.empty(r, dtype=torch.int32, device=dev)
    scratch = [torch.empty(splits * r if splits > 1 else 0, dtype=dt, device=dev)
               for dt in (torch.float32, torch.int32)]
    args = [t.data_ptr() for t in rows] + [r]
    if cols is not None:
        args += [t.data_ptr() for t in cols] + [c]
    args += [d, code, splits, *(t.data_ptr() if splits > 1 else 0 for t in scratch),
             best_w.data_ptr(), best_j.data_ptr()]
    cuda_build.launch(name, dev, *args, wide=d > cuda_build.WIDE)
    return best_w, best_j


def segmin(data, core, comp, valid, metric: str = "euclidean",
           form: str | None = "diff"):
    """One launch of the segment-min kernel over all rows.

    ``data`` (n, d) float32, ``core`` (n,) float32, ``comp`` (n,) int32,
    ``valid`` (n,) bool, all on one CUDA device. Returns ((n,) float32
    best_w, (n,) int32 best_j).
    """
    dev = cuda_build.launch_device("segmin", data, core, comp, valid)
    _check("segmin", data, core, comp, valid)
    code = cuda_build.metric_code(metric, form)
    data, core, comp = data.contiguous(), core.contiguous(), comp.contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    return _launch("segmin", dev, (data, core, comp, valid_u8), None, code)


def min_outgoing_all_rows(data, core, comp, valid, metric: str,
                          row_tile: int, col_tile: int):
    """One Borůvka round's candidates for every row, in the distance form
    the reference takes at the caller's tiles: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    form = scan_form(data.shape[0], data.shape[1], metric, row_tile, col_tile)
    if data.device.type == "cpu":
        return min_outgoing_plain(data, core, comp, valid, metric, form)
    return segmin(data, core, comp, valid, metric, form)


def panel_form(d: int, metric: str, row_tile: int, col_tile: int):
    """The euclidean form the reference's panel kernel takes: its distance
    tile is (row_tile, col_tile) over features zero-padded to the lanes."""
    if metric != "euclidean":
        return None
    d_pad = max(LANES, -(-d // LANES) * LANES)
    return euclidean_form(row_tile, col_tile, d_pad)


def min_outgoing_panel(rows, core_r, comp_r, valid_r, panel, core_c, comp_c,
                       valid_c, metric: str = "euclidean", row_tile: int = 1024,
                       col_tile: int = 8192, form: str | None = None):
    """B9: resident ``rows`` (r, d) against a visiting ``panel`` (c, d),
    each with its own (core, comp, valid) vectors. Returns ((r,) float32
    best_w, (r,) int32 best_j) with ``best_j`` local to the panel, (+inf,
    -1) where the panel holds no outgoing edge.

    ``form`` picks the euclidean distance form; None takes the one the
    reference kernel evaluates at ``row_tile`` x ``col_tile``
    (:func:`panel_form`). A CPU tensor runs the plain version; CUDA tensors
    launch the kernel (and raise if they cannot).
    """
    _check("min_outgoing_panel rows", rows, core_r, comp_r, valid_r)
    _check("min_outgoing_panel panel", panel, core_c, comp_c, valid_c)
    if rows.shape[1] != panel.shape[1]:
        raise ValueError("min_outgoing_panel: rows and panel differ in d")
    if form is None:
        form = panel_form(rows.shape[1], metric, row_tile, col_tile)
    args = (rows, core_r, comp_r, valid_r, panel, core_c, comp_c, valid_c)
    if rows.device.type == "cpu":
        return min_outgoing_panel_plain(*args, metric, form)
    dev = cuda_build.launch_device("segmin_panel", *args)
    code = cuda_build.metric_code(metric, form)
    rows, core_r, comp_r, panel, core_c, comp_c = (
        t.contiguous() for t in (rows, core_r, comp_r, panel, core_c, comp_c)
    )
    vr = valid_r.to(torch.uint8).contiguous()
    vc = valid_c.to(torch.uint8).contiguous()
    return _launch("segmin_panel", dev, (rows, core_r, comp_r, vr),
                   (panel, core_c, comp_c, vc), code)

"""Analytic FLOP/byte accounting for the windowed and tiled scans — the
port of the reference's ``utils/flops.py``.

Each dispatch site credits the process-wide :data:`counter` with the
analytic work of its scan (``2 * rows * cols * d`` distance FLOPs, the
column window re-read once per row tile), and phase boundaries
(``models/mr_hdbscan`` trace events) snapshot it to report achieved rates
(:func:`phase_stats`). Pad tiles (chunks padded to
``ops/blockscan._MIN_CHUNK_TILES``) go to a separate ``pad_flops`` bucket.

``mfu`` is reported against :data:`PEAK_FLOPS`, the FP32 rate of one
H100 SXM outside the tensor cores (the port's distance kernels run on the
FP32 pipes), not against any TPU figure.
"""

from __future__ import annotations

from dataclasses import dataclass

#: FP32 peak of one NVIDIA H100 SXM, outside the tensor cores (FLOP/s).
PEAK_FLOPS = 67e12


@dataclass
class ScanCounter:
    """Monotonic analytic counters; phases diff :meth:`snapshot` tuples."""

    flops: float = 0.0
    bytes: float = 0.0
    pad_flops: float = 0.0

    def add(self, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes

    def add_scan(self, rows: int, cols: int, d: int, itemsize: int = 4,
                 row_tile: int = 1) -> None:
        """Credit one streaming scan: ``rows`` row slots against ``cols``
        columns of ``d`` features, column window re-read once per row tile."""
        n_row_tiles = max(1, -(-rows // max(row_tile, 1)))
        self.add(
            2.0 * rows * cols * d,
            (n_row_tiles * cols * d + rows * d) * itemsize,
        )

    def add_pad_scan(self, rows: int, cols: int, d: int) -> None:
        """Credit pad-tile distance work (same model, separate bucket)."""
        self.pad_flops += 2.0 * rows * cols * d

    def snapshot(self) -> tuple[float, float, float]:
        return self.flops, self.bytes, self.pad_flops


#: The process-wide counter every dispatch site credits.
counter = ScanCounter()


def phase_stats(t0_snap: tuple, wall_s: float) -> dict:
    """Trace-field dict for a phase: FLOPs/bytes since ``t0_snap``, achieved
    GFLOP/s + GB/s, and MFU vs :data:`PEAK_FLOPS` (0 fields dropped)."""
    df = counter.flops - t0_snap[0]
    db = counter.bytes - t0_snap[1]
    dp = counter.pad_flops - t0_snap[2]
    if df <= 0 and db <= 0 and dp <= 0:
        return {}
    out = {"gflops": round(df / 1e9, 1), "gbytes": round(db / 1e9, 2)}
    if dp > 0:
        out["pad_gflops"] = round(dp / 1e9, 1)
    if wall_s > 0:
        out["gflops_s"] = round(df / wall_s / 1e9, 1)
        out["gbytes_s"] = round(db / wall_s / 1e9, 2)
        out["mfu"] = round(df / wall_s / PEAK_FLOPS, 6)
    return out

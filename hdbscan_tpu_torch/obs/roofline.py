"""Roofline / MFU report section: timelines joined with FLOP counters — the
port of ``hdbscan_tpu/obs/roofline.py``, read at the H100's peaks.

``utils/flops`` credits every dispatch site with analytic FLOPs and
modelled memory bytes; ``obs/timeline.TimelineRecorder`` measures
per-phase walls and attributes their comm share. This module joins the two
into the run report's ``roofline`` section (``hdbscan-tpu-report/3``): per
traced phase, achieved GFLOP/s, achieved GB/s, arithmetic intensity
(FLOPs/byte), MFU against :data:`~hdbscan_tpu_torch.utils.flops.PEAK_FLOPS`,
and a bound classification —

- ``comm`` when the timeline attributes >= ``COMM_BOUND_FRAC`` of the
  phase to panel hand-overs,
- ``compute`` when arithmetic intensity sits at or above the ridge point
  ``PEAK_FLOPS / PEAK_BYTES_S``,
- ``memory`` otherwise (including phases with bytes but no FLOPs).

The tags ride the section so a CPU smoke number can never pass for a
card's: ``cpu_smoke`` whenever the run's device is the CPU.
"""

from __future__ import annotations

__all__ = [
    "PEAK_BYTES_S",
    "COMM_BOUND_FRAC",
    "default_tags",
    "roofline_section",
]

#: HBM3 bandwidth of one H100 SXM (bytes/s, NVIDIA's public spec; the rate
#: ``PERF.md``'s bounds use). The roofline's ridge point is
#: ``PEAK_FLOPS / PEAK_BYTES_S``.
PEAK_BYTES_S = 3.35e12

#: A phase whose timeline attributes at least this fraction of its wall to
#: panel hand-overs classifies ``comm``-bound regardless of intensity.
COMM_BOUND_FRAC = 0.5


def default_tags(device=None) -> list[str]:
    """Honesty tags for a run on ``device`` (a ``torch.device`` or its
    name; None: the device an entry point defaults to, the card where one
    is visible): ``cpu_smoke`` when it is the CPU — rates from the plain
    PyTorch versions on the host are smoke figures, not the card's."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return ["cpu_smoke"] if torch.device(device).type == "cpu" else []


def classify_bound(intensity, ridge, comm_frac) -> str:
    """compute / memory / comm for one phase (see module docstring)."""
    if comm_frac is not None and comm_frac >= COMM_BOUND_FRAC:
        return "comm"
    if intensity is not None and intensity >= ridge:
        return "compute"
    return "memory"


def roofline_section(aggregates: dict, timeline_table: dict | None = None,
                     tags=None) -> dict | None:
    """Build the report's ``roofline`` section.

    ``aggregates`` is :func:`~hdbscan_tpu_torch.utils.telemetry.phase_aggregates`
    output (summed gflops/gbytes per stage); ``timeline_table`` is
    :meth:`~hdbscan_tpu_torch.obs.timeline.TimelineRecorder.phase_table`
    (or None when no timeline recorder ran). Phases appear when either
    side knows about them; a phase with neither FLOPs, bytes, nor a
    timeline row is skipped. Returns None when no phase qualifies (the
    section is omitted, not empty — the report convention)."""
    from hdbscan_tpu_torch.utils import flops as _flops

    timeline_table = timeline_table or {}
    tags = list(tags) if tags is not None else default_tags()
    ridge = _flops.PEAK_FLOPS / PEAK_BYTES_S
    phases: dict[str, dict] = {}
    for name in sorted(set(aggregates) | set(timeline_table)):
        agg = aggregates.get(name, {})
        tl = timeline_table.get(name, {})
        gflops = float(agg.get("gflops", 0.0) or 0.0)
        gbytes = float(agg.get("gbytes", 0.0) or 0.0)
        if gflops <= 0 and gbytes <= 0 and not tl:
            continue
        wall = float(tl.get("wall_s") or agg.get("wall_s", 0.0) or 0.0)
        comm_frac = tl.get("comm_frac")
        intensity = (
            round(gflops / gbytes, 6) if gflops > 0 and gbytes > 0 else None
        )
        row: dict = {
            "wall_s": round(wall, 9),
            "gflops": gflops,
            "gbytes": gbytes,
            "arithmetic_intensity": intensity,
            "bound": classify_bound(intensity, ridge, comm_frac),
        }
        if wall > 0:
            row["achieved_gflops_s"] = round(gflops / wall, 3)
            row["achieved_gbytes_s"] = round(gbytes / wall, 3)
            row["mfu"] = round(gflops * 1e9 / wall / _flops.PEAK_FLOPS, 9)
        if comm_frac is not None:
            row["comm_frac"] = comm_frac
        if tl.get("skew") is not None:
            row["skew"] = tl["skew"]
        if tl.get("comm_bytes") is not None:
            row["comm_bytes"] = int(tl["comm_bytes"])
        if tl.get("rounds") is not None:
            row["rounds"] = int(tl["rounds"])
            row["devices"] = int(tl.get("devices", 0))
        phases[name] = row
    if not phases:
        return None
    return {
        "peak_gflops_s": round(_flops.PEAK_FLOPS / 1e9, 3),
        "peak_gbytes_s": round(PEAK_BYTES_S / 1e9, 3),
        "ridge_intensity": round(ridge, 6),
        "tags": tags,
        "phases": phases,
    }

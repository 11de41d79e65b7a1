"""Run telemetry: manifests, reports, memory and build tracking, host merge
— the port of ``hdbscan_tpu/utils/telemetry.py``.

The durable half of the observability layer (``utils/tracing.py`` is the
in-process half): a run can persist (1) a JSONL event trace per process
(:class:`~hdbscan_tpu_torch.utils.tracing.JsonlSink`), and (2) one JSON
**run report** (``hdbscan-tpu-report/3``, the reference's schema) tying
together a manifest (config, resolved backends, device topology, env
overrides, package, PyTorch and CUDA versions), per-phase aggregates
(count, wall, and the analytic GFLOP/GB/MFU figures the dispatch sites
credit through ``utils/flops``), sampled device memory, the memory
auditor's per-phase watermarks, the timeline and roofline sections, and
per-phase kernel build counts. Multi-process runs write one trace file
per process (``trace.<process_index>.jsonl``) and the coordinator merges
them into the report's ``per_host`` section (:func:`merge_host_traces`).

The port has no JIT: its compiled work is the hand-written CUDA kernels.
``jit_compiles`` (the reference's field name) counts the kernel sources
this process built with ``nvcc`` and ``cache_hits`` the libraries it
loaded from the build directory without building (``ops/cuda_build``,
``utils/cache``).

Everything here is host-side bookkeeping: no device computation, and no
file I/O unless a sink or report path was requested.
"""

from __future__ import annotations

import json
import os

from hdbscan_tpu_torch.utils.tracing import Tracer

#: Version tag carried by the run report (the reference's). /2: ``memory``
#: gained the per-phase ``watermarks`` table; /3: the ``timeline`` and
#: ``roofline`` sections, and watermark rows carry ``sampled``.
REPORT_SCHEMA = "hdbscan-tpu-report/3"

#: Env vars echoed into the manifest when set: anything that changes what
#: the run computes or how its figures are derived, without appearing in
#: argv.
_MANIFEST_ENV_VARS = (
    "HDBSCAN_TPU_TRACE",
    "HDBSCAN_TPU_NO_CACHE",
    "HDBSCAN_TPU_FAULTS",
    "CUDA_VISIBLE_DEVICES",
)


def json_sanitize(obj):
    """Recursively coerce numpy and torch scalars and arrays, tuples and
    other non-JSON values to plain Python so ``json.dumps`` never trips on a
    trace field. A torch tensor becomes its number (0-d) or nested list, as
    a numpy array does."""
    import numpy as np
    import torch

    if isinstance(obj, dict):
        return {str(k): json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_sanitize(v) for v in obj]
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return json_sanitize(obj.tolist())
    if isinstance(obj, (np.bool_, bool)):
        return bool(obj)
    if isinstance(obj, (np.integer, int)):
        return int(obj)
    if isinstance(obj, (np.floating, float)):
        return float(obj)
    if obj is None or isinstance(obj, str):
        return obj
    return str(obj)


# --------------------------------------------------------------------------
# Build tracking
# --------------------------------------------------------------------------


def compile_counter():
    """A zero-arg callable returning the process-wide count of kernel
    sources built with ``nvcc`` (``ops/cuda_build.BUILDS``). Pass it as a
    :class:`Tracer` counter (``{"jit_compiles": ...}``, the reference's
    field) to attribute builds to the phases that paid them."""
    from hdbscan_tpu_torch.ops import cuda_build

    return lambda: cuda_build.BUILDS


def cache_hit_counter():
    """A zero-arg callable returning the process-wide count of kernel
    libraries loaded from the build directory without a build
    (``ops/cuda_build.CACHE_HITS``). Paired with :func:`compile_counter` as
    a :class:`Tracer` counter (``{"cache_hits": ...}``), a run report shows
    how much of the build bill the directory absorbed: a warm checkout
    reports ``jit_compiles == 0`` and ``cache_hits`` > 0 on the card."""
    from hdbscan_tpu_torch.ops import cuda_build

    return lambda: cuda_build.CACHE_HITS


# --------------------------------------------------------------------------
# Manifest: what did this run resolve to
# --------------------------------------------------------------------------


def device_topology() -> dict:
    """Device/process topology from ``torch.cuda`` — enough to read a report
    without the machine: platform (``"gpu"`` where a card is visible, else
    ``"cpu"``), counts, and per-device kind."""
    import torch

    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        devices = [{"id": i, "kind": torch.cuda.get_device_name(i), "process_index": 0}
                   for i in range(count)]
        platform = "gpu"
    else:
        count, devices, platform = 1, [{"id": 0, "kind": "cpu", "process_index": 0}], "cpu"
    return {
        "platform": platform,
        "device_count": count,
        "local_device_count": count,
        "process_count": 1,
        "process_index": 0,
        "devices": devices,
    }


def env_overrides() -> dict:
    """The run-shaping env vars that are actually set (see
    ``_MANIFEST_ENV_VARS``)."""
    return {k: os.environ[k] for k in _MANIFEST_ENV_VARS if k in os.environ}


def run_manifest(params=None, argv=None, extra: dict | None = None) -> dict:
    """The run's identity card: config dataclass, resolved backends, device
    topology, env overrides, package, PyTorch and CUDA versions (where the
    reference gives ``jax_version``), and the peak the report's MFU figures
    divide by (``utils/flops.PEAK_FLOPS``, one H100 SXM's FP32 rate).
    ``params`` is an ``HDBSCANParams`` (or None for library runs)."""
    import dataclasses

    import torch

    from hdbscan_tpu_torch import __version__
    from hdbscan_tpu_torch.utils import flops

    manifest = {
        "package_version": __version__,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "argv": list(argv) if argv is not None else None,
        "params": (
            json_sanitize(dataclasses.asdict(params)) if params is not None else None
        ),
        "backends": {
            "default_backend": "gpu" if torch.cuda.is_available() else "cpu",
            "knn_backend": getattr(params, "knn_backend", None),
            "scan_backend": getattr(params, "scan_backend", None),
            "fit_sharding": getattr(params, "fit_sharding", None),
            "tree_backend": getattr(params, "tree_backend", None),
            "mst_backend": getattr(params, "mst_backend", None),
        },
        "topology": device_topology(),
        "env": env_overrides(),
        "peak_flops": flops.PEAK_FLOPS,
    }
    if getattr(params, "fit_sharding", None) is not None:
        from hdbscan_tpu_torch.parallel.shard import partition_rule_table

        manifest["sharding"] = {
            "fit_sharding": params.fit_sharding,
            "partition_rules": partition_rule_table(),
        }
    if extra:
        manifest.update(json_sanitize(extra))
    return manifest


# --------------------------------------------------------------------------
# Device memory sampling
# --------------------------------------------------------------------------


def sample_device_memory() -> dict:
    """Per-device memory figures from the card's caching allocator where a
    card is visible (``source: memory_stats``: ``torch.cuda.memory_stats``'
    ``allocated_bytes.all.current`` as ``bytes_in_use`` and ``.peak`` as
    ``peak_bytes_in_use`` — allocated, not reserved, bytes: the allocator
    keeps freed blocks reserved — and the card's total memory as
    ``bytes_limit`` once CUDA is initialised), else the live tensors on
    the CPU (``source: live_arrays``: count and storage bytes, each
    storage once)."""
    import torch

    if torch.cuda.is_available():
        per_device = []
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            limit = (torch.cuda.get_device_properties(i).total_memory
                     if torch.cuda.is_initialized() else None)
            per_device.append({
                "id": i,
                "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": limit,
            })
        return json_sanitize({"source": "memory_stats", "devices": per_device})
    from hdbscan_tpu_torch.obs.audit import live_tensor_storages

    storages = live_tensor_storages()
    return json_sanitize({
        "source": "live_arrays",
        "live_array_count": len(storages),
        "live_array_bytes": int(sum(nbytes for _, nbytes in storages.values())),
    })


# --------------------------------------------------------------------------
# Report: per-phase aggregates over the trace
# --------------------------------------------------------------------------

#: Event fields summed into the per-phase aggregates (the analytic figures
#: ``utils/flops.phase_stats`` attaches, plus the compile counter field).
_SUMMED_FIELDS = ("gflops", "gbytes", "pad_gflops", "jit_compiles", "cache_hits")


def phase_aggregates(events) -> dict:
    """``{stage: {count, wall_s, gflops?, gbytes?, pad_gflops?,
    jit_compiles?, gflops_s?, mfu?}}`` over a list of
    :class:`~hdbscan_tpu_torch.utils.tracing.TraceEvent` (or JSONL line dicts).
    Wall totals are plain float sums of the events' ``wall_s`` — exactly
    ``Tracer.total(stage)``. Rates re-derive from the SUMMED figures (a
    phase's aggregate MFU over its total wall, not a mean of per-event
    rates)."""
    from hdbscan_tpu_torch.utils import flops

    agg: dict[str, dict] = {}
    for ev in events:
        if isinstance(ev, dict):
            name, wall, fields = ev.get("stage"), ev.get("wall_s", 0.0), ev
        else:
            name, wall, fields = ev.name, ev.wall_s, ev.fields
        row = agg.setdefault(name, {"count": 0, "wall_s": 0.0})
        row["count"] += 1
        row["wall_s"] += float(wall)
        for key in _SUMMED_FIELDS:
            val = fields.get(key)
            if val is not None:
                row[key] = row.get(key, 0.0) + float(val)
    for row in agg.values():
        gf = row.get("gflops")
        if gf and row["wall_s"] > 0:
            row["gflops_s"] = round(gf / row["wall_s"], 1)
            row["mfu"] = round(gf * 1e9 / row["wall_s"] / flops.PEAK_FLOPS, 6)
        if "jit_compiles" in row:
            row["jit_compiles"] = int(row["jit_compiles"])
        if "cache_hits" in row:
            row["cache_hits"] = int(row["cache_hits"])
    # Expensive phases first, matching Tracer.summary().
    return dict(sorted(agg.items(), key=lambda kv: -kv[1]["wall_s"]))


def build_report(
    tracer: Tracer,
    manifest: dict | None = None,
    memory: dict | None = None,
    per_host: dict | None = None,
    timeline: dict | None = None,
    roofline_tags=None,
) -> dict:
    """Assemble the run report dict from a tracer's collected events.

    ``memory``: e.g. ``{"start": sample, "end": sample}`` from
    :func:`sample_device_memory`. ``per_host``: the
    :func:`merge_host_traces` result for multi-host runs. ``timeline``:
    a :meth:`~hdbscan_tpu_torch.obs.timeline.TimelineRecorder.phase_table`
    (the exact figures when a recorder ran; otherwise the section
    reconstructs from the trace's ``device_timeline`` events).
    ``roofline_tags``: honesty tags for the roofline section; None picks
    :func:`~hdbscan_tpu_torch.obs.roofline.default_tags`.
    """
    phases = phase_aggregates(tracer.events)
    report = {
        "schema": REPORT_SCHEMA,
        "manifest": manifest or {},
        "phases": phases,
        "total_wall_s": round(sum(p["wall_s"] for p in phases.values()), 6),
        "event_count": len(tracer.events),
    }
    knn_index = knn_index_section(tracer)
    if knn_index is not None:
        report["knn_index"] = knn_index
    mst_device = mst_device_section(tracer)
    if mst_device is not None:
        report["mst_device"] = mst_device
    stream = stream_section(tracer)
    if stream is not None:
        report["stream"] = stream
    spans = request_span_section(tracer)
    if spans is not None:
        report["request_spans"] = spans
    controlplane = controlplane_section(tracer)
    if controlplane is not None:
        report["controlplane"] = controlplane
    watermarks = memory_watermark_section(tracer)
    if memory is not None or watermarks is not None:
        mem = dict(memory) if memory is not None else {}
        if watermarks is not None:
            mem["watermarks"] = watermarks
        report["memory"] = json_sanitize(mem)
    tl_table = timeline
    if tl_table is None:
        tl_table = timeline_section(tracer)
    if tl_table:
        report["timeline"] = json_sanitize(tl_table)
    from hdbscan_tpu_torch.obs.roofline import roofline_section

    roofline = roofline_section(phases, tl_table, tags=roofline_tags)
    if roofline is not None:
        report["roofline"] = json_sanitize(roofline)
    if per_host is not None:
        report["per_host"] = per_host
    return report


def latency_percentiles(walls: list[float] | tuple[float, ...]) -> dict:
    """Nearest-rank p50/p95/p99/p999 (plus count/mean/max) over per-batch
    walls.

    Nearest-rank (index ``ceil(q*n) - 1`` into the sorted walls) rather than
    interpolation so ``scripts/check_trace.py`` can recompute the exact same
    numbers stdlib-only and cross-check the report against the trace at
    1e-6.
    """
    ws = sorted(float(w) for w in walls)
    n = len(ws)
    if n == 0:
        return {"count": 0}
    import math

    def rank(q: float) -> float:
        return ws[max(0, math.ceil(q * n) - 1)]

    return {
        "count": n,
        "mean_s": round(sum(ws) / n, 6),
        "p50_s": round(rank(0.50), 6),
        "p95_s": round(rank(0.95), 6),
        "p99_s": round(rank(0.99), 6),
        "p999_s": round(rank(0.999), 6),
        "max_s": round(ws[-1], 6),
    }


def slo_verdict(observed: dict, targets: dict) -> dict:
    """Target-vs-attainment verdict for the SLO bench leg.

    ``targets`` maps a metric name in ``observed`` to a bound dict with
    ``"max"`` (upper bound: latencies) and/or ``"min"`` (lower bound:
    throughput). Returns per-metric rows ``{observed, max?/min?, ok}``
    plus an overall ``ok`` — a metric missing from ``observed`` fails its
    target rather than passing silently."""
    rows: dict = {}
    all_ok = True
    for metric, bound in targets.items():
        value = observed.get(metric)
        row = {"observed": value}
        ok = value is not None
        if "max" in bound:
            row["max"] = bound["max"]
            ok = ok and value <= bound["max"]
        if "min" in bound:
            row["min"] = bound["min"]
            ok = ok and value >= bound["min"]
        row["ok"] = bool(ok)
        all_ok = all_ok and ok
        rows[metric] = row
    return {"targets": rows, "ok": bool(all_ok)}


def request_span_section(tracer: Tracer) -> dict | None:
    """The run report's ``request_spans`` section: per-request serving
    aggregates over every ``request_span`` event — span-wall percentiles,
    rows served, the per-segment wall decomposition (parse / queue /
    assemble / predict / respond totals), and the mean coalesced-peer
    count. None when the run emitted no spans (section omitted)."""
    spans = [e for e in tracer.events if e.name == "request_span"]
    if not spans:
        return None
    section = latency_percentiles([e.wall_s for e in spans])
    rows = sum(int(e.fields.get("rows", 0)) for e in spans)
    wall = sum(e.wall_s for e in spans)
    section["rows"] = rows
    if wall > 0:
        section["rows_per_s"] = round(rows / wall, 1)
    section["segments_s"] = {
        seg: round(sum(float(e.fields.get(seg, 0.0)) for e in spans), 6)
        for seg in ("parse_s", "queue_s", "assemble_s", "predict_s", "respond_s")
    }
    section["coalesced_mean"] = round(
        sum(int(e.fields.get("coalesced", 1)) for e in spans) / len(spans), 3
    )
    return section


def knn_index_section(tracer: Tracer) -> dict | None:
    """The run report's ``knn_index`` section: build/query/rescan aggregates
    for the rp-forest approximate-neighbor tier (``config.knn_index``).
    Walls sum per stage; ``recall_at_k`` reports the LAST query event's
    sampled recall (the post-merge figure — earlier events are per-stage
    diagnostics) and ``rescan_improved`` totals the rows each
    neighbor-of-neighbor round tightened. None when the run never built an
    index (exact tier), so the section is omitted rather than empty."""
    build = [e for e in tracer.events if e.name == "knn_index_build"]
    query = [e for e in tracer.events if e.name == "knn_index_query"]
    rescan = [e for e in tracer.events if e.name == "knn_index_rescan"]
    if not build and not query and not rescan:
        return None
    section: dict = {
        "builds": len(build),
        "build_wall_s": round(sum(e.wall_s for e in build), 6),
        "queries": len(query),
        "query_wall_s": round(sum(e.wall_s for e in query), 6),
        "rescan_rounds": len(rescan),
        "rescan_wall_s": round(sum(e.wall_s for e in rescan), 6),
    }
    if build:
        last = build[-1].fields
        for key in ("trees", "depth", "leaf_size", "max_leaf", "n"):
            if last.get(key) is not None:
                section[key] = int(last[key])
    recalls = [
        e.fields["recall_at_k"]
        for e in query
        if e.fields.get("recall_at_k") is not None
    ]
    if recalls:
        section["recall_at_k"] = float(recalls[-1])
    if rescan:
        section["rescan_improved"] = int(
            sum(int(e.fields.get("improved", 0)) for e in rescan)
        )
    return section


def mst_device_section(tracer: Tracer) -> dict | None:
    """The run report's ``mst_device`` section: the single-sync contract of
    the device-resident MST -> forest pipeline (``core/mst_device.py``) made
    auditable. ``host_syncs``/``sync_bytes`` count and size every
    ``host_sync`` fetch (exactly one per device fit/forest rebuild),
    ``rounds`` the retrospective Borůvka ``mst_round`` events, and
    ``fallbacks`` how many ``tree_build_device`` builds hit the runtime
    eligibility gate and fell back to the host builder. None when the run
    never entered the device path (the section is omitted, not empty)."""
    syncs = [e for e in tracer.events if e.name == "host_sync"]
    rounds = [e for e in tracer.events if e.name == "mst_round"]
    builds = [e for e in tracer.events if e.name == "tree_build_device"]
    if not syncs and not rounds and not builds:
        return None
    return {
        "host_syncs": len(syncs),
        "sync_bytes": int(sum(int(e.fields.get("bytes", 0)) for e in syncs)),
        "sync_wall_s": round(sum(e.wall_s for e in syncs), 6),
        "rounds": len(rounds),
        "forest_builds": len(builds),
        "fallbacks": int(
            sum(1 for e in builds if e.fields.get("fallback"))
        ),
        "build_wall_s": round(sum(e.wall_s for e in builds), 6),
    }


def stream_section(tracer: Tracer) -> dict | None:
    """The run report's ``stream`` section: online-maintenance aggregates
    (``hdbscan_tpu_torch/stream`` + ``serve/server.py``). Totals every
    ``stream_ingest`` event's row routing (``absorb_ratio`` = absorbed /
    rows — how much of the stream the bubble summaries soaked up without
    buffering), counts ``drift_check`` evaluations and how many flagged,
    ``model_refit`` outcomes, and for ``model_swap`` the generation reached
    plus the max in-lock pause (the blue/green "zero pause" claim, made a
    number). None when the run never ingested."""
    ingest = [e for e in tracer.events if e.name == "stream_ingest"]
    if not ingest:
        return None
    rows = sum(int(e.fields.get("rows", 0)) for e in ingest)
    absorbed = sum(int(e.fields.get("absorbed", 0)) for e in ingest)
    checks = [e for e in tracer.events if e.name == "drift_check"]
    refits = [e for e in tracer.events if e.name == "model_refit"]
    swaps = [e for e in tracer.events if e.name == "model_swap"]
    section = {
        "ingest_batches": len(ingest),
        "rows": int(rows),
        "absorbed": int(absorbed),
        "absorb_ratio": round(absorbed / rows, 6) if rows else 0.0,
        "ingest_wall_s": round(sum(e.wall_s for e in ingest), 6),
        "drift_checks": len(checks),
        "drift_flags": int(sum(1 for e in checks if e.fields.get("drifted"))),
        "refits": len(refits),
        "refits_ok": int(sum(1 for e in refits if e.fields.get("ok"))),
    }
    if swaps:
        section["swaps"] = len(swaps)
        section["generation"] = int(
            max(int(e.fields.get("generation", 0)) for e in swaps)
        )
        section["swap_pause_max_s"] = round(
            max(float(e.fields.get("pause_s", e.wall_s)) for e in swaps), 9
        )
    return section


def timeline_section(tracer: Tracer) -> dict | None:
    """The run report's ``timeline`` section reconstructed from the trace's
    ``device_timeline`` events — the fallback when no live
    :class:`~hdbscan_tpu_torch.obs.timeline.TimelineRecorder` table is at hand
    (e.g. rebuilding a report from a trace file). Per phase: per-round
    max-device walls sum into ``wall_s`` (the critical path), segment
    means sum per round, skew is the worst round's max/median, and
    ``straggler_flags`` counts the phase's ``straggler_flag`` events.
    None when the run recorded no timelines (the section is omitted)."""
    rows = [e for e in tracer.events if e.name == "device_timeline"]
    if not rows:
        return None
    flags = [e for e in tracer.events if e.name == "straggler_flag"]
    # Group rows into rounds in emission order: a new (phase, round) pair
    # or a repeated device id closes the open group for that phase.
    groups: list[dict] = []
    open_group: dict[str, dict] = {}
    for e in rows:
        f = e.fields
        phase = str(f.get("phase", "?"))
        rnd = int(f.get("round", 0))
        dev = int(f.get("device", 0))
        g = open_group.get(phase)
        if g is None or g["round"] != rnd or dev in g["devices"]:
            g = {"phase": phase, "round": rnd, "devices": {}, "rows": []}
            open_group[phase] = g
            groups.append(g)
        g["devices"][dev] = True
        g["rows"].append(
            (
                float(e.wall_s),
                float(f.get("compute_s", 0.0)),
                float(f.get("comm_s", 0.0)),
                float(f.get("host_s", 0.0)),
                int(f.get("comm_bytes", 0)),
            )
        )
    table: dict[str, dict] = {}
    for g in groups:
        n_dev = len(g["rows"])
        walls = sorted(r[0] for r in g["rows"])
        median = (
            walls[n_dev // 2]
            if n_dev % 2
            else 0.5 * (walls[n_dev // 2 - 1] + walls[n_dev // 2])
        )
        skew = (walls[-1] / median) if median > 0 else 1.0
        ph = table.setdefault(
            g["phase"],
            {
                "rounds": 0,
                "devices": 0,
                "wall_s": 0.0,
                "compute_s": 0.0,
                "comm_s": 0.0,
                "host_s": 0.0,
                "comm_bytes": 0,
                "max_skew": 1.0,
            },
        )
        ph["rounds"] += 1
        ph["devices"] = max(ph["devices"], n_dev)
        ph["wall_s"] += walls[-1]
        ph["compute_s"] += sum(r[1] for r in g["rows"]) / n_dev
        ph["comm_s"] += sum(r[2] for r in g["rows"]) / n_dev
        ph["host_s"] += sum(r[3] for r in g["rows"]) / n_dev
        ph["comm_bytes"] += sum(r[4] for r in g["rows"])
        ph["max_skew"] = max(ph["max_skew"], skew)
    out: dict[str, dict] = {}
    for name, ph in table.items():
        total = ph["compute_s"] + ph["comm_s"] + ph["host_s"]
        skew = ph.pop("max_skew")
        out[name] = {
            **{
                k: (round(v, 9) if isinstance(v, float) else v)
                for k, v in ph.items()
            },
            "comm_frac": round(ph["comm_s"] / total, 6) if total > 0 else 0.0,
            "skew": round(skew, 6),
            "straggler_flags": sum(
                1 for e in flags if str(e.fields.get("phase")) == name
            ),
        }
    return out


def memory_watermark_section(tracer: Tracer) -> dict | None:
    """The run report's ``memory.watermarks`` table: per-phase device-memory
    peaks over every ``mem_phase_peak`` event the
    :class:`~hdbscan_tpu_torch.obs.audit.MemoryAuditor` emitted. Repeated phases
    max-merge (peaks) and sum (samples, wall) — the same merge the auditor's
    in-memory table applies — so the section reads as "the worst any single
    device ever held during this phase, across the whole run". None when the
    run was not audited (the section is omitted, not empty)."""
    peaks = [e for e in tracer.events if e.name == "mem_phase_peak"]
    if not peaks:
        return None
    table: dict[str, dict] = {}
    for e in peaks:
        f = e.fields
        phase = str(f.get("phase", "?"))
        row = table.setdefault(
            phase,
            {
                "source": f.get("source"),
                "samples": 0,
                "sampled": False,
                "devices": 0,
                "max_device_bytes": 0,
                "total_bytes": 0,
                "wall_s": 0.0,
            },
        )
        row["samples"] += int(f.get("samples", 0))
        # Older traces lack the field: infer from samples so rebuilt
        # reports agree with the auditor's in-memory table.
        row["sampled"] = row["sampled"] or bool(
            f.get("sampled", int(f.get("samples", 0)) > 0)
        )
        row["devices"] = max(row["devices"], int(f.get("devices", 0)))
        row["max_device_bytes"] = max(
            row["max_device_bytes"], int(f.get("max_device_bytes", 0))
        )
        row["total_bytes"] = max(row["total_bytes"], int(f.get("total_bytes", 0)))
        row["wall_s"] = round(row["wall_s"] + float(e.wall_s), 9)
    # Heaviest phases first, matching phase_aggregates' ordering convention.
    return dict(sorted(table.items(), key=lambda kv: -kv[1]["max_device_bytes"]))


def predict_latency_section(tracer: Tracer) -> dict | None:
    """The run report's ``predict_latency`` section: percentiles over every
    ``predict_batch`` event plus total rows served and rows/s; None when the
    run served no predictions (the section is omitted, not empty)."""
    events = [e for e in tracer.events if e.name == "predict_batch"]
    if not events:
        return None
    section = latency_percentiles([e.wall_s for e in events])
    rows = sum(int(e.fields.get("rows", 0)) for e in events)
    wall = sum(e.wall_s for e in events)
    section["rows"] = rows
    if wall > 0:
        section["rows_per_s"] = round(rows / wall, 1)
    return section


def controlplane_section(tracer: Tracer) -> dict | None:
    """The run report's ``controlplane`` section: fleet elasticity and
    fit-as-a-service aggregates over ``scale_event`` / ``fit_job`` /
    ``artifact_map`` events. ``scaling`` counts ups/downs (and failures)
    by reason; ``fit_jobs`` counts terminal outcomes per tenant plus the
    mean queue wait; ``artifacts`` reports load hit rate and the LAST
    event's resident footprint (the store only grows within a process,
    so last == high-water). None when the run had no control plane."""
    scale = [e for e in tracer.events if e.name == "scale_event"]
    jobs = [e for e in tracer.events if e.name == "fit_job"]
    art = [e for e in tracer.events if e.name == "artifact_map"]
    if not (scale or jobs or art):
        return None
    section: dict = {}
    if scale:
        reasons: dict = {}
        for e in scale:
            key = str(e.fields.get("reason", "unknown"))
            reasons[key] = reasons.get(key, 0) + 1
        section["scaling"] = {
            "events": len(scale),
            "up": sum(1 for e in scale if e.fields.get("direction") == "up"),
            "down": sum(
                1 for e in scale if e.fields.get("direction") == "down"
            ),
            "failed": sum(1 for e in scale if not e.fields.get("ok", True)),
            "reasons": reasons,
            "mean_wall_s": round(
                sum(e.wall_s for e in scale) / len(scale), 6
            ),
        }
    if jobs:
        per_tenant: dict = {}
        for e in jobs:
            state = str(e.fields.get("state", ""))
            if state not in ("published", "failed"):
                continue
            tenant = str(e.fields.get("tenant", "?"))
            per_tenant.setdefault(tenant, {"published": 0, "failed": 0})
            per_tenant[tenant][state] += 1
        queued = [
            float(e.fields["queued_s"]) for e in jobs if "queued_s" in e.fields
        ]
        section["fit_jobs"] = {
            "events": len(jobs),
            "published": sum(
                1 for e in jobs if e.fields.get("state") == "published"
            ),
            "failed": sum(
                1 for e in jobs if e.fields.get("state") == "failed"
            ),
            "tenants": per_tenant,
        }
        if queued:
            section["fit_jobs"]["mean_queued_s"] = round(
                sum(queued) / len(queued), 6
            )
    if art:
        hits = sum(1 for e in art if e.fields.get("hit"))
        per_digest = {}  # bytes is per-digest; total = sum over digests
        for e in art:
            per_digest[str(e.fields.get("digest", "?"))] = int(
                e.fields.get("bytes", 0)
            )
        section["artifacts"] = {
            "loads": len(art),
            "hits": hits,
            "misses": len(art) - hits,
            "spooled": sum(1 for e in art if e.fields.get("spooled")),
            "resident": int(art[-1].fields.get("resident", 0)),
            "resident_bytes": sum(per_digest.values()),
        }
    return section


def write_report(path: str, report: dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(json_sanitize(report), f, indent=2, sort_keys=False)
        f.write("\n")


# --------------------------------------------------------------------------
# Multi-host: per-process trace files and the coordinator merge
# --------------------------------------------------------------------------


def trace_path_for_process(path: str, process_index: int, process_count: int) -> str:
    """Per-process trace file name: the literal path for single-process runs;
    ``<stem>.<process_index><ext>`` (``trace.3.jsonl``) when several
    processes share the requested base path."""
    if process_count <= 1:
        return path
    stem, ext = os.path.splitext(path)
    return f"{stem}.{process_index}{ext}"


def host_trace_paths(path: str, process_count: int) -> list[str]:
    """Every process's trace path for a given base path (coordinator side)."""
    return [
        trace_path_for_process(path, i, process_count) for i in range(process_count)
    ]


def read_trace(path: str) -> list[dict]:
    """Parse a JSONL trace file into its line dicts (schema-checked softly:
    non-matching lines are kept — the validator is ``scripts/check_trace.py``)."""
    events = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def merge_host_traces(paths: list[str]) -> dict:
    """Merge per-process JSONL traces into ``{host: {stage: {count, wall_s,
    ...}}}`` — one phase-aggregate table per host, so a straggler's phase
    walls sit next to its peers'. The host key is the trace's ``process``
    field when present, else the file's position in ``paths``. Missing files
    appear as ``{"missing": true}`` (a rank that died before writing is
    itself a finding)."""
    merged: dict[str, dict] = {}
    for i, path in enumerate(paths):
        if not os.path.exists(path):
            merged[str(i)] = {"missing": True}
            continue
        events = read_trace(path)
        host = str(events[0].get("process", i)) if events else str(i)
        merged[host] = phase_aggregates(events)
    return merged

"""The command line — the port of ``hdbscan_tpu/cli.py``'s ``fit``,
``predict``, ``serve`` and ``fleet``.

Usage (the reference's ``key=value`` vocabulary, ``config.HDBSCANParams``)::

    python -m hdbscan_tpu_torch [fit] file=<input> minPts=4 minClSize=4 \
        [processing_units=N] [k=0.2] [constraints=<csv>] [compact={true,false}] \
        [dist_function={euclidean,cosine,pearson,manhattan,supremum}] \
        [out_dir=DIR] [seed=N] [exact_inter_edges={true,false}] \
        [global_cores={true,false}] [refine=N] [boundary=F] [boundary_alpha=F] \
        [boundary_max_frac=F] [glue_alpha=F] [glue_factor=N] [glue_rows=N] \
        [knn_backend={auto,xla,pallas,fused}] [knn_index={auto,exact,rpforest}] \
        [knn_index_threshold=N] [rpf_trees=N] [rpf_leaf_size=N] [rpf_rescan=N] \
        [fit_sharding={auto,replicated,sharded}] [scan_backend={auto,host,ring}] \
        [dedup={true,false}] [tree_backend={auto,reference,vectorized}] \
        [mst_backend={auto,host,device}] [variant={db,rs}] [consensus=N] \
        [compat_cf={true,false}] [block_pruning={true,false}] \
        [trace_rotate_bytes=N] [trace_max_events=N] [compile_cache={auto,off,DIR}] \
        [heartbeat=F] [watchdog=F] [skew_threshold=F] [straggler_rounds=N] \
        [--trace-out PATH] [--report PATH] [--flight-dir DIR] \
        [--assert-not-replicated] [--compile-cache {auto,off,DIR}] \
        [--model-out MODEL.npz] [--device DEV] \
        [clusterName={local,auto,<host:port>,<rank>,<ranks>}]
    python -m hdbscan_tpu_torch predict --model MODEL.npz --points <input> \
        [--out PRED.csv] [predict_backend={auto,xla,fused,rpforest}] \
        [predict_batch=N] [--trace-out PATH] [--report PATH] [--device DEV]
    python -m hdbscan_tpu_torch serve --model MODEL.npz [--host H] [--port P] \
        [--port-file PATH] [predict_backend=...] [predict_batch=N] \
        [queue_bound=N] [deadline_ms=F] [faults=SPEC] [trace_max_events=N] \
        [--ingest] [--model-dir DIR] [absorb_eps=F] [drift_stat={psi,ks}] \
        [drift_threshold=F] [refit_budget=N] [stream_reload={auto,manual}] \
        [circuit_failures=N] [circuit_reset=F] [wal_dir=DIR] [snapshot_every=N] \
        [maintain={off,incremental}] [maintain_budget=F] \
        [maintain_dirty_frac=F] [maintain_refresh=N] [heartbeat=F] [watchdog=F] \
        [--tenants-dir DIR] [tenant_lru=N] [tenant_quota=F] \
        [artifact_store={shared,off}] [compile_cache={auto,off,DIR}] \
        [--trace-out PATH] [--report PATH] [--device DEV]
    python -m hdbscan_tpu_torch fleet --model MODEL.npz [--host H] [--port P] \
        [--model-dir DIR] [--tenants-dir DIR] [--ingest] [--wal-root DIR] \
        [--trace-out PATH] [--report PATH] [--replica-trace-dir DIR] \
        [fleet_replicas=N] [fleet_policy={consistent_hash,least_loaded}] \
        [fleet_health_interval=F] [fleet_drain=F] \
        [autoscale={true,false}] [fleet_min=N] [fleet_max=N] \
        [scale_high_load=F] [scale_low_load=F] [scale_p99=F] \
        [scale_cooldown=F] [artifact_store={shared,off}] \
        [fit_workers=N] [fit_queue_bound=N] [fit_quota=F] [--device DEV] \
        [<replica serve knobs, forwarded verbatim>]

The dataset is routed as the reference routes it: with ``fit_sharding``
resolving to ``sharded`` and n <= ``processing_units``, the exact fit over
a mesh (``models/exact.fit``, mode ``exact-sharded``); otherwise n <=
``processing_units`` runs the dense single-block fit (``models/hdbscan.fit``,
mode ``exact``) and larger inputs the MR-HDBSCAN* pipeline
(``models/mr_hdbscan.fit``, mode ``mr (<levels> levels)``, or
``mr-consensus (<N> draws)`` with ``consensus=N`` above 1; ``mr-sharded``
and ``mr-consensus-sharded`` under ``fit_sharding`` resolving to
``sharded``). A mesh is built when more than one card is visible (one
shard a card), or from ``--device DEV,DEV,...`` (one shard per listed
device, e.g. ``--device cpu,cpu,cpu,cpu`` or four shards of one card as
``--device cuda:0,cuda:0,cuda:0,cuda:0``; a list mixing the CPU and cards
exits 2); the MR route runs its sharded
or ring engine over it (``fit_sharding=sharded``, ``scan_backend=ring``)
and splits its block batches over it. On the exact-sharded route
``mst_backend=host`` runs the host-round Borůvka over the sharded scanner
and ``dedup=true`` the weighted fit over unique points; on the MR route
``variant=rs`` clusters the samples directly, ``dedup=true`` runs the
pipeline over weighted unique points, ``consensus=N`` takes the consensus
of N draws and ``compat_cf=true`` the Java code's CF arithmetic; the dense
route ignores ``dedup``, as the reference's does. Outputs are the five
canonical files either way (a consensus run adds the
``<base>_consensus.json`` provenance sidecar); the fit computes in
float32.

``fit --model-out`` persists the fitted clustering as one atomic
schema-versioned ``.npz`` (``serve/artifact.ClusterModel``, the reference's
layout); ``predict`` classifies new points against it (labels, membership
probabilities, GLOSH outlier scores, written as the reference's CSV);
``serve`` starts the stdlib HTTP server (``POST /predict``, ``POST /swap``,
``GET /healthz``, ``GET /metrics``) with micro-batched dispatch and prints
``hdbscan-tpu serve: http://HOST:PORT ...`` on stderr once bound
(``--port-file`` also writes the port). Both serving commands warm every
power-of-two batch bucket and emit per-batch ``predict_batch`` events.

``serve --ingest`` additionally opens ``POST /ingest``: arriving points
route through the predict path, duplicates and near-duplicates (within
``absorb_eps`` of their cluster's density level) fold into per-cluster
bubble summaries, a GLOSH-score drift detector (``drift_stat`` /
``drift_threshold``) watches for distribution shift, and on drift or
``refit_budget`` buffered novel rows a background re-fit on the serving
device publishes a new artifact under ``--model-dir`` that hot-swaps in
(``stream_reload=auto``; ``manual`` stages it for ``POST /swap``).
``circuit_failures`` / ``circuit_reset`` tune the breaker that pins the
served generation after repeated re-fit failures; ``wal_dir=DIR`` makes
``/ingest`` crash-safe (an fsync'd JSONL write-ahead log, snapshotted
every ``snapshot_every`` appends, replayed bit-identically on restart, in
the reference's format). ``maintain=incremental`` folds novel rows into a
maintained mutual-reachability MST on the host and re-finalizes the served
hierarchy every ``maintain_refresh`` inserts (``maintain_budget``,
``maintain_dirty_frac``: the reference's knobs).

``--device DEV`` picks the device (default: the card; ``--device cpu`` runs
every kernel's plain PyTorch version; a comma list names a mesh's shards,
the first one the device of everything not sharded). There is no fallback: with no card
and no ``--device cpu`` the command fails. ``--trace-out PATH`` writes every
stage event as a ``hdbscan-tpu-trace/1`` JSON line (the fit's rotated at
``trace_rotate_bytes``; validate with ``scripts/check_trace.py``);
``HDBSCAN_TPU_TRACE=1`` streams the events as logfmt lines to stderr. The
fit's per-stage summary (``phases:``) always goes to stderr.

Observability (``hdbscan_tpu_torch/obs``, the reference's flags and
semantics): with ``--trace-out`` or ``--report`` the trace's events carry
per-phase kernel build counts (``jit_compiles``, ``cache_hits``), and
``--report PATH`` writes the ``hdbscan-tpu-report/3`` run report (manifest,
per-phase aggregates, memory samples and watermarks, timeline and roofline
sections; ``predict``/``serve``: ``predict_latency``). Either flag, or
``--assert-not-replicated``, installs the memory auditor (the card's
allocator, or the live tensors on the CPU), the heartbeat hub (``heartbeat``
seconds between beats, a hang watchdog after ``watchdog`` seconds without
one) and the timeline recorder (``skew_threshold``, ``straggler_rounds``).
``--flight-dir DIR`` arms the flight recorder: a bundle lands in DIR on a
watchdog stall, a gate trip, an unhandled exception or SIGTERM.
``--assert-not-replicated`` fails the fit (exit 3) when one device's phase
peak implies a replicated O(n) buffer; one device (a mesh of one card's
shards included) passes it as ``single_device``. ``--compile-cache`` /
``compile_cache=`` picks where the kernels are built and loaded from
(``utils/cache``: ``auto``, ``off`` or a directory). Validate the files
with ``scripts/check_trace.py TRACE REPORT`` and ``scripts/check_flight.py
DIR``.

``serve --tenants-dir DIR`` serves every ``<tenant>.npz`` in DIR behind
an LRU of ``tenant_lru`` warmed predictors on the serving device, with
per-tenant generations and a ``tenant_quota`` requests/s token bucket (over
it: 429 + ``Retry-After``); ``POST /predict`` bodies gain an optional
``"tenant"`` field, which a server without a registry answers with 409.
``artifact_store=shared`` loads tenant artifacts through the per-host
digest-keyed mmap spool (``fleet/artifacts.py``): one host copy however
many replicas serve them (each replica still holds its resident tenants'
tables on the card).

``fleet`` (``fleet/router.py``) spawns ``fleet_replicas`` ``serve``
subprocesses over the same ``--model`` (``--device`` forwarded: the card
unless another is named, and no replica ever moves to the CPU unasked) and
fronts them on one asyncio accept loop: ``/predict`` and ``/ingest`` route
by ``fleet_policy`` (``consistent_hash`` pins a tenant to a replica through
an md5 ring; ``least_loaded`` picks the fewest in-flight requests),
``/metrics`` serves one aggregated exposition with a ``replica`` label,
``/swap`` broadcasts. A health loop probes ``/healthz`` every
``fleet_health_interval`` seconds; a dead replica is routed around and
respawned (each keeps its own ``--wal-root``/r<id> write-ahead log).
Every replica is given the one kernel build directory ``compile_cache``
resolves to, so a respawned or scaled-up replica builds nothing.
``autoscale=true`` runs the hysteresis autoscaler between ``fleet_min``
and ``fleet_max`` replicas (``scale_high_load``, ``scale_low_load``,
``scale_p99``, ``scale_cooldown``); the remaining ``key=value`` knobs
forward to every replica verbatim (``fit_workers``, ``fit_queue_bound`` and
``fit_quota`` are validated and forwarded like the rest: the fit service
is the in-process ``fleet/jobs.FitScheduler``, sized by its caller).
``--replica-trace-dir DIR`` gives every replica its own ``--trace-out``
file, joinable with the router's ``router_span`` events by
``scripts/check_trace.py --join``. SIGTERM forwards to every replica and
waits up to ``fleet_drain`` seconds: the exit status is nonzero when a
replica had to be killed.

Multi-process fits (``parallel/distributed``; the reference's Spark master
flag re-mapped): ``clusterName=local`` (the default) is one process;
``clusterName=<host:port>,<rank>,<ranks>`` wires this process as ``rank``
of ``ranks`` over ``torch.distributed`` at ``tcp://host:port`` and
``clusterName=auto`` from torchrun's environment, before any data is read
(a malformed spec or a conflicting wiring exits 2). Every rank runs the
same command on the same file; the global mesh is every rank's
``--device`` list in rank order (``2 processes, 4 devices (global mesh)``
on rank 0's stderr), each rank computes its own shards, the hand-overs
between ranks are collectives (NCCL when each rank names one card of its
own, else gloo: ranks on the CPU, sharing a card or over several cards;
no fallback), and rank 0
alone writes the five files, the model, the report (with every rank's
phases under ``per_host``) and prints; ``--trace-out PATH`` writes
``PATH.<rank>`` per rank (``trace.0.jsonl``). Every route runs over ranks,
the rp-forest tier (``knn_index=rpforest``, or ``auto`` past its threshold)
included.
"""

from __future__ import annotations

import os
import sys
import time

from hdbscan_tpu_torch.config import HDBSCANParams

HELP = __doc__

def _pop_path_flag(argv: list[str], flag: str) -> str | None:
    """Extract ``--flag PATH`` or ``--flag=PATH`` from argv (in place).

    Run-artifact flags stay out of the ``key=value`` vocabulary
    (``HDBSCANParams.from_args`` would reject them as unknown flags).
    """
    value = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == flag:
            if i + 1 >= len(argv):
                raise ValueError(f"{flag} requires a PATH argument")
            value = argv[i + 1]
            del argv[i : i + 2]
        elif a.startswith(flag + "="):
            value = a[len(flag) + 1 :]
            del argv[i]
        else:
            i += 1
    return value


def _pop_bool_flag(argv: list[str], flag: str) -> bool:
    """Extract a bare ``--flag`` switch from argv (in place)."""
    present = False
    while flag in argv:
        argv.remove(flag)
        present = True
    return present


def _device(flag):
    """The ``--device`` flag resolved (the card by default; of a comma list,
    the first entry); None, with the error printed, when no card is
    present and none was named."""
    from hdbscan_tpu_torch.ops import cuda_build

    try:
        return cuda_build.resolve_device(flag.split(",")[0] if flag else flag)
    except RuntimeError as e:
        print(f"error: {e} (on the command line: --device cpu)", file=sys.stderr)
        return None


def _mesh(flag, device):
    """The fit's mesh: one shard per device of a ``--device`` comma list,
    else one shard per card when more than one is visible, else none. In a
    wired process, the global mesh of every rank's list (or device)."""
    import torch

    from hdbscan_tpu_torch.parallel.distributed import process_count
    from hdbscan_tpu_torch.parallel.mesh import get_mesh

    if process_count() > 1:
        return get_mesh([torch.device(d) for d in flag.split(",")] if flag else [device])
    if flag and "," in flag:
        return get_mesh([torch.device(d) for d in flag.split(",")])
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        return get_mesh()
    return None


def _telemetry_counters():
    """The per-phase kernel build counters a traced or reported run's
    events carry (the reference's ``jit_compiles``/``cache_hits`` fields)."""
    from hdbscan_tpu_torch.utils import telemetry

    return {"jit_compiles": telemetry.compile_counter(),
            "cache_hits": telemetry.cache_hit_counter()}


def _serving_tracer(trace_out: str | None, report_out: str | None, max_events: int):
    """Tracer of the serving commands: ``--trace-out`` as JSON lines,
    ``HDBSCAN_TPU_TRACE=1`` as logfmt on stderr, the in-memory list bounded
    by ``trace_max_events``; the build counters ride the events when
    either file was asked for."""
    from hdbscan_tpu_torch.utils.tracing import JsonlSink, Tracer

    sinks = [JsonlSink(trace_out, static={"process": 0})] if trace_out is not None else []
    counters = _telemetry_counters() if trace_out is not None or report_out is not None else None
    return Tracer(stream=sys.stderr if os.environ.get("HDBSCAN_TPU_TRACE") else None,
                  sinks=sinks, counters=counters, max_events=max_events)


def _write_serving_report(report_out: str, tracer, params, argv_full) -> None:
    """The serving commands' run report: the manifest, the phases and the
    ``predict_latency`` section over the ``predict_batch`` events."""
    from hdbscan_tpu_torch.utils import telemetry

    report = telemetry.build_report(
        tracer, manifest=telemetry.run_manifest(params, argv=argv_full)
    )
    latency = telemetry.predict_latency_section(tracer)
    if latency is not None:
        report["predict_latency"] = latency
    telemetry.write_report(report_out, report)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or any(a in ("-h", "--help", "help") for a in argv):
        print(HELP)
        return 0
    # A bare key=value invocation (the reference's documented contract)
    # means fit.
    if argv[0] == "fleet":
        return _main_fleet(argv[1:], list(argv))
    if argv[0] == "predict":
        return _main_predict(argv[1:], list(argv))
    if argv[0] == "serve":
        return _main_serve(argv[1:], list(argv))
    if argv[0] == "fit":
        argv = argv[1:]
    return _main_fit(argv)


def _main_fit(argv: list[str]) -> int:
    argv_full = list(argv)  # the manifest records argv as given, flags included
    try:
        trace_out = _pop_path_flag(argv, "--trace-out")
        report_out = _pop_path_flag(argv, "--report")
        compile_cache_flag = _pop_path_flag(argv, "--compile-cache")
        model_out = _pop_path_flag(argv, "--model-out")
        flight_dir = _pop_path_flag(argv, "--flight-dir")
        device_flag = _pop_path_flag(argv, "--device")
        assert_not_replicated = _pop_bool_flag(argv, "--assert-not-replicated")
        params = HDBSCANParams.from_args(argv)
        if compile_cache_flag is not None:
            import dataclasses

            # replace() re-runs __post_init__ validation on the new value.
            params = dataclasses.replace(params, compile_cache=compile_cache_flag)
    except ValueError as e:
        print(f"error: {e}\n{HELP}", file=sys.stderr)
        return 2
    if not params.input_file:
        print("error: file=<input> is required", file=sys.stderr)
        return 2
    import numpy as np

    device = _device(device_flag)
    if device is None:
        return 1
    # Multi-process wiring before any data is read (the reference's Spark
    # master flag): every rank runs this same deterministic host loop,
    # computes its own shards and hands the rest over by collectives; rank
    # 0 alone writes and prints.
    from hdbscan_tpu_torch.parallel import distributed

    local_devices = device_flag.split(",") if device_flag and "," in device_flag else [device]
    already = distributed.already_initialized()
    try:
        wired = distributed.initialize_from_cluster_name(params.cluster_name,
                                                         devices=local_devices)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # The group is torn down here only when this command wired it.
    teardown = distributed.shutdown if wired and not already else (lambda: None)
    n_proc, rank = distributed.process_count(), distributed.process_index()
    is_main = rank == 0

    from hdbscan_tpu_torch import obs
    from hdbscan_tpu_torch.models import exact, hdbscan, mr_hdbscan
    from hdbscan_tpu_torch.parallel.shard import resolve_fit_sharding
    from hdbscan_tpu_torch.utils import telemetry
    from hdbscan_tpu_torch.utils.cache import enable_persistent_compilation_cache
    from hdbscan_tpu_torch.utils.io import load_points
    from hdbscan_tpu_torch.utils.tracing import JsonlSink, Tracer

    try:
        mesh = _mesh(device_flag, device)
    except ValueError as e:
        print(f"error: --device: {e}", file=sys.stderr)
        return 2
    if is_main and n_proc > 1:
        print(f"hdbscan-tpu: {n_proc} processes, {len(mesh.devices)} devices (global mesh), "
              f"{distributed.backend()} hand-overs", file=sys.stderr)
    cache_dir = enable_persistent_compilation_cache(params.compile_cache)

    # Always collected, so the end-of-run summary shows the phase walls;
    # --trace-out persists the events, HDBSCAN_TPU_TRACE=1 streams them, and
    # with --trace-out or --report the kernel build counters ride them.
    telemetry_on = trace_out is not None or report_out is not None
    sinks = []
    if trace_out is not None:
        sinks.append(JsonlSink(telemetry.trace_path_for_process(trace_out, rank, n_proc),
                               static={"process": rank},
                               rotate_bytes=params.trace_rotate_bytes))
    tracer = Tracer(
        stream=sys.stderr if os.environ.get("HDBSCAN_TPU_TRACE") else None,
        sinks=sinks,
        counters=_telemetry_counters() if telemetry_on else None,
        max_events=params.trace_max_events,
    )
    # The observability layer installs once per fit when telemetry is on or
    # the replication gate was asked for (it needs audited watermarks).
    # Uninstalled, every fit-path obs call is a no-op attribute check.
    installed_obs = False
    tl_rec = None
    if (telemetry_on or assert_not_replicated) and obs.auditor() is None:
        from hdbscan_tpu_torch.obs.audit import MemoryAuditor
        from hdbscan_tpu_torch.obs.heartbeat import Heartbeats
        from hdbscan_tpu_torch.obs.timeline import TimelineRecorder

        tl_rec = TimelineRecorder(skew_threshold=params.obs_skew_threshold,
                                  straggler_rounds=params.obs_straggler_rounds, trace=tracer)
        obs.install(
            auditor=MemoryAuditor(tracer=tracer),
            heartbeats=Heartbeats(tracer, heartbeat_s=params.heartbeat_s,
                                  watchdog_s=params.watchdog_s),
            timeline=tl_rec,
        )
        installed_obs = True
    # The flight recorder: a bounded ring over the trace stream that dumps a
    # bundle to --flight-dir on a watchdog stall (sniffed from the stream),
    # a gate trip, an unhandled exception or SIGTERM. A healthy run writes
    # no file.
    flight = None
    restore_term = None
    if flight_dir is not None:
        import signal
        import threading

        from hdbscan_tpu_torch.obs.flightrec import FlightRecorder

        flight = FlightRecorder(flight_dir, manifest=telemetry.run_manifest(params, argv=argv_full),
                                tracer=tracer)
        tracer.add_sink(flight)
        obs.install(flight=flight)
        installed_obs = True
        if threading.current_thread() is threading.main_thread():
            prev_term = signal.getsignal(signal.SIGTERM)

            def _on_sigterm(signum, frame):
                try:
                    flight.dump("sigterm")
                finally:
                    signal.signal(signal.SIGTERM,
                                  prev_term if callable(prev_term) else signal.SIG_DFL)
                    signal.raise_signal(signal.SIGTERM)

            signal.signal(signal.SIGTERM, _on_sigterm)

            def restore_term():
                if signal.getsignal(signal.SIGTERM) is _on_sigterm:
                    signal.signal(signal.SIGTERM, prev_term)

    mem_start = telemetry.sample_device_memory() if report_out is not None else None

    def close_layers():
        # Uninstall the layer (stops the watchdog and sampler threads)
        # before the tracer flushes: nothing may emit after close.
        if installed_obs:
            obs.clear()
        if restore_term is not None:
            restore_term()
        tracer.close()

    try:
        t0 = time.monotonic()
        data = load_points(params.input_file)
        if data.ndim == 1:
            data = data[:, None]
        n = len(data)
        tracer("load_points", rows=n, dims=int(data.shape[1]),
               wall_s=round(time.monotonic() - t0, 6))
        t0 = time.monotonic()
        sharded = resolve_fit_sharding(params.fit_sharding, mesh) == "sharded"
        try:
            if sharded and n <= params.processing_units:
                result = exact.fit(data, params, device=device, mesh=mesh, trace=tracer)
                mode = "exact-sharded"
            elif n <= params.processing_units:
                result = hdbscan.fit(data, params, device=device, trace=tracer)
                mode = "exact"
            else:
                # consensus_draws > 1 dispatches to consensus.fit inside.
                result = mr_hdbscan.fit(data, params, device=device, mesh=mesh, trace=tracer)
                tag = "-sharded" if sharded else ""
                mode = (f"mr-consensus{tag} ({params.consensus_draws} draws)"
                        if params.consensus_draws > 1 else f"mr{tag} ({result.n_levels} levels)")
        except NotImplementedError as e:
            print(f"error: {e}", file=sys.stderr)
            teardown()
            return 2
        wall = time.monotonic() - t0
        tracer("fit", mode=mode.split(" ")[0], rows=n, wall_s=round(wall, 6))
        if n_proc > 1:
            # What this rank launched and handed over (its counters live in
            # its own process): the per-rank record a launcher reads.
            from hdbscan_tpu_torch.ops.cuda_build import LAUNCHES
            from hdbscan_tpu_torch.parallel.mesh import COMM

            tracer("rank_summary", rank=rank, backend=distributed.backend(),
                   shards=len(mesh.local_shards()), fit_wall_s=round(wall, 6),
                   **{f"launches_{k}": v for k, v in LAUNCHES.items() if v},
                   **{f"handover_{k}_{f}": (round(v[f], 6) if f == "wall_s" else v[f])
                      for k, v in COMM.items() for f in ("bytes", "calls", "wall_s")})

        gate_rc = 0
        if assert_not_replicated:
            from hdbscan_tpu_torch.obs.audit import ReplicatedBufferError

            try:
                gate = obs.assert_not_replicated(n, data.dtype.itemsize)
            except ReplicatedBufferError as e:
                if flight is not None:
                    try:
                        flight.dump("replication_gate", extra={"error": str(e)})
                    except Exception:
                        pass
                print(f"error: replicated device buffer: {e}", file=sys.stderr)
                gate_rc = 3
            except RuntimeError as e:
                # No audited phase: the gate fails loudly, never vacuously.
                print(f"error: {e}", file=sys.stderr)
                gate_rc = 3
            else:
                tracer("replication_gate", ok=True,
                       threshold_bytes=int(gate["threshold_bytes"]),
                       worst_fraction=gate["worst_fraction"], phases=len(gate["phases"]))
        if n_proc > 1:
            # The exit barrier, on every rank alike right after the fit, so
            # rank 0's writes (which grow with n) come after it and no
            # collective timeout bounds them. A peer closes its trace first:
            # rank 0 reads every rank's whole trace for the report.
            import torch.distributed as dist

            if not is_main:
                close_layers()
            dist.barrier()
            if not is_main:
                teardown()
                return gate_rc
        if gate_rc:
            return gate_rc

        t0 = time.monotonic()
        paths = hdbscan.write_outputs(result, params)
        tracer("write_outputs", wall_s=round(time.monotonic() - t0, 6))
        if model_out is not None:
            t0 = time.monotonic()
            result.to_cluster_model(data, params, device=device).save(model_out)
            tracer("model_save", wall_s=round(time.monotonic() - t0, 6))
            paths = dict(paths, model=model_out)
        n_clusters = len(set(result.labels[result.labels > 0].tolist()))
        n_noise = int(np.sum(result.labels == 0))
        print(
            f"hdbscan-tpu: {n} points, {mode}, {n_clusters} clusters, "
            f"{n_noise} noise, {wall:.2f}s"
        )
        if result.infinite_stability:
            print(
                "WARNING: some clusters have infinite stability (duplicate "
                "points denser than minPts); results may be unreliable at "
                "those clusters.",
                file=sys.stderr,
            )
        for kind, path in paths.items():
            print(f"  {kind}: {path}")
        if getattr(result, "consensus_info", None) is not None:
            print(
                "note: consensus run — partition.csv and outlier scores "
                "describe the stabilized ensemble reading; hierarchy/tree "
                "files describe the representative draw (see the "
                "consensus provenance sidecar).",
                file=sys.stderr,
            )
        summary = tracer.summary()
        if summary:
            print("phases:", file=sys.stderr)
            for line in summary.splitlines():
                print(f"  {line}", file=sys.stderr)
    except BaseException as e:
        # An unhandled fit crash leaves a bundle behind even though the
        # process is about to die.
        if flight is not None and not isinstance(e, SystemExit):
            try:
                flight.dump("exception", extra={"error": repr(e)})
            except Exception:
                pass
        # A rank that fails tears its group down, so its peers fail at
        # their next collective instead of waiting out the timeout.
        teardown()
        raise
    finally:
        close_layers()

    if report_out is not None:
        from hdbscan_tpu_torch.obs.roofline import default_tags

        telemetry.write_report(report_out, telemetry.build_report(
            tracer,
            manifest=telemetry.run_manifest(params, argv=argv_full, extra={
                "compile_cache": {
                    "dir": cache_dir,
                    "jit_compiles": telemetry.compile_counter()(),
                    "cache_hits": telemetry.cache_hit_counter()(),
                },
            }),
            memory={"start": mem_start, "end": telemetry.sample_device_memory()},
            timeline=tl_rec.phase_table() if tl_rec is not None else None,
            roofline_tags=default_tags(device),
            per_host=(telemetry.merge_host_traces(telemetry.host_trace_paths(trace_out, n_proc))
                      if n_proc > 1 and trace_out is not None else None),
        ))
    teardown()
    return 0


def _main_predict(argv: list[str], argv_full: list[str]) -> int:
    try:
        model_path = _pop_path_flag(argv, "--model")
        points_path = _pop_path_flag(argv, "--points")
        out_path = _pop_path_flag(argv, "--out")
        trace_out = _pop_path_flag(argv, "--trace-out")
        report_out = _pop_path_flag(argv, "--report")
        device_flag = _pop_path_flag(argv, "--device")
        params = HDBSCANParams.from_args(argv)
    except ValueError as e:
        print(f"error: {e}\n{HELP}", file=sys.stderr)
        return 2
    if not model_path or not points_path:
        print("error: predict requires --model MODEL.npz and --points <input>",
              file=sys.stderr)
        return 2

    import numpy as np

    device = _device(device_flag)
    if device is None:
        return 1

    from hdbscan_tpu_torch.serve.artifact import ClusterModel
    from hdbscan_tpu_torch.serve.predict import Predictor
    from hdbscan_tpu_torch.utils.cache import enable_persistent_compilation_cache
    from hdbscan_tpu_torch.utils.io import load_points

    enable_persistent_compilation_cache(params.compile_cache)
    tracer = _serving_tracer(trace_out, report_out, params.trace_max_events)
    try:
        t0 = time.monotonic()
        try:
            model = ClusterModel.load(model_path)
        except (OSError, ValueError, KeyError) as e:
            print(f"error: cannot load model: {e}", file=sys.stderr)
            return 2
        tracer("model_load", n_train=model.n_train, mode=model.mode,
               wall_s=round(time.monotonic() - t0, 6))
        t0 = time.monotonic()
        points = load_points(points_path)
        if points.ndim == 1:
            points = points[:, None]
        tracer("load_points", rows=len(points), dims=int(points.shape[1]),
               wall_s=round(time.monotonic() - t0, 6))
        predictor = Predictor(model, backend=params.predict_backend,
                              max_batch=params.predict_max_batch, tracer=tracer,
                              device=device)
        predictor.warmup()
        try:
            labels, prob, score = predictor.predict(points)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if out_path is not None:
            with open(out_path, "w", encoding="utf-8") as f:
                f.write("label,probability,outlier_score\n")
                for row in zip(labels, prob, score):
                    f.write(f"{row[0]},{row[1]:.6f},{row[2]:.6f}\n")
        n_clusters = len(set(labels[labels > 0].tolist()))
        n_noise = int(np.sum(labels == 0))
        print(f"hdbscan-tpu predict: {len(points)} points, {n_clusters} clusters, "
              f"{n_noise} noise ({predictor.backend} backend)")
        if out_path is not None:
            print(f"  predictions: {out_path}")
    finally:
        tracer.close()
    if report_out is not None:
        _write_serving_report(report_out, tracer, params, argv_full)
    return 0


def _main_serve(argv: list[str], argv_full: list[str]) -> int:
    try:
        model_path = _pop_path_flag(argv, "--model")
        host = _pop_path_flag(argv, "--host") or "127.0.0.1"
        port = _pop_path_flag(argv, "--port")
        trace_out = _pop_path_flag(argv, "--trace-out")
        report_out = _pop_path_flag(argv, "--report")
        port_file = _pop_path_flag(argv, "--port-file")
        device_flag = _pop_path_flag(argv, "--device")
        model_dir = _pop_path_flag(argv, "--model-dir")
        tenants_dir = _pop_path_flag(argv, "--tenants-dir")
        ingest = _pop_bool_flag(argv, "--ingest")
        params = HDBSCANParams.from_args(argv)
        port = int(port) if port is not None else 8799
    except ValueError as e:
        print(f"error: {e}\n{HELP}", file=sys.stderr)
        return 2
    if not model_path:
        print("error: serve requires --model MODEL.npz", file=sys.stderr)
        return 2
    device = _device(device_flag)
    if device is None:
        return 1

    from hdbscan_tpu_torch.serve.artifact import ClusterModel
    from hdbscan_tpu_torch.serve.server import ClusterServer
    from hdbscan_tpu_torch.utils.cache import enable_persistent_compilation_cache

    enable_persistent_compilation_cache(params.compile_cache)
    tracer = _serving_tracer(trace_out, report_out, params.trace_max_events)
    try:
        try:
            model = ClusterModel.load(model_path)
        except (OSError, ValueError, KeyError) as e:
            print(f"error: cannot load model: {e}", file=sys.stderr)
            return 2
        try:
            server = ClusterServer(model, backend=params.predict_backend,
                                   max_batch=params.predict_max_batch, host=host, port=port,
                                   tracer=tracer, ingest=ingest, params=params,
                                   model_dir=model_dir, tenants=tenants_dir, device=device)
        except NotImplementedError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if port_file is not None:
            # The fleet router polls this file to discover the replica's
            # ephemeral port (serve --port 0): written only once bound.
            with open(port_file, "w", encoding="utf-8") as f:
                f.write(f"{server.port}\n")
        mode = ""
        if ingest:
            mode = (f", ingest on ({params.stream_drift_stat} drift @ "
                    f"{params.stream_drift_threshold}, {params.stream_reload} reload)")
        if tenants_dir is not None:
            mode += f", tenants dir {tenants_dir} (lru {params.tenant_lru_size})"
        print(
            f"hdbscan-tpu serve: http://{server.host}:{server.port} "
            f"(model {model_path}, {model.n_train} train points, "
            f"{server.predictor.backend} backend, buckets {server.predictor.buckets}{mode})",
            file=sys.stderr, flush=True,
        )
        server.serve_forever()
    finally:
        tracer.close()
    if report_out is not None:
        _write_serving_report(report_out, tracer, params, argv_full)
    return 0


def _main_fleet(argv: list[str], argv_full: list[str]) -> int:
    try:
        model_path = _pop_path_flag(argv, "--model")
        host = _pop_path_flag(argv, "--host") or "127.0.0.1"
        port = _pop_path_flag(argv, "--port")
        trace_out = _pop_path_flag(argv, "--trace-out")
        report_out = _pop_path_flag(argv, "--report")
        model_dir = _pop_path_flag(argv, "--model-dir")
        tenants_dir = _pop_path_flag(argv, "--tenants-dir")
        wal_root = _pop_path_flag(argv, "--wal-root")
        replica_trace_dir = _pop_path_flag(argv, "--replica-trace-dir")
        device_flag = _pop_path_flag(argv, "--device")
        ingest = _pop_bool_flag(argv, "--ingest")
        params = HDBSCANParams.from_args(argv)
        port = int(port) if port is not None else 0
    except ValueError as e:
        print(f"error: {e}\n{HELP}", file=sys.stderr)
        return 2
    if not model_path:
        print("error: fleet requires --model MODEL.npz", file=sys.stderr)
        return 2

    from hdbscan_tpu_torch.fleet.router import FleetRouter

    tracer = _serving_tracer(trace_out, report_out, params.trace_max_events)
    rc = 1
    try:
        # The remaining key=value argv forwards to every replica verbatim,
        # so predict_batch / queue_bound / wal knobs tune the whole fleet
        # from one command line (fleet_* keys are valid serve config too,
        # inert in a replica).
        try:
            router = FleetRouter(
                model_path,
                replicas=params.fleet_replicas,
                policy=params.fleet_policy,
                health_interval_s=params.fleet_health_interval_s,
                drain_s=params.fleet_drain_s,
                host=host,
                port=port,
                replica_args=argv,
                tenants_dir=tenants_dir,
                model_dir=model_dir,
                ingest=ingest,
                wal_root=wal_root,
                tracer=tracer,
                replica_trace_dir=replica_trace_dir,
                verbose=True,
                compile_cache=params.compile_cache,
                device=device_flag,
            )
            router.start()
        except (RuntimeError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(
            f"hdbscan-tpu fleet: http://{router.host}:{router.port} "
            f"({params.fleet_replicas} replicas, {params.fleet_policy} "
            f"routing, model {model_path})",
            file=sys.stderr, flush=True,
        )
        scaler = None
        if params.fleet_autoscale:
            from hdbscan_tpu_torch.fleet.controlplane import Autoscaler

            scaler = Autoscaler(
                router,
                min_replicas=params.fleet_min_replicas,
                max_replicas=params.fleet_max_replicas,
                high_load=params.fleet_scale_high_load,
                low_load=params.fleet_scale_low_load,
                high_p99_s=params.fleet_scale_p99_s,
                cooldown_s=params.fleet_scale_cooldown_s,
            ).start()
            print(
                f"hdbscan-tpu fleet: autoscaler on [{params.fleet_min_replicas}, "
                f"{params.fleet_max_replicas}] replicas",
                file=sys.stderr, flush=True,
            )
        try:
            rc = router.serve_forever()
        finally:
            if scaler is not None:
                scaler.stop()
    finally:
        tracer.close()
    if report_out is not None:
        _write_serving_report(report_out, tracer, params, argv_full)
    return rc

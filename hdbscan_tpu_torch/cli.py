"""The command line — the port of ``hdbscan_tpu/cli.py``'s ``fit``,
``predict`` and ``serve``.

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
        [trace_rotate_bytes=N] [trace_max_events=N] \
        [--trace-out PATH] [--model-out MODEL.npz] [--device DEV]
    python -m hdbscan_tpu_torch predict --model MODEL.npz --points <input> \
        [--out PRED.csv] [predict_backend={auto,xla,fused,rpforest}] \
        [predict_batch=N] [--trace-out PATH] [--device DEV]
    python -m hdbscan_tpu_torch serve --model MODEL.npz [--host H] [--port P] \
        [--port-file PATH] [predict_backend=...] [predict_batch=N] \
        [queue_bound=N] [deadline_ms=F] [faults=SPEC] [trace_max_events=N] \
        [--ingest] [--model-dir DIR] [absorb_eps=F] [drift_stat={psi,ks}] \
        [drift_threshold=F] [refit_budget=N] [stream_reload={auto,manual}] \
        [circuit_failures=N] [circuit_reset=F] [wal_dir=DIR] [snapshot_every=N] \
        [maintain={off,incremental}] [maintain_budget=F] \
        [maintain_dirty_frac=F] [maintain_refresh=N] \
        [--trace-out PATH] [--device DEV]

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

Not ported yet — each exits 2 before any data is read:
``fleet`` (ROADMAP A12), ``serve --tenants-dir`` (A12), ``--report``,
``--flight-dir``, ``--assert-not-replicated``, ``--compile-cache`` /
``compile_cache=`` and the observability knobs ``heartbeat``,
``watchdog``, ``skew_threshold``, ``straggler_rounds`` (A11),
``clusterName`` other than ``local`` (multi-process runs, A9b).
"""

from __future__ import annotations

import os
import sys
import time

from hdbscan_tpu_torch.config import HDBSCANParams

HELP = __doc__

#: Subcommands of the reference that are not ported, with their items.
_UNPORTED_COMMANDS = {"fleet": "A12"}
#: ``--flag PATH`` options of the reference's fit that are not ported.
_UNPORTED_PATH_FLAGS = (("--report", "A11"), ("--flight-dir", "A11"),
                        ("--compile-cache", "A11"))
#: The reference's ``serve --flag PATH`` options that are not ported.
_UNPORTED_SERVE_FLAGS = (("--report", "A11"), ("--tenants-dir", "A12"))
#: Fit parameters whose engine is not ported: (field, CLI key, item).
_UNPORTED_FIELDS = (("compile_cache", "compile_cache", "A11"),
                    ("heartbeat_s", "heartbeat", "A11"),
                    ("watchdog_s", "watchdog", "A11"),
                    ("obs_skew_threshold", "skew_threshold", "A11"),
                    ("obs_straggler_rounds", "straggler_rounds", "A11"))


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


def _not_ported(what: str, item: str) -> int:
    print(f"error: {what} is not ported yet (ROADMAP {item})", file=sys.stderr)
    return 2


def _refuse_fields(params) -> int:
    """Exit 2 naming the item of the first unported knob that is set."""
    default = HDBSCANParams()
    for field, key, item in _UNPORTED_FIELDS:
        if getattr(params, field) != getattr(default, field):
            return _not_ported(f"{key}={getattr(params, field)}", item)
    return 0


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
    else one shard per card when more than one is visible, else none."""
    import torch

    from hdbscan_tpu_torch.parallel.mesh import get_mesh

    if flag and "," in flag:
        return get_mesh([torch.device(d) for d in flag.split(",")])
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        return get_mesh()
    return None


def _serving_tracer(trace_out: str | None, max_events: int):
    """Tracer of the serving commands: ``--trace-out`` as JSON lines,
    ``HDBSCAN_TPU_TRACE=1`` as logfmt on stderr, the in-memory list bounded
    by ``trace_max_events``."""
    from hdbscan_tpu_torch.utils.tracing import JsonlSink, Tracer

    sinks = [JsonlSink(trace_out, static={"process": 0})] if trace_out is not None else []
    return Tracer(stream=sys.stderr if os.environ.get("HDBSCAN_TPU_TRACE") else None,
                  sinks=sinks, max_events=max_events)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or any(a in ("-h", "--help", "help") for a in argv):
        print(HELP)
        return 0
    # A bare key=value invocation (the reference's documented contract)
    # means fit.
    if argv[0] in _UNPORTED_COMMANDS:
        return _not_ported(f"the {argv[0]} subcommand", _UNPORTED_COMMANDS[argv[0]])
    if argv[0] == "predict":
        return _main_predict(argv[1:])
    if argv[0] == "serve":
        return _main_serve(argv[1:])
    if argv[0] == "fit":
        argv = argv[1:]
    return _main_fit(argv)


def _main_fit(argv: list[str]) -> int:
    try:
        trace_out = _pop_path_flag(argv, "--trace-out")
        model_out = _pop_path_flag(argv, "--model-out")
        device_flag = _pop_path_flag(argv, "--device")
        for flag, item in _UNPORTED_PATH_FLAGS:
            if _pop_path_flag(argv, flag) is not None:
                return _not_ported(flag, item)
        if _pop_bool_flag(argv, "--assert-not-replicated"):
            return _not_ported("--assert-not-replicated", "A11")
        params = HDBSCANParams.from_args(argv)
    except ValueError as e:
        print(f"error: {e}\n{HELP}", file=sys.stderr)
        return 2
    if not params.input_file:
        print("error: file=<input> is required", file=sys.stderr)
        return 2
    refused = _refuse_fields(params)
    if refused:
        return refused
    if params.cluster_name != "local":
        return _not_ported(f"clusterName={params.cluster_name} (multi-process runs)", "A9b")

    import numpy as np

    device = _device(device_flag)
    if device is None:
        return 1

    from hdbscan_tpu_torch.models import exact, hdbscan, mr_hdbscan
    from hdbscan_tpu_torch.parallel.shard import resolve_fit_sharding
    from hdbscan_tpu_torch.utils.io import load_points
    from hdbscan_tpu_torch.utils.tracing import JsonlSink, Tracer

    try:
        mesh = _mesh(device_flag, device)
    except ValueError as e:
        print(f"error: --device: {e}", file=sys.stderr)
        return 2

    # Always collected, so the end-of-run summary shows the phase walls;
    # --trace-out persists the events, HDBSCAN_TPU_TRACE=1 streams them.
    sinks = []
    if trace_out is not None:
        sinks.append(JsonlSink(trace_out, static={"process": 0},
                               rotate_bytes=params.trace_rotate_bytes))
    tracer = Tracer(
        stream=sys.stderr if os.environ.get("HDBSCAN_TPU_TRACE") else None,
        sinks=sinks,
        max_events=params.trace_max_events,
    )
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
            return 2
        wall = time.monotonic() - t0
        tracer("fit", mode=mode.split(" ")[0], rows=n, wall_s=round(wall, 6))

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
    finally:
        tracer.close()
    return 0


def _main_predict(argv: list[str]) -> int:
    try:
        model_path = _pop_path_flag(argv, "--model")
        points_path = _pop_path_flag(argv, "--points")
        out_path = _pop_path_flag(argv, "--out")
        trace_out = _pop_path_flag(argv, "--trace-out")
        device_flag = _pop_path_flag(argv, "--device")
        if _pop_path_flag(argv, "--report") is not None:
            return _not_ported("--report", "A11")
        params = HDBSCANParams.from_args(argv)
    except ValueError as e:
        print(f"error: {e}\n{HELP}", file=sys.stderr)
        return 2
    if not model_path or not points_path:
        print("error: predict requires --model MODEL.npz and --points <input>",
              file=sys.stderr)
        return 2
    refused = _refuse_fields(params)
    if refused:
        return refused

    import numpy as np

    device = _device(device_flag)
    if device is None:
        return 1

    from hdbscan_tpu_torch.serve.artifact import ClusterModel
    from hdbscan_tpu_torch.serve.predict import Predictor
    from hdbscan_tpu_torch.utils.io import load_points

    tracer = _serving_tracer(trace_out, params.trace_max_events)
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
    return 0


def _main_serve(argv: list[str]) -> int:
    try:
        model_path = _pop_path_flag(argv, "--model")
        host = _pop_path_flag(argv, "--host") or "127.0.0.1"
        port = _pop_path_flag(argv, "--port")
        trace_out = _pop_path_flag(argv, "--trace-out")
        port_file = _pop_path_flag(argv, "--port-file")
        device_flag = _pop_path_flag(argv, "--device")
        model_dir = _pop_path_flag(argv, "--model-dir")
        ingest = _pop_bool_flag(argv, "--ingest")
        for flag, item in _UNPORTED_SERVE_FLAGS:
            if _pop_path_flag(argv, flag) is not None:
                return _not_ported(f"serve {flag}", item)
        params = HDBSCANParams.from_args(argv)
        port = int(port) if port is not None else 8799
    except ValueError as e:
        print(f"error: {e}\n{HELP}", file=sys.stderr)
        return 2
    if not model_path:
        print("error: serve requires --model MODEL.npz", file=sys.stderr)
        return 2
    refused = _refuse_fields(params)
    if refused:
        return refused
    device = _device(device_flag)
    if device is None:
        return 1

    from hdbscan_tpu_torch.serve.artifact import ClusterModel
    from hdbscan_tpu_torch.serve.server import ClusterServer

    tracer = _serving_tracer(trace_out, params.trace_max_events)
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
                                   model_dir=model_dir, device=device)
        except NotImplementedError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if port_file is not None:
            # Written only after the socket is bound (serve --port 0).
            with open(port_file, "w", encoding="utf-8") as f:
                f.write(f"{server.port}\n")
        mode = ""
        if ingest:
            mode = (f", ingest on ({params.stream_drift_stat} drift @ "
                    f"{params.stream_drift_threshold}, {params.stream_reload} reload)")
        print(
            f"hdbscan-tpu serve: http://{server.host}:{server.port} "
            f"(model {model_path}, {model.n_train} train points, "
            f"{server.predictor.backend} backend, buckets {server.predictor.buckets}{mode})",
            file=sys.stderr, flush=True,
        )
        server.serve_forever()
    finally:
        tracer.close()
    return 0

"""The command line — the port of ``hdbscan_tpu/cli.py``'s ``fit`` path.

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
        [--trace-out PATH] [--device DEV]

The dataset is routed as the reference routes it: with ``fit_sharding``
resolving to ``sharded`` and n <= ``processing_units``, the exact fit over
a mesh (``models/exact.fit``, mode ``exact-sharded``); otherwise n <=
``processing_units`` runs the dense single-block fit (``models/hdbscan.fit``,
mode ``exact``) and larger inputs the MR-HDBSCAN* pipeline
(``models/mr_hdbscan.fit``, mode ``mr (<levels> levels)``, or
``mr-consensus (<N> draws)`` with ``consensus=N`` above 1). A mesh is built
only when more than one card is visible. On the exact-sharded route
``mst_backend=host`` runs the host-round Borůvka over the sharded scanner
and ``dedup=true`` the weighted fit over unique points; on the MR route
``variant=rs`` clusters the samples directly, ``dedup=true`` runs the
pipeline over weighted unique points, ``consensus=N`` takes the consensus
of N draws and ``compat_cf=true`` the Java code's CF arithmetic; the dense
route ignores ``dedup``, as the reference's does. Outputs are the five
canonical files either way (a consensus run adds the
``<base>_consensus.json`` provenance sidecar); the fit computes in
float32.

``--device DEV`` picks the device (default: the card; ``--device cpu`` runs
every kernel's plain PyTorch version). There is no fallback: with no card
and no ``--device cpu`` the command fails. ``--trace-out PATH`` writes every
stage event as a ``hdbscan-tpu-trace/1`` JSON line (rotated at
``trace_rotate_bytes``; validate with ``scripts/check_trace.py``);
``HDBSCAN_TPU_TRACE=1`` streams the events as logfmt lines to stderr. The
per-stage summary (``phases:``) always goes to stderr.

Not ported yet — each exits 2 before any data is read:
``predict`` and ``serve`` (ROADMAP A7), ``fleet`` (A12), ``--model-out``
(A7), ``--report``, ``--flight-dir``, ``--assert-not-replicated``,
``--compile-cache`` / ``compile_cache=`` and the observability knobs
``heartbeat``, ``watchdog``, ``skew_threshold``, ``straggler_rounds``
(A11), ``clusterName`` other than ``local`` (A9). A fit route that is not
ported (the MR route with ``fit_sharding=sharded`` or ``scan_backend=ring``,
or over a mesh of several cards (A9)) raises ``NotImplementedError``
naming its item, printed the same way with exit 2.
"""

from __future__ import annotations

import os
import sys
import time

from hdbscan_tpu_torch.config import HDBSCANParams

HELP = __doc__

#: Subcommands of the reference that are not ported, with their items.
_UNPORTED_COMMANDS = {"predict": "A7", "serve": "A7", "fleet": "A12"}
#: ``--flag PATH`` options of the reference's fit that are not ported.
_UNPORTED_PATH_FLAGS = (("--report", "A11"), ("--flight-dir", "A11"),
                        ("--compile-cache", "A11"), ("--model-out", "A7"))
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


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or any(a in ("-h", "--help", "help") for a in argv):
        print(HELP)
        return 0
    # A bare key=value invocation (the reference's documented contract)
    # means fit.
    if argv[0] in _UNPORTED_COMMANDS:
        return _not_ported(f"the {argv[0]} subcommand", _UNPORTED_COMMANDS[argv[0]])
    if argv[0] == "fit":
        argv = argv[1:]
    return _main_fit(argv)


def _main_fit(argv: list[str]) -> int:
    try:
        trace_out = _pop_path_flag(argv, "--trace-out")
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
    default = HDBSCANParams()
    for field, key, item in _UNPORTED_FIELDS:
        if getattr(params, field) != getattr(default, field):
            return _not_ported(f"{key}={getattr(params, field)}", item)
    if params.cluster_name != "local":
        return _not_ported(f"clusterName={params.cluster_name} (multi-process runs)", "A9")

    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import cuda_build

    try:
        device = cuda_build.resolve_device(device_flag)
    except RuntimeError as e:
        print(f"error: {e} (on the command line: --device cpu)", file=sys.stderr)
        return 1

    from hdbscan_tpu_torch.models import exact, hdbscan, mr_hdbscan
    from hdbscan_tpu_torch.parallel.shard import resolve_fit_sharding
    from hdbscan_tpu_torch.utils.io import load_points
    from hdbscan_tpu_torch.utils.tracing import JsonlSink, Tracer

    mesh = None
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        from hdbscan_tpu_torch.parallel.mesh import get_mesh

        mesh = get_mesh()

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
                mode = (f"mr-consensus ({params.consensus_draws} draws)"
                        if params.consensus_draws > 1 else f"mr ({result.n_levels} levels)")
        except NotImplementedError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        wall = time.monotonic() - t0
        tracer("fit", mode=mode.split(" ")[0], rows=n, wall_s=round(wall, 6))

        t0 = time.monotonic()
        paths = hdbscan.write_outputs(result, params)
        tracer("write_outputs", wall_s=round(time.monotonic() - t0, 6))
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

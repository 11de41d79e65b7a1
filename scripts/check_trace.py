#!/usr/bin/env python3
"""Validate hdbscan-tpu telemetry artifacts (README "Observability").

Usage::

    python scripts/check_trace.py TRACE.jsonl [REPORT.json]

Checks every JSONL line against the trace schema contract
(``utils/tracing.TRACE_SCHEMA``): parses as JSON, carries a matching
``schema`` tag, a string ``stage`` and a finite numeric ``wall_s``, and
``seq`` strictly increases per process. Ring-scan events
(``parallel/ring.py``, README "Scaling out") add two invariants: any event
carrying ``devices`` + ``ppermute_steps`` must satisfy
``ppermute_steps == devices - 1`` (one full panel rotation per round), and
per-device wall events (integer ``device`` field) must keep ``seq``
strictly increasing per (process, device). Host finalize events
(``models/_finalize.py``, README "Finalize pipeline") add one more: any
``tree_*`` stage must be one of the five known finalize stages
(merge_forest/condense/propagate/labels/glosh) and must carry a string
``backend`` tag naming the engine that ran (``native``/``python`` for the
merge forest, ``vectorized``/``reference`` for the tree stages). Serving
events (``serve/predict.py``, README "Serving") add three: every
``predict_batch`` event must carry a power-of-two ``bucket``, ``rows`` in
``[1, bucket]``, and a strictly increasing ``batch_seq`` per
(process, predictor) — blue/green swaps start a fresh predictor whose
sequence restarts, but each predictor's dispatch order is total.
Device MST events (``core/mst_device.py``, README "Device-resident
finalize") add three schemas: ``mst_round`` must carry an integer
``round >= 0``, ``components >= 1`` and ``edges_added >= 0`` — and rounds
tagged ``sharded: true`` (the in-jit sharded Borůvka ``while_loop``,
``parallel/shard.shard_boruvka_mst``) must additionally be CONTIGUOUS per
process (each round exactly prev + 1, resetting to 0 on a fresh fit) with
STRICTLY DECREASING ``components``; ``host_sync`` positive ``arrays`` and
non-negative ``bytes``; ``tree_build_device`` (a finalize stage, so it
also carries the ``backend`` tag) a boolean ``fallback`` and
``nodes == -1`` exactly when it fell back — plus two GLOBAL invariants:
the single-sync contract, per process exactly ONE ``host_sync`` per
``tree_build_device`` forest build, and the sharded single-sync contract,
per process at least one ``host_sync`` per ``shard_mst_device`` summary
(a sharded ``mst_backend=device`` fit syncs exactly once — the final edge
fetch).
Approximate-neighbor events (``ops/rpforest.py``, README "Approximate
neighbors") add three schemas: ``knn_index_build`` must carry positive
integer ``trees``/``depth``/``leaf_size``/``n`` with ``max_leaf <=
leaf_size``; ``knn_index_query`` positive ``n``/``k``/``trees`` and, when
sampled, ``recall_at_k`` in [0, 1]; ``knn_index_rescan`` an integer
``round`` in ``[0, rescan_rounds)`` and a non-negative ``improved``.
Streaming events (``hdbscan_tpu/stream``, README "Streaming") add four
schemas: ``stream_ingest`` must carry positive ``rows`` with non-negative
``absorbed``/``buffered`` summing to ``rows`` and a positive model
``generation``; ``drift_check`` a ``stat`` in {psi, ks}, finite
non-negative ``value``/``assign_psi``, positive ``threshold``, integer
``rows >= 0`` and a boolean ``drifted``; ``model_refit`` a boolean ``ok``
and positive ``rows``; ``model_swap`` a positive ``generation`` that
STRICTLY INCREASES per (process, server) — the blue/green contract that a
server process never swaps backwards or repeats a generation — plus a
string ``digest`` and positive ``n_train``.
Incremental-maintenance events (``hdbscan_tpu/incremental``, README
"Incremental maintenance") add three schemas: ``mst_splice`` must carry a
non-empty string ``maintainer``, positive ``n``, non-negative
``inserts``/``candidates``/``spliced``/``evicted``, a ``dirty_frac`` in
[0, 1], and edge counts that RECONCILE — ``edges_prev + spliced -
evicted == edges`` per maintenance step, with ``edges == n - 1`` exactly
(a splice always leaves one spanning tree); ``subtree_finalize`` a
non-empty string ``maintainer``, positive ``n``, non-negative
``nodes_total`` with ``0 <= nodes_dirty <= nodes_total``, ``dirty_frac``
in [0, 1] and non-negative ``clusters``/``changed_clusters``;
``maintain_fallback`` a non-empty string ``maintainer``/``error``,
positive ``generation`` and non-negative ``n``/``inserts``.
Request spans (``serve/server.py``, README "Observability") add one more
schema: every ``request_span`` must carry a ``route`` in
``{/predict, /ingest}``, a non-empty string ``request_id`` that is UNIQUE
per process (each HTTP request is spanned exactly once), ``rows >= 1``, a
power-of-two ``bucket``, ``coalesced >= 1``, ``generation >= 1``, and five
finite non-negative segment walls (``parse_s``/``queue_s``/``assemble_s``/
``predict_s``/``respond_s``) that TELESCOPE: their sum equals ``wall_s``
within 1e-6 — the contract that the decomposition accounts for every
microsecond of request wall. Spans may carry an integer HTTP ``status``
(error spans included since the fault-tolerance layer); ``status >= 400``
relaxes ``rows`` to ``>= 0`` (a request can fail before any row reaches
the batcher).
Fault-tolerance events (``hdbscan_tpu/fault`` + ``stream/wal.py``, README
"Fault tolerance") add six schemas: ``fault_injected`` must carry a string
``site``/``mode`` and a positive ``nth`` (the per-site fire ordinal);
``request_shed`` a route in ``{/predict, /ingest}``, ``status`` in
``{429, 503}``, a string ``reason`` and a ``request_id`` UNIQUE per
process ACROSS shed and span events — every terminated request is exactly
one of the two, so shed + served + failed == offered; ``circuit_state`` a
string ``name``, ``state`` in {closed, open, half_open} and non-negative
``failures``; ``retry_backoff`` a string ``name``/``error``, positive
``attempt`` and non-negative ``delay_s``; ``wal_append`` a string ``wal``,
string ``kind``, non-negative ``rows`` and a ``wal_seq`` that is CONTIGUOUS
per (process, wal) — each append is exactly prev + 1, except a ``begin``
record may reset to 0 (journal wipe on digest change / blue-green swap);
``wal_recover`` a string ``wal``, non-negative ``records``/``rows`` and a
boolean ``snapshot``.
Fleet events (``hdbscan_tpu/fleet``, README "Fleet") add four schemas:
``fleet_route`` must carry a non-empty string ``replica``, a ``route`` in
``{/predict, /ingest}``, a ``policy`` in
``{consistent_hash, least_loaded}``, an HTTP ``status`` int and a positive
``attempts`` (how many replicas the router tried before this terminal
answer — 1 on the happy path, more after re-routes); ``replica_health`` a
non-empty string ``replica``, a boolean ``ok`` and non-negative
``failures``/``restarts``; ``tenant_load`` a non-empty string ``tenant``,
positive ``generation``, positive ``resident`` (the new tenant is resident
when its load event fires) and non-negative ``jit_compiles`` (0 on a
re-warm against a warmed bucket ladder — the zero-steady-state-recompile
contract across evictions); ``tenant_evict`` a non-empty string
``tenant``, positive ``generation`` and non-negative
``resident``/``requests``.
Control-plane events (``hdbscan_tpu/fleet`` controlplane/artifacts/jobs,
README "Fleet control plane") add three schemas: ``scale_event`` must
carry a ``direction`` in ``{up, down}``, a non-empty string ``replica``
and ``reason``, a positive ``replicas`` (the routing-set size AFTER the
operation) and a boolean ``ok`` (a failed scale-up leaves the set
unchanged and reports its ``error``); ``artifact_map`` a non-empty string
``digest``/``path``, boolean ``hit``/``spooled``, positive
``resident``/``refs`` (the described digest is itself resident and
referenced when its event fires), non-negative ``bytes``, and a ``hit``
history per (process, digest) that is MISS-THEN-HITS — the first touch of
a digest is always ``hit: false`` and every later touch ``hit: true``,
because store entries live for the process lifetime and are never
re-mapped; ``fit_job`` a non-empty string ``job``/``tenant``/``reason``,
a ``state`` in ``{queued, running, published, failed}`` forming a state
MACHINE per (process, job) — queued → running → published|failed, each
visited exactly once, nothing after a terminal state — plus a positive
``generation`` when present (published jobs), a finite non-negative
``queued_s`` when present (running events), and a non-empty ``error`` on
every failure.
Deep-observability events (``hdbscan_tpu/obs``, README "Observability")
add eight schemas: ``mem_sample`` must carry a non-empty string ``phase``,
a ``source`` in ``{memory_stats, live_arrays}`` and non-negative integer
``max_device_bytes``/``total_bytes``; ``mem_phase_peak`` additionally
positive ``samples``/``devices`` (non-negative when the row carries
``sampled: false`` — a phase whose sampling failed or raced teardown
still gets an honest zero row) and a ``max_device_bytes`` that is >= the
running max of every ``mem_sample`` seen for that (process, phase) since
the previous peak — a phase's published peak can never under-report its
own samples; ``heartbeat`` a non-empty string ``phase``, a positive
integer ``task`` id, a ``progress`` in [0, 1] that is MONOTONE
non-decreasing per (process, phase, task) — progress fractions never move
backwards — plus an optional finite non-negative ``eta_s``;
``watchdog_stall`` a positive ``stalled_s``, a positive integer
``threads``, a non-empty ``phases`` list and a string ``stacks`` dump;
``router_span`` (the fleet router's half of a request's causal chain) a
non-empty string ``request_id``/``replica``, ``route`` in
``{/predict, /ingest}``, ``policy`` in ``{consistent_hash, least_loaded}``,
an HTTP ``status`` int, positive ``attempts``, a finite non-negative
``queue_s`` and a boolean ``replied``; ``device_timeline`` (the mesh
timeline, README "Deep observability") a non-empty string ``phase``,
non-negative integer ``device``/``round``/``comm_bytes``,
``attribution == "model"`` and three finite non-negative segments
(``compute_s``/``comm_s``/``host_s``) that TELESCOPE — their sum equals
``wall_s`` within 1e-6 — plus round CONTIGUITY per (process, device,
phase): rounds may repeat, advance by one, or reset to a lower value,
never skip ahead; ``straggler_flag`` a non-negative ``device``/``round``,
positive ``streak``, ``threshold >= 1``, ``ratio >= threshold`` and
``wall_s >= median_s`` (a flag must describe a genuinely slow device);
``flight_dump`` a ``reason`` from the known dump-reason set, a non-empty
bundle ``path`` and a non-negative ``events`` count.
Sharded-fit events (``parallel/shard.py``, README "One sharded program")
add six schemas: ``shard_knn_build`` must carry positive integer
``devices``/``trees``/``depth``/``leaf_size``/``n``/``d`` with
``max_leaf <= leaf_size``; ``shard_panel_sweep`` positive
``devices``/``rows``/``trees``/``shard`` (its ``ppermute_steps ==
devices - 1`` rides the generic ring invariant above);
``shard_knn_exchange`` positive ``n``/``k``/``trees``/``devices``/
``candidates`` and, when sampled, ``recall_at_k`` in [0, 1];
``shard_boruvka_scan`` positive ``devices``/``n_comp``, non-negative
``round``/``candidates``, a ``round`` that is CONTIGUOUS per process
(each scan is exactly prev + 1, resetting to 0 when a new scanner
starts) and an ``n_comp`` that STRICTLY DECREASES across a scanner's
rounds — Borůvka contracts components every round or the fit is looping;
``shard_mst_device`` (the in-jit sharded Borůvka program summary,
one per sharded ``mst_backend=device`` fit) positive
``devices``/``rounds``/``n``/``shard`` — its per-round
``ppermute_steps == devices - 1`` rides the generic ring invariant, and
its one-host_sync contract is the global device-MST check above;
``replication_gate`` must carry ``ok == true`` (the event only exists on
a passing gate), a positive ``threshold_bytes``/``phases`` and a
``worst_fraction`` in [0, 1).

``check_trace.py --join ROUTER.jsonl REPLICA.jsonl [REPLICA.jsonl ...]``
validates every file, then joins the router's ``router_span`` events
against the replicas' ``request_span``/``request_shed`` events on
``request_id``: every replied router span must match EXACTLY ONE replica
event (100% causal-chain reconstruction), and a duplicate match (the same
id answered by two replicas) is a violation.

Spans (``utils/tracing.span`` in the PyTorch port, README "Observability")
are added fields on any line under the same schema: a line carrying
``t0_ns`` must carry integer ``t0_ns <= t1_ns`` (``time.perf_counter_ns``),
a ``wall_s`` equal to their difference within 1e-6 s, a ``span_id`` (an
integer or a non-empty string: a request's id), a ``parent_id`` and a
``root_id`` of the same kinds (``parent_id`` null at a root), a string
``thread`` and, where the span was device-timed, a finite non-negative
``device_ms``. A line with ``span`` true is a span alone (not a stage of a
``trace`` hook): the report's phase table leaves it out.

Given
a report (``utils/telemetry.REPORT_SCHEMA``), additionally cross-checks
that the report's per-phase wall totals equal the trace's per-stage wall
sums within 1e-6, and — when the report carries a ``predict_latency``
section — that its nearest-rank p50/p95/p99/p999 recompute exactly from
the trace's ``predict_batch`` walls (same 1e-6 tolerance) — the round-trip
guarantees the tier-1 e2e tests pin.

Rotated trace sets (``JsonlSink`` ``rotate_bytes``, README "Deep
observability"): when ``TRACE.jsonl.1`` sits next to ``TRACE.jsonl`` the
pair is validated as ONE logical trace — the rotated file first, then the
live file — with every cross-event invariant spanning the boundary, and
the live file's first ``seq`` per process must be exactly contiguous with
the rotated file's last (a gap means the rotation lost lines).

Exit code 0 = valid; 1 = any violation (all violations printed). Pure
stdlib on purpose: the validator must run where the run artifacts land,
without the package or jax installed.
"""

from __future__ import annotations

import json
import math
import os
import sys

#: Kept in sync with ``hdbscan_tpu.utils.tracing.TRACE_SCHEMA`` /
#: ``hdbscan_tpu.utils.telemetry.REPORT_SCHEMA`` — stdlib-only duplicate so
#: the validator runs without the package importable.
TRACE_SCHEMA_PREFIX = "hdbscan-tpu-trace/"
REPORT_SCHEMA_PREFIX = "hdbscan-tpu-report/"
WALL_TOLERANCE = 1e-6

#: The host finalize stages ``models/_finalize.py`` emits — any other
#: ``tree_``-prefixed stage name is a contract violation (e.g. the pre-split
#: lumped ``tree_extract`` event).
TREE_STAGES = frozenset(
    {
        "tree_merge_forest",
        "tree_condense",
        "tree_propagate",
        "tree_labels",
        "tree_glosh",
    }
)

#: ``tree_``-prefixed stages that are legal but not part of the mandatory
#: split set: ``tree_build_device`` only appears when the device engine
#: built the merge forest (core/mst_device.py).
TREE_STAGES_OPTIONAL = frozenset({"tree_build_device"})
TREE_STAGES_ALL = TREE_STAGES | TREE_STAGES_OPTIONAL


def _span_id(v, null_ok: bool = False) -> bool:
    if v is None:
        return null_ok
    if isinstance(v, str):
        return bool(v)
    return isinstance(v, int) and not isinstance(v, bool)


def _check_span(path: str, lineno: int, ev: dict) -> list[str]:
    """A span's added fields (utils/tracing.span)."""
    where = f"{path}:{lineno}: span {ev.get('stage')!r}"
    errors = []
    t0, t1 = ev.get("t0_ns"), ev.get("t1_ns")
    if not all(isinstance(t, int) and not isinstance(t, bool) for t in (t0, t1)) or t1 < t0:
        errors.append(f"{where} t0_ns={t0!r} t1_ns={t1!r} not ordered integers")
    else:
        wall = ev.get("wall_s")
        if isinstance(wall, (int, float)) and abs(wall - (t1 - t0) / 1e9) > WALL_TOLERANCE:
            errors.append(f"{where} wall_s={wall!r} != (t1_ns - t0_ns) / 1e9")
    if not _span_id(ev.get("span_id")):
        errors.append(f"{where} span_id={ev.get('span_id')!r} not an id")
    if not _span_id(ev.get("parent_id"), null_ok=True) or not _span_id(ev.get("root_id")):
        errors.append(f"{where} parent_id/root_id not ids")
    if not isinstance(ev.get("thread"), str):
        errors.append(f"{where} thread={ev.get('thread')!r} not a string")
    if "device_ms" in ev:
        d = ev["device_ms"]
        if not isinstance(d, (int, float)) or isinstance(d, bool) or not math.isfinite(d) \
                or d < 0:
            errors.append(f"{where} device_ms={d!r} not a finite non-negative number")
    return errors


def validate_trace(path: str) -> tuple[list[dict], list[str]]:
    """Parse + validate one JSONL trace file.

    Returns ``(events, errors)`` — events that parsed (even if invalid), and
    human-readable violation strings (empty = valid).
    """
    events: list[dict] = []
    errors: list[str] = []
    last_seq: dict = {}  # per-process strictly-increasing seq check
    last_dev_seq: dict = {}  # per-(process, device) seq for ring wall events
    last_batch_seq: dict = {}  # per-(process, predictor) predict_batch seq
    sync_counts: dict = {}  # per-process [host_syncs, device forest builds]
    last_sharded_mst: dict = {}  # per-process (round, components), sharded
    sharded_mst_fits: dict = {}  # per-process shard_mst_device fit count
    last_swap_gen: dict = {}  # per-(process, server) model_swap generation
    seen_request_ids: dict = {}  # per-process ids across span + shed events
    last_wal_seq: dict = {}  # per-(process, wal) wal_append seq
    mem_running_max: dict = {}  # per-(process, phase) mem_sample running max
    hb_progress: dict = {}  # per-(process, phase, task) heartbeat progress
    last_shard_round: dict = {}  # per-process (round, n_comp) Borůvka state
    last_tl_round: dict = {}  # per-(process, device, phase) timeline round
    fit_job_state: dict = {}  # per-(process, job) fit_job state machine
    artifact_seen: dict = {}  # per-process set of artifact_map digests
    # Rotated sets (``JsonlSink`` ``rotate_bytes``): when ``<path>.1``
    # exists, the pair is ONE logical trace — read the rotated file first,
    # then the live file, sharing every cross-event tracker so seq order,
    # watermark state and round contiguity all span the boundary. The
    # sink's per-line seq keeps counting across a rotation, so the live
    # file's first seq per process must be exactly the rotated file's last
    # seq + 1 (a gap means lines were lost, not rotated).
    live_path = path
    sources = (
        [path + ".1", path] if os.path.exists(path + ".1") else [path]
    )
    rotation_carry: dict | None = None
    seen_after_rotation: set = set()
    for path in sources:
        rotating_boundary = rotation_carry is not None
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError as e:
                    errors.append(f"{path}:{lineno}: not valid JSON ({e})")
                    continue
                if not isinstance(ev, dict):
                    errors.append(f"{path}:{lineno}: line is not a JSON object")
                    continue
                events.append(ev)
                schema = ev.get("schema")
                if not isinstance(schema, str) or not schema.startswith(
                    TRACE_SCHEMA_PREFIX
                ):
                    errors.append(
                        f"{path}:{lineno}: schema={schema!r} (want "
                        f"{TRACE_SCHEMA_PREFIX}<n>)"
                    )
                if not isinstance(ev.get("stage"), str) or not ev.get("stage"):
                    errors.append(f"{path}:{lineno}: missing/non-string 'stage'")
                stage = ev.get("stage")
                if isinstance(stage, str) and stage.startswith("tree_"):
                    # Finalize-stage invariants (models/_finalize.py).
                    if stage not in TREE_STAGES_ALL:
                        errors.append(
                            f"{path}:{lineno}: unknown finalize stage {stage!r} "
                            f"(want one of {sorted(TREE_STAGES_ALL)})"
                        )
                    backend = ev.get("backend")
                    if not isinstance(backend, str) or not backend:
                        errors.append(
                            f"{path}:{lineno}: {stage} lacks a string 'backend' tag"
                        )
                wall = ev.get("wall_s")
                if not isinstance(wall, (int, float)) or isinstance(wall, bool) or (
                    isinstance(wall, float) and not math.isfinite(wall)
                ):
                    errors.append(f"{path}:{lineno}: wall_s={wall!r} not finite number")
                seq = ev.get("seq")
                proc = ev.get("process")
                if isinstance(seq, int):
                    if rotating_boundary and proc not in seen_after_rotation:
                        seen_after_rotation.add(proc)
                        carried = rotation_carry.get(proc)
                        if carried is not None and seq != carried + 1:
                            errors.append(
                                f"{path}:{lineno}: rotated set discontinuous: "
                                f"seq {seq} does not continue {live_path}.1 "
                                f"(last seq {carried})"
                            )
                    prev = last_seq.get(proc)
                    if prev is not None and seq <= prev:
                        errors.append(
                            f"{path}:{lineno}: seq {seq} not increasing (prev {prev})"
                        )
                    last_seq[proc] = seq
                if "t0_ns" in ev:
                    errors += _check_span(path, lineno, ev)
                # Ring-scan invariants (parallel/ring.py). Summary events carry
                # devices + ppermute_steps: one full panel rotation is exactly
                # devices - 1 permutes (the final panel is scanned in place).
                devices = ev.get("devices")
                steps = ev.get("ppermute_steps")
                if isinstance(devices, int) and steps is not None:
                    if not isinstance(steps, int) or steps != devices - 1:
                        errors.append(
                            f"{path}:{lineno}: ppermute_steps={steps!r} != "
                            f"devices - 1 ({devices} devices)"
                        )
                # Serving invariants (serve/predict.py): batches dispatch into
                # power-of-two buckets (the zero-recompile bucket set), never
                # carry more real rows than the bucket holds, and the dispatch
                # order is totally ordered per process.
                if stage == "predict_batch":
                    bucket = ev.get("bucket")
                    rows = ev.get("rows")
                    if not isinstance(bucket, int) or bucket < 1 or (
                        bucket & (bucket - 1)
                    ):
                        errors.append(
                            f"{path}:{lineno}: predict_batch bucket={bucket!r} "
                            f"is not a power of two"
                        )
                    elif not isinstance(rows, int) or not (1 <= rows <= bucket):
                        errors.append(
                            f"{path}:{lineno}: predict_batch rows={rows!r} not in "
                            f"[1, bucket={bucket}]"
                        )
                    bseq = ev.get("batch_seq")
                    if not isinstance(bseq, int):
                        errors.append(
                            f"{path}:{lineno}: predict_batch lacks integer "
                            f"'batch_seq'"
                        )
                    else:
                        # Keyed per (process, predictor): a blue/green swap
                        # builds a fresh Predictor whose batch_seq restarts at
                        # 0, but each predictor's own dispatch order is total.
                        bkey = (proc, ev.get("pred"))
                        prev = last_batch_seq.get(bkey)
                        if prev is not None and bseq <= prev:
                            errors.append(
                                f"{path}:{lineno}: batch_seq {bseq} not "
                                f"increasing (prev {prev})"
                            )
                        last_batch_seq[bkey] = bseq
                # Approximate-neighbor invariants (ops/rpforest.py): the three
                # knn_index_* events each pin their geometry fields.
                if stage in ("knn_index_build", "knn_index_query", "knn_index_rescan"):
                    errors += _check_knn_index(path, lineno, stage, ev)
                # Fused forest program summary (ops/rpforest.py fused
                # dispatch): geometry + precision/interpret provenance.
                if stage == "knn_fused_forest":
                    errors += _check_knn_fused_forest(path, lineno, ev)
                # Device-MST invariants (core/mst_device.py): per-event schemas
                # here; the one-sync-per-forest-build count check runs after the
                # file is fully read (see below).
                if stage in ("mst_round", "host_sync", "tree_build_device"):
                    errors += _check_mst_device(path, lineno, stage, ev)
                    if stage != "mst_round":
                        counts = sync_counts.setdefault(proc, [0, 0])
                        counts[0 if stage == "host_sync" else 1] += 1
                    elif ev.get("sharded") is True:
                        # In-jit sharded rounds (parallel/shard.py
                        # shard_boruvka_mst): contiguous per process and
                        # components strictly decreasing — replayed from
                        # the single fetched round counter, so a stall
                        # here means the while_loop looped without
                        # contracting.
                        rnd, nc = ev.get("round"), ev.get("components")
                        if _nonneg_int(rnd) and _pos_int(nc):
                            prev = last_sharded_mst.get(proc)
                            if rnd == 0:
                                pass  # a fresh sharded fit restarts
                            elif prev is None or rnd != prev[0] + 1:
                                errors.append(
                                    f"{path}:{lineno}: sharded mst_round "
                                    f"{rnd} not contiguous (prev "
                                    f"{None if prev is None else prev[0]})"
                                )
                            elif nc >= prev[1]:
                                errors.append(
                                    f"{path}:{lineno}: sharded mst_round "
                                    f"components {nc} did not decrease "
                                    f"(prev {prev[1]}) — the in-jit "
                                    f"Borůvka loop must contract every "
                                    f"round"
                                )
                            last_sharded_mst[proc] = (rnd, nc)
                # Each shard_mst_device summary marks one sharded fit with
                # mst_backend=device; the end-of-file check pins its
                # one-host_sync contract.
                if stage == "shard_mst_device":
                    sharded_mst_fits[proc] = sharded_mst_fits.get(proc, 0) + 1
                # Streaming invariants (hdbscan_tpu/stream + serve/server.py):
                # ingest row accounting, drift-check schema, and the blue/green
                # contract — swap generations strictly increase per server.
                if stage in ("stream_ingest", "drift_check", "model_refit",
                             "model_swap"):
                    errors += _check_stream(path, lineno, stage, ev)
                    if stage == "model_swap":
                        gen = ev.get("generation")
                        if _pos_int(gen):
                            key = (proc, ev.get("server"))
                            prev = last_swap_gen.get(key)
                            if prev is not None and gen <= prev:
                                errors.append(
                                    f"{path}:{lineno}: model_swap generation "
                                    f"{gen} not increasing (prev {prev}) for "
                                    f"server {ev.get('server')!r}"
                                )
                            last_swap_gen[key] = gen
                # Incremental-maintenance invariants (hdbscan_tpu/incremental):
                # splice edge-count reconciliation, dirty-subtree bounds, and
                # the fallback-event schema.
                if stage in ("mst_splice", "subtree_finalize",
                             "maintain_fallback"):
                    errors += _check_maintain(path, lineno, stage, ev)
                # Request-span invariants (serve/server.py): per-event schema
                # here; per-process request-id uniqueness needs cross-event
                # state so it lives in this loop.
                if stage == "request_span":
                    errors += _check_request_span(path, lineno, ev)
                    rid = ev.get("request_id")
                    if isinstance(rid, str) and rid:
                        seen = seen_request_ids.setdefault(proc, set())
                        if rid in seen:
                            errors.append(
                                f"{path}:{lineno}: request_span request_id "
                                f"{rid!r} repeated within process {proc!r}"
                            )
                        seen.add(rid)
                # Fault-tolerance invariants (hdbscan_tpu/fault + stream/wal.py):
                # per-event schemas in the helper; the shed/span request-id
                # exclusivity and the per-(process, wal) seq contiguity need
                # cross-event state so they live in this loop.
                if stage in ("fault_injected", "request_shed", "circuit_state",
                             "retry_backoff", "wal_append", "wal_recover"):
                    errors += _check_fault(path, lineno, stage, ev)
                    if stage == "request_shed":
                        rid = ev.get("request_id")
                        if isinstance(rid, str) and rid:
                            seen = seen_request_ids.setdefault(proc, set())
                            if rid in seen:
                                errors.append(
                                    f"{path}:{lineno}: request_shed request_id "
                                    f"{rid!r} repeated within process {proc!r} — "
                                    f"a request terminates as exactly one of "
                                    f"span/shed"
                                )
                            seen.add(rid)
                    elif stage == "wal_append":
                        wseq = ev.get("wal_seq")
                        if _nonneg_int(wseq):
                            key = (proc, ev.get("wal"))
                            prev = last_wal_seq.get(key)
                            reset = wseq == 0 and ev.get("kind") == "begin"
                            if prev is not None and wseq != prev + 1 and not reset:
                                errors.append(
                                    f"{path}:{lineno}: wal_append seq {wseq} not "
                                    f"contiguous (prev {prev}) for wal "
                                    f"{ev.get('wal')!r}"
                                )
                            last_wal_seq[key] = wseq
                # Fleet invariants (hdbscan_tpu/fleet): router routing/health
                # events and tenant-registry lifecycle events.
                if stage in ("fleet_route", "replica_health", "tenant_load",
                             "tenant_evict"):
                    errors += _check_fleet(path, lineno, stage, ev)
                # Control-plane invariants (fleet/controlplane.py,
                # fleet/artifacts.py, fleet/jobs.py): per-event schemas in the
                # helper; the fit-job state machine and the artifact
                # first-touch-is-a-miss contract need cross-event state so
                # they live in this loop.
                if stage in ("scale_event", "artifact_map", "fit_job"):
                    errors += _check_controlplane(path, lineno, stage, ev)
                    if stage == "fit_job":
                        state = ev.get("state")
                        if state in ("queued", "running", "published",
                                     "failed"):
                            key = (proc, ev.get("job"))
                            prev = fit_job_state.get(key)
                            allowed = {
                                None: ("queued",),
                                "queued": ("running",),
                                "running": ("published", "failed"),
                                "published": (),
                                "failed": (),
                            }[prev]
                            if state not in allowed:
                                errors.append(
                                    f"{path}:{lineno}: fit_job {ev.get('job')!r} "
                                    f"state {state!r} illegal after {prev!r} — "
                                    f"jobs run queued → running → "
                                    f"published|failed exactly once"
                                )
                            fit_job_state[key] = state
                    elif stage == "artifact_map":
                        digest = ev.get("digest")
                        if isinstance(digest, str) and digest:
                            seen = artifact_seen.setdefault(proc, set())
                            first = digest not in seen
                            seen.add(digest)
                            if first and ev.get("hit") is True:
                                errors.append(
                                    f"{path}:{lineno}: artifact_map digest "
                                    f"{digest[:12]}… first touch claims hit — "
                                    f"a process's first load of a digest is "
                                    f"always a miss"
                                )
                            elif not first and ev.get("hit") is False:
                                errors.append(
                                    f"{path}:{lineno}: artifact_map digest "
                                    f"{digest[:12]}… re-load claims miss — "
                                    f"store entries live for the process "
                                    f"lifetime, never re-mapped"
                                )
                # Sharded-fit invariants (parallel/shard.py): per-event schemas
                # in the helper; the round-contiguity and component-contraction
                # checks need cross-event state so they live in this loop.
                if stage in ("shard_knn_build", "shard_panel_sweep",
                             "shard_knn_exchange", "shard_boruvka_scan",
                             "shard_mst_device", "replication_gate"):
                    errors += _check_shard(path, lineno, stage, ev)
                    if stage == "shard_boruvka_scan":
                        rnd, nc = ev.get("round"), ev.get("n_comp")
                        if _nonneg_int(rnd) and _pos_int(nc):
                            prev = last_shard_round.get(proc)
                            if rnd == 0:
                                pass  # a fresh scanner restarts the sequence
                            elif prev is None or rnd != prev[0] + 1:
                                errors.append(
                                    f"{path}:{lineno}: shard_boruvka_scan round "
                                    f"{rnd} not contiguous (prev "
                                    f"{None if prev is None else prev[0]})"
                                )
                            elif nc >= prev[1]:
                                errors.append(
                                    f"{path}:{lineno}: shard_boruvka_scan "
                                    f"n_comp {nc} did not decrease (prev "
                                    f"{prev[1]}) — Borůvka must contract "
                                    f"components every round"
                                )
                            last_shard_round[proc] = (rnd, nc)
                # Deep-observability invariants (hdbscan_tpu/obs): per-event
                # schemas in the helper; the peak-covers-samples and monotone-
                # progress checks need cross-event state so they live here.
                if stage in ("mem_sample", "mem_phase_peak", "heartbeat",
                             "watchdog_stall", "router_span"):
                    errors += _check_obs(path, lineno, stage, ev)
                    if stage == "mem_sample":
                        mx = ev.get("max_device_bytes")
                        if _nonneg_int(mx):
                            key = (proc, ev.get("phase"))
                            if mx > mem_running_max.get(key, -1):
                                mem_running_max[key] = mx
                    elif stage == "mem_phase_peak":
                        peak = ev.get("max_device_bytes")
                        key = (proc, ev.get("phase"))
                        running = mem_running_max.pop(key, None)
                        if _nonneg_int(peak) and running is not None and (
                            peak < running
                        ):
                            errors.append(
                                f"{path}:{lineno}: mem_phase_peak "
                                f"max_device_bytes {peak} < running sample max "
                                f"{running} for phase {ev.get('phase')!r} — a "
                                f"phase peak cannot under-report its own samples"
                            )
                    elif stage == "heartbeat":
                        p = ev.get("progress")
                        if isinstance(p, (int, float)) and not isinstance(p, bool):
                            key = (proc, ev.get("phase"), ev.get("task"))
                            prev = hb_progress.get(key)
                            if prev is not None and float(p) < prev:
                                errors.append(
                                    f"{path}:{lineno}: heartbeat progress {p} "
                                    f"moved backwards (prev {prev}) for task "
                                    f"{key[1]!r}/{key[2]!r}"
                                )
                            hb_progress[key] = max(prev or 0.0, float(p))
                # Mesh-timeline invariants (obs/timeline.py, obs/flightrec.py):
                # per-event schemas (including the telescoping decomposition) in
                # the helper; round contiguity per (process, device, phase)
                # needs cross-event state so it lives here. A device's rounds
                # within one phase may only repeat, advance by one, or reset to
                # a lower value (a fresh scanner) — a forward jump means the
                # recorder dropped a round.
                if stage in ("device_timeline", "straggler_flag", "flight_dump"):
                    errors += _check_timeline(path, lineno, stage, ev)
                    if stage == "device_timeline":
                        rnd = ev.get("round")
                        dev = ev.get("device")
                        if _nonneg_int(rnd) and _nonneg_int(dev):
                            key = (proc, dev, ev.get("phase"))
                            prev = last_tl_round.get(key)
                            if prev is not None and rnd > prev + 1:
                                errors.append(
                                    f"{path}:{lineno}: device_timeline round "
                                    f"{rnd} skipped ahead (prev {prev}) for "
                                    f"device {dev} phase {ev.get('phase')!r}"
                                )
                            last_tl_round[key] = rnd
                # Per-device wall events: each device's timeline must be ordered.
                device = ev.get("device")
                if isinstance(device, int) and isinstance(seq, int):
                    key = (proc, device)
                    prev = last_dev_seq.get(key)
                    if prev is not None and seq <= prev:
                        errors.append(
                            f"{path}:{lineno}: device {device} seq {seq} not "
                            f"increasing (prev {prev})"
                        )
                    last_dev_seq[key] = seq
        if path != live_path:
            rotation_carry = dict(last_seq)
    path = live_path
    # The single-sync contract: the device MST pipeline fetches ONCE per
    # forest build, so a process's host_sync count must equal its
    # tree_build_device count (core/mst_device.py / models/exact._fit_device).
    for proc, (syncs, builds) in sync_counts.items():
        if syncs != builds:
            errors.append(
                f"{path}: process {proc!r} has {syncs} host_sync event(s) "
                f"for {builds} tree_build_device build(s) — the device MST "
                f"pipeline must sync exactly once per forest build"
            )
    # The sharded single-sync contract: a sharded fit with
    # mst_backend=device (one shard_mst_device summary per fit) makes
    # exactly ONE host sync — the final edge fetch feeding the device
    # merge-forest assemble. Together with the equality above this pins
    # one host_sync AND one forest build per sharded device fit.
    for proc, fits in sharded_mst_fits.items():
        syncs = sync_counts.get(proc, [0, 0])[0]
        if fits > syncs:
            errors.append(
                f"{path}: process {proc!r} has {fits} sharded device fit(s) "
                f"(shard_mst_device) but only {syncs} host_sync event(s) — "
                f"each sharded fit must sync exactly once"
            )
    return events, errors


def _pos_int(val) -> bool:
    return isinstance(val, int) and not isinstance(val, bool) and val > 0


def _check_knn_index(path: str, lineno: int, stage: str, ev: dict) -> list[str]:
    """The three rp-forest event schemas (ops/rpforest.py)."""
    errors: list[str] = []
    where = f"{path}:{lineno}: {stage}"
    if stage == "knn_index_build":
        for key in ("trees", "depth", "leaf_size", "n"):
            if not _pos_int(ev.get(key)):
                errors.append(f"{where} {key}={ev.get(key)!r} not a positive int")
        max_leaf = ev.get("max_leaf")
        leaf_size = ev.get("leaf_size")
        if _pos_int(max_leaf) and _pos_int(leaf_size) and max_leaf > leaf_size:
            errors.append(
                f"{where} max_leaf={max_leaf} exceeds leaf_size={leaf_size}"
            )
    elif stage == "knn_index_query":
        for key in ("n", "k", "trees"):
            if not _pos_int(ev.get(key)):
                errors.append(f"{where} {key}={ev.get(key)!r} not a positive int")
        recall = ev.get("recall_at_k")
        if recall is not None and (
            not isinstance(recall, (int, float))
            or isinstance(recall, bool)
            or not (0.0 <= float(recall) <= 1.0)
        ):
            errors.append(f"{where} recall_at_k={recall!r} not in [0, 1]")
    else:  # knn_index_rescan
        rnd = ev.get("round")
        rounds = ev.get("rescan_rounds")
        if not isinstance(rnd, int) or not _pos_int(rounds) or not (
            0 <= rnd < rounds
        ):
            errors.append(
                f"{where} round={rnd!r} not in [0, rescan_rounds={rounds!r})"
            )
        improved = ev.get("improved")
        if not isinstance(improved, int) or isinstance(improved, bool) or improved < 0:
            errors.append(f"{where} improved={improved!r} not a non-negative int")
    return errors


def _check_knn_fused_forest(path: str, lineno: int, ev: dict) -> list[str]:
    """One summary event per fused-forest core-distance pass
    (ops/rpforest.py ``rpforest_core_distances`` with ``knn_backend=fused``):
    leaf tiles prefetched (trees x leaves), trees merged, rows refined
    (0 at f32 — the exact path needs no refine), precision knob, and the
    interpret-mode provenance flag the benchmark honesty policy requires."""
    errors: list[str] = []
    where = f"{path}:{lineno}: knn_fused_forest"
    for key in ("n", "k", "trees", "leaf_tiles"):
        if not _pos_int(ev.get(key)):
            errors.append(f"{where} {key}={ev.get(key)!r} not a positive int")
    if (
        _pos_int(ev.get("leaf_tiles"))
        and _pos_int(ev.get("trees"))
        and ev["leaf_tiles"] % ev["trees"] != 0
    ):
        errors.append(
            f"{where} leaf_tiles={ev['leaf_tiles']} not a multiple of "
            f"trees={ev['trees']} (leaf_tiles = trees x leaves)"
        )
    if not _nonneg_int(ev.get("refine_rows")):
        errors.append(
            f"{where} refine_rows={ev.get('refine_rows')!r} not a "
            f"non-negative int"
        )
    precision = ev.get("precision")
    if precision not in ("f32", "bf16"):
        errors.append(f"{where} precision={precision!r} not f32|bf16")
    elif precision == "f32" and ev.get("refine_rows", 0) != 0:
        errors.append(
            f"{where} refine_rows={ev.get('refine_rows')!r} nonzero at f32 "
            f"(the exact path must not refine)"
        )
    if not isinstance(ev.get("interpret"), bool):
        errors.append(f"{where} interpret={ev.get('interpret')!r} not a bool")
    return errors


def _nonneg_int(val) -> bool:
    return isinstance(val, int) and not isinstance(val, bool) and val >= 0


def _check_mst_device(path: str, lineno: int, stage: str, ev: dict) -> list[str]:
    """The three device-MST event schemas (core/mst_device.py)."""
    errors: list[str] = []
    where = f"{path}:{lineno}: {stage}"
    if stage == "mst_round":
        if not _nonneg_int(ev.get("round")):
            errors.append(f"{where} round={ev.get('round')!r} not a non-negative int")
        if not _pos_int(ev.get("components")):
            errors.append(
                f"{where} components={ev.get('components')!r} not a positive int"
            )
        if not _nonneg_int(ev.get("edges_added")):
            errors.append(
                f"{where} edges_added={ev.get('edges_added')!r} not a "
                f"non-negative int"
            )
        if "sharded" in ev and not isinstance(ev.get("sharded"), bool):
            errors.append(f"{where} sharded={ev.get('sharded')!r} not a bool")
    elif stage == "host_sync":
        if not _pos_int(ev.get("arrays")):
            errors.append(f"{where} arrays={ev.get('arrays')!r} not a positive int")
        if not _nonneg_int(ev.get("bytes")):
            errors.append(f"{where} bytes={ev.get('bytes')!r} not a non-negative int")
    else:  # tree_build_device
        fallback = ev.get("fallback")
        nodes = ev.get("nodes")
        if not isinstance(fallback, bool):
            errors.append(f"{where} fallback={fallback!r} not a bool")
        elif not isinstance(nodes, int) or isinstance(nodes, bool) or (
            (nodes == -1) != fallback or nodes < -1
        ):
            errors.append(
                f"{where} nodes={nodes!r} inconsistent with fallback={fallback}"
                f" (want nodes == -1 exactly on fallback)"
            )
    return errors


def _check_stream(path: str, lineno: int, stage: str, ev: dict) -> list[str]:
    """The four streaming event schemas (hdbscan_tpu/stream,
    serve/server.py). The cross-event monotonic-generation check for
    ``model_swap`` lives in the main loop (it needs per-server state)."""
    errors: list[str] = []
    where = f"{path}:{lineno}: {stage}"
    if stage == "stream_ingest":
        rows = ev.get("rows")
        absorbed = ev.get("absorbed")
        buffered = ev.get("buffered")
        if not _pos_int(rows):
            errors.append(f"{where} rows={rows!r} not a positive int")
        elif not _nonneg_int(absorbed) or not _nonneg_int(buffered):
            errors.append(
                f"{where} absorbed={absorbed!r}/buffered={buffered!r} not "
                f"non-negative ints"
            )
        elif absorbed + buffered != rows:
            errors.append(
                f"{where} absorbed={absorbed} + buffered={buffered} != "
                f"rows={rows} — every ingested row is exactly one of the two"
            )
        if not _pos_int(ev.get("generation")):
            errors.append(
                f"{where} generation={ev.get('generation')!r} not a "
                f"positive int"
            )
    elif stage == "drift_check":
        if ev.get("stat") not in ("psi", "ks"):
            errors.append(f"{where} stat={ev.get('stat')!r} not in (psi, ks)")
        for key in ("value", "assign_psi"):
            val = ev.get(key)
            if (
                not isinstance(val, (int, float))
                or isinstance(val, bool)
                or not math.isfinite(float(val))
                or float(val) < 0
            ):
                errors.append(
                    f"{where} {key}={val!r} not a finite non-negative number"
                )
        thr = ev.get("threshold")
        if not isinstance(thr, (int, float)) or isinstance(thr, bool) or not (
            float(thr) > 0
        ):
            errors.append(f"{where} threshold={thr!r} not a positive number")
        if not _nonneg_int(ev.get("rows")):
            errors.append(f"{where} rows={ev.get('rows')!r} not a non-negative int")
        if not isinstance(ev.get("drifted"), bool):
            errors.append(f"{where} drifted={ev.get('drifted')!r} not a bool")
    elif stage == "model_refit":
        if not isinstance(ev.get("ok"), bool):
            errors.append(f"{where} ok={ev.get('ok')!r} not a bool")
        if not _pos_int(ev.get("rows")):
            errors.append(f"{where} rows={ev.get('rows')!r} not a positive int")
    else:  # model_swap
        if not _pos_int(ev.get("generation")):
            errors.append(
                f"{where} generation={ev.get('generation')!r} not a "
                f"positive int"
            )
        if not isinstance(ev.get("digest"), str) or not ev.get("digest"):
            errors.append(f"{where} lacks a string 'digest'")
        if not _pos_int(ev.get("n_train")):
            errors.append(f"{where} n_train={ev.get('n_train')!r} not a positive int")
    return errors


def _check_maintain(path: str, lineno: int, stage: str, ev: dict) -> list[str]:
    """The three incremental-maintenance event schemas
    (hdbscan_tpu/incremental, serve/server.py).  The load-bearing check is
    the ``mst_splice`` edge-count reconciliation: every splice starts from
    one spanning tree, adds ``spliced`` new edges, evicts ``evicted`` old
    ones, and must land on one spanning tree again — so
    ``edges_prev + spliced - evicted == edges`` and ``edges == n - 1``
    exactly.  A splice that doesn't reconcile means the maintainer lost or
    duplicated an edge, which the server would only notice as a silently
    wrong hierarchy."""
    errors: list[str] = []
    where = f"{path}:{lineno}: {stage}"
    if not isinstance(ev.get("maintainer"), str) or not ev.get("maintainer"):
        errors.append(f"{where} lacks a non-empty string 'maintainer'")
    if stage == "mst_splice":
        if not _pos_int(ev.get("n")):
            errors.append(f"{where} n={ev.get('n')!r} not a positive int")
        for key in ("inserts", "candidates", "spliced", "evicted",
                    "edges_prev", "edges"):
            if not _nonneg_int(ev.get(key)):
                errors.append(
                    f"{where} {key}={ev.get(key)!r} not a non-negative int"
                )
        frac = ev.get("dirty_frac")
        if (
            not isinstance(frac, (int, float))
            or isinstance(frac, bool)
            or not math.isfinite(float(frac))
            or not (0.0 <= float(frac) <= 1.0)
        ):
            errors.append(f"{where} dirty_frac={frac!r} not in [0, 1]")
        if all(
            _nonneg_int(ev.get(key))
            for key in ("spliced", "evicted", "edges_prev", "edges")
        ):
            if ev["edges_prev"] + ev["spliced"] - ev["evicted"] != ev["edges"]:
                errors.append(
                    f"{where} edges_prev={ev['edges_prev']} + "
                    f"spliced={ev['spliced']} - evicted={ev['evicted']} != "
                    f"edges={ev['edges']} — splice edge counts must reconcile"
                )
            if _pos_int(ev.get("n")) and ev["edges"] != ev["n"] - 1:
                errors.append(
                    f"{where} edges={ev['edges']} != n-1={ev['n'] - 1} — a "
                    f"splice must leave exactly one spanning tree"
                )
    elif stage == "subtree_finalize":
        if not _pos_int(ev.get("n")):
            errors.append(f"{where} n={ev.get('n')!r} not a positive int")
        total = ev.get("nodes_total")
        dirty = ev.get("nodes_dirty")
        if not _nonneg_int(total):
            errors.append(f"{where} nodes_total={total!r} not a non-negative int")
        if not _nonneg_int(dirty):
            errors.append(f"{where} nodes_dirty={dirty!r} not a non-negative int")
        elif _nonneg_int(total) and dirty > total:
            errors.append(
                f"{where} nodes_dirty={dirty} > nodes_total={total}"
            )
        frac = ev.get("dirty_frac")
        if (
            not isinstance(frac, (int, float))
            or isinstance(frac, bool)
            or not math.isfinite(float(frac))
            or not (0.0 <= float(frac) <= 1.0)
        ):
            errors.append(f"{where} dirty_frac={frac!r} not in [0, 1]")
        for key in ("clusters", "changed_clusters"):
            if not _nonneg_int(ev.get(key)):
                errors.append(
                    f"{where} {key}={ev.get(key)!r} not a non-negative int"
                )
    else:  # maintain_fallback
        if not isinstance(ev.get("error"), str) or not ev.get("error"):
            errors.append(f"{where} lacks a non-empty string 'error'")
        if not _pos_int(ev.get("generation")):
            errors.append(
                f"{where} generation={ev.get('generation')!r} not a "
                f"positive int"
            )
        for key in ("n", "inserts"):
            if not _nonneg_int(ev.get(key)):
                errors.append(
                    f"{where} {key}={ev.get(key)!r} not a non-negative int"
                )
    return errors


def _check_fault(path: str, lineno: int, stage: str, ev: dict) -> list[str]:
    """The six fault-tolerance event schemas (hdbscan_tpu/fault/inject.py,
    fault/policy.py, stream/wal.py). The cross-event checks — shed/span
    request-id exclusivity, per-(process, wal) ``wal_seq`` contiguity —
    live in the main loop (they need shared state)."""
    errors: list[str] = []
    where = f"{path}:{lineno}: {stage}"
    if stage == "fault_injected":
        for key in ("site", "mode"):
            if not isinstance(ev.get(key), str) or not ev.get(key):
                errors.append(f"{where} lacks a non-empty string {key!r}")
        if not _pos_int(ev.get("nth")):
            errors.append(f"{where} nth={ev.get('nth')!r} not a positive int")
    elif stage == "request_shed":
        if ev.get("route") not in ("/predict", "/ingest"):
            errors.append(
                f"{where} route={ev.get('route')!r} not in (/predict, /ingest)"
            )
        if ev.get("status") not in (429, 503):
            errors.append(
                f"{where} status={ev.get('status')!r} not in (429, 503) — "
                f"shedding is always a retryable refusal"
            )
        if not isinstance(ev.get("reason"), str) or not ev.get("reason"):
            errors.append(f"{where} lacks a non-empty string 'reason'")
        rid = ev.get("request_id")
        if not isinstance(rid, str) or not rid:
            errors.append(f"{where} lacks a non-empty string 'request_id'")
    elif stage == "circuit_state":
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            errors.append(f"{where} lacks a non-empty string 'name'")
        if ev.get("state") not in ("closed", "open", "half_open"):
            errors.append(
                f"{where} state={ev.get('state')!r} not in "
                f"(closed, open, half_open)"
            )
        if not _nonneg_int(ev.get("failures")):
            errors.append(
                f"{where} failures={ev.get('failures')!r} not a "
                f"non-negative int"
            )
    elif stage == "retry_backoff":
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            errors.append(f"{where} lacks a non-empty string 'name'")
        if not _pos_int(ev.get("attempt")):
            errors.append(
                f"{where} attempt={ev.get('attempt')!r} not a positive int"
            )
        delay = ev.get("delay_s")
        if (
            not isinstance(delay, (int, float))
            or isinstance(delay, bool)
            or not math.isfinite(float(delay))
            or float(delay) < 0
        ):
            errors.append(
                f"{where} delay_s={delay!r} not a finite non-negative number"
            )
        if not isinstance(ev.get("error"), str) or not ev.get("error"):
            errors.append(f"{where} lacks a non-empty string 'error'")
    elif stage == "wal_append":
        if not isinstance(ev.get("wal"), str) or not ev.get("wal"):
            errors.append(f"{where} lacks a non-empty string 'wal'")
        if not isinstance(ev.get("kind"), str) or not ev.get("kind"):
            errors.append(f"{where} lacks a non-empty string 'kind'")
        if not _nonneg_int(ev.get("wal_seq")):
            errors.append(
                f"{where} wal_seq={ev.get('wal_seq')!r} not a "
                f"non-negative int"
            )
        if not _nonneg_int(ev.get("rows")):
            errors.append(
                f"{where} rows={ev.get('rows')!r} not a non-negative int"
            )
    else:  # wal_recover
        if not isinstance(ev.get("wal"), str) or not ev.get("wal"):
            errors.append(f"{where} lacks a non-empty string 'wal'")
        for key in ("records", "rows"):
            if not _nonneg_int(ev.get(key)):
                errors.append(
                    f"{where} {key}={ev.get(key)!r} not a non-negative int"
                )
        if not isinstance(ev.get("snapshot"), bool):
            errors.append(f"{where} snapshot={ev.get('snapshot')!r} not a bool")
    return errors


def _check_fleet(path: str, lineno: int, stage: str, ev: dict) -> list[str]:
    """The four fleet event schemas (hdbscan_tpu/fleet/router.py,
    fleet/tenants.py)."""
    errors: list[str] = []
    where = f"{path}:{lineno}: {stage}"
    if stage == "fleet_route":
        if not isinstance(ev.get("replica"), str) or not ev.get("replica"):
            errors.append(f"{where} lacks a non-empty string 'replica'")
        if ev.get("route") not in ("/predict", "/ingest"):
            errors.append(
                f"{where} route={ev.get('route')!r} not in (/predict, /ingest)"
            )
        if ev.get("policy") not in ("consistent_hash", "least_loaded"):
            errors.append(
                f"{where} policy={ev.get('policy')!r} not in "
                f"(consistent_hash, least_loaded)"
            )
        status = ev.get("status")
        if not isinstance(status, int) or isinstance(status, bool) or not (
            100 <= status <= 599
        ):
            errors.append(f"{where} status={status!r} not an HTTP status int")
        if not _pos_int(ev.get("attempts")):
            errors.append(
                f"{where} attempts={ev.get('attempts')!r} not a positive int"
            )
    elif stage == "replica_health":
        if not isinstance(ev.get("replica"), str) or not ev.get("replica"):
            errors.append(f"{where} lacks a non-empty string 'replica'")
        if not isinstance(ev.get("ok"), bool):
            errors.append(f"{where} ok={ev.get('ok')!r} not a bool")
        for key in ("failures", "restarts"):
            if not _nonneg_int(ev.get(key)):
                errors.append(
                    f"{where} {key}={ev.get(key)!r} not a non-negative int"
                )
    else:  # tenant_load / tenant_evict
        if not isinstance(ev.get("tenant"), str) or not ev.get("tenant"):
            errors.append(f"{where} lacks a non-empty string 'tenant'")
        if not _pos_int(ev.get("generation")):
            errors.append(
                f"{where} generation={ev.get('generation')!r} not a "
                f"positive int"
            )
        if stage == "tenant_load":
            # The freshly loaded tenant is itself resident when the event
            # fires, so resident is strictly positive here.
            if not _pos_int(ev.get("resident")):
                errors.append(
                    f"{where} resident={ev.get('resident')!r} not a "
                    f"positive int"
                )
            if not _nonneg_int(ev.get("jit_compiles")):
                errors.append(
                    f"{where} jit_compiles={ev.get('jit_compiles')!r} not a "
                    f"non-negative int"
                )
        else:
            for key in ("resident", "requests"):
                if not _nonneg_int(ev.get(key)):
                    errors.append(
                        f"{where} {key}={ev.get(key)!r} not a "
                        f"non-negative int"
                    )
    return errors


def _check_controlplane(path: str, lineno: int, stage: str,
                        ev: dict) -> list[str]:
    """The three control-plane event schemas (fleet/router.py scaling,
    fleet/artifacts.py, fleet/jobs.py)."""
    errors: list[str] = []
    where = f"{path}:{lineno}: {stage}"
    if stage == "scale_event":
        if ev.get("direction") not in ("up", "down"):
            errors.append(
                f"{where} direction={ev.get('direction')!r} not in (up, down)"
            )
        if not isinstance(ev.get("replica"), str) or not ev.get("replica"):
            errors.append(f"{where} lacks a non-empty string 'replica'")
        if not _pos_int(ev.get("replicas")):
            errors.append(
                f"{where} replicas={ev.get('replicas')!r} not a positive int"
            )
        if not isinstance(ev.get("reason"), str) or not ev.get("reason"):
            errors.append(f"{where} lacks a non-empty string 'reason'")
        if not isinstance(ev.get("ok"), bool):
            errors.append(f"{where} ok={ev.get('ok')!r} not a bool")
        if "error" in ev and (
            not isinstance(ev.get("error"), str) or not ev.get("error")
        ):
            errors.append(f"{where} error={ev.get('error')!r} not a string")
    elif stage == "artifact_map":
        for key in ("digest", "path"):
            if not isinstance(ev.get(key), str) or not ev.get(key):
                errors.append(f"{where} lacks a non-empty string {key!r}")
        for key in ("hit", "spooled"):
            if not isinstance(ev.get(key), bool):
                errors.append(f"{where} {key}={ev.get(key)!r} not a bool")
        # The digest this event describes is resident (and referenced)
        # when the event fires, on every path — hit, race loser, publish.
        for key in ("resident", "refs"):
            if not _pos_int(ev.get(key)):
                errors.append(
                    f"{where} {key}={ev.get(key)!r} not a positive int"
                )
        if not _nonneg_int(ev.get("bytes")):
            errors.append(
                f"{where} bytes={ev.get('bytes')!r} not a non-negative int"
            )
    else:  # fit_job
        for key in ("job", "tenant", "reason"):
            if not isinstance(ev.get(key), str) or not ev.get(key):
                errors.append(f"{where} lacks a non-empty string {key!r}")
        if ev.get("state") not in ("queued", "running", "published", "failed"):
            errors.append(
                f"{where} state={ev.get('state')!r} not in "
                f"(queued, running, published, failed)"
            )
        if "generation" in ev and not _pos_int(ev.get("generation")):
            errors.append(
                f"{where} generation={ev.get('generation')!r} not a "
                f"positive int"
            )
        queued_s = ev.get("queued_s")
        if queued_s is not None and (
            not isinstance(queued_s, (int, float))
            or isinstance(queued_s, bool)
            or not (queued_s >= 0.0 and math.isfinite(float(queued_s)))
        ):
            errors.append(
                f"{where} queued_s={queued_s!r} not a finite non-negative "
                f"number"
            )
        if ev.get("state") == "failed" and not (
            isinstance(ev.get("error"), str) and ev.get("error")
        ):
            errors.append(
                f"{where} failed without a non-empty string 'error'"
            )
    return errors


def _check_shard(path: str, lineno: int, stage: str, ev: dict) -> list[str]:
    """The five sharded-fit event schemas (parallel/shard.py): forest
    build/sweep, bounded k-NN exchange, row-sharded Borůvka scan rounds and
    the replication-gate verdict."""
    errors: list[str] = []
    where = f"{path}:{lineno}: {stage}"

    def pos(*keys):
        for key in keys:
            if not _pos_int(ev.get(key)):
                errors.append(
                    f"{where} {key}={ev.get(key)!r} not a positive int"
                )

    def nonneg(*keys):
        for key in keys:
            if not _nonneg_int(ev.get(key)):
                errors.append(
                    f"{where} {key}={ev.get(key)!r} not a non-negative int"
                )

    if stage == "shard_knn_build":
        pos("devices", "trees", "depth", "leaf_size", "max_leaf", "n", "d")
        ml, ls = ev.get("max_leaf"), ev.get("leaf_size")
        if _pos_int(ml) and _pos_int(ls) and ml > ls:
            errors.append(f"{where} max_leaf={ml} > leaf_size={ls}")
    elif stage == "shard_panel_sweep":
        pos("devices", "rows", "trees", "shard")
    elif stage == "shard_knn_exchange":
        pos("n", "k", "trees", "devices", "candidates")
        recall = ev.get("recall_at_k")
        if recall is not None and (
            not isinstance(recall, (int, float)) or isinstance(recall, bool)
            or not (0.0 <= float(recall) <= 1.0)
        ):
            errors.append(f"{where} recall_at_k={recall!r} not in [0, 1]")
    elif stage == "shard_boruvka_scan":
        pos("devices", "n_comp")
        nonneg("round", "candidates")
    elif stage == "shard_mst_device":
        pos("devices", "rounds", "n", "shard")
    else:  # replication_gate
        if ev.get("ok") is not True:
            errors.append(
                f"{where} ok={ev.get('ok')!r} — the event is only emitted "
                f"on a passing gate, so ok must be true"
            )
        pos("threshold_bytes", "phases")
        frac = ev.get("worst_fraction")
        if not isinstance(frac, (int, float)) or isinstance(frac, bool) or (
            not 0.0 <= float(frac) < 1.0
        ):
            errors.append(
                f"{where} worst_fraction={frac!r} not in [0, 1) — a passing "
                f"gate's worst device-phase growth is strictly under the "
                f"threshold"
            )
    return errors


def _finite_nonneg(val) -> bool:
    return (
        isinstance(val, (int, float))
        and not isinstance(val, bool)
        and math.isfinite(float(val))
        and float(val) >= 0
    )


def _check_obs(path: str, lineno: int, stage: str, ev: dict) -> list[str]:
    """The five deep-observability event schemas (hdbscan_tpu/obs). The
    cross-event checks — peak >= running sample max, monotone heartbeat
    progress — live in the main loop (they need shared state)."""
    errors: list[str] = []
    where = f"{path}:{lineno}: {stage}"
    if stage in ("mem_sample", "mem_phase_peak"):
        if not isinstance(ev.get("phase"), str) or not ev.get("phase"):
            errors.append(f"{where} lacks a non-empty string 'phase'")
        if ev.get("source") not in ("memory_stats", "live_arrays"):
            errors.append(
                f"{where} source={ev.get('source')!r} not in "
                f"(memory_stats, live_arrays)"
            )
        for key in ("max_device_bytes", "total_bytes"):
            if not _nonneg_int(ev.get(key)):
                errors.append(
                    f"{where} {key}={ev.get(key)!r} not a non-negative int"
                )
        if stage == "mem_phase_peak":
            sampled = ev.get("sampled")
            if "sampled" in ev and not isinstance(sampled, bool):
                errors.append(f"{where} sampled={sampled!r} not a bool")
            for key in ("samples", "devices"):
                # ``sampled: false`` marks a phase whose sampling failed or
                # raced teardown (audit.py) — its counts are honestly zero.
                if sampled is False:
                    if not _nonneg_int(ev.get(key)):
                        errors.append(
                            f"{where} {key}={ev.get(key)!r} not a "
                            f"non-negative int"
                        )
                elif not _pos_int(ev.get(key)):
                    errors.append(
                        f"{where} {key}={ev.get(key)!r} not a positive int"
                    )
    elif stage == "heartbeat":
        if not isinstance(ev.get("phase"), str) or not ev.get("phase"):
            errors.append(f"{where} lacks a non-empty string 'phase'")
        if not _pos_int(ev.get("task")):
            errors.append(f"{where} task={ev.get('task')!r} not a positive int")
        p = ev.get("progress")
        if not _finite_nonneg(p) or float(p) > 1.0:
            errors.append(f"{where} progress={p!r} not in [0, 1]")
        if "done" in ev and not _nonneg_int(ev.get("done")):
            errors.append(
                f"{where} done={ev.get('done')!r} not a non-negative int"
            )
        if "total" in ev and not _pos_int(ev.get("total")):
            errors.append(
                f"{where} total={ev.get('total')!r} not a positive int"
            )
        if "eta_s" in ev and not _finite_nonneg(ev.get("eta_s")):
            errors.append(
                f"{where} eta_s={ev.get('eta_s')!r} not a finite "
                f"non-negative number"
            )
    elif stage == "watchdog_stall":
        stalled = ev.get("stalled_s")
        if not _finite_nonneg(stalled) or float(stalled) <= 0:
            errors.append(f"{where} stalled_s={stalled!r} not a positive number")
        if not _pos_int(ev.get("threads")):
            errors.append(
                f"{where} threads={ev.get('threads')!r} not a positive int"
            )
        phases = ev.get("phases")
        if not isinstance(phases, list) or not phases:
            errors.append(f"{where} phases={phases!r} not a non-empty list")
        if not isinstance(ev.get("stacks"), str):
            errors.append(f"{where} lacks a string 'stacks' dump")
    else:  # router_span
        for key in ("request_id", "replica"):
            if not isinstance(ev.get(key), str) or not ev.get(key):
                errors.append(f"{where} lacks a non-empty string {key!r}")
        if ev.get("route") not in ("/predict", "/ingest"):
            errors.append(
                f"{where} route={ev.get('route')!r} not in (/predict, /ingest)"
            )
        if ev.get("policy") not in ("consistent_hash", "least_loaded"):
            errors.append(
                f"{where} policy={ev.get('policy')!r} not in "
                f"(consistent_hash, least_loaded)"
            )
        status = ev.get("status")
        if not isinstance(status, int) or isinstance(status, bool) or not (
            100 <= status <= 599
        ):
            errors.append(f"{where} status={status!r} not an HTTP status int")
        if not _pos_int(ev.get("attempts")):
            errors.append(
                f"{where} attempts={ev.get('attempts')!r} not a positive int"
            )
        if not _finite_nonneg(ev.get("queue_s")):
            errors.append(
                f"{where} queue_s={ev.get('queue_s')!r} not a finite "
                f"non-negative number"
            )
        if not isinstance(ev.get("replied"), bool):
            errors.append(f"{where} replied={ev.get('replied')!r} not a bool")
    return errors


#: Every reason a flight-recorder bundle may be dumped (obs/flightrec.py).
FLIGHT_DUMP_REASONS = (
    "watchdog_stall", "replication_gate", "slo_breach", "exception",
    "sigterm", "manual",
)

#: The three telescoping segments of a device_timeline row.
TIMELINE_SEGMENTS = ("compute_s", "comm_s", "host_s")


def _check_timeline(path: str, lineno: int, stage: str, ev: dict) -> list[str]:
    """The three mesh-timeline schemas (obs/timeline.py, obs/flightrec.py):
    device_timeline rows must telescope — compute_s + comm_s + host_s equals
    wall_s within ``WALL_TOLERANCE`` — straggler_flag rows must be
    self-consistent (the flagged wall really exceeds threshold × median),
    and flight_dump rows must name a known reason and a bundle path. Round
    contiguity lives in the main loop (it needs per-device state)."""
    errors: list[str] = []
    where = f"{path}:{lineno}: {stage}"
    if stage == "device_timeline":
        if not isinstance(ev.get("phase"), str) or not ev.get("phase"):
            errors.append(f"{where} lacks a non-empty string 'phase'")
        for key in ("device", "round", "comm_bytes"):
            if not _nonneg_int(ev.get(key)):
                errors.append(
                    f"{where} {key}={ev.get(key)!r} not a non-negative int"
                )
        segs_ok = True
        for key in TIMELINE_SEGMENTS:
            if not _finite_nonneg(ev.get(key)):
                errors.append(
                    f"{where} {key}={ev.get(key)!r} not a finite "
                    f"non-negative number"
                )
                segs_ok = False
        if ev.get("attribution") != "model":
            errors.append(
                f"{where} attribution={ev.get('attribution')!r} != 'model' — "
                f"the comm/compute split comes from a cost model, and the "
                f"event must say so"
            )
        wall = ev.get("wall_s")
        if segs_ok and _finite_nonneg(wall):
            total = sum(float(ev[key]) for key in TIMELINE_SEGMENTS)
            if not math.isclose(
                total, float(wall), rel_tol=0.0, abs_tol=WALL_TOLERANCE
            ):
                errors.append(
                    f"{where} segments sum to {total} but wall_s={wall} "
                    f"(tol {WALL_TOLERANCE}) — the decomposition must "
                    f"telescope exactly"
                )
    elif stage == "straggler_flag":
        if not isinstance(ev.get("phase"), str) or not ev.get("phase"):
            errors.append(f"{where} lacks a non-empty string 'phase'")
        for key in ("device", "round"):
            if not _nonneg_int(ev.get(key)):
                errors.append(
                    f"{where} {key}={ev.get(key)!r} not a non-negative int"
                )
        if not _pos_int(ev.get("streak")):
            errors.append(
                f"{where} streak={ev.get('streak')!r} not a positive int"
            )
        thr = ev.get("threshold")
        if not _finite_nonneg(thr) or float(thr) < 1.0:
            errors.append(f"{where} threshold={thr!r} not a number >= 1")
        ratio = ev.get("ratio")
        if not _finite_nonneg(ratio):
            errors.append(f"{where} ratio={ratio!r} not a finite number")
        elif _finite_nonneg(thr) and float(ratio) < float(thr) - WALL_TOLERANCE:
            # The event rounds ratio to 6 decimals; give the comparison the
            # same tolerance every other rounded-wall check gets.
            errors.append(
                f"{where} ratio={ratio} below threshold={thr} — a flag "
                f"must only fire at or above the configured skew"
            )
        med = ev.get("median_s")
        dev_wall = ev.get("wall_s")
        if _finite_nonneg(med) and _finite_nonneg(dev_wall) and (
            float(dev_wall) < float(med)
        ):
            errors.append(
                f"{where} wall_s={dev_wall} < median_s={med} — a straggler "
                f"cannot be faster than the round median"
            )
    else:  # flight_dump
        if ev.get("reason") not in FLIGHT_DUMP_REASONS:
            errors.append(
                f"{where} reason={ev.get('reason')!r} not in "
                f"{FLIGHT_DUMP_REASONS}"
            )
        if not isinstance(ev.get("path"), str) or not ev.get("path"):
            errors.append(f"{where} lacks a non-empty string 'path'")
        if not _nonneg_int(ev.get("events")):
            errors.append(
                f"{where} events={ev.get('events')!r} not a non-negative int"
            )
    return errors


#: The five telescoping segments of a request_span, in wall-clock order.
SPAN_SEGMENTS = ("parse_s", "queue_s", "assemble_s", "predict_s", "respond_s")


def _check_request_span(path: str, lineno: int, ev: dict) -> list[str]:
    """The request_span schema (serve/server.py): route/id/shape fields
    plus the telescoping contract — the five segments sum to ``wall_s``
    within ``WALL_TOLERANCE``. Request-id uniqueness is checked in the
    main loop (it needs per-process state)."""
    errors: list[str] = []
    where = f"{path}:{lineno}: request_span"
    if ev.get("route") not in ("/predict", "/ingest"):
        errors.append(
            f"{where} route={ev.get('route')!r} not in (/predict, /ingest)"
        )
    rid = ev.get("request_id")
    if not isinstance(rid, str) or not rid:
        errors.append(f"{where} lacks a non-empty string 'request_id'")
    status = ev.get("status")
    is_error = False
    if status is not None:
        if not isinstance(status, int) or isinstance(status, bool) or not (
            100 <= status <= 599
        ):
            errors.append(f"{where} status={status!r} not an HTTP status int")
        else:
            is_error = status >= 400
    # An error span may legitimately carry rows=0 (the request failed
    # before any row reached the batcher); success spans always have rows.
    if is_error:
        if not _nonneg_int(ev.get("rows")):
            errors.append(
                f"{where} rows={ev.get('rows')!r} not a non-negative int"
            )
    elif not _pos_int(ev.get("rows")):
        errors.append(f"{where} rows={ev.get('rows')!r} not a positive int")
    bucket = ev.get("bucket")
    if not _pos_int(bucket) or (bucket & (bucket - 1)):
        errors.append(f"{where} bucket={bucket!r} is not a power of two")
    if not _pos_int(ev.get("coalesced")):
        errors.append(
            f"{where} coalesced={ev.get('coalesced')!r} not a positive int"
        )
    if not _pos_int(ev.get("generation")):
        errors.append(
            f"{where} generation={ev.get('generation')!r} not a positive int"
        )
    total = 0.0
    segments_ok = True
    for key in SPAN_SEGMENTS:
        val = ev.get(key)
        if (
            not isinstance(val, (int, float))
            or isinstance(val, bool)
            or not math.isfinite(float(val))
            or float(val) < 0
        ):
            errors.append(
                f"{where} {key}={val!r} not a finite non-negative number"
            )
            segments_ok = False
        else:
            total += float(val)
    wall = ev.get("wall_s")
    if segments_ok and isinstance(wall, (int, float)) and not isinstance(
        wall, bool
    ):
        if not math.isclose(
            total, float(wall), rel_tol=0.0, abs_tol=WALL_TOLERANCE
        ):
            errors.append(
                f"{where} segments sum {round(total, 9)} != wall_s {wall} "
                f"(tol {WALL_TOLERANCE}) — the decomposition must account "
                f"for the full request wall"
            )
    return errors


def validate_report(
    path: str, trace_events: list[dict] | None = None
) -> tuple[dict, list[str]]:
    """Validate a run-report JSON; cross-check phase walls against a trace.

    Returns ``(report, errors)``.
    """
    errors: list[str] = []
    with open(path, encoding="utf-8") as f:
        try:
            report = json.load(f)
        except json.JSONDecodeError as e:
            return {}, [f"{path}: not valid JSON ({e})"]
    schema = report.get("schema")
    if not isinstance(schema, str) or not schema.startswith(REPORT_SCHEMA_PREFIX):
        errors.append(
            f"{path}: schema={schema!r} (want {REPORT_SCHEMA_PREFIX}<n>)"
        )
    phases = report.get("phases")
    if not isinstance(phases, dict):
        errors.append(f"{path}: 'phases' missing or not an object")
        phases = {}
    if not isinstance(report.get("manifest"), dict):
        errors.append(f"{path}: 'manifest' missing or not an object")
    for stage, row in phases.items():
        if not isinstance(row, dict) or not isinstance(
            row.get("wall_s"), (int, float)
        ):
            errors.append(f"{path}: phase {stage!r} lacks numeric wall_s")
    if trace_events is not None:
        # Round-trip: report per-phase walls == trace per-stage wall sums
        # (span-only lines, ``span`` true, are not phases).
        sums: dict[str, float] = {}
        for ev in trace_events:
            stage = ev.get("stage")
            if isinstance(stage, str) and ev.get("span") is not True:
                sums[stage] = sums.get(stage, 0.0) + float(ev.get("wall_s") or 0.0)
        for stage, want in sums.items():
            row = phases.get(stage)
            if row is None:
                errors.append(f"{path}: trace stage {stage!r} missing from report")
                continue
            got = float(row.get("wall_s", float("nan")))
            if not math.isclose(got, want, rel_tol=0.0, abs_tol=WALL_TOLERANCE):
                errors.append(
                    f"{path}: phase {stage!r} wall_s {got} != trace sum "
                    f"{want} (tol {WALL_TOLERANCE})"
                )
        for stage in phases:
            if stage not in sums:
                errors.append(f"{path}: report phase {stage!r} absent from trace")
        latency = report.get("predict_latency")
        if latency is not None:
            errors += _check_predict_latency(path, latency, trace_events)
    return report, errors


def _check_predict_latency(
    path: str, latency: dict, trace_events: list[dict]
) -> list[str]:
    """Recompute the report's predict_latency percentiles from the trace's
    ``predict_batch`` walls — nearest-rank (index ceil(q*n)-1 into the
    sorted walls), the same formula as ``utils/telemetry.
    latency_percentiles``, duplicated stdlib-only on purpose."""
    errors: list[str] = []
    if not isinstance(latency, dict):
        return [f"{path}: 'predict_latency' is not an object"]
    walls = sorted(
        float(ev.get("wall_s") or 0.0)
        for ev in trace_events
        if ev.get("stage") == "predict_batch"
    )
    n = len(walls)
    if latency.get("count") != n:
        errors.append(
            f"{path}: predict_latency count {latency.get('count')!r} != "
            f"{n} predict_batch trace events"
        )
    if n == 0:
        return errors
    want = {
        "p50_s": walls[max(0, math.ceil(0.50 * n) - 1)],
        "p95_s": walls[max(0, math.ceil(0.95 * n) - 1)],
        "p99_s": walls[max(0, math.ceil(0.99 * n) - 1)],
        "p999_s": walls[max(0, math.ceil(0.999 * n) - 1)],
        "max_s": walls[-1],
        "mean_s": sum(walls) / n,
    }
    for key, val in want.items():
        got = latency.get(key)
        if not isinstance(got, (int, float)) or not math.isclose(
            float(got), val, rel_tol=0.0, abs_tol=WALL_TOLERANCE
        ):
            errors.append(
                f"{path}: predict_latency {key} {got!r} != trace-derived "
                f"{round(val, 6)} (tol {WALL_TOLERANCE})"
            )
    return errors


def join_fleet(router_path: str, replica_paths: list[str]) -> int:
    """Validate every file, then require the router→replica causal join to
    be complete: each replied=true ``router_span`` must match exactly one
    replica ``request_span``/``request_shed`` on request_id."""
    errors: list[str] = []
    router_events, router_errors = validate_trace(router_path)
    errors += router_errors
    replica_events: list[dict] = []
    for path in replica_paths:
        evs, errs = validate_trace(path)
        errors += errs
        replica_events += evs
    spans = [e for e in router_events if e.get("stage") == "router_span"]
    replied = [e for e in spans if e.get("replied")]
    replica_ids: dict[str, int] = {}
    for ev in replica_events:
        if ev.get("stage") in ("request_span", "request_shed"):
            rid = ev.get("request_id")
            if isinstance(rid, str):
                replica_ids[rid] = replica_ids.get(rid, 0) + 1
    matched = 0
    for ev in replied:
        rid = ev.get("request_id")
        count = replica_ids.get(rid, 0)
        if count == 0:
            errors.append(
                f"{router_path}: router_span {rid!r} (replied) has no "
                f"matching replica request_span/request_shed"
            )
        elif count > 1:
            errors.append(
                f"{router_path}: router_span {rid!r} matches {count} "
                f"replica spans (expected exactly one)"
            )
        else:
            matched += 1
    for err in errors:
        print(f"FAIL {err}", file=sys.stderr)
    if errors:
        print(f"{len(errors)} violation(s)", file=sys.stderr)
        return 1
    print(
        f"OK join: {len(spans)} router_span(s), {len(replied)} replied, "
        f"{matched} matched across {len(replica_paths)} replica trace(s)"
    )
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--join":
        if len(argv) < 3:
            print(__doc__, file=sys.stderr)
            return 1
        return join_fleet(argv[1], argv[2:])
    if not argv or len(argv) > 2:
        print(__doc__, file=sys.stderr)
        return 1
    trace_path = argv[0]
    events, errors = validate_trace(trace_path)
    if len(argv) == 2:
        _, report_errors = validate_report(argv[1], trace_events=events)
        errors += report_errors
    for err in errors:
        print(f"FAIL {err}", file=sys.stderr)
    if errors:
        print(f"{len(errors)} violation(s)", file=sys.stderr)
        return 1
    print(
        f"OK {trace_path}: {len(events)} events, "
        f"{len({e.get('stage') for e in events})} stages"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

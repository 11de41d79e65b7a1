"""Stdlib HTTP inference server over a fitted ClusterModel — the port of
``hdbscan_tpu/serve/server.py``.

Endpoints:

- ``POST /predict`` — body ``{"points": [[...], ...]}`` (optionally
  ``"membership": true``); responds ``{"labels", "probabilities",
  "outlier_scores", "generation"}`` (plus ``"membership"`` +
  ``"selected_ids"`` when requested). Plain predicts route through the
  :class:`~hdbscan_tpu_torch.serve.batcher.MicroBatcher`, so concurrent
  clients coalesce into shared bucket dispatches. A body with
  ``"tenant"`` is answered by that tenant's model through the server's
  :class:`~hdbscan_tpu_torch.fleet.tenants.TenantRegistry` (``tenants=``,
  ``serve --tenants-dir``; the response adds ``"tenant"`` and the
  tenant's generation): 429 with ``Retry-After`` over the tenant's quota,
  400 for an unknown tenant, and 409 from a server with no registry.
- ``POST /ingest`` — streaming mode only: predicts the points, absorbs
  duplicates/near-duplicates into bubble summaries, updates the drift
  sketches, and (on a drift flag or point budget) kicks off a background
  re-fit on the server's device. See ``hdbscan_tpu_torch/stream/``.
- ``POST /swap`` — apply a staged re-fit artifact (``stream_reload=manual``)
  or an explicit ``{"path": ...}`` artifact: the blue/green hot swap.
- ``GET /healthz`` — model summary, backend, buckets, warmup, batcher
  coalescing stats, stream/swap state, uptime, per-route request/error
  counts and the current in-flight count; on the card also the process's
  ``kernels`` (launches by kernel, builds, build-directory loads) and
  ``device_memory`` (the caching allocator's allocated, peak and reserved
  bytes), so a fleet's replica processes can be read from outside.
- ``GET /metrics`` — Prometheus text exposition (``utils/metrics.py``):
  request totals by route/status, in-flight gauge, request-latency and
  batch-size histograms, swap, shed, fault, drift, re-fit, maintenance,
  WAL and circuit families. ``scripts/check_metrics.py`` validates the
  output.

Per-request spans: every terminated ``/predict``/``/ingest`` request —
success or error — gets a process-unique request id (echoed as
``X-Request-Id``) and, when a tracer is attached, exactly one trace event:
a ``request_shed`` (the bounded batcher queue refused it with 503 +
Retry-After) or a ``request_span`` carrying the HTTP ``status`` and
decomposing its wall into parse / queue-wait / batch-assembly /
device-predict / respond segments that telescope exactly to the span wall
(``scripts/check_trace.py``).

Fault tolerance: per-request deadlines (``X-Deadline-Ms`` header /
``serve_deadline_ms`` knob → 504 before a batch slot is spent),
bounded-queue load shedding (``serve_queue_bound``), a re-fit circuit
breaker that degrades to the pinned generation after repeated re-fit/swap
failures, crash-safe ingest durability (``stream_wal_dir`` →
``stream/wal.StreamJournal``), retried artifact loads on swap, and the
``HDBSCAN_TPU_FAULTS`` injection harness (``hdbscan_tpu_torch/fault``).

Incremental maintenance (``stream_maintain="incremental"``): novel ingest
rows fold into an online MST (``incremental/``) on the host, and every
``maintain_refresh_every`` inserts the hierarchy re-finalizes into a
padded maintained model that is installed blue/green.

Blue/green serving: every model lives in an immutable ``_ModelHandle``
(model + warmed predictor + its own MicroBatcher + generation number). A
request pins the handle it started with, and a swap is a single reference
assignment under a lock, so in-flight requests finish on the model they
started on; the old handle's batcher is then drain-closed. Swaps are
guarded by the artifact digest check (``ClusterModel.load``) plus a
fingerprint-field match against the served model, and emit ``model_swap``
trace events with a per-server monotonic generation. Lock order: the swap
lock before the ingest lock, never the reverse.

Observability (``hdbscan_tpu_torch/obs``): with ``watchdog_s > 0`` and no
heartbeat hub installed the server arms one (and disarms it on close), and
an installed hub or timeline recorder feeds the
``hdbscan_tpu_watchdog_stalls_total`` and
``hdbscan_tpu_straggler_flags_total`` counters; ``/healthz`` carries their
``watchdog`` and ``straggler`` blocks and ``/metrics`` the installed
memory auditor's per-device peaks (``hdbscan_tpu_device_peak_bytes``).

``SIGTERM``/``close()`` drains in-flight work before exiting.
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from hdbscan_tpu_torch import obs
from hdbscan_tpu_torch.fault import inject
from hdbscan_tpu_torch.fault.policy import (
    CIRCUIT_STATE_VALUES,
    CircuitBreaker,
    DeadlineExceeded,
    ShedRequest,
    retry_call,
)
from hdbscan_tpu_torch.serve.artifact import _FINGERPRINT_FIELDS, ClusterModel
from hdbscan_tpu_torch.serve.batcher import MicroBatcher
from hdbscan_tpu_torch.serve.predict import Predictor
from hdbscan_tpu_torch.utils.metrics import MetricsRegistry

#: Refuse request bodies above this size (64 MiB ~ a 1M x 8-dim f64 batch).
MAX_BODY_BYTES = 64 << 20

#: Bounded retries for the swap race: a request that pinned a handle whose
#: batcher closed before its submit landed just re-pins the current handle.
_PIN_RETRIES = 8

#: Process-wide request-id sequence: ids stay unique even when several
#: servers share one process and one trace file.
_REQUEST_IDS = itertools.count(1)

#: Inert-row sentinel for maintained models: padded rows sit at this
#: coordinate with this core distance, so they can never be a query's
#: nearest neighbor and never attach. Fits float32 comfortably (squared
#: distances stay below f32 max), which the predict kernels rely on.
_INERT_FILL = 1e18


class _ModelHandle:
    """One served model generation: artifact + warmed predictor + batcher.

    Immutable once built — a swap builds a fresh handle and replaces the
    server's reference; it never mutates a live one.
    """

    __slots__ = ("model", "predictor", "batcher", "generation", "warmup_info")

    def __init__(self, model, predictor, batcher, generation, warmup_info):
        self.model = model
        self.predictor = predictor
        self.batcher = batcher
        self.generation = generation
        self.warmup_info = warmup_info

    @property
    def digest(self) -> str | None:
        return self.model.fingerprint.get("data")


class _Handler(BaseHTTPRequestHandler):
    server_version = "hdbscan-tpu-serve/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route access logs away from stderr
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _json(self, code: int, obj: dict, headers: dict | None = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _text(self, code: int, text: str) -> None:
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - http.server API
        route = self.path.split("?")[0]
        srv = self.server.cluster_server
        known = route in ("/healthz", "/metrics")
        t0 = time.perf_counter()
        srv._m_in_flight.inc()
        code = 500
        try:
            if route == "/healthz":
                code = 200
                self._json(code, srv.health())
            elif route == "/metrics":
                code = 200
                self._text(code, srv.render_metrics())
            else:
                code = 404
                self._json(code, {"error": f"unknown path {self.path!r}"})
        finally:
            srv._m_in_flight.dec()
            srv._observe_request(route if known else "other", code, time.perf_counter() - t0)

    def _read_payload(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        if length > MAX_BODY_BYTES:
            raise ValueError(f"body exceeds {MAX_BODY_BYTES} bytes")
        return json.loads(self.rfile.read(length).decode()) if length else {}

    def do_POST(self):  # noqa: N802 - http.server API
        path = self.path.split("?")[0]
        srv = self.server.cluster_server
        known = path in ("/predict", "/ingest", "/swap")
        t0 = time.perf_counter()
        srv._m_in_flight.inc()
        code = 500
        # An upstream that stamped X-Request-Id wins.
        rid = self.headers.get("X-Request-Id") or srv.next_request_id()
        # meta is filled across threads (batcher worker) with the span
        # timestamps; the Future resolution inside predict is the
        # happens-before edge that publishes it back to this thread.
        meta: dict = {}
        rows = 0
        generation = int(srv.generation)
        shed_reason = None  # set when the request was load-shed (503)
        try:
            act = inject.maybe_fire("slow_request")
            if act is not None:
                time.sleep(act.delay_s)
            if inject.maybe_fire("http_reset") is not None:
                # Simulated socket reset: drop the connection without a
                # response. 499 keeps the status label numeric.
                code = 499
                self.close_connection = True
                return
            try:
                payload = self._read_payload()
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                code = 400
                self._json(code, {"error": f"bad request: {e}"})
                return
            try:
                deadline = srv.request_deadline(self.headers, t0)
                if deadline is not None:
                    meta["deadline"] = deadline
                if path == "/predict":
                    points = np.asarray(payload["points"], np.float64)
                    meta["t_parse"] = time.perf_counter()
                    tenant = payload.get("tenant")
                    if tenant is not None:
                        out = srv.tenant_predict(
                            str(tenant), points,
                            bool(payload.get("membership", False)), meta=meta,
                        )
                    else:
                        out = srv.predict(
                            points, bool(payload.get("membership", False)), meta=meta
                        )
                    rows = len(out["labels"])
                elif path == "/ingest":
                    points = np.asarray(payload["points"], np.float64)
                    meta["t_parse"] = time.perf_counter()
                    out = srv.ingest(points, meta=meta)
                    rows = out["rows"]
                elif path == "/swap":
                    out = srv.swap(payload.get("path"))
                else:
                    code = 404
                    self._json(code, {"error": f"unknown path {self.path!r}"})
                    return
            except ShedRequest as e:  # bounded-queue load shedding
                code = e.status
                shed_reason = e.reason
                self._json(
                    code,
                    {"error": str(e), "reason": e.reason},
                    headers={
                        "Retry-After": f"{max(e.retry_after_s, 0.001):.3f}",
                        "X-Request-Id": rid,
                    },
                )
                return
            except DeadlineExceeded as e:  # fail fast, no batch slot spent
                code = 504
                self._json(code, {"error": str(e)}, headers={"X-Request-Id": rid})
                return
            except KeyError as e:
                code = 400
                self._json(code, {"error": f"bad request: missing {e}"})
                return
            except ValueError as e:  # shape/dim/guard mismatches: client errors
                code = 400
                self._json(code, {"error": str(e)})
                return
            except RuntimeError as e:  # mode errors (ingest off, nothing staged, no tenants)
                code = 409
                self._json(code, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 - surface, don't crash
                code = 500
                self._json(code, {"error": f"{type(e).__name__}: {e}"})
                return
            code = 200
            generation = int(out.get("generation", generation))
            self._json(code, out, headers={"X-Request-Id": rid})
        finally:
            t_end = time.perf_counter()
            srv._m_in_flight.dec()
            srv._observe_request(path if known else "other", code, t_end - t0)
            # Every /predict and /ingest request terminates in exactly one
            # request_shed or one request_span (success or error).
            if path in ("/predict", "/ingest"):
                if shed_reason is not None:
                    srv._emit_request_shed(path, rid, code, shed_reason)
                else:
                    srv._emit_request_span(
                        path, rid, rows, generation, meta, t0=t0, t_end=t_end, status=code,
                    )


class ClusterServer:
    """Predictor + batcher + HTTP front, as one closeable unit.

    Construction builds the predictor on ``device`` (the card unless the
    caller passes another, e.g. ``"cpu"``) and warms every bucket, so the
    first real request finds every kernel built; ``port=0`` binds an
    ephemeral port (tests).

    ``ingest=True`` turns on the streaming subsystem: ``/ingest`` routes
    arriving points through the predict path into an
    :class:`~hdbscan_tpu_torch.stream.IngestBuffer`, a
    :class:`~hdbscan_tpu_torch.stream.DriftDetector` watches the GLOSH-score
    and assignment-rate distributions, and a
    :class:`~hdbscan_tpu_torch.stream.Refitter` re-fits on ``device`` in the
    background on drift or point budget, publishing generation-numbered
    artifacts under ``model_dir`` that hot-swap in (``stream_reload="auto"``)
    or stage for ``POST /swap`` (``"manual"``). Stream knobs come from
    ``params`` (``HDBSCANParams`` ``stream_*`` and ``maintain_*`` fields);
    ``wal_dir`` (or ``stream_wal_dir``) journals every accepted batch.
    ``params.watchdog_s > 0`` arms a heartbeat hub when none is installed.

    ``tenants`` — a directory of ``<tenant>.npz`` artifacts, or a prebuilt
    :class:`~hdbscan_tpu_torch.fleet.tenants.TenantRegistry` — serves many
    models behind the same front: a directory builds a registry with this
    server's backend, batch ceiling, metrics, tracer and ``device``, its
    LRU and quota from ``tenant_lru_size`` / ``tenant_quota_rps``, and with
    ``fleet_artifact_store="shared"`` the per-host artifact store.
    """

    def __init__(
        self,
        model,
        backend: str = "auto",
        max_batch: int = 256,
        linger_s: float = 0.002,
        host: str = "127.0.0.1",
        port: int = 8799,
        tracer=None,
        warmup: bool = True,
        verbose: bool = False,
        ingest: bool = False,
        params=None,
        model_dir: str | None = None,
        queue_bound: int | None = None,
        deadline_ms: float | None = None,
        wal_dir: str | None = None,
        fault_spec: str | None = None,
        tenants=None,
        device=None,
    ):
        self.tracer = tracer
        self.device = device
        self._backend_req = backend
        self._max_batch = max_batch
        self._linger_s = linger_s
        self._warmup = warmup
        self._swap_lock = threading.Lock()
        self._closed = False
        self._swap_count = 0
        self.last_swap: dict | None = None
        self.pending: dict | None = None  # staged artifact (manual reload)
        # Distinguishes servers sharing one trace file: check_trace enforces
        # monotonic swap generations per (process, server).
        self._server_id = f"{os.getpid():x}.{id(self) & 0xFFFFFF:06x}"

        def knob(name, default):
            return getattr(params, name, default) if params is not None else default

        # Resilience knobs: explicit ctor args win, then params, then the
        # permissive defaults (unbounded queue, no deadline).
        self._queue_bound = int(
            queue_bound if queue_bound is not None else knob("serve_queue_bound", 0)
        )
        self._deadline_ms = float(
            deadline_ms if deadline_ms is not None else knob("serve_deadline_ms", 0.0)
        )
        self._wal_dir = wal_dir or str(knob("stream_wal_dir", "") or "")

        # Fault harness: an explicit/config spec installs the process plan;
        # either way an already-installed plan gets this server's tracer and
        # fault counter attached.
        spec = fault_spec if fault_spec is not None else str(knob("fault_spec", "") or "")
        if not spec:
            spec = os.environ.get(inject.ENV_VAR, "").strip()
        if spec:
            inject.install(spec, tracer=tracer)

        # The registry must exist before the first handle: the predictor
        # observes its batch histograms through it.
        self.metrics = MetricsRegistry()
        self._m_requests = self.metrics.counter(
            "hdbscan_tpu_requests_total",
            "HTTP requests by route and status code.",
            labelnames=("route", "status"),
        )
        self._m_in_flight = self.metrics.gauge(
            "hdbscan_tpu_requests_in_flight", "HTTP requests currently being handled."
        )
        self._m_latency = self.metrics.histogram(
            "hdbscan_tpu_request_latency_seconds",
            "End-to-end HTTP request wall by route.",
            labelnames=("route",),
        )
        self._m_swaps = self.metrics.counter(
            "hdbscan_tpu_model_swaps_total", "Blue/green model swaps applied."
        )
        self._m_generation = self.metrics.gauge(
            "hdbscan_tpu_model_generation", "Generation number of the served model handle."
        )
        self._m_uptime = self.metrics.gauge(
            "hdbscan_tpu_uptime_seconds", "Seconds since server construction."
        )
        self._m_shed = self.metrics.counter(
            "hdbscan_tpu_requests_shed_total",
            "HTTP requests refused to shed load, by route and reason.",
            labelnames=("route", "reason"),
        )
        self._m_faults = self.metrics.counter(
            "hdbscan_tpu_faults_injected_total",
            "Injected faults fired (fault harness), by site.",
            labelnames=("site",),
        )
        self._m_watchdog = self.metrics.counter(
            "hdbscan_tpu_watchdog_stalls_total",
            "Watchdog stack dumps fired (no heartbeat within watchdog_s).",
        )
        self._m_device_peak = self.metrics.gauge(
            "hdbscan_tpu_device_peak_bytes",
            "Per-device peak resident bytes across audited fit phases.",
            labelnames=("device",),
        )
        self._m_straggler = self.metrics.counter(
            "hdbscan_tpu_straggler_flags_total",
            "Straggler flags fired (device >= skew_threshold x round-median "
            "wall for straggler_rounds consecutive rounds), by device.",
            labelnames=("device",),
        )
        # An installed timeline recorder (CLI- or test-built) feeds this
        # server's straggler counter; none is created here.
        tl = obs.timeline()
        if tl is not None and tl.straggler_counter is None:
            tl.straggler_counter = self._m_straggler
        # Arm a heartbeat hub when the config asks for a watchdog and none
        # is installed (an installed hub keeps priority); either way the
        # installed hub feeds this server's stall counter.
        self._armed_hub = None
        hub = obs.heartbeats()
        if hub is None and float(knob("watchdog_s", 0.0)) > 0:
            from hdbscan_tpu_torch.obs.heartbeat import Heartbeats

            hub = self._armed_hub = Heartbeats(
                tracer=tracer,
                heartbeat_s=float(knob("heartbeat_s", 1.0)),
                watchdog_s=float(knob("watchdog_s", 0.0)),
                stall_counter=self._m_watchdog,
            )
            obs.install(heartbeats=hub)
        elif hub is not None and hub._stall_counter is None:
            hub._stall_counter = self._m_watchdog
        plan = inject.plan()
        if plan is not None:
            if plan.tracer is None and tracer is not None:
                plan.tracer = tracer
            plan.add_on_fire(self._on_fault_fire)

        self._handle = self._build_handle(model, generation=1)
        self._m_generation.set(1.0)

        # Multi-tenant registry (``fleet/tenants.py``): a directory path
        # builds one over its artifacts with this server's metrics, tracer
        # and device attached; a prebuilt TenantRegistry is used as-is. None
        # keeps the single-model behavior (a request with a tenant field
        # gets 409).
        self.tenants = None
        if tenants is not None:
            if isinstance(tenants, str):
                from hdbscan_tpu_torch.fleet.tenants import TenantRegistry

                # Per-host zero-copy artifact store: with the knob on,
                # tenant artifacts map through the digest-keyed spool
                # (fleet/artifacts.py) shared by every replica on the host.
                store = None
                if str(knob("fleet_artifact_store", "off")) == "shared":
                    from hdbscan_tpu_torch.fleet.artifacts import default_store

                    store = default_store(tracer=tracer, metrics=self.metrics)
                self.tenants = TenantRegistry.from_dir(
                    tenants,
                    backend=self._backend_req,
                    max_batch=self._max_batch,
                    lru_size=int(knob("tenant_lru_size", 8)),
                    quota_rps=float(knob("tenant_quota_rps", 0.0)),
                    metrics=self.metrics,
                    tracer=tracer,
                    artifact_store=store,
                    device=self.device,
                )
            else:
                self.tenants = tenants

        self.ingest_enabled = bool(ingest)
        self._params = params
        if self.ingest_enabled:
            self._init_stream(params, model_dir)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.cluster_server = self
        self._httpd.verbose = verbose
        self.host, self.port = self._httpd.server_address[:2]
        self._t0 = time.monotonic()
        self._thread: threading.Thread | None = None
        self._serving = False  # a serve_forever loop is (or was) running

    def _on_fault_fire(self, site: str, spec, nth: int) -> None:
        """Fault-plan hook: count every injected fault so /metrics accounts
        for each one the harness fires."""
        self._m_faults.inc(site=site)

    def _on_circuit_state(self, name: str, state: str) -> None:
        self._m_circuit.set(float(CIRCUIT_STATE_VALUES[state]), name=name)

    def _on_refit_result(self, ok: bool, error: str | None) -> None:
        """Refitter outcome hook → the refit circuit breaker."""
        if ok:
            self._refit_circuit.record_success()
        else:
            self._refit_circuit.record_failure()

    # -- stream wiring -----------------------------------------------------

    def _init_stream(self, params, model_dir) -> None:
        from hdbscan_tpu_torch.stream import (
            DriftDetector,
            IngestBuffer,
            Refitter,
            StreamJournal,
        )

        def knob(name, default):
            return getattr(params, name, default) if params is not None else default

        self.reload_mode = knob("stream_reload", "auto")
        self._refit_budget = int(knob("stream_refit_budget", 2048))
        self._absorb_frac = float(knob("stream_absorb_eps_frac", 0.25))
        self._drift_stat = knob("stream_drift_stat", "psi")
        self._drift_threshold = float(knob("stream_drift_threshold", 2.0))
        self.model_dir = model_dir or "stream_models"
        self._ingest_lock = threading.Lock()
        self._m_drift_checks = self.metrics.counter(
            "hdbscan_tpu_drift_checks_total", "Drift detector checks run."
        )
        self._m_drift_flags = self.metrics.counter(
            "hdbscan_tpu_drift_flags_total", "Drift checks that flagged shift."
        )
        self._m_refit_kicks = self.metrics.counter(
            "hdbscan_tpu_refit_kicks_total",
            "Background re-fits kicked from the ingest path, by trigger.",
            labelnames=("trigger",),
        )
        self.buffer = IngestBuffer(
            self.model, absorb_eps_frac=self._absorb_frac, metrics=self.metrics
        )
        self.drift = DriftDetector(
            *DriftDetector.baseline_from_model(self.model, self._handle.predictor),
            stat=self._drift_stat,
            threshold=self._drift_threshold,
            tracer=self.tracer,
        )
        # Refit circuit breaker: repeated fit/swap failures trip it open and
        # the server degrades to serving the pinned generation — no refit
        # kicks until reset_s has elapsed (state in /healthz + /metrics).
        self._m_circuit = self.metrics.gauge(
            "hdbscan_tpu_circuit_state",
            "Circuit breaker state (0 closed, 1 half-open, 2 open).",
            labelnames=("name",),
        )
        self._m_circuit.set(0.0, name="refit")
        self._refit_circuit = CircuitBreaker(
            "refit",
            failures=int(knob("circuit_failures", 3)),
            reset_s=float(knob("circuit_reset_s", 30.0)),
            tracer=self.tracer,
            on_state=self._on_circuit_state,
        )
        refit_params = self._refit_params(params)
        self.refitter = Refitter(
            refit_params,
            self.model_dir,
            tracer=self.tracer,
            on_publish=self._on_publish,
            metrics=self.metrics,
            on_result=self._on_refit_result,
            device=self.device,
        )
        # Crash-safe durability: recover buffer/drift state from the WAL
        # directory (if it belongs to this model's digest), then keep
        # journaling every accepted ingest batch.
        self.journal = None
        wal_info = None
        if self._wal_dir:
            self.journal = StreamJournal(
                self._wal_dir,
                snapshot_every=int(knob("stream_snapshot_every", 64)),
                tracer=self.tracer,
                metrics=self.metrics,
            )
            wal_info = self.journal.open(
                str(self.model.fingerprint.get("data") or ""),
                self.buffer,
                self.drift,
            )
        # Incremental hierarchy maintenance (``stream_maintain=incremental``):
        # novel rows fold into an online MST + dirty-subtree finalize instead
        # of waiting for a full re-fit; the re-fit path demotes to the
        # fallback ladder (drift / maintainer failure / circuit breaker).
        self.maintain_mode = str(knob("stream_maintain", "off"))
        self._maintain_budget_ms = float(knob("maintain_budget_ms", 0.0))
        self._maintain_dirty_frac = float(knob("maintain_dirty_max_frac", 1.0))
        self._maintain_refresh = int(knob("maintain_refresh_every", 64))
        self.maintainer = None
        self._finalizer = None
        self.maintain_refreshes = 0
        self.maintain_fallbacks = 0
        self.maintain_last_error: str | None = None
        if self.maintain_mode == "incremental":
            self._init_maintainer(wal_info)

    def _refit_params(self, params):
        """Re-fit params: caller's knobs where given, but the fingerprint
        fields pinned to the served model's so the swap guard passes."""
        from hdbscan_tpu_torch.config import HDBSCANParams

        base = params if params is not None else HDBSCANParams()
        return base.replace(**dict(self.model.params))

    # -- incremental maintenance -------------------------------------------

    def _init_maintainer(self, wal_info=None) -> None:
        """Bootstrap the online hierarchy maintainer from the served model
        (O(n² d) host k-NN + Prim, as the reference's: artifacts store no
        MST), then replay any WAL-recovered novel rows through the
        deterministic maintenance fold and verify the persisted watermark
        digests. Any failure (``MaintainFallback`` included) demotes to the
        re-fit ladder instead of raising into server construction."""
        from hdbscan_tpu_torch.incremental import DirtySubtreeFinalizer, HierarchyMaintainer

        model = self._handle.model
        try:
            self.maintainer = HierarchyMaintainer(
                model.data,
                min_pts=int(model.params.get("min_points", 2)),
                metric=str(model.params.get("dist_function", "euclidean")),
                rpf=model.rpf,
                budget_ms=self._maintain_budget_ms,
                dirty_max_frac=self._maintain_dirty_frac,
                refresh_every=self._maintain_refresh,
                tracer=self.tracer,
                metrics=self.metrics,
                name=self._server_id,
            )
            self._finalizer = DirtySubtreeFinalizer(
                self._refit_params(self._params),
                dirty_max_frac=self._maintain_dirty_frac,
                tracer=self.tracer,
                name=self._server_id,
            )
        except Exception as exc:
            self._maintain_disable(f"bootstrap: {type(exc).__name__}: {exc}")
            return
        # WAL recovery: maintainer state is never journaled as events — it
        # is a deterministic fold over the buffer's novel chunks, which
        # ``journal.open()`` above just replayed (stream/wal.py docstring).
        # Re-run the fold; the snapshot's "maintain" watermark (journal +
        # MST sha256) must reproduce bitwise at the recorded insert count,
        # else the maintainer stands down rather than serve a silently
        # diverged hierarchy.
        watermark = (wal_info or {}).get("maintain") or None
        verify = None
        if watermark and int(watermark.get("inserts", 0)) > 0:
            verify = (int(watermark["inserts"]), watermark)
        try:
            for chunk in self.buffer.novel_chunks():
                self.maintainer.rebuild(chunk, verify_at=verify)
        except Exception as exc:
            self._maintain_disable(f"recovery: {type(exc).__name__}: {exc}")

    def _maintain_disable(self, error) -> None:
        """Demote the stream to the re-fit ladder: drop the maintainer (the
        ``budget`` trigger un-suppresses on the next ingest), record and
        trace the demotion. Caller decides whether to kick a re-fit."""
        m, self.maintainer, self._finalizer = self.maintainer, None, None
        self.maintain_fallbacks += 1
        self.maintain_last_error = str(error)
        if m is not None:
            m._count("fallback")
        if self.tracer is not None:
            self.tracer(
                "maintain_fallback",
                maintainer=self._server_id,
                generation=int(self._handle.generation),
                n=int(m.n) if m is not None else 0,
                inserts=int(m.inserts) if m is not None else 0,
                error=str(error),
            )

    def _maintain_batch(self, chunk_start: int):
        """Fold this batch's novel rows into the maintainer (caller holds
        ``_ingest_lock``). Per row: bounded insert; when the splice cadence
        fires, MST splice + dirty-subtree finalize + maintained-model build
        — but NOT the handle swap, which needs ``_swap_lock`` and is done
        by the caller after releasing the ingest lock (lock order:
        ``swap_model`` takes swap → ingest, so never the reverse).

        The per-row cadence check mirrors ``HierarchyMaintainer.rebuild``
        exactly — live fold and WAL recovery fold are the same function of
        the novel-row sequence, which is what makes the snapshot watermark
        verifiable bitwise.

        Returns ``(stats_dict, maintained_model_or_None)``; a failure
        (``MaintainFallback`` or any other) demotes via
        :meth:`_maintain_disable` and reports ``fallback`` in the stats —
        ingest itself never fails on maintenance."""
        m = self.maintainer
        inserted = spliced = 0
        over_budget = False
        new_model = None
        try:
            for idx in range(chunk_start, self.buffer.novel_chunk_count):
                for row in self.buffer.novel_chunk(idx):
                    info = m.insert(row)
                    inserted += 1
                    over_budget = over_budget or info["over_budget"]
                    if m._since_splice >= m.refresh_every:
                        m.splice()
                        spliced += 1
            if spliced:
                with obs.task("stream_maintain", total=1) as t:
                    lo, hi, w = m.mst_arrays()
                    tree, labels, _scores, _inf = self._finalizer.finalize(
                        m.n, lo, hi, w, m.core[: m.n]
                    )
                    new_model = self._maintained_model(tree, labels)
                    t.beat(1)
        except Exception as exc:
            self._maintain_disable(f"{type(exc).__name__}: {exc}")
            return (
                {"inserted": inserted, "spliced": spliced, "fallback": True},
                None,
            )
        return (
            {
                "inserted": inserted,
                "spliced": spliced,
                "over_budget": over_budget,
                "fallback": False,
            },
            new_model,
        )

    def _maintained_model(self, tree, labels):
        """Serving artifact for the maintained hierarchy, shape-padded.

        Rows pad to the maintainer's power-of-two capacity with inert
        sentinels (coordinates and core at 1e18 — never the nearest
        neighbor, never attach) so the predictor's train-side shapes stay
        constant across maintenance refreshes until the capacity doubles,
        and the served artifact (and its data digest) is the reference's
        for the same rows. ``rpf=None``: the stored planes only
        index the bootstrap rows, so the padded model serves through the
        exhaustive backend."""
        from hdbscan_tpu_torch.models._finalize import serving_tables
        from hdbscan_tpu_torch.utils.checkpoint import _data_digest

        m = self.maintainer
        base = self._handle.model
        n, cap = m.n, m._cap
        labels = np.asarray(labels, np.int64)
        tables = serving_tables(tree, labels)
        data = np.full((cap, m.dims), _INERT_FILL, np.float64)
        data[:n] = m.data[:n]
        core = np.full(cap, _INERT_FILL, np.float64)
        core[:n] = m.core[:n]
        lab = np.zeros(cap, np.int64)
        lab[:n] = labels
        last = np.zeros(cap, np.int64)
        last[:n] = np.asarray(tree.point_last_cluster, np.int64)
        fingerprint = dict(base.fingerprint)
        fingerprint["n"] = int(cap)
        fingerprint["data"] = _data_digest(data)
        return ClusterModel(
            mode=base.mode,
            params=dict(base.params),
            fingerprint=fingerprint,
            data=data,
            core=core,
            labels=lab,
            last_cluster=last,
            parent=np.asarray(tree.parent, np.int64),
            birth=np.asarray(tree.birth, np.float64),
            selected=np.asarray(tree.selected, bool),
            sel_anc=np.asarray(tables["sel_anc"], np.int64),
            eps_min=np.asarray(tables["eps_min"], np.float64),
            eps_max=np.asarray(tables["eps_max"], np.float64),
            rpf=None,
        )

    def maintain_stats(self) -> dict:
        """Maintenance block of ``/healthz``'s stream dict."""
        out = {
            "mode": self.maintain_mode,
            "active": self.maintainer is not None,
            "refreshes": int(self.maintain_refreshes),
            "fallbacks": int(self.maintain_fallbacks),
            "last_error": self.maintain_last_error,
        }
        if self.maintainer is not None:
            m = self.maintainer
            out.update(
                n=int(m.n),
                inserts=int(m.inserts),
                splices=int(m.splices),
                pending_edges=int(m.pending_edges),
                over_budget=int(m.over_budget),
            )
        return out

    # -- handles -----------------------------------------------------------

    def _build_handle(self, model, generation: int) -> _ModelHandle:
        backend = self._backend_req
        if backend == "rpforest" and model.rpf is None:
            backend = "auto"  # an artifact that ships without a forest
        predictor = Predictor(
            model, backend=backend, max_batch=self._max_batch,
            tracer=self.tracer, metrics=self.metrics, device=self.device,
        )
        warmup_info = predictor.warmup() if self._warmup else None
        batcher = MicroBatcher(predictor, linger_s=self._linger_s, max_queue=self._queue_bound)
        return _ModelHandle(model, predictor, batcher, generation, warmup_info)

    def _install_handle(self, new_model, reason: str) -> tuple:
        """Blue/green core: build + warm the new handle on the old model's
        watch, swap under ``_swap_lock`` (one reference assignment), account
        the swap, emit the ``model_swap`` trace, drain-close the old
        batcher. Returns ``(new_handle, pause_s)``."""
        new_handle = self._build_handle(new_model, generation=0)  # warm first
        with self._swap_lock:
            if self._closed:
                new_handle.batcher.close()
                raise RuntimeError("server is closed")
            old = self._handle
            new_handle.generation = old.generation + 1
            t0 = time.perf_counter()
            self._handle = new_handle  # the swap: one reference assignment
            pause_s = time.perf_counter() - t0
            self._swap_count += 1
        self._m_swaps.inc()
        self._m_generation.set(float(new_handle.generation))
        if self.tracer is not None:
            self.tracer(
                "model_swap",
                generation=int(new_handle.generation),
                digest=str(new_handle.digest),
                n_train=int(new_model.n_train),
                reason=str(reason),
                server=self._server_id,
                pause_s=round(pause_s, 9),
                wall_s=round(pause_s, 9),
            )
        old.batcher.close()  # graceful: every in-flight future completes
        return new_handle, pause_s

    def _publish_maintained(self, new_model) -> None:
        """Handle refresh for a maintained model — NOT a swap: buffer,
        drift sketches and journal keep their state, because the WAL
        replay base is the bootstrap model plus the grow-only novel-chunk
        log. Called with no locks held."""
        try:
            self._install_handle(new_model, reason="maintain")
        except Exception as exc:
            self._maintain_disable(f"publish: {type(exc).__name__}: {exc}")
        else:
            self.maintain_refreshes += 1
            if self.maintainer is not None:
                self.maintainer._count("refresh")

    @property
    def model(self):
        return self._handle.model

    @property
    def predictor(self):
        return self._handle.predictor

    @property
    def batcher(self):
        return self._handle.batcher

    @property
    def generation(self) -> int:
        return self._handle.generation

    @property
    def warmup_info(self):
        return self._handle.warmup_info

    # -- request paths -----------------------------------------------------

    def next_request_id(self) -> str:
        """Process-unique request id (pid + process-wide sequence)."""
        return f"{os.getpid()}-{next(_REQUEST_IDS)}"

    def _observe_request(self, route: str, status: int, wall: float) -> None:
        self._m_requests.inc(route=route, status=str(status))
        self._m_latency.observe(wall, route=route)

    def request_deadline(self, headers, t0: float) -> float | None:
        """Resolve the request's deadline (a perf_counter instant) from the
        ``X-Deadline-Ms`` header, falling back to the server-wide
        ``serve_deadline_ms`` default; None when neither applies."""
        raw = headers.get("X-Deadline-Ms")
        if raw is not None:
            try:
                ms = float(raw)
            except ValueError:
                raise ValueError(f"bad X-Deadline-Ms header: {raw!r}") from None
            if ms <= 0:
                raise ValueError(f"X-Deadline-Ms must be > 0, got {raw!r}")
            return t0 + ms / 1000.0
        if self._deadline_ms > 0:
            return t0 + self._deadline_ms / 1000.0
        return None

    def _emit_request_shed(self, route, rid, status, reason) -> None:
        """Account one load-shed request: counter always, ``request_shed``
        trace event when a tracer is attached."""
        self._m_shed.inc(route=route, reason=str(reason))
        if self.tracer is not None:
            self.tracer(
                "request_shed", request_id=rid, route=route, status=int(status),
                reason=str(reason),
            )

    def _emit_request_span(
        self, route, rid, rows, generation, meta, t0, t_end, status=200
    ) -> None:
        """Emit one ``request_span`` trace event for a terminated request,
        successes and errors alike. The five segments are contiguous
        perf_counter diffs (clamped monotone into [t0, t_end]) so they
        telescope exactly to the span wall; 9-decimal rounding keeps the sum
        inside check_trace's 1e-6 tolerance."""
        if self.tracer is None:
            return
        t_parse = min(max(t0, meta.get("t_parse", t0)), t_end)
        t_asm = min(max(t_parse, meta.get("t_assembled", t_parse)), t_end)
        t_disp = min(max(t_asm, meta.get("t_dispatch", t_asm)), t_end)
        t_done = min(max(t_disp, meta.get("t_done", t_disp)), t_end)
        bucket = meta.get("bucket")
        if not bucket:  # never emit a non-pow2 bucket
            pred = self._handle.predictor
            bucket = pred.bucket_for(min(max(int(rows), 1), pred.max_bucket))
        self.tracer(
            "request_span",
            request_id=rid,
            route=route,
            status=int(status),
            rows=int(rows),
            bucket=int(bucket),
            coalesced=int(meta.get("coalesced", 1)),
            generation=int(generation),
            parse_s=round(t_parse - t0, 9),
            queue_s=round(t_asm - t_parse, 9),
            assemble_s=round(t_disp - t_asm, 9),
            predict_s=round(t_done - t_disp, 9),
            respond_s=round(t_end - t_done, 9),
            wall_s=round(t_end - t0, 9),
        )

    def predict(self, points: np.ndarray, membership: bool = False,
                meta: dict | None = None) -> dict:
        for _ in range(_PIN_RETRIES):
            handle = self._handle  # pin: this request never mixes models
            try:
                return self._predict_on(handle, points, membership, meta)
            except RuntimeError as e:
                # The pinned handle's batcher closed under us (a swap landed
                # between the pin and the submit): re-pin and retry.
                if "closed" not in str(e) or self._closed:
                    raise
        raise RuntimeError("predict retries exhausted during model swaps")

    def _predict_on(self, handle: _ModelHandle, points, membership: bool,
                    meta: dict | None = None) -> dict:
        if membership:
            # Membership bypasses the batcher and relies on the predictor's
            # dispatch lock: no queue wait and no coalescing, so the span
            # meta collapses queue/assemble to zero width.
            if meta is not None:
                t = time.perf_counter()
                meta["t_assembled"] = meta["t_dispatch"] = t
            labels, prob, score, mvec = handle.predictor.predict(points, with_membership=True)
            if meta is not None:
                meta["t_done"] = time.perf_counter()
                meta["coalesced"] = 1
                meta["bucket"] = handle.predictor.bucket_for(
                    min(len(labels), handle.predictor.max_bucket)
                )
            return {
                "labels": labels.tolist(),
                "probabilities": [round(p, 6) for p in prob.tolist()],
                "outlier_scores": [round(s, 6) for s in score.tolist()],
                "membership": np.round(mvec, 6).tolist(),
                "selected_ids": handle.model.selected_ids.tolist(),
                "generation": handle.generation,
            }
        labels, prob, score = handle.batcher.predict(points, meta=meta)
        return {
            "labels": labels.tolist(),
            "probabilities": [round(p, 6) for p in prob.tolist()],
            "outlier_scores": [round(s, 6) for s in score.tolist()],
            "generation": handle.generation,
        }

    def tenant_predict(
        self, tenant: str, points, membership: bool = False,
        meta: dict | None = None,
    ) -> dict:
        """Predict against one tenant's model via the registry: quota check
        (429 ShedRequest on exceed), LRU touch, load + warmup on a cold
        tenant. Bypasses the micro-batcher like the membership path — the
        tenant predictor's internal dispatch lock serializes, so the span
        meta collapses queue/assemble to zero-width."""
        if self.tenants is None:
            raise RuntimeError(
                "server started without a tenant registry (--tenants-dir)"
            )
        if meta is not None:
            t = time.perf_counter()
            meta["t_assembled"] = meta["t_dispatch"] = t
        out, info = self.tenants.predict(
            tenant, points, with_membership=membership
        )
        if meta is not None:
            meta["t_done"] = time.perf_counter()
            meta["coalesced"] = 1
            meta["bucket"] = info["bucket"]
        labels, prob, score = out[:3]
        resp = {
            "labels": labels.tolist(),
            "probabilities": [round(p, 6) for p in prob.tolist()],
            "outlier_scores": [round(s, 6) for s in score.tolist()],
            "tenant": info["tenant"],
            "generation": info["generation"],
        }
        if membership:
            resp["membership"] = np.round(out[3], 6).tolist()
            resp["selected_ids"] = info["selected_ids"]
        return resp

    def ingest(self, points: np.ndarray, meta: dict | None = None) -> dict:
        """Streaming entry: predict → absorb/buffer → drift check → maybe
        kick a background re-fit. Returns per-batch routing + drift info."""
        if not self.ingest_enabled:
            raise RuntimeError("server started without ingest mode")
        t0 = time.perf_counter()
        points = np.asarray(points, np.float64)
        if points.ndim == 1:
            points = points[None, :]
        scored = False
        for _ in range(_PIN_RETRIES):
            handle = self._handle
            try:
                labels, prob, score = handle.batcher.predict(points, meta=meta)
            except RuntimeError as e:
                if "closed" not in str(e) or self._closed:
                    raise
                continue
            scored = True
            if handle is self._handle:
                break
            # A swap landed mid-predict: the buffer/drift state now keys to
            # the new model, so this batch's scores are stale — redo on the
            # current handle rather than polluting the fresh sketches.
        if not scored:
            raise RuntimeError("ingest retries exhausted during model swaps")
        maintained = None
        new_model = None
        with self._ingest_lock:
            chunk_start = (
                self.buffer.novel_chunk_count
                if self.maintainer is not None else 0
            )
            absorbed, buffered = self.buffer.absorb(points, labels, prob)
            self.drift.update(labels, score)
            if self.maintainer is not None:
                maintained, new_model = self._maintain_batch(chunk_start)
            if self.journal is not None:
                # Write-ahead relative to the HTTP ack: the batch (with its
                # predicted labels/prob/scores, so replay never re-predicts)
                # is fsync'd before the 200 goes out. The maintain watermark
                # captures the state AFTER this batch's fold, so recovery
                # verifies its replay at exactly this insert count.
                self.journal.append_ingest(points, labels, prob, score)
                self.journal.maybe_snapshot(
                    self.buffer,
                    self.drift,
                    maintain=(
                        self.maintainer.state_dict()
                        if self.maintainer is not None else None
                    ),
                )
            check = self.drift.check(generation=handle.generation)
            self._m_drift_checks.inc()
            if check["drifted"]:
                self._m_drift_flags.inc()
            trigger = None
            if maintained is not None and maintained["fallback"]:
                trigger = "maintain_fallback"
            elif check["drifted"]:
                trigger = "drift"
            elif (
                self.maintainer is None
                and self.buffer.buffered_rows >= self._refit_budget
            ):
                # An active maintainer suppresses the point-budget trigger:
                # novel rows are already folded into the served hierarchy,
                # so the full re-fit is reserved for drift and the fallback
                # ladder (maintain_fallback / circuit breaker).
                trigger = "budget"
            refit_started = False
            # Circuit gate: after repeated refit/swap failures the breaker
            # is open and triggers are suppressed — the server degrades to
            # serving the pinned generation instead of burning fit cycles.
            if (
                trigger
                and self.pending is None
                and not self.refitter.busy
                and self._refit_circuit.allow()
            ):
                pool = self.buffer.refit_points(
                    originals=min(self.model.n_train, 8192)
                )
                refit_started = self.refitter.request(pool, trigger)
                if refit_started:
                    self._m_refit_kicks.inc(trigger=trigger)
        if new_model is not None:
            # Outside the ingest lock by necessity: the handle refresh takes
            # _swap_lock, and swap_model's order is swap → ingest.
            self._publish_maintained(new_model)
        if self.tracer is not None:
            self.tracer(
                "stream_ingest",
                rows=int(len(points)),
                absorbed=int(absorbed),
                buffered=int(buffered),
                generation=int(handle.generation),
                wall_s=round(time.perf_counter() - t0, 6),
            )
        out = {
            "rows": int(len(points)),
            "absorbed": int(absorbed),
            "buffered": int(buffered),
            "generation": int(self._handle.generation),
            "drift": check,
            "refit_started": bool(refit_started),
        }
        if maintained is not None:
            out["maintained"] = maintained
        return out

    # -- blue/green swap ---------------------------------------------------

    def _on_publish(self, path: str, model, reason: str) -> None:
        """Refitter callback (worker thread): hot-swap, or stage for
        ``POST /swap`` in manual reload mode."""
        staged = {"path": path, "reason": reason, "n_train": int(model.n_train)}
        if self.reload_mode == "manual":
            self.pending = staged
            return
        try:
            self.swap_model(model, reason=reason, path=path)
        except Exception as exc:  # guard failure: keep serving the old model
            self.last_swap = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
            self._refit_circuit.record_failure()

    def swap(self, path: str | None = None) -> dict:
        """HTTP-facing swap: explicit artifact ``path``, else the staged
        re-fit publication."""
        if path is None:
            if self.pending is None:
                raise RuntimeError("no staged artifact to swap in")
            path = self.pending["path"]
        return self.swap_model(path, reason="manual")

    def swap_model(self, model_or_path, reason: str = "manual",
                   path: str | None = None) -> dict:
        """Atomically replace the served model (blue/green).

        Accepts a :class:`ClusterModel` or an artifact path. Path loads run
        the artifact's schema + digest checks (``ClusterModel.load`` refuses
        corrupt or mismatched files; transient IO faults retry with
        backoff); either way the fingerprint fields must match the served
        model — a swap may change the data, not the clustering contract.
        In ingest mode the buffer, drift baseline, journal and maintainer
        re-key to the new model under the ingest lock, after the swap lock
        is released.
        """
        if isinstance(model_or_path, (str, os.PathLike)):
            path = str(model_or_path)
            new_model = retry_call(
                lambda: ClusterModel.load(path),
                attempts=3, base_s=0.05, cap_s=0.5, seed=0,
                retry_on=(OSError, inject.InjectedFault),
                tracer=self.tracer, name="artifact_load",
            )
        else:
            new_model = model_or_path
        old_model = self._handle.model
        for f in _FINGERPRINT_FIELDS:
            if new_model.params.get(f) != old_model.params.get(f):
                raise ValueError(
                    f"swap fingerprint mismatch on {f!r}: incoming "
                    f"{new_model.params.get(f)!r} != served "
                    f"{old_model.params.get(f)!r} — refusing to swap"
                )
        new_handle, pause_s = self._install_handle(new_model, reason)
        if self.ingest_enabled:
            with self._ingest_lock:
                self.buffer.reset(new_model)
                self.drift.rebaseline(
                    *type(self.drift).baseline_from_model(new_model, new_handle.predictor)
                )
                self.pending = None
                if self.journal is not None:
                    # The old generation's stream state was consumed by the
                    # re-fit; re-key the journal to the new digest.
                    self.journal.restart(str(new_handle.digest or ""))
                if self.maintain_mode == "incremental":
                    # A real swap resets the maintenance fold's base: re-
                    # bootstrap over the new fit (O(n² d) host pass) under
                    # the ingest lock so no batch folds into a stale
                    # maintainer meanwhile.
                    self.maintainer = self._finalizer = None
                    self._init_maintainer()
        info = {
            "ok": True,
            "generation": int(new_handle.generation),
            "n_train": int(new_model.n_train),
            "digest": str(new_handle.digest),
            "reason": str(reason),
            "path": path,
            "pause_s": round(pause_s, 9),
        }
        self.last_swap = info
        return info

    # -- health / metrics --------------------------------------------------

    def render_metrics(self) -> str:
        """Prometheus text exposition for ``GET /metrics``. Live-state
        gauges (uptime, served generation, the installed auditor's
        per-device peaks) refresh at scrape time."""
        self._m_uptime.set(round(time.monotonic() - self._t0, 3))
        self._m_generation.set(float(self._handle.generation))
        aud = obs.auditor()
        if aud is not None:
            for dev, peak in aud.device_peaks().items():
                self._m_device_peak.set(float(peak), device=dev)
        return self.metrics.render()

    def health(self) -> dict:
        handle = self._handle
        # Per-route request/error counts (>= 400 counts as an error) and the
        # current in-flight count, from the metrics registry.
        requests: dict = {}
        for labels, value in self._m_requests.samples():
            row = requests.setdefault(labels["route"], {"requests": 0, "errors": 0})
            row["requests"] += int(value)
            if int(labels["status"]) >= 400:
                row["errors"] += int(value)
        out = {
            "status": "ok",
            "model": handle.model.summary(),
            "backend": handle.predictor.backend,
            "device": str(handle.predictor.device),
            "buckets": list(handle.predictor.buckets),
            "warmup": handle.warmup_info,
            "batcher": handle.batcher.stats,
            "generation": handle.generation,
            "swaps": self._swap_count,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "requests": requests,
            "in_flight": int(self._m_in_flight.value()),
        }
        if self.last_swap is not None:
            out["last_swap"] = self.last_swap
        wd = obs.watchdog_state()
        if wd is not None:
            out["watchdog"] = wd
        sg = obs.straggler_state()
        if sg is not None:
            out["straggler"] = sg
        dev = handle.predictor.device
        if dev.type == "cuda":
            import torch

            from hdbscan_tpu_torch.ops import cuda_build

            out["kernels"] = {
                "launches": {k: v for k, v in cuda_build.LAUNCHES.items() if v},
                "builds": cuda_build.BUILDS,
                "cache_hits": cuda_build.CACHE_HITS,
            }
            out["device_memory"] = {
                "allocated_bytes": torch.cuda.memory_allocated(dev),
                "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
                "reserved_bytes": torch.cuda.memory_reserved(dev),
            }
        if self.ingest_enabled:
            stats = self.buffer.stats()
            out["stream"] = {
                "rows_seen": stats["rows_seen"],
                "absorbed_exact": stats["absorbed_exact"],
                "absorbed_near": stats["absorbed_near"],
                "buffered": stats["buffered"],
                "bubbles": len(stats["bubbles"]),
                "drift_rows": self.drift.rows,
                "drift_checks": self.drift.checks,
                "refits_ok": self.refitter.refits_ok,
                "refits_failed": self.refitter.refits_failed,
                "refit_busy": self.refitter.busy,
                "refit_last_error": self.refitter.last_error,
                "refit_last_error_at": self.refitter.last_error_at,
                "refit_backoff_s": round(self.refitter.backoff_remaining_s(), 3),
                "circuit": self._refit_circuit.state_info(),
                "reload": self.reload_mode,
                "pending": self.pending,
                "maintain": self.maintain_stats(),
            }
            if self.journal is not None:
                out["stream"]["wal"] = self.journal.stats()
        return out

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ClusterServer":
        """Serve on a daemon thread (tests / embedding); returns self."""
        self._serving = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="predict-http", daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Serve on the calling thread until interrupted (CLI path).
        ``SIGTERM`` triggers the same graceful drain as ``close()``."""
        try:
            signal.signal(
                signal.SIGTERM,
                lambda *_: threading.Thread(target=self.close, name="sigterm-close").start(),
            )
        except ValueError:
            pass  # not the main thread (embedded) — close() still works
        try:
            self._serving = True
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.close()

    def close(self) -> None:
        """Graceful shutdown: stop accepting, finish in-flight requests
        (batcher drain resolves every accepted future), then release."""
        with self._swap_lock:
            if self._closed:
                return
            self._closed = True
        if self._serving:  # shutdown() blocks unless a serve loop is live
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._handle.batcher.close()
        if self.ingest_enabled:
            self.refitter.join(timeout=0.5)  # daemon thread; don't block long
            if self.journal is not None:
                self.journal.close()
        if self._armed_hub is not None:
            obs.disarm(self._armed_hub)

    def __enter__(self) -> "ClusterServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

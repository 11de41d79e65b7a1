"""Stdlib HTTP inference server over a fitted ClusterModel — the port of
``hdbscan_tpu/serve/server.py``'s predict, health, metrics, swap and close
paths.

Endpoints:

- ``POST /predict`` — body ``{"points": [[...], ...]}`` (optionally
  ``"membership": true``); responds ``{"labels", "probabilities",
  "outlier_scores", "generation"}`` (plus ``"membership"`` +
  ``"selected_ids"`` when requested). Plain predicts route through the
  :class:`~hdbscan_tpu_torch.serve.batcher.MicroBatcher`, so concurrent
  clients coalesce into shared bucket dispatches.
- ``POST /swap`` — an explicit ``{"path": ...}`` artifact: the blue/green
  hot swap.
- ``GET /healthz`` — model summary, backend, buckets, warmup, batcher
  coalescing stats, swap state, uptime, per-route request/error counts and
  the current in-flight count.
- ``GET /metrics`` — Prometheus text exposition (``utils/metrics.py``):
  request totals by route/status, in-flight gauge, request-latency and
  batch-size histograms, swap, shed and fault counters.
  ``scripts/check_metrics.py`` validates the output.

Per-request spans: every terminated ``/predict`` request — success or
error — gets a process-unique request id (echoed as ``X-Request-Id``) and,
when a tracer is attached, exactly one trace event: a ``request_shed``
(the bounded batcher queue refused it with 503 + Retry-After) or a
``request_span`` carrying the HTTP ``status`` and decomposing its wall into
parse / queue-wait / batch-assembly / device-predict / respond segments
that telescope exactly to the span wall (``scripts/check_trace.py``).

Fault tolerance: per-request deadlines (``X-Deadline-Ms`` header /
``serve_deadline_ms`` knob → 504 before a batch slot is spent),
bounded-queue load shedding (``serve_queue_bound``), retried artifact
loads on swap, and the ``HDBSCAN_TPU_FAULTS`` injection harness
(``hdbscan_tpu_torch/fault``).

Blue/green serving: every model lives in an immutable ``_ModelHandle``
(model + warmed predictor + its own MicroBatcher + generation number). A
request pins the handle it started with, and a swap is a single reference
assignment under a lock, so in-flight requests finish on the model they
started on; the old handle's batcher is then drain-closed. Swaps are
guarded by the artifact digest check (``ClusterModel.load``) plus a
fingerprint-field match against the served model, and emit ``model_swap``
trace events with a per-server monotonic generation.

Not ported: streaming ingest and re-fit (``ingest=True``, ``model_dir``,
``wal_dir``; ROADMAP A10), incremental maintenance (``stream_maintain``
other than ``off``; A10), tenants (A12) and the observability layer's
watchdog (A11): each raises ``NotImplementedError`` before any socket
opens. ``SIGTERM``/``close()`` drains in-flight work before exiting.
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

from hdbscan_tpu_torch.fault import inject
from hdbscan_tpu_torch.fault.policy import DeadlineExceeded, ShedRequest, retry_call
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


def _refuse_unported(ingest, params, model_dir, wal_dir, tenants) -> None:
    """The server's features that are not ported, each named with its
    ROADMAP item; raised before any model is staged or socket opened."""
    def knob(name, default):
        return getattr(params, name, default) if params is not None else default

    if ingest or model_dir:
        raise NotImplementedError(
            "streaming ingest (ingest=True, model_dir) is not ported yet (ROADMAP A10)")
    if wal_dir or knob("stream_wal_dir", ""):
        raise NotImplementedError("the ingest WAL (wal_dir) is not ported yet (ROADMAP A10)")
    if str(knob("stream_maintain", "off")) != "off":
        raise NotImplementedError(
            "incremental maintenance (stream_maintain) is not ported yet (ROADMAP A10)")
    if tenants is not None:
        raise NotImplementedError("tenants are not ported yet (ROADMAP A12)")
    if float(knob("watchdog_s", 0.0)) > 0:
        raise NotImplementedError("the watchdog (watchdog_s) is not ported yet (ROADMAP A11)")


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
                    if payload.get("tenant") is not None:
                        raise RuntimeError("tenants are not ported yet (ROADMAP A12)")
                    out = srv.predict(
                        points, bool(payload.get("membership", False)), meta=meta
                    )
                    rows = len(out["labels"])
                elif path == "/ingest":
                    raise RuntimeError("ingest is not ported yet (ROADMAP A10)")
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
            except RuntimeError as e:  # mode errors (nothing to swap, unported)
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
    ephemeral port (tests). ``ingest``, ``model_dir``, ``wal_dir``,
    ``stream_maintain`` other than ``off`` (in ``params``), ``tenants`` and
    a watchdog are not ported: each raises ``NotImplementedError`` naming
    its ROADMAP item before anything else happens.
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
        _refuse_unported(ingest, params, model_dir, wal_dir, tenants)
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
        # The observability layer's families (ROADMAP A11 feeds them). With
        # no layer installed, the reference's default, they stay at zero,
        # and a scrape names the reference's families.
        self.metrics.counter(
            "hdbscan_tpu_watchdog_stalls_total",
            "Watchdog stack dumps fired (no heartbeat within watchdog_s).",
        )
        self.metrics.gauge(
            "hdbscan_tpu_device_peak_bytes",
            "Per-device peak resident bytes across audited fit phases.",
            labelnames=("device",),
        )
        self.metrics.counter(
            "hdbscan_tpu_straggler_flags_total",
            "Straggler flags fired (device >= skew_threshold x round-median "
            "wall for straggler_rounds consecutive rounds), by device.",
            labelnames=("device",),
        )
        plan = inject.plan()
        if plan is not None:
            if plan.tracer is None and tracer is not None:
                plan.tracer = tracer
            plan.add_on_fire(self._on_fault_fire)

        self._handle = self._build_handle(model, generation=1)
        self._m_generation.set(1.0)

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

    # -- blue/green swap ---------------------------------------------------

    def swap(self, path: str | None = None) -> dict:
        """HTTP-facing swap: an explicit artifact ``path`` (staged re-fit
        publications come with streaming, ROADMAP A10)."""
        if path is None:
            raise RuntimeError("no staged artifact to swap in")
        return self.swap_model(path, reason="manual")

    def swap_model(self, model_or_path, reason: str = "manual") -> dict:
        """Atomically replace the served model (blue/green).

        Accepts a :class:`ClusterModel` or an artifact path. Path loads run
        the artifact's schema + digest checks (``ClusterModel.load`` refuses
        corrupt or mismatched files; transient IO faults retry with
        backoff); either way the fingerprint fields must match the served
        model — a swap may change the data, not the clustering contract.
        """
        path = None
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
        gauges (uptime, served generation) refresh at scrape time."""
        self._m_uptime.set(round(time.monotonic() - self._t0, 3))
        self._m_generation.set(float(self._handle.generation))
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

    def __enter__(self) -> "ClusterServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

"""Asyncio fleet router: N replica subprocesses behind one front door — a
host-side copy of ``hdbscan_tpu/fleet/router.py`` whose replicas are the
port's ``serve`` processes on the card.

The paper's MR-HDBSCAN* is a master coordinating many workers over
partitioned data; this is the serving-side analogue — a thin coordination
layer over unchanged per-replica servers, the way PANDA (arxiv 1607.08220)
scales one-node k-NN into a distributed exchange. Each replica is a full
``serve/server.ClusterServer`` process with the serving contracts intact
(micro-batching, blue/green swap, deadlines, shedding, WAL); the router
adds only placement and failure handling:

* **Spawn/monitor** — replicas launch as ``python -m hdbscan_tpu_torch
  serve`` subprocesses (``--device`` forwarded; none means the card, and
  a replica never moves to the CPU unasked) sharing ``--model-dir``
  artifacts (digest-guarded loads make concurrent loading safe) and report
  their ephemeral port through a ``--port-file``; a crashed replica is
  respawned (its WAL replays on the same ``wal_dir``, so acked ingest
  survives a SIGKILL). Replicas sharing one card each pay their own CUDA
  context and their own copies of their resident tenants' tables; a
  SIGKILLed replica frees its context and its respawn pays it again.
* **Routing** — ``/predict``/``/ingest`` route by ``consistent_hash``
  (md5 ring over the request's tenant id, falling back to a body digest)
  or ``least_loaded`` (fewest in-flight proxied requests). A replica that
  refuses a connection is marked down *immediately* and the request
  re-routes in place — strictly faster than the one-health-interval bound.
  Re-dispatch after bytes were already sent is only safe for idempotent
  ``/predict``; a torn ``/ingest`` returns 502 rather than risk double
  ingestion (acked writes are WAL-durable either way).
* **Asyncio front-end** — the accept path is a single-threaded
  ``asyncio`` loop: connections are coroutines, not threads, so 10k idle
  keep-alive clients cost file descriptors rather than stacks, and the
  replicas' linger-based coalescing is fed by as many concurrent proxied
  requests as the OS allows.
* **Headers** — ``X-Deadline-Ms`` propagates to the chosen replica (and
  bounds the proxy's own wait); ``Retry-After`` from a shedding replica
  passes through untouched; an all-replicas-down 503 carries the health
  interval as its Retry-After.
* **Aggregation** — ``GET /metrics`` scrapes every live replica, re-parses
  the exposition into a registry tagged ``replica="<id>"``
  (``utils.metrics.registry_from_exposition``), and folds the results plus
  the router's own instruments through ``MetricsRegistry.merge()``.

Trace events: ``fleet_route`` per proxied request, ``replica_health`` per
probe, ``scale_event`` per scale operation — all validated by
``scripts/check_trace.py``.

Elasticity: the replica set is dynamic. :meth:`FleetRouter.scale_up`
spawns a STANDBY replica — port reported, health probe green, every bucket
warmed (its kernels loaded from the one build directory every replica is
given as ``compile_cache=<dir>``, so a warm standby builds nothing) —
before the ring is rebuilt to include it, so the first routed request is
full-speed. :meth:`FleetRouter.scale_down` removes the
replica from the ring first, drains its in-flight requests, then runs the
WAL-safe SIGTERM shutdown; a later scale-up reuses the lowest free rid and
thus the departed replica's WAL directory. The decision loop driving these
lives in ``fleet/controlplane.Autoscaler``, reading :meth:`signals`.

Device pinning: on multi-card hosts pass ``devices=N`` — a replica ``i``
on the card gets ``CUDA_VISIBLE_DEVICES`` set to ``i % N`` (keyed off the
replicas' ``device``; CPU replicas are left alone), so replicas land on
distinct cards instead of all initializing card 0. Without ``devices``
every replica shares ``cuda:0``.
"""

from __future__ import annotations

import asyncio
import bisect
import hashlib
import itertools
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque

_TENANT_RE = re.compile(rb'"tenant"\s*:\s*(?:"((?:[^"\\]|\\.)*)"|(-?\d+))')

#: Routing policies ``FleetRouter`` accepts (mirrored by the
#: ``fleet_policy`` config knob).
POLICIES = ("consistent_hash", "least_loaded")

_VNODES = 64  # ring points per replica; 64 keeps the max/min load skew < ~20%

_HOP_HEADERS = {"connection", "keep-alive", "transfer-encoding", "server", "date"}


def _on_card(device) -> bool:
    """Whether a replica given ``--device device`` runs on a card (None
    means the card: the port has no fallback)."""
    return device is None or str(device).split(":")[0] == "cuda"


def _h(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class _ReplicaError(Exception):
    """A proxied request failed against one replica. ``sent`` is True when
    request bytes reached the replica (re-dispatch is then unsafe for
    non-idempotent routes)."""

    def __init__(self, message: str, *, sent: bool):
        super().__init__(message)
        self.sent = sent


class _Replica:
    """One managed replica subprocess and its routing state."""

    def __init__(self, rid: str):
        self.rid = rid
        self.proc: subprocess.Popen | None = None
        self.port: int | None = None
        self.port_file = ""
        self.log_path = ""
        self.up = False
        self.retired = False  # scaled down: never respawn
        self.failures = 0  # consecutive
        self.in_flight = 0
        self.restarts = 0
        self.checks = 0
        # Deep-obs signals lifted from the replica's /healthz body at each
        # probe: watchdog stall count and straggler-flag totals, so one
        # router /healthz shows which replica is hung or on a slow device.
        self.watchdog_stalls = 0
        self.straggler_flags = 0

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class FleetRouter:
    """Spawn and front N ``serve`` replicas on one asyncio accept loop.

    Args:
      model_path: artifact every replica serves (``--model``).
      replicas: process count (>= 1).
      policy: one of :data:`POLICIES`.
      health_interval_s: probe period; also the re-route bound for a dead
        replica and the Retry-After hint when no replica is up.
      drain_s: SIGTERM drain bound per :meth:`close`; a replica still
        alive after it is SIGKILLed and close() reports failure.
      replica_args: extra serve argv entries (``predict_batch=32``, ...).
      replica_env: env overrides for every replica.
      tenants_dir / model_dir / ingest / wal_root: forwarded serving
        features; ``wal_root`` gives each replica ``wal_root/r<id>`` so a
        respawned replica replays its own WAL.
      device: the replicas' ``--device`` (None: the card; ``"cpu"`` runs
        the plain versions). With ``devices`` set a CUDA replica sees one
        card, so only index 0 may be named.
      devices: pin replica i on the card to ordinal ``i % devices``.
      restart: respawn replicas that exit while the fleet is running.
      tracer: optional ``utils.tracing.Tracer`` (``fleet_route`` /
        ``replica_health`` events).
    """

    def __init__(self, model_path: str, *, replicas: int = 2,
                 policy: str = "least_loaded", health_interval_s: float = 0.5,
                 drain_s: float = 10.0, host: str = "127.0.0.1", port: int = 0,
                 replica_args=(), replica_env: dict | None = None,
                 tenants_dir: str | None = None, model_dir: str | None = None,
                 ingest: bool = False, wal_root: str | None = None,
                 devices: int | None = None, restart: bool = True,
                 startup_timeout_s: float = 180.0, proxy_timeout_s: float = 30.0,
                 run_dir: str | None = None, tracer=None, metrics=None,
                 replica_trace_dir: str | None = None, verbose: bool = False,
                 compile_cache: str | None = "auto", device: str | None = None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas!r}")
        if policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {policy!r}"
            )
        if health_interval_s <= 0.0:
            raise ValueError(
                f"health_interval_s must be > 0, got {health_interval_s!r}"
            )
        if drain_s <= 0.0:
            raise ValueError(f"drain_s must be > 0, got {drain_s!r}")
        if device is not None and devices and _on_card(device) and device not in (
                "cuda", "cuda:0"):
            raise ValueError(
                f"device {device!r} with devices={devices}: a pinned replica "
                "sees one card, cuda:0"
            )
        self.model_path = str(model_path)
        self.n_replicas = int(replicas)
        self.policy = policy
        self.health_interval_s = float(health_interval_s)
        self.drain_s = float(drain_s)
        self.host = host
        self.port = int(port)  # 0 until bound
        self.replica_args = list(replica_args)
        self.replica_env = dict(replica_env or {})
        self.tenants_dir = tenants_dir
        self.model_dir = model_dir
        self.ingest = bool(ingest)
        self.wal_root = wal_root
        self.devices = devices
        self.device = None if device is None else str(device)
        self.restart = bool(restart)
        self.startup_timeout_s = float(startup_timeout_s)
        self.proxy_timeout_s = float(proxy_timeout_s)
        self.run_dir = run_dir or tempfile.mkdtemp(prefix="hdbscan_fleet_")
        self.tracer = tracer
        # Per-replica JSONL traces (``--trace-out``): set a directory to
        # have every replica write replica_<rid>.jsonl there, joinable with
        # this router's ``router_span`` events on the propagated
        # X-Request-Id (``obs/correlate.py``).
        self.replica_trace_dir = replica_trace_dir
        if replica_trace_dir:
            os.makedirs(replica_trace_dir, exist_ok=True)
        # Request ids this router mints when the client didn't send one:
        # pid-qualified so several routers (tests) never collide in a trace.
        self._rids = itertools.count(1)
        self.verbose = bool(verbose)
        # Every replica is given the SAME kernel build directory as
        # ``compile_cache=<dir>`` (resolve_cache_dir honors the knob / the
        # opt-out), so a respawned or scaled-up replica warm-starts: its
        # warmup loads the libraries its siblings already built and
        # reports jit_compiles == 0 (builds) and cache_hits > 0.
        from hdbscan_tpu_torch.utils.cache import resolve_cache_dir

        self.compile_cache_dir = resolve_cache_dir(compile_cache)
        self.replicas = [_Replica(str(i)) for i in range(self.n_replicas)]
        self._rebuild_ring()
        # Rolling window of proxied-request walls — the p99 signal the
        # autoscaler (fleet/controlplane.py) reads alongside queue depth.
        self._lat = deque(maxlen=2048)
        self._scaling = False  # one scale op at a time (loop-serialized)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._server: asyncio.AbstractServer | None = None
        self._ready = threading.Event()
        self._startup_error: BaseException | None = None
        self._shutdown = threading.Event()
        self._closed = False
        self._close_lock = threading.Lock()
        self.drain_ok: bool | None = None
        self._requests = {"/predict": 0, "/ingest": 0, "/swap": 0}

        if metrics is None:
            from hdbscan_tpu_torch.utils.metrics import MetricsRegistry

            metrics = MetricsRegistry()
        self.metrics = metrics
        self._m_requests = metrics.counter(
            "hdbscan_tpu_fleet_requests_total",
            "Requests proxied through the fleet router by outcome.",
            ("replica", "route", "status"),
        )
        self._m_reroutes = metrics.counter(
            "hdbscan_tpu_fleet_reroutes_total",
            "Proxied requests re-dispatched away from a failed replica.",
            ("replica", "route"),
        )
        self._m_up = metrics.gauge(
            "hdbscan_tpu_replica_up",
            "1 when the replica answered its last probe, else 0.",
            ("replica",),
        )
        self._m_checks = metrics.counter(
            "hdbscan_tpu_replica_health_checks_total",
            "Health probes by result.",
            ("replica", "ok"),
        )
        self._m_restarts = metrics.counter(
            "hdbscan_tpu_replica_restarts_total",
            "Replica subprocess respawns after an unexpected exit.",
            ("replica",),
        )
        self._m_in_flight = metrics.gauge(
            "hdbscan_tpu_replica_in_flight",
            "Requests currently proxied to the replica.",
            ("replica",),
        )
        self._m_scale = metrics.counter(
            "hdbscan_tpu_scale_events_total",
            "Fleet scale operations by direction and outcome.",
            ("direction", "ok"),
        )
        self._m_replicas = metrics.gauge(
            "hdbscan_tpu_fleet_replicas",
            "Replicas currently in the routing set.",
        )
        self._m_replicas.set(float(len(self.replicas)))

    # -- replica lifecycle -------------------------------------------------

    def _rebuild_ring(self) -> None:
        """Recompute the consistent-hash ring and rid index from the
        current replica set. Runs on the router's event loop (scale ops)
        or before it exists (__init__), never concurrently with routing."""
        self._ring = sorted(
            (_h(f"{r.rid}#{v}"), r.rid)
            for r in self.replicas for v in range(_VNODES)
        )
        self._ring_keys = [h for h, _ in self._ring]
        self._by_rid = {r.rid: r for r in self.replicas}

    def _replica_cmd(self, r: _Replica) -> list:
        cmd = [
            sys.executable, "-m", "hdbscan_tpu_torch", "serve",
            "--model", self.model_path,
            "--host", "127.0.0.1", "--port", "0",
            "--port-file", r.port_file,
        ]
        if self.device is not None:
            cmd += ["--device", self.device]
        if self.model_dir:
            cmd += ["--model-dir", self.model_dir]
        if self.tenants_dir:
            cmd += ["--tenants-dir", self.tenants_dir]
        if self.ingest:
            cmd.append("--ingest")
        if self.wal_root:
            cmd.append(
                f"wal_dir={os.path.join(self.wal_root, 'r' + r.rid)}"
            )
        if self.replica_trace_dir:
            cmd += [
                "--trace-out",
                os.path.join(self.replica_trace_dir, f"replica_{r.rid}.jsonl"),
            ]
        cmd += self.replica_args
        # The shared build directory; an explicit compile_cache= in the
        # replica args wins, and with the cache off each replica follows
        # its own knob.
        if self.compile_cache_dir and not any(
                str(a).startswith("compile_cache=") for a in self.replica_args):
            cmd.append(f"compile_cache={self.compile_cache_dir}")
        return cmd

    def _replica_environ(self, r: _Replica) -> dict:
        env = dict(os.environ)
        env.update(self.replica_env)
        env["HDBSCAN_TPU_REPLICA_ID"] = r.rid
        if self.devices and _on_card(self.device):
            env["CUDA_VISIBLE_DEVICES"] = str(int(r.rid) % int(self.devices))
        return env

    def _spawn(self, r: _Replica) -> None:
        r.port_file = os.path.join(self.run_dir, f"replica_{r.rid}.port")
        r.log_path = os.path.join(self.run_dir, f"replica_{r.rid}.log")
        if os.path.exists(r.port_file):
            os.unlink(r.port_file)
        r.port = None
        log = open(r.log_path, "ab")
        try:
            r.proc = subprocess.Popen(
                self._replica_cmd(r),
                stdout=log, stderr=log, stdin=subprocess.DEVNULL,
                env=self._replica_environ(r),
                start_new_session=True,  # SIGINT to the router can't nuke replicas mid-drain
            )
        finally:
            log.close()

    def _log_tail(self, r: _Replica, n: int = 2000) -> str:
        try:
            with open(r.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - n))
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    async def _await_port(self, r: _Replica, deadline: float) -> None:
        while True:
            try:
                with open(r.port_file, encoding="utf-8") as f:
                    text = f.read().strip()
                if text:
                    r.port = int(text)
                    return
            except (OSError, ValueError):
                pass
            if not r.alive():
                raise RuntimeError(
                    f"replica {r.rid} exited (rc={r.proc.returncode}) before "
                    f"binding a port; log tail:\n{self._log_tail(r)}"
                )
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"replica {r.rid} did not report a port within "
                    f"{self.startup_timeout_s:.0f}s; log tail:\n{self._log_tail(r)}"
                )
            await asyncio.sleep(0.05)

    async def _respawn(self, r: _Replica) -> None:
        r.restarts += 1
        self._m_restarts.inc(replica=r.rid)
        self._spawn(r)
        await self._await_port(
            r, time.monotonic() + self.startup_timeout_s
        )

    # -- tiny async HTTP ---------------------------------------------------

    async def _replica_request(self, r: _Replica, method: str, path: str,
                               headers: dict, body: bytes, timeout: float):
        """One request/response against a replica over a fresh connection.
        Returns ``(status, headers, body)``; raises :class:`_ReplicaError`."""
        sent_box = [False]

        async def _one():
            reader, writer = await asyncio.open_connection("127.0.0.1", r.port)
            try:
                head = [
                    f"{method} {path} HTTP/1.1",
                    f"Host: 127.0.0.1:{r.port}",
                    f"Content-Length: {len(body)}",
                    "Connection: close",
                ]
                head += [f"{k}: {v}" for k, v in headers.items()]
                writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
                sent_box[0] = True
                await writer.drain()
                status_line = await reader.readline()
                if not status_line:
                    raise ConnectionResetError("empty response")
                parts = status_line.decode("latin1").split(None, 2)
                status = int(parts[1])
                rheaders: dict = {}
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = line.decode("latin1").partition(":")
                    rheaders[k.strip().lower()] = v.strip()
                n = int(rheaders.get("content-length", 0))
                rbody = await reader.readexactly(n) if n else b""
                return status, rheaders, rbody
            finally:
                writer.close()

        try:
            return await asyncio.wait_for(_one(), timeout)
        except (OSError, asyncio.IncompleteReadError, asyncio.TimeoutError,
                TimeoutError, ValueError, IndexError) as exc:
            raise _ReplicaError(
                f"replica {r.rid}: {type(exc).__name__}: {exc}",
                sent=sent_box[0],
            ) from exc

    # -- routing -----------------------------------------------------------

    def _hash_key(self, body: bytes) -> str:
        m = _TENANT_RE.search(body[:4096])
        if m is not None:
            return (m.group(1) or m.group(2)).decode("utf-8", "replace")
        return hashlib.md5(body).hexdigest()

    def _route_order(self, route: str, body: bytes) -> list:
        """Replicas in dispatch-preference order; down replicas go last so
        a request placed while every replica is marked down still probes
        one (it may have just recovered)."""
        if self.policy == "consistent_hash":
            start = bisect.bisect_left(self._ring_keys, _h(self._hash_key(body)))
            order: list = []
            for i in range(len(self._ring)):
                rid = self._ring[(start + i) % len(self._ring)][1]
                r = self._by_rid[rid]
                if r not in order:
                    order.append(r)
                if len(order) == len(self.replicas):
                    break
        else:
            order = sorted(
                self.replicas, key=lambda r: (r.in_flight, r.failures, r.rid)
            )
        return sorted(order, key=lambda r: not r.up)

    def _mark(self, r: _Replica, ok: bool) -> None:
        r.up = ok
        r.failures = 0 if ok else r.failures + 1
        self._m_up.set(1.0 if ok else 0.0, replica=r.rid)

    async def _proxy(self, route: str, headers: dict, body: bytes):
        self._requests[route] = self._requests.get(route, 0) + 1
        # Correlation key: honor a client-supplied X-Request-Id, else mint
        # one. The replica's request_span/request_shed carries the same id
        # (serve/server.py), so the router_span joins it bitwise
        # (obs/correlate.join_spans).
        req_id = headers.get("x-request-id") or f"r{os.getpid()}-{next(self._rids)}"
        fwd = {
            "Content-Type": headers.get("content-type", "application/json"),
            "X-Request-Id": req_id,
        }
        timeout = self.proxy_timeout_s
        if headers.get("x-deadline-ms"):
            fwd["X-Deadline-Ms"] = headers["x-deadline-ms"]
            try:
                timeout = min(timeout, float(headers["x-deadline-ms"]) / 1000.0)
            except ValueError:
                pass
        order = self._route_order(route, body)
        t0 = time.perf_counter()
        attempts = 0
        queue_s = 0.0
        last_rid = order[0].rid if order else "none"
        for r in order:
            if r.port is None:
                continue
            attempts += 1
            last_rid = r.rid
            queue_s = time.perf_counter() - t0
            r.in_flight += 1
            self._m_in_flight.set(r.in_flight, replica=r.rid)
            try:
                status, rheaders, rbody = await self._replica_request(
                    r, "POST", route, fwd, body, timeout
                )
            except _ReplicaError as exc:
                # Connection-refused never reached the replica: always safe
                # to re-dispatch. After bytes were sent, only idempotent
                # /predict (and /swap, a no-op republish) may retry.
                self._mark(r, False)
                self._m_reroutes.inc(replica=r.rid, route=route)
                if exc.sent and route == "/ingest":
                    self._emit_route(
                        route, r.rid, 502, attempts, t0,
                        req_id, queue_s, replied=False,
                    )
                    return 502, {}, _json_body(
                        {"error": f"replica {r.rid} failed mid-ingest: {exc}"}
                    )
                continue
            finally:
                r.in_flight -= 1
                self._m_in_flight.set(r.in_flight, replica=r.rid)
            self._mark(r, True)
            self._emit_route(
                route, r.rid, status, attempts, t0, req_id, queue_s,
                replied=True,
            )
            out_headers = {
                k: v for k, v in rheaders.items() if k not in _HOP_HEADERS
                and k != "content-length"
            }
            out_headers["x-replica"] = r.rid
            out_headers["x-request-id"] = req_id
            return status, out_headers, rbody
        self._emit_route(
            route, last_rid, 503, max(attempts, 1), t0, req_id, queue_s,
            replied=False,
        )
        return 503, {"retry-after": f"{self.health_interval_s:.3f}"}, _json_body(
            {"error": "no replica available", "reason": "fleet_unavailable"}
        )

    def _emit_route(self, route: str, rid: str, status: int, attempts: int,
                    t0: float, req_id: str | None = None,
                    queue_s: float = 0.0, replied: bool = False) -> None:
        wall = time.perf_counter() - t0
        if replied:
            self._lat.append(wall)
        self._m_requests.inc(replica=rid, route=route, status=str(status))
        if self.tracer is not None:
            self.tracer(
                "fleet_route", replica=rid, route=route, policy=self.policy,
                status=int(status), attempts=int(attempts),
                wall_s=round(wall, 9),
            )
            if req_id is not None:
                # router_span: the router's half of the per-request causal
                # chain. ``replied=True`` iff a replica's response was
                # relayed — only those joins a replica-side span
                # (check_trace --join enforces exactly-one).
                self.tracer(
                    "router_span", request_id=req_id, route=route,
                    policy=self.policy, replica=rid, status=int(status),
                    attempts=int(attempts), queue_s=round(queue_s, 9),
                    wall_s=round(wall, 9), replied=bool(replied),
                )

    # -- scaling -----------------------------------------------------------

    def signals(self) -> dict:
        """The autoscaler's inputs, from state the router already tracks:
        total in-flight proxied requests (queue depth), the same per up
        replica, and p50/p99 over the recent replied-request window."""
        replicas = self.replicas
        up = sum(1 for r in replicas if r.up)
        in_flight = sum(r.in_flight for r in replicas)
        lats = sorted(self._lat)
        out = {
            "replicas": len(replicas), "up": up,
            "in_flight": in_flight,
            "in_flight_per_up": in_flight / up if up else float(in_flight),
            "window": len(lats),
        }
        for q, name in ((0.5, "p50_s"), (0.99, "p99_s")):
            if lats:
                rank = max(1, math.ceil(q * len(lats)))
                out[name] = lats[rank - 1]
        return out

    def _free_rid(self) -> str:
        """Lowest non-negative integer rid not in the routing set — a
        scale-up after a scale-down reuses the departed replica's rid and
        therefore its ``wal_root/r<id>`` directory, so acked writes that
        replica WAL'd before draining replay into its successor."""
        used = {int(r.rid) for r in self.replicas if r.rid.isdigit()}
        rid = 0
        while rid in used:
            rid += 1
        return str(rid)

    def _emit_scale(self, direction: str, rid: str, ok: bool, reason: str,
                    t0: float, error: str | None = None) -> None:
        self._m_scale.inc(direction=direction, ok=str(ok).lower())
        self._m_replicas.set(float(len(self.replicas)))
        if self.tracer is not None:
            fields = dict(
                direction=direction, replica=str(rid),
                replicas=len(self.replicas), reason=str(reason),
                ok=bool(ok), wall_s=round(time.perf_counter() - t0, 6),
            )
            if error:
                fields["error"] = str(error)[:300]
            self.tracer("scale_event", **fields)

    async def _scale_up_async(self, reason: str = "manual") -> str | None:
        """Spawn one replica, warm it as a STANDBY (port + healthy probe —
        its bucket warmup has completed before any traffic can route to it),
        then add it to the ring. Returns the new rid, or None on failure
        (the failed standby is killed; the routing set is unchanged)."""
        if self._scaling:
            return None
        self._scaling = True
        t0 = time.perf_counter()
        r = _Replica(self._free_rid())
        try:
            self._spawn(r)
            deadline = time.monotonic() + self.startup_timeout_s
            await self._await_port(r, deadline)
            while not r.up:
                await self._check_one(r)
                if r.up:
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"standby replica {r.rid} not healthy within "
                        f"{self.startup_timeout_s:.0f}s"
                    )
                await asyncio.sleep(0.1)
            self.replicas = self.replicas + [r]
            self._rebuild_ring()
        except Exception as exc:
            if r.proc is not None and r.alive():
                r.proc.kill()
            self._emit_scale("up", r.rid, False, reason, t0, error=str(exc))
            return None
        finally:
            self._scaling = False
        self._emit_scale("up", r.rid, True, reason, t0)
        return r.rid

    async def _scale_down_async(self, rid: str | None = None,
                                reason: str = "manual") -> bool:
        """Remove one replica: out of the ring first (no new dispatch),
        drain its in-flight requests, then the WAL-safe SIGTERM shutdown.
        Defaults to the highest-numbered replica (rid 0 is never chosen
        implicitly, keeping the fleet's anchor stable). Refuses to drop
        the last replica."""
        if self._scaling or len(self.replicas) <= 1:
            return False
        self._scaling = True
        t0 = time.perf_counter()
        try:
            if rid is None:
                r = max(
                    self.replicas,
                    key=lambda x: int(x.rid) if x.rid.isdigit() else -1,
                )
            else:
                r = self._by_rid.get(str(rid))
                if r is None:
                    return False
            r.retired = True
            self.replicas = [x for x in self.replicas if x is not r]
            self._rebuild_ring()
            deadline = time.monotonic() + self.drain_s
            while r.in_flight > 0 and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
            if r.alive():
                r.proc.send_signal(signal.SIGTERM)
            while r.alive() and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
            ok = not r.alive()
            if not ok:
                r.proc.kill()
            self._mark(r, False)
            self._emit_scale("down", r.rid, ok, reason, t0,
                             error=None if ok else "drain timeout; SIGKILLed")
            return ok
        finally:
            self._scaling = False

    def scale_up(self, reason: str = "manual",
                 timeout: float | None = None) -> str | None:
        """Thread-safe scale-up (see :meth:`_scale_up_async`)."""
        if self._loop is None or self._shutdown.is_set():
            return None
        fut = asyncio.run_coroutine_threadsafe(
            self._scale_up_async(reason), self._loop
        )
        return fut.result(timeout or self.startup_timeout_s + 10.0)

    def scale_down(self, rid: str | None = None, reason: str = "manual",
                   timeout: float | None = None) -> bool:
        """Thread-safe scale-down (see :meth:`_scale_down_async`)."""
        if self._loop is None or self._shutdown.is_set():
            return False
        fut = asyncio.run_coroutine_threadsafe(
            self._scale_down_async(rid, reason), self._loop
        )
        return fut.result(timeout or self.drain_s + 10.0)

    # -- health ------------------------------------------------------------

    async def _check_one(self, r: _Replica) -> None:
        probe_timeout = max(0.05, min(2.0, self.health_interval_s))
        ok = False
        if r.port is not None:
            try:
                status, _, body = await self._replica_request(
                    r, "GET", "/healthz", {}, b"", probe_timeout
                )
                ok = status == 200
                if ok:
                    # Lift the replica's deep-obs signals while the body is
                    # in hand: a hung phase (watchdog) or slow device
                    # (straggler) surfaces in the router's own /healthz
                    # without a second probe. Best-effort — the probe's
                    # verdict never depends on the body parsing.
                    try:
                        h = json.loads(body.decode("utf-8"))
                        wd = h.get("watchdog")
                        if isinstance(wd, dict):
                            r.watchdog_stalls = int(wd.get("stalls", 0))
                        sg = h.get("straggler")
                        if isinstance(sg, dict):
                            r.straggler_flags = int(sg.get("flags_total", 0))
                    except (ValueError, TypeError, AttributeError):
                        pass
            except _ReplicaError:
                ok = False
        self._mark(r, ok)
        r.checks += 1
        self._m_checks.inc(replica=r.rid, ok=str(ok).lower())
        if self.tracer is not None:
            self.tracer(
                "replica_health", replica=r.rid, ok=bool(ok),
                failures=int(r.failures), restarts=int(r.restarts),
            )
        if (not ok and not r.alive() and self.restart and not r.retired
                and not self._shutdown.is_set()):
            try:
                await self._respawn(r)
            except RuntimeError:
                pass  # next probe retries; the replica stays down meanwhile

    async def _health_loop(self) -> None:
        while not self._shutdown.is_set():
            await asyncio.gather(
                *(self._check_one(r) for r in self.replicas)
            )
            await asyncio.sleep(self.health_interval_s)

    def health(self) -> dict:
        n_up = sum(1 for r in self.replicas if r.up)
        return {
            "status": "ok" if n_up == len(self.replicas)
            else ("degraded" if n_up else "down"),
            "policy": self.policy,
            "replicas": {
                r.rid: {
                    "up": r.up, "port": r.port,
                    "pid": r.proc.pid if r.proc else None,
                    "failures": r.failures, "in_flight": r.in_flight,
                    "restarts": r.restarts, "checks": r.checks,
                    "watchdog_stalls": r.watchdog_stalls,
                    "straggler_flags": r.straggler_flags,
                }
                for r in self.replicas
            },
            "requests": dict(self._requests),
            "health_interval_s": self.health_interval_s,
            "signals": self.signals(),
        }

    # -- metrics aggregation ----------------------------------------------

    async def _aggregate_metrics(self) -> str:
        from hdbscan_tpu_torch.utils.metrics import (
            MetricsRegistry, registry_from_exposition,
        )

        async def scrape(r: _Replica):
            try:
                status, _, body = await self._replica_request(
                    r, "GET", "/metrics", {}, b"", min(2.0, self.proxy_timeout_s)
                )
                return r.rid, body if status == 200 else None
            except _ReplicaError:
                return r.rid, None

        results = await asyncio.gather(
            *(scrape(r) for r in self.replicas if r.port is not None)
        )
        agg = MetricsRegistry()
        agg.merge(self.metrics)
        for rid, body in results:
            if body is None:
                continue  # down replica: its series drop out of this scrape
            agg.merge(
                registry_from_exposition(
                    body.decode("utf-8", "replace"), {"replica": rid}
                )
            )
        return agg.render()

    # -- front-end ---------------------------------------------------------

    async def _handle_client(self, reader, writer) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                try:
                    method, target, _ = line.decode("latin1").split(None, 2)
                except ValueError:
                    return
                headers: dict = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode("latin1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                n = int(headers.get("content-length", 0) or 0)
                body = await reader.readexactly(n) if n else b""
                status, out_headers, out_body = await self._dispatch(
                    method, target, headers, body
                )
                keep = headers.get("connection", "").lower() != "close"
                head = [
                    f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}",
                    f"Content-Length: {len(out_body)}",
                    f"Connection: {'keep-alive' if keep else 'close'}",
                ]
                if "content-type" not in out_headers:
                    head.append("Content-Type: application/json")
                head += [f"{k}: {v}" for k, v in out_headers.items()]
                writer.write(
                    ("\r\n".join(head) + "\r\n\r\n").encode() + out_body
                )
                await writer.drain()
                if not keep:
                    return
        except (OSError, asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    async def _dispatch(self, method: str, target: str, headers: dict,
                        body: bytes):
        path = target.split("?", 1)[0]
        if method == "GET" and path == "/healthz":
            return 200, {}, _json_body(self.health())
        if method == "GET" and path == "/metrics":
            text = await self._aggregate_metrics()
            return 200, {"content-type": "text/plain; version=0.0.4"}, \
                text.encode()
        if method == "POST" and path in ("/predict", "/ingest"):
            return await self._proxy(path, headers, body)
        if method == "POST" and path == "/swap":
            return await self._broadcast_swap(headers, body)
        return 404, {}, _json_body({"error": f"unknown route {path}"})

    async def _broadcast_swap(self, headers: dict, body: bytes):
        self._requests["/swap"] = self._requests.get("/swap", 0) + 1
        fwd = {"Content-Type": headers.get("content-type", "application/json")}

        async def one(r: _Replica):
            if r.port is None:
                return r.rid, {"error": "not started"}
            try:
                status, _, rbody = await self._replica_request(
                    r, "POST", "/swap", fwd, body, self.proxy_timeout_s
                )
                try:
                    payload = json.loads(rbody.decode() or "{}")
                except ValueError:
                    payload = {}
                return r.rid, {"status": status, **payload}
            except _ReplicaError as exc:
                self._mark(r, False)
                return r.rid, {"error": str(exc)}

        results = dict(await asyncio.gather(*(one(r) for r in self.replicas)))
        ok = all("error" not in v and v.get("status") == 200
                 for v in results.values())
        return (200 if ok else 502), {}, _json_body({"replicas": results})

    # -- lifecycle ---------------------------------------------------------

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        try:
            deadline = time.monotonic() + self.startup_timeout_s
            await asyncio.gather(
                *(self._await_port(r, deadline) for r in self.replicas)
            )
            # First health pass before accepting: a fleet that reports
            # ready has every replica warmed and answering.
            while not all(r.up for r in self.replicas):
                await asyncio.gather(
                    *(self._check_one(r) for r in self.replicas)
                )
                if all(r.up for r in self.replicas):
                    break
                if time.monotonic() > deadline:
                    bad = [r.rid for r in self.replicas if not r.up]
                    raise RuntimeError(
                        f"replicas {bad} not healthy within "
                        f"{self.startup_timeout_s:.0f}s"
                    )
                await asyncio.sleep(0.1)
            self._server = await asyncio.start_server(
                self._handle_client, self.host, self.port or 0
            )
            self.port = self._server.sockets[0].getsockname()[1]
        except BaseException as exc:
            self._startup_error = exc
            self._ready.set()
            return
        self._ready.set()
        health = asyncio.ensure_future(self._health_loop())
        try:
            while not self._shutdown.is_set():
                await asyncio.sleep(0.05)
        finally:
            health.cancel()
            self._server.close()
            await self._server.wait_closed()

    def start(self) -> "FleetRouter":
        """Spawn replicas, wait until every one is healthy, bind the front
        port. Blocking; raises (after killing the spawned replicas) if the
        fleet cannot come up."""
        for r in self.replicas:
            self._spawn(r)
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self._main()),
            name="fleet-router", daemon=True,
        )
        self._thread.start()
        self._ready.wait(self.startup_timeout_s + 10.0)
        if self._startup_error is not None or not self._ready.is_set():
            err = self._startup_error or RuntimeError(
                "fleet router startup timed out"
            )
            self.close()
            raise RuntimeError(f"fleet startup failed: {err}") from err
        if self.verbose:
            print(
                f"fleet: {self.n_replicas} replicas behind "
                f"http://{self.host}:{self.port} (policy={self.policy})",
                file=sys.stderr,
            )
        return self

    def close(self, drain_s: float | None = None) -> bool:
        """SIGTERM every replica and wait for the in-flight drain.

        Each replica's SIGTERM handler runs ``ClusterServer.close()`` —
        resolving every accepted request — before exiting. Returns True
        when all replicas exit within the bound; a hung replica is
        SIGKILLed and the result is False (the CLI turns that into a
        nonzero exit). Idempotent; the first call's verdict sticks
        (``drain_ok``).
        """
        with self._close_lock:
            if self._closed:
                return bool(self.drain_ok) if self.drain_ok is not None else True
            self._closed = True
            self._shutdown.set()
            if self._thread is not None:
                self._thread.join(timeout=10.0)
            bound = self.drain_s if drain_s is None else float(drain_s)
            for r in self.replicas:
                if r.alive():
                    r.proc.send_signal(signal.SIGTERM)
            ok = True
            deadline = time.monotonic() + bound
            for r in self.replicas:
                if r.proc is None:
                    continue
                try:
                    r.proc.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    ok = False
                    r.proc.kill()
                    try:
                        r.proc.wait(timeout=5.0)
                    except subprocess.TimeoutExpired:
                        pass
                self._mark(r, False)
            self.drain_ok = ok
            return ok

    def serve_forever(self) -> int:
        """Block until SIGTERM/SIGINT, then drain. Exit code 0 on a clean
        drain, 1 when a replica hung past the bound."""
        stop = threading.Event()

        def _stop(signum, frame):
            stop.set()

        signal.signal(signal.SIGTERM, _stop)
        signal.signal(signal.SIGINT, _stop)
        try:
            stop.wait()
        finally:
            clean = self.close()
        return 0 if clean else 1

    def __enter__(self) -> "FleetRouter":
        # `with FleetRouter(...) as router:` implies a running fleet —
        # start() is idempotent via _thread so an explicit
        # `FleetRouter(...).start()` composes with `with` too.
        if self._thread is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found", 408: "Request Timeout",
    429: "Too Many Requests", 500: "Internal Server Error",
    502: "Bad Gateway", 503: "Service Unavailable", 504: "Gateway Timeout",
}


def _json_body(obj) -> bytes:
    return json.dumps(obj).encode()

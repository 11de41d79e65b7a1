"""Fit-path deep observability — the port of ``hdbscan_tpu/obs``.

Five layers, all opt-in and process-global (the ``fault`` harness's
install pattern):

- :class:`~hdbscan_tpu_torch.obs.audit.MemoryAuditor` — a per-phase
  device-memory auditor. Instrumented pipeline sites wrap their work in
  :func:`mem_phase`, which samples per-device bytes (the card's caching
  allocator, or the live tensors on the CPU) at entry and exit and on a
  background thread, emits ``mem_sample`` / ``mem_phase_peak`` trace
  events, and accumulates a per-phase watermark table for the run report.
  ``assert_not_replicated(n, itemsize)`` turns "no replicated O(n) buffer
  survives on any single device" into a hard gate over those watermarks.
- :class:`~hdbscan_tpu_torch.obs.heartbeat.Heartbeats` — progress
  heartbeats and a hang watchdog. Long loops (Borůvka rounds, ring panel
  sweeps, rp-forest tree builds, background re-fits) open a :func:`task`
  and ``beat(done, total)`` each iteration; throttled ``heartbeat`` trace
  events carry a monotone progress fraction and ETA, and a watchdog thread
  dumps every Python thread's stack to the trace and stderr when no beat
  arrives within ``watchdog_s``.
- :mod:`~hdbscan_tpu_torch.obs.correlate` — fleet trace correlation: joins
  a router's ``router_span`` events with replica ``request_span`` /
  ``request_shed`` events on the propagated ``X-Request-Id``.
- :class:`~hdbscan_tpu_torch.obs.timeline.TimelineRecorder` — per-device
  phase timelines: every sharded or ring round decomposes into telescoping
  ``compute_s``/``comm_s``/``host_s`` segments (``device_timeline``
  events), and per-round skew feeds the straggler detector
  (``straggler_flag`` events + ``hdbscan_tpu_straggler_flags_total``).
- :class:`~hdbscan_tpu_torch.obs.flightrec.FlightRecorder` — the
  crash/stall black box: a bounded ring of recent trace events that dumps
  a self-contained post-mortem bundle on watchdog stall, replication-gate
  trip, SLO breach, unhandled exception, or SIGTERM.

The uninstalled fast path is one module-attribute load + ``is None`` test
per instrumented site (the contract ``fault/inject.py`` keeps): fit paths
pay nothing unless :func:`install` ran.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext

from hdbscan_tpu_torch.obs.audit import (
    MemoryAuditor,
    ReplicatedBufferError,
    donation_guard,
)
from hdbscan_tpu_torch.obs.correlate import join_spans, merge_fleet_traces
from hdbscan_tpu_torch.obs.flightrec import FlightRecorder
from hdbscan_tpu_torch.obs.heartbeat import Heartbeats
from hdbscan_tpu_torch.obs.timeline import TimelineRecorder

__all__ = [
    "MemoryAuditor",
    "ReplicatedBufferError",
    "donation_guard",
    "Heartbeats",
    "TimelineRecorder",
    "FlightRecorder",
    "join_spans",
    "merge_fleet_traces",
    "install",
    "clear",
    "disarm",
    "auditor",
    "heartbeats",
    "timeline",
    "flight",
    "mem_phase",
    "task",
    "beat",
    "watchdog_state",
    "straggler_state",
    "assert_not_replicated",
]


class _NullTask:
    """No-op stand-in yielded by :func:`task` when heartbeats are off."""

    __slots__ = ()

    def beat(self, done, total=None) -> None:
        pass


_NULL_TASK = _NullTask()

# Process-wide installs checked by every instrumented site. None = off: the
# hot-path cost of the uninstalled layer is one attribute load + is-None.
_AUDITOR: MemoryAuditor | None = None
_HEARTBEATS: Heartbeats | None = None
_TIMELINE: TimelineRecorder | None = None
_FLIGHT: FlightRecorder | None = None
_INSTALL_LOCK = threading.Lock()


def install(auditor=None, heartbeats=None, timeline=None, flight=None) -> None:
    """Install the process-wide auditor / heartbeat hub / timeline recorder
    / flight recorder. Passing None for any layer leaves it as it was
    (install them independently)."""
    global _AUDITOR, _HEARTBEATS, _TIMELINE, _FLIGHT
    with _INSTALL_LOCK:
        if auditor is not None:
            _AUDITOR = auditor
        if heartbeats is not None:
            _HEARTBEATS = heartbeats
        if timeline is not None:
            _TIMELINE = timeline
        if flight is not None:
            _FLIGHT = flight


def clear() -> None:
    """Remove every layer (instrumented sites go back to no-ops)."""
    global _AUDITOR, _HEARTBEATS, _TIMELINE, _FLIGHT
    with _INSTALL_LOCK:
        if _HEARTBEATS is not None:
            _HEARTBEATS.close()
        _AUDITOR = None
        _HEARTBEATS = None
        _TIMELINE = None
        _FLIGHT = None


def disarm(hub: Heartbeats) -> None:
    """Close ``hub`` and uninstall it if it is still the installed heartbeat
    hub (a server releasing the hub it armed); other layers stay."""
    global _HEARTBEATS
    with _INSTALL_LOCK:
        if _HEARTBEATS is hub:
            _HEARTBEATS = None
    hub.close()


def auditor() -> MemoryAuditor | None:
    return _AUDITOR


def heartbeats() -> Heartbeats | None:
    return _HEARTBEATS


def timeline() -> TimelineRecorder | None:
    return _TIMELINE


def flight() -> FlightRecorder | None:
    return _FLIGHT


def mem_phase(name: str):
    """Context manager auditing device memory around a traced phase; a
    ``nullcontext`` when no auditor is installed."""
    aud = _AUDITOR
    if aud is None:
        return nullcontext()
    return aud.phase(name)


def task(phase: str, total=None):
    """Context manager opening a heartbeat task for a progress loop; yields
    an object with ``beat(done, total=None)`` (a no-op when heartbeats are
    off, so call sites never branch)."""
    hb = _HEARTBEATS
    if hb is None:
        return nullcontext(_NULL_TASK)
    return hb.task(phase, total=total)


def beat(phase: str, done, total=None) -> None:
    """One-shot heartbeat outside a :func:`task` scope (rarely needed —
    prefer the task context so the watchdog knows what is in flight)."""
    hb = _HEARTBEATS
    if hb is None:
        return
    with hb.task(phase, total=total) as t:
        t.beat(done, total=total)


def watchdog_state() -> dict | None:
    """The heartbeat hub's live state for ``/healthz``; None when off."""
    hb = _HEARTBEATS
    if hb is None:
        return None
    return hb.state()


def straggler_state() -> dict | None:
    """The timeline recorder's straggler-detector state for ``/healthz``;
    None when no timeline recorder is installed."""
    tl = _TIMELINE
    if tl is None:
        return None
    return tl.state()


def assert_not_replicated(n, itemsize, slack=0.5, phases=None) -> dict:
    """Delegate to the installed auditor's replication gate. Raises
    :class:`RuntimeError` when no auditor is installed — a gate that was
    requested but never armed must fail loudly, not pass vacuously."""
    aud = _AUDITOR
    if aud is None:
        raise RuntimeError(
            "assert_not_replicated: no MemoryAuditor installed "
            "(obs.install(auditor=...) before the fit)"
        )
    return aud.assert_not_replicated(n, itemsize, slack=slack, phases=phases)


@contextmanager
def installed(auditor=None, heartbeats=None, timeline=None, flight=None):
    """Scoped install for tests: install, yield, restore previous layers."""
    global _AUDITOR, _HEARTBEATS, _TIMELINE, _FLIGHT
    with _INSTALL_LOCK:
        prev = (_AUDITOR, _HEARTBEATS, _TIMELINE, _FLIGHT)
        if auditor is not None:
            _AUDITOR = auditor
        if heartbeats is not None:
            _HEARTBEATS = heartbeats
        if timeline is not None:
            _TIMELINE = timeline
        if flight is not None:
            _FLIGHT = flight
    try:
        yield
    finally:
        with _INSTALL_LOCK:
            if heartbeats is not None and heartbeats is not prev[1]:
                heartbeats.close()
            _AUDITOR, _HEARTBEATS, _TIMELINE, _FLIGHT = prev

"""Crash/stall flight recorder: a bounded black box that survives the run —
a host-only copy of ``hdbscan_tpu/obs/flightrec.py``, with the dump
reasons and the bundle schema unchanged.

When the watchdog fires or a bench leg regresses, the evidence usually
evaporates with the process. The :class:`FlightRecorder` is an always-on
bounded ring of the most recent trace events (it attaches to the run's
:class:`~hdbscan_tpu_torch.utils.tracing.Tracer` as one more sink, so it costs
one deque append per event) plus the last N heartbeats, and on a trigger
dumps one self-contained post-mortem bundle to ``--flight-dir``:

- the event tail (the stalling phase's last events included),
- the last N ``heartbeat`` events,
- every Python thread's stack at dump time,
- the installed auditor's per-phase watermarks + per-device peaks,
- the heartbeat hub's watchdog state and the timeline recorder's
  straggler state,
- the run manifest (when the CLI provided one) and the trigger's extra
  context.

Triggers: ``watchdog_stall`` (automatic — the recorder sniffs the event
stream), ``ReplicatedBufferError`` / unhandled fit exception / SIGTERM
(``cli.py`` calls :meth:`FlightRecorder.dump`), and SLO breach (a
caller's ``dump("slo_breach")``; the reference's SLO bench has no port
yet). ``scripts/check_flight.py`` validates and pretty-prints bundles.

Schema ``hdbscan-tpu-flight/1``; one JSON file per dump, named
``flight-<pid>-<seq>-<reason>.json``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

__all__ = [
    "FLIGHT_SCHEMA",
    "DUMP_REASONS",
    "FlightRecorder",
]

#: Version tag carried by every bundle; ``scripts/check_flight.py``
#: validates the prefix.
FLIGHT_SCHEMA = "hdbscan-tpu-flight/1"

#: The trigger vocabulary. ``check_flight.py`` rejects unknown reasons so
#: a typo'd ad-hoc dump can't slip into a post-mortem unnoticed.
DUMP_REASONS = (
    "watchdog_stall",
    "replication_gate",
    "slo_breach",
    "exception",
    "sigterm",
    "manual",
)


class FlightRecorder:
    """Bounded trace-event ring + post-mortem bundle writer.

    Parameters
    ----------
    out_dir:
        Directory bundles dump into (created on first need, not at
        construction — an armed recorder on a healthy run leaves no
        filesystem trace).
    capacity:
        Ring size: the newest ``capacity`` events are retained. >= 16.
    heartbeat_tail:
        ``heartbeat`` events kept in their own tail (they drown in a
        busy ring otherwise). >= 1.
    manifest:
        Optional run-manifest dict embedded in every bundle.
    tracer:
        Optional ``Tracer``; explicit :meth:`dump` calls emit a
        ``flight_dump`` event through it. The automatic watchdog dump
        never re-enters the tracer (it runs inside the tracer's emit
        lock), so it records the dump in the bundle alone.
    """

    def __init__(self, out_dir: str, capacity: int = 2048,
                 heartbeat_tail: int = 32, manifest: dict | None = None,
                 tracer=None):
        capacity = int(capacity)
        if capacity < 16:
            raise ValueError(f"capacity must be >= 16, got {capacity!r}")
        heartbeat_tail = int(heartbeat_tail)
        if heartbeat_tail < 1:
            raise ValueError(
                f"heartbeat_tail must be >= 1, got {heartbeat_tail!r}"
            )
        self.out_dir = str(out_dir)
        self.capacity = capacity
        self.manifest = manifest
        self.tracer = tracer
        self._events: deque = deque(maxlen=capacity)
        self._heartbeats: deque = deque(maxlen=heartbeat_tail)
        self._seen = 0
        self._lock = threading.Lock()
        self.dumps: list[str] = []

    # -- Tracer sink protocol ----------------------------------------------

    def emit(self, ev) -> None:
        from hdbscan_tpu_torch.utils.telemetry import json_sanitize

        rec = {
            "stage": ev.name,
            "wall_s": float(ev.wall_s),
            **json_sanitize(ev.fields),
        }
        with self._lock:
            self._seen += 1
            self._events.append(rec)
            if ev.name == "heartbeat":
                self._heartbeats.append(rec)
        if ev.name == "watchdog_stall":
            # Sink emits run inside the tracer's emit lock: write the
            # bundle but do NOT re-enter the tracer (deadlock).
            self.dump("watchdog_stall", extra={"stall": rec},
                      emit_event=False)

    def close(self) -> None:  # sinks own no file handle between dumps
        pass

    # -- dumping -----------------------------------------------------------

    def snapshot(self) -> dict:
        """The ring's current contents (tests and /healthz peeks)."""
        with self._lock:
            return {
                "events": list(self._events),
                "heartbeats": list(self._heartbeats),
                "events_seen": self._seen,
                "dumps": list(self.dumps),
            }

    def dump(self, reason: str, extra: dict | None = None,
             emit_event: bool = True) -> str:
        """Write one self-contained post-mortem bundle; returns its path.

        Never raises on best-effort sections (auditor/watchdog/timeline
        state): a flight recorder that crashes the crash path is worse
        than a partial bundle.
        """
        from hdbscan_tpu_torch import obs
        from hdbscan_tpu_torch.obs.heartbeat import _format_stacks
        from hdbscan_tpu_torch.utils.telemetry import json_sanitize

        if reason not in DUMP_REASONS:
            raise ValueError(
                f"reason must be one of {DUMP_REASONS}, got {reason!r}"
            )
        with self._lock:
            seq = len(self.dumps)
            events = list(self._events)
            heartbeats = list(self._heartbeats)
            seen = self._seen
        bundle: dict = {
            "schema": FLIGHT_SCHEMA,
            "reason": reason,
            "pid": os.getpid(),
            "created_unix": time.time(),
            "events_seen": seen,
            "events": events,
            "heartbeats": heartbeats,
            "stacks": _format_stacks(),
        }
        try:
            wd = obs.watchdog_state()
            if wd is not None:
                bundle["watchdog"] = wd
            tl = obs.timeline()
            if tl is not None:
                bundle["straggler"] = tl.state()
            aud = obs.auditor()
            if aud is not None:
                bundle["watermarks"] = aud.watermark_table()
                bundle["device_peaks"] = aud.device_peaks()
        except Exception as exc:  # best-effort: record, don't crash
            bundle["state_error"] = repr(exc)
        if self.manifest is not None:
            bundle["manifest"] = self.manifest
        if extra:
            bundle["extra"] = extra
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(
            self.out_dir, f"flight-{os.getpid()}-{seq:03d}-{reason}.json"
        )
        with open(path, "w", encoding="utf-8") as f:
            json.dump(json_sanitize(bundle), f, indent=2)
            f.write("\n")
        with self._lock:
            self.dumps.append(path)
        if emit_event and self.tracer is not None:
            self.tracer(
                "flight_dump", reason=reason, path=path, events=len(events)
            )
        return path

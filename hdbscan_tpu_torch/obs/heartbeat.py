"""Progress heartbeats and the hang watchdog — a host-only copy of
``hdbscan_tpu/obs/heartbeat.py``.

A long fit phase (Borůvka rounds, ring panel sweeps, rp-forest tree
builds, background re-fits) is indistinguishable from a hang without a
liveness signal. Instrumented loops open ``obs.task(phase, total=N)`` and
call ``beat(done)`` each iteration:

- the task emits an unthrottled ``heartbeat`` at entry (progress 0.0) and
  exit (progress 1.0), and throttled ones in between (at most one per
  ``heartbeat_s``), each carrying a *monotone* progress fraction in [0,1]
  and an ETA extrapolated from elapsed wall time;
- every ``beat`` — emitted or throttled — refreshes the hub's liveness
  clock. A daemon watchdog thread (armed when ``watchdog_s > 0``) fires
  when tasks are active but no beat has arrived within ``watchdog_s``:
  it dumps every Python thread's stack to stderr, emits a
  ``watchdog_stall`` trace event with the (truncated) stacks, and bumps
  the ``hdbscan_tpu_watchdog_stalls_total`` counter. The hub's
  :meth:`Heartbeats.state` is surfaced in the server's ``/healthz``.

Both knobs come from ``HDBSCANParams`` (``heartbeat_s`` / ``watchdog_s``)
and are eagerly validated here as well, since the hub is also built
directly by serving code. Tests stall a phase deterministically through
the existing fault harness: ``beat`` fires the ``phase_stall`` injection
site *before* refreshing the liveness clock, so an injected delay is
exactly what the watchdog sees.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
import traceback

from hdbscan_tpu_torch.fault import inject

_STACK_DUMP_LIMIT = 4000  # chars of stack text carried in the trace event


def _format_stacks() -> str:
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for ident, frame in frames.items():
        name = names.get(ident, "?")
        parts.append(f"--- thread {name} ({ident}) ---")
        parts.append("".join(traceback.format_stack(frame)))
    return "\n".join(parts)


class _Task:
    """Handle yielded by :meth:`Heartbeats.task`; not built directly."""

    def __init__(self, hub: "Heartbeats", task_id: int, phase: str, total):
        self._hub = hub
        self.task_id = task_id
        self.phase = phase
        self.total = total
        self._t0 = time.monotonic()
        self._progress = 0.0
        self._last_emit = 0.0

    def beat(self, done, total=None) -> None:
        """Record one unit of progress; may emit a throttled heartbeat."""
        spec = inject.maybe_fire("phase_stall")
        if spec is not None and spec.delay_s > 0:
            # The stall happens BEFORE the liveness clock refresh, so the
            # watchdog observes exactly the injected delay.
            time.sleep(spec.delay_s)
        hub = self._hub
        now = time.monotonic()
        hub._last_beat = now
        if total is not None:
            self.total = total
        if self.total:
            frac = min(max(float(done) / float(self.total), 0.0), 1.0)
            self._progress = max(self._progress, frac)
        if now - self._last_emit >= hub.heartbeat_s:
            self._emit(done, now, final=False)

    def _emit(self, done, now: float, final: bool) -> None:
        self._last_emit = now
        if final:
            self._progress = 1.0
        p = self._progress
        fields = {
            "phase": self.phase,
            "task": self.task_id,
            "progress": round(p, 6),
            "done": int(done) if done is not None else None,
        }
        if fields["done"] is None:
            del fields["done"]
        if self.total is not None:
            fields["total"] = int(self.total)
        elapsed = now - self._t0
        if 0.0 < p <= 1.0:
            fields["eta_s"] = round(elapsed * (1.0 - p) / p, 9)
        tracer = self._hub.tracer
        if tracer is not None:
            tracer("heartbeat", **fields)


class Heartbeats:
    """Hub owning the liveness clock, heartbeat throttle, and watchdog.

    Parameters
    ----------
    tracer:
        Optional ``Tracer`` receiving ``heartbeat`` / ``watchdog_stall``
        events.
    heartbeat_s:
        Minimum spacing between emitted heartbeats per task (> 0).
    watchdog_s:
        Stall budget: with active tasks and no beat for this long, the
        watchdog dumps stacks. 0 disables the watchdog thread entirely.
    stall_counter:
        Optional metrics counter (``.inc()``) bumped once per stall dump.
    """

    def __init__(self, tracer=None, heartbeat_s: float = 1.0,
                 watchdog_s: float = 0.0, stall_counter=None):
        if not heartbeat_s > 0:
            raise ValueError(f"heartbeat_s must be > 0, got {heartbeat_s!r}")
        if watchdog_s < 0:
            raise ValueError(f"watchdog_s must be >= 0, got {watchdog_s!r}")
        self.tracer = tracer
        self.heartbeat_s = float(heartbeat_s)
        self.watchdog_s = float(watchdog_s)
        self._stall_counter = stall_counter
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._active: dict[int, str] = {}
        self._last_beat = time.monotonic()
        self.stalls = 0
        self._stop = threading.Event()
        self._watchdog_thread = None
        if self.watchdog_s > 0:
            self._watchdog_thread = threading.Thread(
                target=self._watch, name="obs-watchdog", daemon=True
            )
            self._watchdog_thread.start()

    # -- tasks -------------------------------------------------------------

    def task(self, phase: str, total=None):
        return _TaskScope(self, phase, total)

    # -- watchdog ----------------------------------------------------------

    def _watch(self) -> None:
        tick = max(0.01, min(self.watchdog_s / 4.0, 1.0))
        while not self._stop.wait(tick):
            with self._lock:
                phases = sorted(set(self._active.values()))
            if not phases:
                continue
            stalled = time.monotonic() - self._last_beat
            if stalled <= self.watchdog_s:
                continue
            stacks = _format_stacks()
            sys.stderr.write(
                f"[obs-watchdog] no heartbeat for {stalled:.3f}s "
                f"(budget {self.watchdog_s}s); active phases: "
                f"{', '.join(phases)}\n{stacks}\n"
            )
            sys.stderr.flush()
            self.stalls += 1
            if self._stall_counter is not None:
                try:
                    self._stall_counter.inc()
                except Exception:
                    pass
            if self.tracer is not None:
                self.tracer(
                    "watchdog_stall",
                    phases=phases,
                    stalled_s=round(stalled, 9),
                    threads=threading.active_count(),
                    stacks=stacks[:_STACK_DUMP_LIMIT],
                )
            # One dump per stall: reset the clock so a still-stalled phase
            # produces the next dump only after another full budget.
            self._last_beat = time.monotonic()

    def state(self) -> dict:
        """Live snapshot for ``/healthz``."""
        with self._lock:
            active = sorted(set(self._active.values()))
        return {
            "heartbeat_s": self.heartbeat_s,
            "watchdog_s": self.watchdog_s,
            "active_tasks": active,
            "last_beat_age_s": round(time.monotonic() - self._last_beat, 6),
            "stalls": self.stalls,
        }

    def close(self) -> None:
        self._stop.set()
        t = self._watchdog_thread
        if t is not None:
            t.join(timeout=5.0)
            self._watchdog_thread = None


class _TaskScope:
    def __init__(self, hub: Heartbeats, phase: str, total):
        self._hub = hub
        self._phase = phase
        self._total = total
        self._task = None

    def __enter__(self) -> _Task:
        hub = self._hub
        task = _Task(hub, next(hub._ids), self._phase, self._total)
        with hub._lock:
            hub._active[task.task_id] = self._phase
            hub._last_beat = time.monotonic()
        task._emit(0, time.monotonic(), final=False)
        self._task = task
        return task

    def __exit__(self, exc_type, exc, tb) -> None:
        hub = self._hub
        task = self._task
        with hub._lock:
            hub._active.pop(task.task_id, None)
            hub._last_beat = time.monotonic()
        if exc_type is None:
            task._emit(task.total, time.monotonic(), final=True)

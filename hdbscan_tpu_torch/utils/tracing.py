"""Structured per-stage tracing — the port of ``hdbscan_tpu/utils/tracing.py``.

Every pipeline stage can emit a structured event (name, wall seconds,
counters) through a :class:`Tracer`, which streams to pluggable sinks:
logfmt lines on a text stream for live progress, or schema-versioned JSON
lines on disk (:class:`JsonlSink`) — the same ``hdbscan-tpu-trace/1`` lines
the reference writes, so ``scripts/check_trace.py`` validates the port's
files unchanged.

A :class:`Tracer` goes anywhere the port takes a ``trace`` hook
(``models.exact.fit``, ``models.mr_hdbscan.fit``, ``models.hdbscan.fit``).
Counter deltas (``Tracer(counters=...)``: the kernel builds and build
directory hits of ``utils/telemetry``) ride the phase events, and the
observability layer (``hdbscan_tpu_torch/obs``) emits through the same
Tracer: ``mem_sample``/``mem_phase_peak`` from the memory auditor,
``heartbeat``/``watchdog_stall`` from the progress hub,
``device_timeline``/``straggler_flag`` from the timeline recorder, and the
flight recorder attaches as one more sink (:meth:`Tracer.add_sink`).
:func:`xla_profile` (the reference's name) captures a ``torch.profiler``
trace of the host and the card.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

#: Version tag carried by every JSONL trace line (the reference's); bump
#: the integer suffix on any backwards-incompatible line-shape change.
TRACE_SCHEMA = "hdbscan-tpu-trace/1"


@dataclass
class TraceEvent:
    name: str
    wall_s: float  # 0.0 for instant events
    fields: dict = field(default_factory=dict)

    def format(self) -> str:
        parts = [f"stage={self.name}", f"wall_s={self.wall_s:.3f}"]
        parts += [f"{k}={v}" for k, v in self.fields.items()]
        return " ".join(parts)


class LogfmtSink:
    """Prints events as logfmt lines on a text stream (live progress)."""

    def __init__(self, stream):
        self._stream = stream

    def emit(self, ev: TraceEvent) -> None:
        print(ev.format(), file=self._stream, flush=True)

    def close(self) -> None:  # the stream is owned by the caller
        pass


class JsonlSink:
    """Appends schema-versioned JSON event lines to a file.

    Each line is a self-describing dict ``{"schema": TRACE_SCHEMA, "seq": i,
    "stage": name, "wall_s": float, ...fields}`` plus any ``static`` fields
    given at construction. Values are sanitized to plain JSON types
    (``utils/telemetry.json_sanitize``: numpy and torch scalars appear in
    trace fields). Lines flush as they happen so a killed run keeps its
    partial trace.

    ``rotate_bytes`` (config knob ``trace_rotate_bytes``, 0 = off) bounds
    the file: when the next line would push the file past the bound, the
    current file moves to ``<path>.1`` (replacing any previous rotation)
    and a fresh ``<path>`` opens. ``seq`` continues across the boundary.
    """

    def __init__(self, path: str, static: dict | None = None,
                 rotate_bytes: int = 0):
        rotate_bytes = int(rotate_bytes)
        if rotate_bytes < 0:
            raise ValueError(
                f"rotate_bytes must be >= 0 (0 = off), got {rotate_bytes!r}"
            )
        self.path = path
        self.rotate_bytes = rotate_bytes
        self.rotations = 0
        self._static = dict(static or {})
        self._seq = 0
        self._bytes = 0
        self._f = open(path, "w", encoding="utf-8")

    def emit(self, ev: TraceEvent) -> None:
        from hdbscan_tpu_torch.utils.telemetry import json_sanitize

        rec = {
            "schema": TRACE_SCHEMA,
            "seq": self._seq,
            **self._static,
            "stage": ev.name,
            "wall_s": float(ev.wall_s),
            **json_sanitize(ev.fields),
        }
        self._seq += 1
        line = json.dumps(rec) + "\n"  # ensure_ascii: len == byte length
        if (
            self.rotate_bytes
            and self._bytes
            and self._bytes + len(line) > self.rotate_bytes
        ):
            self._rotate()
        self._f.write(line)
        self._f.flush()
        self._bytes += len(line)

    def _rotate(self) -> None:
        """Move the full file to ``<path>.1`` and start a fresh one; ``seq``
        keeps counting."""
        self._f.close()
        os.replace(self.path, self.path + ".1")
        self._f = open(self.path, "w", encoding="utf-8")
        self._bytes = 0
        self.rotations += 1

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class Tracer:
    """Collects :class:`TraceEvent` records; optionally streams them to sinks.

    Calling it records an instant event (an explicit ``wall_s`` field
    becomes the event's wall); ``stage()`` wraps a timed block.

    Args:
      stream: file-like; events print as logfmt lines as they happen
        (``sys.stderr`` for live progress). None = collect only.
      sinks: sink objects (``emit(event)`` / ``close()``), e.g.
        :class:`JsonlSink`.
      counters: ``{field_name: zero-arg callable -> number}``; at every emit
        the delta since the previous emit is attached as an event field
        when nonzero. Phase events are emitted at the end of their phase,
        so the kernel builds a phase paid land on its own event
        (``utils/telemetry.compile_counter``).
      max_events: bound on the in-memory ``events`` list (None or 0 =
        unbounded). Past it the oldest events drop in chunks
        (``events_dropped`` counts them); sinks still get every event.
    """

    def __init__(self, stream=None, sinks=None, counters=None, max_events=None):
        # One lock keeps the counter deltas, the in-memory event order and
        # the sink write order (JsonlSink's seq) consistent across threads.
        self._emit_lock = threading.Lock()
        self.events: list[TraceEvent] = []
        self.max_events = int(max_events) if max_events else None
        if self.max_events is not None and self.max_events < 1:
            raise ValueError(f"max_events must be >= 1 (or 0/None), got {max_events!r}")
        self.events_dropped = 0
        self._sinks = list(sinks or [])
        if stream is not None:
            self._sinks.append(LogfmtSink(stream))
        self._counters = dict(counters or {})
        self._counter_last = {k: fn() for k, fn in self._counters.items()}

    def add_sink(self, sink) -> None:
        self._sinks.append(sink)

    def close(self) -> None:
        """Close all sinks (flushes JSONL files). Idempotent."""
        for s in self._sinks:
            s.close()

    def __call__(self, name: str, /, **fields) -> None:
        # ``name`` is positional-only so an event field called ``name``
        # cannot collide with the stage parameter.
        wall = fields.pop("wall_s", 0.0)
        self._emit(TraceEvent(name, float(wall), fields))

    @contextmanager
    def stage(self, name: str, /, **fields):
        t0 = time.monotonic()
        try:
            yield self
        finally:
            self._emit(TraceEvent(name, time.monotonic() - t0, fields))

    def _emit(self, ev: TraceEvent) -> None:
        with self._emit_lock:
            for key, fn in self._counters.items():
                cur = fn()
                delta = cur - self._counter_last[key]
                self._counter_last[key] = cur
                if delta:
                    ev.fields[key] = delta
            self.events.append(ev)
            if self.max_events is not None and len(self.events) > self.max_events:
                # Trim the oldest ~1/8 of the window in one slice so the
                # deletion cost amortizes to O(1) per emit.
                drop = len(self.events) - self.max_events + max(1, self.max_events // 8)
                drop = min(drop, len(self.events) - 1)
                del self.events[:drop]
                self.events_dropped += drop
            for s in self._sinks:
                s.emit(ev)

    def total(self, name: str) -> float:
        """Summed wall seconds of all events with this stage name."""
        return sum(e.wall_s for e in self.events if e.name == name)

    def walls(self, name: str) -> list[float]:
        """Per-event wall seconds of every event with this stage name, in
        emission order."""
        return [e.wall_s for e in self.events if e.name == name]

    def summary(self) -> str:
        """One line per distinct stage — count and summed wall — sorted by
        summed wall descending."""
        agg: dict[str, list] = {}
        for e in self.events:
            agg.setdefault(e.name, [0, 0.0])
            agg[e.name][0] += 1
            agg[e.name][1] += e.wall_s
        rows = sorted(agg.items(), key=lambda kv: -kv[1][1])
        lines = [f"{name}: n={n} wall_s={w:.3f}" for name, (n, w) in rows]
        if self.events_dropped:
            lines.append(
                f"(ring buffer: {self.events_dropped} oldest events dropped, "
                f"max_events={self.max_events}; totals cover the retained window)"
            )
        return "\n".join(lines)


def stderr_tracer() -> Tracer:
    """Tracer that live-streams logfmt lines to stderr."""
    return Tracer(stream=sys.stderr)


@contextmanager
def xla_profile(logdir: str):
    """Capture a ``torch.profiler`` trace of a block — the reference's
    ``jax.profiler`` capture, under its name so a reader finds the
    counterpart. Records the host's and (where a card is present) the
    card's activity and writes one Chrome trace file under ``logdir``
    (``chrome://tracing`` or Perfetto open it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace.{os.getpid()}.json"))

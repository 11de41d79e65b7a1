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

Spans. :func:`span` times a block inside the program on
``time.perf_counter_ns()`` and hands it, as a :class:`TraceEvent` carrying
:data:`SPAN_KEYS` among its fields, to every tracer put in place with
:func:`install` (process-wide, from any thread: ``torch.profiler`` records
``record_function`` only on the thread that started the profile) and to
the site's ``trace`` hook, if it has one, under the hook's stage name. Each
span knows its parent (the span open on the same thread, through
``contextvars``) and its root (one id a fit or a request). With
``device=`` a card, a pair of CUDA events (pooled) on the current stream
brackets the span; their elapsed time lands on it as ``device_ms`` once
both have completed, which they have where the program already waits on
the card (a span held until then is emitted by the next span to end). It
adds no synchronise. ``device_ms`` is the stream's time between the
markers: it counts the stream waiting for the host's launches too, so it
is the kernels' time only where the host launches ahead of the card; the
kernels' own time under a span comes from a profile of the card (the
span's stamps put on its clock with :meth:`Tracer.profile_us`). With
nothing installed and no hook, :func:`span` is one module-attribute load
and an ``is None`` test: no clock, no id, no event. :func:`xla_profile`
merges the installed tracers' spans into the Chrome trace it writes.
"""

from __future__ import annotations

import contextvars
import itertools
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


#: The fields a span adds to its event: its id, its parent's (None at a
#: root) and its root's, the thread's name and native id, its start and end
#: on ``time.perf_counter_ns()``, ``device_ms`` where it was device-timed on
#: a card, and ``span`` (true) on the event an installed tracer gets, which
#: is not a stage of the site's ``trace`` hook: a report's phase table
#: leaves such events out (:func:`is_span_only`). A JSONL line carries them
#: as added fields.
SPAN_KEYS = ("span_id", "parent_id", "root_id", "thread", "tid", "t0_ns", "t1_ns", "device_ms",
             "span")


def is_span_only(fields: dict) -> bool:
    """Whether an event's fields (or a JSONL line) are a span's alone, not
    a stage some ``trace`` hook emitted: phase tables leave it out."""
    return fields.get("span") is True


@dataclass
class TraceEvent:
    """One event: a stage's name, its wall seconds and its fields; a span's
    event (:func:`span`) also carries :data:`SPAN_KEYS` in its fields."""

    name: str
    wall_s: float  # 0.0 for instant events
    fields: dict = field(default_factory=dict)

    @property
    def is_span(self) -> bool:
        return "t0_ns" in self.fields

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
      ring_spans: False keeps span-only events (:func:`is_span_only`) out
        of ``events``, so they cannot evict the stage events a report
        reads; sinks still get them.
    """

    def __init__(self, stream=None, sinks=None, counters=None, max_events=None,
                 ring_spans=True):
        # One lock keeps the counter deltas, the in-memory event order and
        # the sink write order (JsonlSink's seq) consistent across threads.
        self._emit_lock = threading.Lock()
        self.events: list[TraceEvent] = []
        self.max_events = int(max_events) if max_events else None
        if self.max_events is not None and self.max_events < 1:
            raise ValueError(f"max_events must be >= 1 (or 0/None), got {max_events!r}")
        self.events_dropped = 0
        self.ring_spans = bool(ring_spans)
        self._sinks = list(sinks or [])
        if stream is not None:
            self._sinks.append(LogfmtSink(stream))
        self._counters = dict(counters or {})
        self._counter_last = {k: fn() for k, fn in self._counters.items()}
        # The two clocks read together: (perf_counter_ns, time_ns). Span
        # stamps are perf_counter_ns; the profiler keeps the Unix clock.
        self.anchor = (time.perf_counter_ns(), time.time_ns())

    def unix_ns(self, perf_ns: int) -> int:
        """A ``time.perf_counter_ns()`` stamp on the Unix clock."""
        return self.anchor[1] + (perf_ns - self.anchor[0])

    def profile_us(self, perf_ns: int, trace_start_ns: int) -> float:
        """A ``time.perf_counter_ns()`` stamp in a ``torch.profiler``
        profile's time base: microseconds after ``trace_start_ns``, which is
        ``prof.profiler.kineto_results.trace_start_ns()`` (the profile's
        start on the Unix clock), the base of its events' ``time_range``."""
        return (self.unix_ns(perf_ns) - trace_start_ns) / 1e3

    def spans(self, name: str | None = None) -> list[TraceEvent]:
        """The span events kept in :attr:`events` (of stage ``name``)."""
        return [e for e in self.events if e.is_span and (name is None or e.name == name)]

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
            if self.ring_spans or not is_span_only(ev.fields):
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


# -- spans ------------------------------------------------------------------

#: The innermost open span of the running thread (each thread starts with
#: its own empty context, so with its own stack).
_CURRENT: contextvars.ContextVar = contextvars.ContextVar("hdbscan_tpu_torch_span",
                                                          default=None)
_IDS = itertools.count(1)
_HANDLES: list = []
#: The distinct installed tracers, or None: the one test every span site makes.
_INSTALLED: tuple | None = None
#: Whether an installed tracer asked for ``device_ms`` (``install(device=)``).
_DEVICE = False
_INSTALL_LOCK = threading.Lock()
#: Device-timed spans that ended before their end marker completed.
_PENDING: list = []
_PENDING_LOCK = threading.Lock()


class Installed:
    """The handle :func:`install` returns: ``remove()``, or leaving it as a
    context manager, takes that install out again."""

    def __init__(self, tracer: Tracer, device: bool):
        self.tracer, self.device = tracer, device

    def remove(self) -> None:
        with _INSTALL_LOCK:
            if self in _HANDLES:
                _HANDLES.remove(self)
            _publish()

    def __enter__(self) -> Tracer:
        return self.tracer

    def __exit__(self, *exc) -> None:
        self.remove()


def _publish() -> None:
    global _INSTALLED, _DEVICE
    _DEVICE = any(h.device for h in _HANDLES)
    _INSTALLED = tuple({id(h.tracer): h.tracer for h in _HANDLES}.values()) or None


def install(tracer: Tracer, *, device: bool = True) -> Installed:
    """Hand every span opened from now on, on any thread, to ``tracer``,
    until the install is removed (a span still open then is not handed).
    Installs nest: each installed tracer gets each span once. ``device``
    False: this tracer does not want ``device_ms`` (it reads the card's
    time from a profile), so its install alone records no CUDA event."""
    handle = Installed(tracer, device)
    with _INSTALL_LOCK:
        _HANDLES.append(handle)
        _publish()
    return handle


#: Each thread's (name, native id), read once a thread.
_THREAD = threading.local()
#: Timing CUDA events whose readings were taken, by device index, for reuse.
_EVENTS: dict = {}


def _thread_info() -> tuple:
    info = getattr(_THREAD, "info", None)
    if info is None:
        th = threading.current_thread()
        info = _THREAD.info = (th.name, th.native_id)
    return info


def _event(stream):
    """A timing CUDA event recorded on ``stream``, from the pool if it has
    one for the stream's card."""
    try:
        ev = _EVENTS[stream.device_index].pop()
    except (KeyError, IndexError):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class Span:
    """An open span (:func:`span`, :func:`begin`). ``set(**fields)`` adds
    fields; ``device_stop()`` records the end marker on the card before the
    program's own wait there (else the span's end records it);
    ``elapsed_s()`` reads the wall so far; ``end()`` closes a span that
    was not entered."""

    __slots__ = ("name", "fields", "span_id", "parent_id", "root_id", "thread",
                 "t0_ns", "t1_ns", "_tracers", "_hook", "_stage", "_stream", "_ev0", "_ev1",
                 "_token")

    def __init__(self, name, tracers, hook, stage, device, span_id, fields, parent):
        self.name, self.fields = name, fields
        self._tracers, self._hook, self._stage = tracers, hook, stage
        self.span_id = next(_IDS) if span_id is None else span_id
        self.parent_id = None if parent is None else parent.span_id
        self.root_id = self.span_id if parent is None else parent.root_id
        self.thread = _thread_info()
        self.t1_ns = self._token = self._ev1 = self._stream = self._ev0 = None
        self.t0_ns = time.perf_counter_ns()
        if getattr(device, "type", None) == "cuda":
            import torch

            self._stream = torch.cuda.current_stream(device)
            self._ev0 = _event(self._stream)

    def __enter__(self) -> "Span":
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, *exc) -> bool:
        _CURRENT.reset(self._token)
        self.end()
        return False

    def set(self, **fields) -> None:
        self.fields.update(fields)

    def elapsed_s(self) -> float:
        return (time.perf_counter_ns() - self.t0_ns) / 1e9

    def device_stop(self) -> None:
        if self._ev0 is not None and self._ev1 is None:
            self._ev1 = _event(self._stream)

    def end(self, *_) -> None:
        """Stamp the end and emit the span, or hold it while its end marker
        has not completed on the card (the next span to end emits it).
        Takes (and ignores) a Future, so it serves as a done callback."""
        if self.t1_ns is not None:
            return
        self.device_stop()
        self.t1_ns = time.perf_counter_ns()
        if self._ev1 is not None and not self._ev1.query():
            with _PENDING_LOCK:
                _PENDING.append(self)
            return
        if _PENDING:
            _settle()  # the spans that ended before this one, first
        self._emit()

    def _emit(self) -> None:
        wall = (self.t1_ns - self.t0_ns) / 1e9
        fields = self.fields  # the span's own: one dict for the hook and the first tracer
        fields.update(span_id=self.span_id, parent_id=self.parent_id, root_id=self.root_id,
                      thread=self.thread[0], tid=self.thread[1], t0_ns=self.t0_ns,
                      t1_ns=self.t1_ns)
        if self._ev1 is not None:
            fields["device_ms"] = self._ev0.elapsed_time(self._ev1)
            _EVENTS.setdefault(self._stream.device_index, []).extend((self._ev0, self._ev1))
            self._ev0 = self._ev1 = None
        hook = self._hook
        if hook is not None:
            hook(self._stage, wall_s=wall, **fields)
        live = _INSTALLED or ()
        fields["span"] = True
        for tracer in self._tracers:
            # A tracer gets the spans that began and ended while it was
            # installed (it may be closed since); one that is also the hook
            # has the event already. A tracer may add its counters to an
            # event's fields: the second and later get their own copy.
            if tracer is not hook and tracer in live:
                tracer._emit(TraceEvent(self.name, wall, fields))
                fields = dict(fields)


class _NullSpan:
    """What :func:`span` gives with nothing installed and no hook."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **fields) -> None:
        pass

    def device_stop(self) -> None:
        pass

    def __bool__(self) -> bool:
        return False


_NULL = _NullSpan()


def span(name: str, /, *, hook=None, stage: str | None = None, device=None, **fields):
    """A span over a ``with`` block, child of the span open on this thread.

    ``hook``: the site's ``trace(stage, **fields)`` callable, if any; it gets
    the span as one event named ``stage`` (default ``name``) with
    ``wall_s`` and the span's fields, and an installed tracer that is the
    hook does not get it twice. ``device``: a CUDA device to bracket the
    span with events on its current stream (``device_ms``) where a hook or
    an installed tracer wants device time; anything else adds nothing.
    With nothing installed and no hook it returns a shared no-op span
    (false in a boolean test)."""
    tracers = _INSTALLED
    if tracers is None and hook is None:
        return _NULL
    return Span(name, tracers or (), hook, stage or name,
                device if hook is not None or _DEVICE else None, None, fields, _CURRENT.get())


def begin(name: str, /, *, span_id=None, **fields) -> Span | None:
    """A span that starts now without entering this thread's stack and is
    closed by its ``end()`` from any thread (a request, ended by its
    Future's done callback). None when nothing is installed."""
    tracers = _INSTALLED
    if tracers is None:
        return None
    return Span(name, tracers, None, name, None, span_id, fields, _CURRENT.get())


def _settle() -> None:
    """Emit the device-timed spans whose end markers have completed. Every
    span's end calls it while some wait; the end of a span around the
    program's own wait on the card (the fit's fetch) finds them done."""
    keep, done = [], []
    with _PENDING_LOCK:
        for s in _PENDING:
            (done if s._ev1.query() else keep).append(s)
        _PENDING[:] = keep
    for s in done:
        s._emit()


def _merge_spans(path: str, tracers, t0_unix: int, t1_unix: int) -> None:
    """Add the spans of ``tracers`` that overlap ``[t0_unix, t1_unix]`` to the
    Chrome trace at ``path``: one complete event a span on its thread's
    track (``tid`` the native thread id, as the profiler's host events),
    ``ts`` in the file's own base (``baseTimeNanoseconds``)."""
    from hdbscan_tpu_torch.utils.telemetry import json_sanitize

    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = trace.setdefault("traceEvents", [])
    pid, seen, threads = os.getpid(), set(), {}
    for tracer in tracers:
        for ev in tracer.spans():
            f = ev.fields
            a, b = tracer.unix_ns(f["t0_ns"]), tracer.unix_ns(f["t1_ns"])
            if b < t0_unix or a > t1_unix or f["span_id"] in seen:
                continue
            seen.add(f["span_id"])
            threads[f["tid"]] = f["thread"]
            args = {k: v for k, v in f.items() if k not in ("t0_ns", "t1_ns", "thread", "tid")}
            events.append({"ph": "X", "cat": "span", "name": ev.name, "pid": pid,
                           "tid": f["tid"], "ts": (a - base) / 1e3, "dur": (b - a) / 1e3,
                           "args": json_sanitize(args)})
    for tid, name in threads.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": name}})
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)


@contextmanager
def xla_profile(logdir: str):
    """Capture a ``torch.profiler`` trace of a block — the reference's
    ``jax.profiler`` capture, under its name so a reader finds the
    counterpart. Records the host's and (where a card is present) the
    card's activity and writes one Chrome trace file under ``logdir``
    (``chrome://tracing`` or Perfetto open it). The spans of the installed
    tracers (:func:`install`) that overlap the capture go into the same
    file on the profile's clock, each on its thread's track: the profiler
    records no other thread than its own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield prof
    t1 = time.time_ns()
    path = os.path.join(logdir, f"trace.{os.getpid()}.json")
    prof.export_chrome_trace(path)
    tracers = _INSTALLED
    if tracers is not None:
        _merge_spans(path, tracers, t0, t1)

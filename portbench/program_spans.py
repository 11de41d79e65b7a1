"""The program's own spans over the traced window, on the profile's clock.

``record()`` gives the recorder that every span-reading metric shares: one
collecting ``Tracer`` put in place with ``hdbscan_tpu_torch.utils.tracing.
install`` while any of them is open (spans from every thread; with
``device=False``: it asks for no CUDA events, which would cost the worker
that paces skin.predict host time). When it
closes, the window's profile has finished: each span is put on the
profile's clock (``Tracer.profile_us`` with the profile's
``trace_start_ns()``), cut to the window's marker, and the card's busy time
inside it (the union of the kernels, copies and sets the profile holds) is
read there. That is the kernels' own time under a span: a span's
``device_ms`` (CUDA events) also counts the stream waiting for the host's
launches. The profile's device timestamps may run ahead of or behind its
host clock by up to a millisecond from one run to the next (H100, torch
2.11): they are put back by the least delay from a launch on the host to
the start of what it launched (:func:`clock_shift_us`). The harness hands a
reader the profile's numbers, not its events, so the collector takes the
finished profile from the frame that holds it.
Against a program without spans the recorder keeps nothing and the readers
return None.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import sys

from portbench import profile as profread


class Busy:
    """The busy time inside any interval, from disjoint sorted intervals
    (``profile._union``'s)."""

    def __init__(self, intervals):
        self._starts = [a for a, _ in intervals]
        self._ends = [b for _, b in intervals]
        self._before = [0.0]  # busy time of the intervals before each one
        for a, b in intervals:
            self._before.append(self._before[-1] + b - a)

    def _to(self, t: float) -> float:
        i = bisect.bisect_right(self._starts, t)
        if i == 0:
            return 0.0
        return self._before[i - 1] + min(t, self._ends[i - 1]) - self._starts[i - 1]

    def __call__(self, a: float, b: float) -> float:
        return self._to(b) - self._to(a)


def clock_shift_us(events) -> float:
    """How far a profile's device timestamps run ahead of its host clock
    (negative: ahead), from its Kineto events: the least delay from a CUDA
    API call on the host (``cuda*``/``cu*``) to the start of the device
    operation of the same correlation id. The true delay is never negative,
    so the least measured one is the offset plus the shortest launch
    latency (a few µs). 0 where nothing links."""
    from torch.autograd import DeviceType

    launched, device = {}, []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(e)
        elif e.name().startswith("cu"):
            launched[e.correlation_id()] = e.start_ns()
    delays = [e.start_ns() - launched[e.correlation_id()] for e in device
              if e.correlation_id() in launched]
    return min(delays) / 1e3 if delays else 0.0


class Timeline:
    """The window's spans on the profile's clock (µs), and the card's busy
    time: ``spans(name)`` gives ``(start, end, fields)`` of each span of
    that name cut to the window, ``busy_us(a, b)`` the busy time in
    ``[a, b]`` (device intervals put back by ``shift_us``), ``window_us``
    the window's length, ``has_device`` whether the profile holds any
    device event."""

    def __init__(self, prof, tracer):
        dev, host = profread._events(prof, False)
        wins = [(a, b) for a, b, name in host if name == profread.WINDOW]
        if not wins:
            raise LookupError("the window's marker is not in the profile")
        w0, w1 = wins[0]
        self.window_us = w1 - w0
        self.has_device = bool(dev)
        self.shift_us = clock_shift_us(prof.profiler.kineto_results.events()) if dev else 0.0
        dev = [(a - self.shift_us, b - self.shift_us) for _, a, b, _ in dev]
        self.busy_us = Busy(profread._union([(max(a, w0), min(b, w1)) for a, b in dev
                                             if min(b, w1) > max(a, w0)]))
        start = prof.profiler.kineto_results.trace_start_ns()
        self._spans: dict = {}
        for e in tracer.spans():
            f = e.fields
            a = max(tracer.profile_us(f["t0_ns"], start), w0)
            b = min(tracer.profile_us(f["t1_ns"], start), w1)
            if b > a:
                self._spans.setdefault(e.name, []).append((a, b, f))

    def spans(self, name: str) -> list:
        return self._spans.get(name, [])

    def idle_us(self, name: str) -> list:
        """Each span's time in which the card ran nothing (its wall less
        the busy time inside it)."""
        return [(b - a) - self.busy_us(a, b) for a, b, _ in self.spans(name)]

    def share(self, us: float) -> float:
        """``us`` as a percent of the window."""
        return 100.0 * us / self.window_us


def _finished_profile():
    """The ``torch.profiler.profile`` that has finished in a calling frame
    (the harness's traced window), or None."""
    try:
        from torch.profiler import profile
    except ImportError:
        return None
    frame = sys._getframe(1)
    while frame is not None:
        for value in list(frame.f_locals.values()):
            if isinstance(value, profile) and getattr(value, "profiler", None) is not None \
                    and getattr(value.profiler, "kineto_results", None) is not None:
                return value
        frame = frame.f_back
    return None


class Collector:
    """The installed tracer while open; ``timeline``: the window's
    :class:`Timeline` once closed, or None."""

    def __init__(self):
        self.users = 0
        self.timeline = None
        self._tracer = self._handle = None
        try:
            tracing = importlib.import_module("hdbscan_tpu_torch.utils.tracing")
        except ImportError:
            return
        if hasattr(tracing, "install"):
            self._tracer = tracing.Tracer()
            self._handle = tracing.install(self._tracer, device=False)

    def close(self) -> None:
        if self._handle is None:
            return
        self._handle.remove()
        prof = _finished_profile()
        if prof is not None and self._tracer.events:
            self.timeline = Timeline(prof, self._tracer)


_SHARED: Collector | None = None


@contextlib.contextmanager
def record():
    """The shared :class:`Collector`, open while any metric's recorder is."""
    global _SHARED
    if _SHARED is None:
        _SHARED = Collector()
    shared = _SHARED
    shared.users += 1
    try:
        yield shared
    finally:
        shared.users -= 1
        if shared.users == 0:
            _SHARED = None
            shared.close()


def timeline(ctx: dict) -> Timeline | None:
    """The window's timeline a span reader reads, or None."""
    rec = ctx["recorded"]
    return None if rec is None else rec.timeline

"""Resilience policies: deadlines, load shedding, retry/backoff, circuit breaker.

A host-only copy of ``hdbscan_tpu/fault/policy.py``: the contracts the
serving and streaming stack keeps against the fault harness in
:mod:`hdbscan_tpu_torch.fault.inject`.

- :class:`DeadlineExceeded` — a request whose deadline passed fails fast
  (HTTP 504) instead of occupying a batch slot; the batcher drops expired
  entries before dispatch.
- :class:`ShedRequest` — bounded-queue load shedding (HTTP 429/503 with a
  Retry-After hint) so an overloaded server degrades by refusing work it
  cannot finish rather than queueing unboundedly.
- :func:`retry_call` / :func:`retry` — capped exponential backoff with
  jitter for transient failures (artifact load during a hot swap, re-fit
  publish).
- :class:`CircuitBreaker` — trips re-fit/swap after repeated failures and
  degrades to serving the pinned model generation; state is surfaced in
  /healthz, /metrics (``circuit_state`` gauge), and ``circuit_state``
  trace events.
"""

from __future__ import annotations

import functools
import random
import threading
import time


class DeadlineExceeded(Exception):
    """The request's deadline passed before (or while) it could be served."""


class ShedRequest(Exception):
    """The server refused the request to shed load.

    ``status`` is the HTTP status to return (429 client-rate / 503
    overload), ``retry_after_s`` the Retry-After hint, ``reason`` a short
    machine-readable cause (``queue_full``, ...).
    """

    def __init__(self, message: str, *, status: int = 503,
                 retry_after_s: float = 0.05, reason: str = "queue_full"):
        super().__init__(message)
        if status not in (429, 503):
            raise ValueError(f"ShedRequest status must be 429 or 503, got {status}")
        self.status = int(status)
        self.retry_after_s = float(retry_after_s)
        self.reason = str(reason)


def backoff_s(attempt: int, *, base_s: float = 0.05, cap_s: float = 2.0,
              jitter: float = 0.5, rng: random.Random | None = None) -> float:
    """Capped exponential backoff for 0-based ``attempt``, with jitter.

    Deterministic given ``rng``; with ``jitter=j`` the delay is uniform in
    ``[(1-j)*d, d]`` where ``d = min(cap_s, base_s * 2**attempt)``.
    """
    if attempt < 0:
        raise ValueError(f"attempt must be >= 0, got {attempt}")
    delay = min(float(cap_s), float(base_s) * (2.0 ** int(attempt)))
    if jitter > 0.0 and rng is not None:
        delay *= (1.0 - jitter) + jitter * rng.random()
    return delay


def retry_call(fn, *, attempts: int = 4, base_s: float = 0.05, cap_s: float = 2.0,
               jitter: float = 0.5, retry_on=(Exception,), should_retry=None,
               seed: int | None = None, sleep=time.sleep, tracer=None,
               name: str = ""):
    """Call ``fn()`` with up to ``attempts`` tries and capped backoff between.

    Retries exceptions matching ``retry_on`` (and, if given, passing the
    ``should_retry(exc) -> bool`` predicate); the last failure re-raises.
    ``seed`` makes the jitter deterministic (None = unjittered backoff so
    bare calls stay reproducible). Each retry emits a ``retry_backoff``
    trace event when ``tracer`` is provided.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    rng = random.Random(seed) if seed is not None else None
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as exc:
            if should_retry is not None and not should_retry(exc):
                raise
            if attempt == attempts - 1:
                raise
            delay = backoff_s(attempt, base_s=base_s, cap_s=cap_s,
                              jitter=jitter if rng is not None else 0.0, rng=rng)
            if tracer is not None:
                tracer("retry_backoff", name=name or getattr(fn, "__name__", "call"),
                       attempt=attempt + 1, delay_s=round(delay, 9),
                       error=f"{type(exc).__name__}: {exc}"[:200])
            sleep(delay)
    raise AssertionError("unreachable")


def retry(**retry_kwargs):
    """Decorator form of :func:`retry_call`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return retry_call(lambda: fn(*args, **kwargs), **retry_kwargs)

        return wrapper

    return deco


# Gauge encoding for /metrics: hdbscan_tpu_circuit_state{name=...}.
CIRCUIT_STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}


class CircuitBreaker:
    """Classic three-state breaker guarding an unreliable dependency.

    closed: calls allowed; ``failures`` consecutive failures trip it open.
    open: calls refused until ``reset_s`` has elapsed since the trip.
    half_open: trial calls allowed; the first success closes, the first
    failure re-opens. (Trials are not limited to one here — a caller whose
    ``allow()`` never materializes into an attempt must not wedge the
    breaker; the server's refitter serializes attempts anyway.)

    Transitions emit ``circuit_state`` trace events and call ``on_state``
    (the server points this at the ``circuit_state`` gauge). Thread-safe.
    """

    def __init__(self, name: str = "circuit", *, failures: int = 3,
                 reset_s: float = 30.0, tracer=None, on_state=None,
                 clock=time.monotonic):
        if failures < 1:
            raise ValueError(f"failures must be >= 1, got {failures}")
        if reset_s <= 0.0:
            raise ValueError(f"reset_s must be > 0, got {reset_s}")
        self.name = str(name)
        self.failure_threshold = int(failures)
        self.reset_s = float(reset_s)
        self.tracer = tracer
        self.on_state = on_state
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0  # consecutive
        self._opened_at = 0.0
        self._trips = 0

    def _transition(self, state: str) -> None:
        # caller holds the lock
        if state == self._state:
            return
        self._state = state
        if state == "open":
            self._opened_at = self._clock()
            self._trips += 1
        tracer, on_state = self.tracer, self.on_state
        failures = self._failures
        if tracer is not None:
            tracer("circuit_state", name=self.name, state=state, failures=failures)
        if on_state is not None:
            on_state(self.name, state)

    def allow(self) -> bool:
        """True if a call may proceed now (may move open -> half_open)."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at >= self.reset_s:
                    self._transition("half_open")
                    return True
                return False
            return True  # half_open: trials allowed

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._transition("closed")

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == "half_open" or self._failures >= self.failure_threshold:
                self._transition("open")

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def state_info(self) -> dict:
        """Snapshot for /healthz."""
        with self._lock:
            info = {
                "name": self.name,
                "state": self._state,
                "failures": self._failures,
                "trips": self._trips,
            }
            if self._state == "open":
                info["retry_in_s"] = round(
                    max(0.0, self.reset_s - (self._clock() - self._opened_at)), 6
                )
            return info

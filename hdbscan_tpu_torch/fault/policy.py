"""Resilience policies: deadlines, load shedding, retry/backoff.

A host-only copy of the serving half of ``hdbscan_tpu/fault/policy.py``:
the contracts the serving stack keeps against the fault harness in
:mod:`hdbscan_tpu_torch.fault.inject`. The reference's ``CircuitBreaker``
and ``retry`` decorator guard its streaming re-fits and come with them
(ROADMAP A10).

- :class:`DeadlineExceeded` — a request whose deadline passed fails fast
  (HTTP 504) instead of occupying a batch slot; the batcher drops expired
  entries before dispatch.
- :class:`ShedRequest` — bounded-queue load shedding (HTTP 429/503 with a
  Retry-After hint) so an overloaded server degrades by refusing work it
  cannot finish rather than queueing unboundedly.
- :func:`retry_call` — capped exponential backoff with jitter for
  transient failures (artifact load during a hot swap).
"""

from __future__ import annotations

import random
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

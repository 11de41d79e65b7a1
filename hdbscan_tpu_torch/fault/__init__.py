"""Fault-tolerance layer of the serving stack: deterministic fault
injection and resilience policy — host-only copies of the reference's
``hdbscan_tpu/fault`` with the same names.

- ``fault/inject.py`` — the fault-injection harness: named sites across the
  serving stack (predictor dispatch, artifact save/load, batcher submit,
  HTTP socket resets, slow-request stalls) fire with per-site
  probability/count/seed from the ``HDBSCAN_TPU_FAULTS`` spec, emitting
  ``fault_injected`` trace events so every injected failure is accounted
  for in the trace and metrics.
- ``fault/policy.py`` — the resilience policies: per-request deadlines
  (``DeadlineExceeded`` → 504), bounded-queue load shedding
  (``ShedRequest`` → 429/503 + Retry-After) and capped exponential
  backoff with jitter (``retry_call``). The reference's circuit breaker
  guards its streaming re-fits and comes with them (ROADMAP A10).

Stdlib-only on purpose: injection sites live on serving hot paths, and the
no-fault fast path is a single module-attribute check.
"""

from hdbscan_tpu_torch.fault.inject import (  # noqa: F401
    ENV_VAR,
    FAULT_SITES,
    FaultPlan,
    InjectedFault,
    clear,
    install,
    maybe_fire,
    parse_spec,
)
from hdbscan_tpu_torch.fault.policy import (  # noqa: F401
    DeadlineExceeded,
    ShedRequest,
    backoff_s,
    retry_call,
)

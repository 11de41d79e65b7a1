"""Deterministic fault-injection harness for the serving stack — a
host-only copy of ``hdbscan_tpu/fault/inject.py`` (same sites, same
``HDBSCAN_TPU_FAULTS`` variable, same spec grammar), so a chaos spec one
package accepts the other accepts too.

A *fault plan* names injection sites and, per site, how often and how many
times to fire. The spec grammar (also accepted via the ``HDBSCAN_TPU_FAULTS``
environment variable and the ``faults=...`` config flag) is::

    site[:key=value[,key=value...]][;site2[:...]...]

with keys

- ``p``        firing probability per arrival at the site (default 1.0)
- ``count``    maximum number of fires for the site (default unlimited)
- ``seed``     per-site PRNG seed — same spec, same arrival order, same
               fires (default 0)
- ``mode``     site-specific behavior variant (e.g. ``artifact_save`` has
               ``torn`` and ``digest``); default ``raise``
- ``delay_s``  stall duration for ``slow_request`` (default 0.05)

Example: ``predict_dispatch:p=0.2,count=5,seed=7;artifact_save:mode=torn``.

Sites check the plan through :func:`maybe_fire`. The no-fault fast path is a
module attribute ``is None`` test, so leaving injection compiled into hot
paths costs nothing measurable. Every fire emits a ``fault_injected`` trace
event and invokes the installed ``on_fire`` hooks (the server wires these
to the ``hdbscan_tpu_faults_injected_total{site}`` counter), so chaos tests
can prove that metrics/trace account for every injected fault.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field

ENV_VAR = "HDBSCAN_TPU_FAULTS"

# Sites wired into the stack. parse_spec rejects unknown names so a typo in
# a chaos config fails loudly instead of silently injecting nothing.
FAULT_SITES = (
    "predict_dispatch",  # predictor device dispatch (fails the coalesced batch)
    "artifact_save",     # model publish; mode=torn crashes pre-rename, mode=digest corrupts bytes
    "artifact_load",     # model load (transient; callers retry with backoff)
    "refit_fit",         # background refit crash
    "batcher_submit",    # micro-batcher enqueue
    "http_reset",        # server drops the connection without a response
    "slow_request",      # server stalls delay_s before handling
    "phase_stall",       # heartbeat beat() sleeps delay_s before refreshing liveness (watchdog tests)
)


class InjectedFault(Exception):
    """Raised at an injection site standing in for a real crash/IO error."""


@dataclass
class SiteSpec:
    """Parsed per-site injection parameters."""

    site: str
    p: float = 1.0
    count: int = -1  # -1 = unlimited
    seed: int = 0
    mode: str = "raise"
    delay_s: float = 0.05

    def __post_init__(self) -> None:
        if self.site not in FAULT_SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; expected one of {sorted(FAULT_SITES)}"
            )
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault site {self.site}: p must be in [0, 1], got {self.p}")
        if self.delay_s < 0.0:
            raise ValueError(f"fault site {self.site}: delay_s must be >= 0, got {self.delay_s}")


def parse_spec(text: str) -> list[SiteSpec]:
    """Parse a ``site:key=val,...;site2:...`` spec into :class:`SiteSpec` list."""
    specs: list[SiteSpec] = []
    seen: set[str] = set()
    for clause in text.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        site, _, rest = clause.partition(":")
        site = site.strip()
        kwargs: dict[str, object] = {}
        for pair in rest.split(","):
            pair = pair.strip()
            if not pair:
                continue
            key, eq, value = pair.partition("=")
            key = key.strip()
            value = value.strip()
            if not eq or not value:
                raise ValueError(f"fault spec clause {clause!r}: expected key=value, got {pair!r}")
            if key == "p":
                kwargs["p"] = float(value)
            elif key == "count":
                kwargs["count"] = int(value)
            elif key == "seed":
                kwargs["seed"] = int(value)
            elif key == "mode":
                kwargs["mode"] = value
            elif key == "delay_s":
                kwargs["delay_s"] = float(value)
            else:
                raise ValueError(f"fault spec clause {clause!r}: unknown key {key!r}")
        if site in seen:
            raise ValueError(f"fault spec names site {site!r} twice")
        seen.add(site)
        specs.append(SiteSpec(site=site, **kwargs))
    return specs


@dataclass
class _SiteState:
    spec: SiteSpec
    rng: random.Random
    fired: int = 0


class FaultPlan:
    """An installed set of sites with per-site PRNG state and fire counts.

    Thread-safe: serving sites fire from HTTP handler threads, the batcher
    worker, and the refit daemon concurrently.
    """

    def __init__(self, specs, tracer=None):
        if isinstance(specs, str):
            specs = parse_spec(specs)
        self._sites = {s.site: _SiteState(spec=s, rng=random.Random(s.seed)) for s in specs}
        self._lock = threading.Lock()
        self.tracer = tracer
        self._on_fire: list = []

    def add_on_fire(self, hook) -> None:
        """Register ``hook(site, spec, nth)`` called on every fire."""
        with self._lock:
            if hook not in self._on_fire:
                self._on_fire.append(hook)

    def maybe_fire(self, site: str):
        """Return the :class:`SiteSpec` if ``site`` fires this arrival, else None."""
        state = self._sites.get(site)
        if state is None:
            return None
        with self._lock:
            spec = state.spec
            if 0 <= spec.count <= state.fired:
                return None
            if spec.p < 1.0 and state.rng.random() >= spec.p:
                return None
            state.fired += 1
            nth = state.fired
            hooks = list(self._on_fire)
        tracer = self.tracer
        if tracer is not None:
            tracer("fault_injected", site=site, mode=spec.mode, nth=nth)
        for hook in hooks:
            hook(site, spec, nth)
        return spec

    def fired(self) -> dict[str, int]:
        """Per-site fire counts so far."""
        with self._lock:
            return {name: st.fired for name, st in self._sites.items()}


# Module-level plan checked by every injection site. None = no faults: the
# hot-path cost of an uninstalled harness is one attribute load + is-None.
_PLAN: FaultPlan | None = None
_INSTALL_LOCK = threading.Lock()


def install(spec, tracer=None) -> FaultPlan:
    """Install ``spec`` (string or FaultPlan) as the process-wide plan."""
    global _PLAN
    plan = spec if isinstance(spec, FaultPlan) else FaultPlan(spec, tracer=tracer)
    if tracer is not None and plan.tracer is None:
        plan.tracer = tracer
    with _INSTALL_LOCK:
        _PLAN = plan
    return plan


def clear() -> None:
    """Remove the process-wide plan (sites stop firing)."""
    global _PLAN
    with _INSTALL_LOCK:
        _PLAN = None


def plan() -> FaultPlan | None:
    return _PLAN


def maybe_fire(site: str):
    """Fire ``site`` against the installed plan; None when no plan/no fire."""
    p = _PLAN
    if p is None:
        return None
    return p.maybe_fire(site)

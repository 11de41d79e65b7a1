"""Multi-tenant model registry: many ClusterModels behind one replica — a
host-side copy of ``hdbscan_tpu/fleet/tenants.py`` whose predictors live on
the registry's device (the card unless another is named).

One fleet, thousands of models: each tenant id maps to a model artifact on
disk, and a bounded LRU of warmed :class:`serve.predict.Predictor`
instances keeps the hot tenants device-resident while cold ones cost one
load + warmup on first touch. The registry owns the per-tenant contracts
the single-model server already has globally:

* **Generations** — every publish (first load, re-warm after eviction, or
  an explicit :meth:`swap`) bumps the tenant's generation; generations
  strictly increase per tenant for the life of the registry, mirroring the
  blue/green ``model_swap`` invariant.
* **Quotas** — a per-tenant token bucket (``quota_rps`` sustained, burst of
  ``max(1, quota_rps)``); an exhausted bucket raises
  :class:`fault.policy.ShedRequest` with status 429 and a Retry-After hint
  sized to the next token, which the server's shed path already turns into
  the right HTTP response.
* **SLO verdicts** — per-tenant latency windows feed
  :func:`utils.telemetry.slo_verdict`, so one noisy tenant's tail cannot
  hide inside a fleet-wide p99.

Evictions emit ``tenant_evict`` trace events (validated by
``scripts/check_trace.py``) and ``hdbscan_tpu_tenant_evictions_total``.
The port has no JIT: a tenant's warmup runs every bucket through the
process's already-loaded kernel libraries, so a re-warm after eviction
reports 0 builds (``warmup()['jit_compiles']``, the sources compiled with
nvcc) for every tenant after the first — the zero-steady-state-recompile
property survives multi-tenancy.

Device memory: each resident tenant's ``Predictor`` holds its tables on
the registry's device. An evicted entry leaves no reference behind (the
trace event and the metrics carry only plain values), so its tensors
return to the card's caching allocator: the allocated bytes of an LRU of
``lru_size`` stay near ``lru_size`` tenants' worth however many tenants
cycle through it.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field

from hdbscan_tpu_torch.fault.policy import ShedRequest

#: Default per-tenant SLO bounds for :meth:`TenantRegistry.slo_verdicts` —
#: same shape as ``bench.SLO_TARGETS``, scoped to what a tenant window
#: can observe (latency; throughput is a fleet property).
DEFAULT_TENANT_SLO = {"p50_s": {"max": 0.1}, "p99_s": {"max": 0.5}}

#: Per-tenant latency window for SLO verdicts (recent-window semantics,
#: like the Tracer ring: old latencies age out instead of pinning a
#: verdict to startup transients forever).
_SLO_WINDOW = 2048


@dataclass
class _TenantEntry:
    """One resident tenant: a warmed predictor plus its provenance."""

    tenant: str
    model: object
    predictor: object
    generation: int
    warmup: dict
    loaded_at: float
    requests: int = 0


@dataclass
class _QuotaBucket:
    tokens: float
    last: float


@dataclass
class _TenantStats:
    """Survives eviction (generations/quota/latency are per-tenant, not
    per-residency)."""

    generation: int = 0
    quota: _QuotaBucket | None = None
    latencies: deque = field(default_factory=lambda: deque(maxlen=_SLO_WINDOW))
    requests: int = 0
    shed: int = 0
    evictions: int = 0


class TenantRegistry:
    """LRU cache of warmed Predictors keyed by tenant id.

    Args:
      paths: ``{tenant_id: artifact_path}``. Tenants can also be added
        later via :meth:`add`; an unknown tenant id raises ``KeyError``
        (the server maps it to HTTP 404).
      backend / max_batch: forwarded to each Predictor (which serves in
        float32, the reference's serving type; there is no ``dtype``).
      lru_size: max resident tenants (>= 1). The coldest resident is
        evicted — with a ``tenant_evict`` trace event — when a miss would
        exceed it.
      quota_rps: sustained per-tenant request rate; 0 disables quotas.
      metrics: optional ``utils.metrics.MetricsRegistry`` — tenant-labeled
        request/eviction/load counters, a resident gauge, and a per-tenant
        latency histogram register here.
      tracer: optional ``utils.tracing.Tracer`` for ``tenant_load`` /
        ``tenant_evict`` events (and each Predictor's ``predict_batch``).
      artifact_store: optional ``fleet.artifacts.ArtifactStore`` — tenant
        artifacts then load through the per-host digest-keyed store (one
        mmap'd copy per host, re-warms after eviction are free) instead of
        a private ``ClusterModel.load`` per registry.
      device: where every tenant's Predictor lives and runs (the card
        unless another is named, e.g. ``"cpu"``; no fallback).
    """

    def __init__(self, paths: dict | None = None, *, backend: str = "auto",
                 max_batch: int = 256, lru_size: int = 8,
                 quota_rps: float = 0.0, metrics=None, tracer=None,
                 artifact_store=None, clock=time.monotonic, device=None):
        if lru_size < 1:
            raise ValueError(f"lru_size must be >= 1, got {lru_size!r}")
        if quota_rps < 0.0 or not math.isfinite(quota_rps):
            raise ValueError(f"quota_rps must be finite and >= 0, got {quota_rps!r}")
        self.backend = backend
        self.max_batch = int(max_batch)
        self.lru_size = int(lru_size)
        self.quota_rps = float(quota_rps)
        self.metrics = metrics
        self.tracer = tracer
        self.artifact_store = artifact_store
        self.device = device
        self._clock = clock
        self._lock = threading.RLock()
        self._paths: dict = dict(paths or {})
        self._resident: "OrderedDict[str, _TenantEntry]" = OrderedDict()
        self._stats: dict = {}  # tenant -> _TenantStats
        self._m_requests = self._m_evictions = self._m_loads = None
        self._m_resident = self._m_latency = None
        if metrics is not None:
            from hdbscan_tpu_torch.utils.metrics import DEFAULT_LATENCY_BUCKETS

            self._m_requests = metrics.counter(
                "hdbscan_tpu_tenant_requests_total",
                "Tenant-scoped predict requests by outcome.",
                ("tenant", "outcome"),
            )
            self._m_evictions = metrics.counter(
                "hdbscan_tpu_tenant_evictions_total",
                "LRU evictions of a warmed tenant predictor.",
                ("tenant",),
            )
            self._m_loads = metrics.counter(
                "hdbscan_tpu_tenant_loads_total",
                "Tenant model loads (first touch, re-warm, or swap).",
                ("tenant",),
            )
            self._m_resident = metrics.gauge(
                "hdbscan_tpu_tenant_resident",
                "Warmed tenant predictors currently resident in the LRU.",
            )
            self._m_latency = metrics.histogram(
                "hdbscan_tpu_tenant_predict_seconds",
                "Per-tenant end-to-end predict latency.",
                ("tenant",),
                buckets=DEFAULT_LATENCY_BUCKETS,
            )

    # -- tenant set --------------------------------------------------------

    @classmethod
    def from_dir(cls, path: str, **kwargs) -> "TenantRegistry":
        """Registry over every ``*.npz`` artifact in ``path``; the tenant
        id is the file stem (``acme.npz`` serves tenant ``acme``)."""
        paths = {
            os.path.splitext(name)[0]: os.path.join(path, name)
            for name in sorted(os.listdir(path))
            if name.endswith(".npz")
        }
        if not paths:
            raise ValueError(f"no .npz model artifacts under {path!r}")
        return cls(paths, **kwargs)

    def add(self, tenant: str, path: str) -> None:
        with self._lock:
            self._paths[str(tenant)] = str(path)

    def tenants(self) -> list:
        with self._lock:
            return sorted(self._paths)

    def resident(self) -> list:
        """Resident tenant ids, coldest first (LRU order)."""
        with self._lock:
            return list(self._resident)

    # -- quota -------------------------------------------------------------

    def _acquire_quota(self, tenant: str, st: _TenantStats) -> None:
        # caller holds the lock
        if self.quota_rps <= 0.0:
            return
        now = self._clock()
        burst = max(1.0, self.quota_rps)
        if st.quota is None:
            st.quota = _QuotaBucket(tokens=burst, last=now)
        b = st.quota
        b.tokens = min(burst, b.tokens + (now - b.last) * self.quota_rps)
        b.last = now
        if b.tokens >= 1.0:
            b.tokens -= 1.0
            return
        st.shed += 1
        if self._m_requests is not None:
            self._m_requests.inc(tenant=tenant, outcome="shed")
        retry_s = (1.0 - b.tokens) / self.quota_rps
        raise ShedRequest(
            f"tenant {tenant!r} over quota ({self.quota_rps:g} rps)",
            status=429, retry_after_s=retry_s, reason="tenant_quota",
        )

    # -- LRU / load --------------------------------------------------------

    def _load(self, tenant: str, path: str, st: _TenantStats) -> _TenantEntry:
        # caller holds the lock; load + warmup happen inline so a tenant is
        # never observable half-warm. Model artifacts are digest-guarded, so
        # concurrent loads of the same file across replicas are safe.
        from hdbscan_tpu_torch.serve.artifact import ClusterModel
        from hdbscan_tpu_torch.serve.predict import Predictor

        t0 = time.perf_counter()
        if self.artifact_store is not None:
            model = self.artifact_store.load(path)
        else:
            model = ClusterModel.load(path)
        predictor = Predictor(
            model, backend=self.backend, max_batch=self.max_batch,
            tracer=self.tracer, metrics=self.metrics, device=self.device,
        )
        info = predictor.warmup()
        st.generation += 1
        entry = _TenantEntry(
            tenant=tenant, model=model, predictor=predictor,
            generation=st.generation, warmup=info, loaded_at=self._clock(),
        )
        self._resident[tenant] = entry
        self._resident.move_to_end(tenant)
        if self._m_loads is not None:
            self._m_loads.inc(tenant=tenant)
            self._m_resident.set(len(self._resident))
        if self.tracer is not None:
            self.tracer(
                "tenant_load", tenant=tenant, generation=entry.generation,
                resident=len(self._resident),
                jit_compiles=int(info.get("jit_compiles", 0)),
                wall_s=time.perf_counter() - t0,
            )
        self._evict_over_capacity()
        return entry

    def _evict_over_capacity(self) -> None:
        # caller holds the lock
        while len(self._resident) > self.lru_size:
            tenant, entry = self._resident.popitem(last=False)
            st = self._stats[tenant]
            st.evictions += 1
            if self._m_evictions is not None:
                self._m_evictions.inc(tenant=tenant)
                self._m_resident.set(len(self._resident))
            if self.tracer is not None:
                self.tracer(
                    "tenant_evict", tenant=tenant,
                    generation=entry.generation,
                    resident=len(self._resident),
                    requests=entry.requests,
                )

    def checkout(self, tenant: str) -> _TenantEntry:
        """Resolve a tenant to a warmed entry: quota check, LRU touch,
        load + warmup on miss (evicting the coldest resident if full).

        Raises ``KeyError`` for an unknown tenant and
        :class:`ShedRequest` (status 429) when the tenant is over quota —
        quota is charged before the load so cold tenants cannot buy free
        warmups by thrashing the LRU.
        """
        tenant = str(tenant)
        with self._lock:
            path = self._paths.get(tenant)
            if path is None:
                raise KeyError(f"unknown tenant {tenant!r}")
            st = self._stats.setdefault(tenant, _TenantStats())
            self._acquire_quota(tenant, st)
            entry = self._resident.get(tenant)
            if entry is None:
                entry = self._load(tenant, path, st)
            else:
                self._resident.move_to_end(tenant)
            entry.requests += 1
            st.requests += 1
            return entry

    def swap(self, tenant: str, path: str) -> _TenantEntry:
        """Publish a new artifact for a tenant (generation bumps); the old
        predictor, if resident, is replaced atomically under the lock."""
        tenant = str(tenant)
        with self._lock:
            self._paths[tenant] = str(path)
            st = self._stats.setdefault(tenant, _TenantStats())
            self._resident.pop(tenant, None)
            return self._load(tenant, str(path), st)

    # -- serving -----------------------------------------------------------

    def predict(self, tenant: str, X, with_membership: bool = False):
        """Predict for one tenant. Returns ``(outputs, info)`` where
        ``outputs`` is the Predictor's tuple and ``info`` carries
        ``{"tenant", "generation", "bucket"}`` (plus ``"selected_ids"``
        when membership was requested) for the response body/span."""
        entry = self.checkout(tenant)
        t0 = time.perf_counter()
        out = entry.predictor.predict(X, with_membership=with_membership)
        wall = time.perf_counter() - t0
        with self._lock:
            st = self._stats[str(tenant)]
            st.latencies.append(wall)
        if self._m_requests is not None:
            self._m_requests.inc(tenant=str(tenant), outcome="ok")
            self._m_latency.observe(wall, tenant=str(tenant))
        pred = entry.predictor
        info = {
            "tenant": str(tenant),
            "generation": entry.generation,
            "bucket": pred.bucket_for(min(len(out[0]), pred.max_bucket)),
        }
        if with_membership:
            info["selected_ids"] = entry.model.selected_ids.tolist()
        return out, info

    # -- introspection -----------------------------------------------------

    def generation(self, tenant: str) -> int:
        with self._lock:
            st = self._stats.get(str(tenant))
            return st.generation if st else 0

    def slo_verdicts(self, targets: dict | None = None) -> dict:
        """Per-tenant target-vs-attainment verdicts over the recent latency
        window (``utils.telemetry.slo_verdict`` semantics)."""
        from hdbscan_tpu_torch.utils.telemetry import slo_verdict

        targets = dict(targets or DEFAULT_TENANT_SLO)
        out: dict = {}
        with self._lock:
            snap = {
                t: (list(st.latencies), st.requests, st.shed)
                for t, st in self._stats.items()
            }
        for tenant, (lats, requests, shed) in sorted(snap.items()):
            observed: dict = {"requests": requests, "shed": shed}
            if lats:
                ranked = sorted(lats)
                for q, name in ((0.5, "p50_s"), (0.99, "p99_s")):
                    rank = max(1, math.ceil(q * len(ranked)))
                    observed[name] = ranked[rank - 1]
            out[tenant] = slo_verdict(observed, targets)
            out[tenant]["observed"] = observed
        return out

    def stats(self) -> dict:
        """Snapshot for /healthz."""
        with self._lock:
            return {
                "tenants": len(self._paths),
                "resident": list(self._resident),
                "lru_size": self.lru_size,
                "quota_rps": self.quota_rps,
                "generations": {
                    t: st.generation for t, st in sorted(self._stats.items())
                },
                "requests": {
                    t: st.requests for t, st in sorted(self._stats.items())
                },
                "shed": {t: st.shed for t, st in sorted(self._stats.items())},
                "evictions": {
                    t: st.evictions for t, st in sorted(self._stats.items())
                },
            }

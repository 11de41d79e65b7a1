"""Serving fleet: router, tenant registry, and the control plane — the port
of ``hdbscan_tpu/fleet``.

``FleetRouter`` (``fleet/router.py``) fronts a DYNAMIC set of the port's
``serve`` replica subprocesses (on the card unless ``device`` names
another) on one asyncio accept loop with health-tracked consistent-hash /
least-loaded routing, aggregated ``/metrics``, and warm-standby scale-up /
drain-first scale-down; ``TenantRegistry`` (``fleet/tenants.py``) serves
many models per replica behind an LRU of warmed Predictors with
per-tenant generations, quotas, and SLO verdicts. The control plane rides
on top: ``Autoscaler`` (``fleet/controlplane.py``) drives the router's
scale ops off its queue-depth/p99 signals, ``ArtifactStore``
(``fleet/artifacts.py``) maps each distinct artifact digest once per host,
and ``FitScheduler`` (``fleet/jobs.py``) runs fit-as-a-service jobs on the
card that publish through the per-tenant blue/green swap. The trace
events, metric families and HTTP answers are the reference's.
"""

from hdbscan_tpu_torch.fleet.artifacts import ArtifactStore, default_store
from hdbscan_tpu_torch.fleet.controlplane import Autoscaler
from hdbscan_tpu_torch.fleet.jobs import FitJob, FitScheduler
from hdbscan_tpu_torch.fleet.router import POLICIES, FleetRouter
from hdbscan_tpu_torch.fleet.tenants import DEFAULT_TENANT_SLO, TenantRegistry

__all__ = [
    "ArtifactStore",
    "Autoscaler",
    "FitJob",
    "FitScheduler",
    "FleetRouter",
    "TenantRegistry",
    "POLICIES",
    "DEFAULT_TENANT_SLO",
    "default_store",
]

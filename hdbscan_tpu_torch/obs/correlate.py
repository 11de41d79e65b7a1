"""Fleet trace correlation: join router spans to replica spans — a
host-only copy of ``hdbscan_tpu/obs/correlate.py``, joining the traces of
the fleet router (``fleet/router.py``) and its replicas; the join works on
either package's traces.

The fleet router stamps (or propagates) an ``X-Request-Id`` on every
proxied request and emits a ``router_span`` trace event per request
(route decision, chosen replica, queue wait, attempt count). The replica
that served it emits its existing ``request_span`` — or ``request_shed``
when it refused — carrying the same id. :func:`join_spans` reconstructs
the causal chain: every *replied* router span must join exactly one
replica-side event, bitwise on the request id.

:func:`merge_fleet_traces` is the fleet analogue of
``telemetry.merge_host_traces``: it reads the router's trace plus each
replica's, computes per-side phase aggregates, and attaches the join so
one artifact answers "what happened to request X, end to end".
"""

from __future__ import annotations

from hdbscan_tpu_torch.utils import telemetry

_REPLICA_SPAN_STAGES = ("request_span", "request_shed")


def _as_dict(ev):
    return ev if isinstance(ev, dict) else {**ev.fields, "stage": ev.name}


def _stage(ev) -> str:
    return ev.get("stage", "") if isinstance(ev, dict) else ev.name


def join_spans(router_events, replica_events) -> dict:
    """Join ``router_span`` events against replica request spans by id.

    Returns a stats dict: total router spans, how many were ``replied``
    (the router actually relayed a replica response — only those can
    join), matched count, plus the offending ids in ``orphans`` (no
    replica event) and ``duplicates`` (more than one). A chain
    reconstruction is 100% when ``matched == replied`` and both lists
    are empty.
    """
    replica_ids: dict[str, int] = {}
    for ev in replica_events:
        if _stage(ev) in _REPLICA_SPAN_STAGES:
            d = _as_dict(ev)
            rid = d.get("request_id")
            if rid:
                replica_ids[str(rid)] = replica_ids.get(str(rid), 0) + 1

    total = replied = matched = 0
    orphans: list[str] = []
    duplicates: list[str] = []
    for ev in router_events:
        if _stage(ev) != "router_span":
            continue
        total += 1
        d = _as_dict(ev)
        if not d.get("replied"):
            continue
        replied += 1
        rid = str(d.get("request_id", ""))
        count = replica_ids.get(rid, 0)
        if count == 0:
            orphans.append(rid)
        elif count > 1:
            duplicates.append(rid)
        else:
            matched += 1
    return {
        "router_spans": total,
        "replied": replied,
        "matched": matched,
        "orphans": orphans,
        "duplicates": duplicates,
        "complete": replied > 0 and matched == replied,
    }


def merge_fleet_traces(router_path, replica_paths) -> dict:
    """Merge a router trace with its replicas' traces into one summary.

    Mirrors ``telemetry.merge_host_traces``'s shape: per-side phase
    aggregates keyed by trace path, plus the router↔replica span join.
    """
    router_events = telemetry.read_trace(router_path)
    replica_events = []
    replicas = {}
    for path in replica_paths:
        events = telemetry.read_trace(path)
        replica_events.extend(events)
        replicas[str(path)] = {
            "events": len(events),
            "phases": telemetry.phase_aggregates(events),
        }
    return {
        "router": {
            "path": str(router_path),
            "events": len(router_events),
            "phases": telemetry.phase_aggregates(router_events),
        },
        "replicas": replicas,
        "join": join_spans(router_events, replica_events),
    }

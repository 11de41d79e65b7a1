"""The port's host-only copies of the fault harness (``fault/inject.py``,
``fault/policy.py``) and of the metrics registry (``utils/metrics.py``)
against the reference's: the same spec grammar and refusals, the same
seeded fire pattern, the same backoff and retry behaviour, and the same
Prometheus exposition line for line. Everything here is exact.
"""

import dataclasses
import random

import pytest

from hdbscan_tpu import fault as ref_fault
from hdbscan_tpu.fault import inject as ref_inject
from hdbscan_tpu.fault import policy as ref_policy
from hdbscan_tpu.utils import metrics as ref_metrics
from hdbscan_tpu_torch import fault as port_fault
from hdbscan_tpu_torch.config import HDBSCANParams
from hdbscan_tpu_torch.fault import inject as port_inject
from hdbscan_tpu_torch.fault import policy as port_policy
from hdbscan_tpu_torch.utils import metrics as port_metrics
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


_GOOD_SPECS = [
    "",
    "predict_dispatch",
    "predict_dispatch:p=0.2,count=5,seed=7;artifact_save:mode=torn",
    " slow_request : delay_s=0.5 ; http_reset:p=1.0 ;",
    "artifact_load:count=2;batcher_submit:p=0.25,seed=3;phase_stall:delay_s=0",
    "refit_fit:mode=crash,count=0",
]

_BAD_SPECS = [
    "nosuchsite",
    "predict_dispatch:p=2",
    "predict_dispatch:p=-0.1",
    "predict_dispatch:bogus=1",
    "predict_dispatch:p",
    "predict_dispatch:p=",
    "predict_dispatch;predict_dispatch:p=0.5",
    "slow_request:delay_s=-1",
    "artifact_save:count=x",
]


def test_sites_and_env_var_match_reference():
    assert port_inject.FAULT_SITES == ref_inject.FAULT_SITES
    assert port_inject.ENV_VAR == ref_inject.ENV_VAR
    names = {n for n in dir(port_fault) if not n.startswith("_")}
    assert names <= {n for n in dir(ref_fault) if not n.startswith("_")}
    assert {"parse_spec", "install", "maybe_fire", "retry_call", "ShedRequest"} <= names


@pytest.mark.parametrize("spec", _GOOD_SPECS)
def test_parse_spec_matches_reference(spec):
    port = [dataclasses.asdict(s) for s in port_fault.parse_spec(spec)]
    ref = [dataclasses.asdict(s) for s in ref_fault.parse_spec(spec)]
    assert port == ref


@pytest.mark.parametrize("spec", _BAD_SPECS)
def test_parse_spec_refusals_match_reference(spec):
    with pytest.raises(ValueError) as ref_err:
        ref_fault.parse_spec(spec)
    with pytest.raises(ValueError) as port_err:
        port_fault.parse_spec(spec)
    assert str(port_err.value) == str(ref_err.value)
    # The config's eager check is the same parser.
    with pytest.raises(ValueError) as cfg_err:
        HDBSCANParams(fault_spec=spec)
    assert str(cfg_err.value) == str(ref_err.value)


def test_fault_plan_fires_like_reference():
    spec = "predict_dispatch:p=0.3,seed=11;batcher_submit:p=0.5,count=4,seed=2;http_reset"
    events = {"ref": [], "port": []}
    plans = {
        "ref": ref_inject.FaultPlan(spec, tracer=lambda s, **f: events["ref"].append((s, f))),
        "port": port_inject.FaultPlan(spec, tracer=lambda s, **f: events["port"].append((s, f))),
    }
    arrivals = ["predict_dispatch", "batcher_submit", "http_reset", "artifact_load"] * 40
    fires = {key: [plan.maybe_fire(site) is not None for site in arrivals]
             for key, plan in plans.items()}
    assert fires["port"] == fires["ref"] and any(fires["port"])
    assert plans["port"].fired() == plans["ref"].fired()
    assert events["port"] == events["ref"]


def test_install_and_maybe_fire_are_process_wide():
    try:
        plan = port_inject.install("artifact_load:count=1")
        assert port_inject.plan() is plan
        assert port_inject.maybe_fire("artifact_load") is not None
        assert port_inject.maybe_fire("artifact_load") is None
    finally:
        port_inject.clear()
    assert port_inject.maybe_fire("artifact_load") is None


def test_backoff_and_retry_match_reference():
    for seed in (0, 5):
        a = [port_policy.backoff_s(i, rng=random.Random(seed)) for i in range(8)]
        b = [ref_policy.backoff_s(i, rng=random.Random(seed)) for i in range(8)]
        assert a == b
    logs = {}
    for name, pol in (("port", port_policy), ("ref", ref_policy)):
        calls, events, sleeps = [], [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        out = pol.retry_call(flaky, attempts=4, seed=9, sleep=sleeps.append,
                             tracer=lambda s, **f: events.append((s, f)), name="load")
        logs[name] = (out, len(calls), sleeps, events)
    assert logs["port"] == logs["ref"]
    with pytest.raises(ValueError, match="attempts"):
        port_policy.retry_call(lambda: 0, attempts=0)


def test_shed_request_contract_matches_reference():
    for pol in (port_policy, ref_policy):
        with pytest.raises(ValueError, match="429 or 503"):
            pol.ShedRequest("x", status=500)
    e = port_policy.ShedRequest("full", status=429, retry_after_s=0.5, reason="quota")
    assert (e.status, e.retry_after_s, e.reason) == (429, 0.5, "quota")


def _drive(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("hdbscan_tpu_requests_total", "HTTP requests.", labelnames=("route", "status"))
    g = reg.gauge("hdbscan_tpu_requests_in_flight", "In flight.")
    h = reg.histogram("hdbscan_tpu_request_latency_seconds", "Latency.", labelnames=("route",))
    s = reg.histogram("hdbscan_tpu_predict_batch_rows", "Rows.", buckets=mod.DEFAULT_SIZE_BUCKETS)
    for i in range(50):
        c.inc(route="/predict", status="200" if i % 7 else "400")
        h.observe(0.0003 * (i + 1) ** 1.5, route="/predict" if i % 3 else "/healthz")
        s.observe(1 + (i * 37) % 300)
        g.inc()
        if i % 2:
            g.dec()
    c.inc(2.5, route='odd"label\\', status="200")
    return reg


def test_metrics_exposition_matches_reference():
    assert _drive(port_metrics).render() == _drive(ref_metrics).render()
    assert port_metrics.DEFAULT_LATENCY_BUCKETS == ref_metrics.DEFAULT_LATENCY_BUCKETS


@pytest.mark.parametrize(
    "make",
    [
        lambda r: r.counter("bad name"),
        lambda r: r.counter("ok_total", labelnames=("le",)),
        lambda r: (r.counter("dup_total"), r.gauge("dup_total")),
        lambda r: r.counter("c_total").inc(-1),
        lambda r: r.histogram("h", buckets=(1.0, 1.0)),
        lambda r: r.counter("l_total", labelnames=("route",)).inc(status="200"),
    ],
)
def test_metrics_refusals_match_reference(make):
    with pytest.raises(ValueError) as ref_err:
        make(ref_metrics.MetricsRegistry())
    with pytest.raises(ValueError) as port_err:
        make(port_metrics.MetricsRegistry())
    assert str(port_err.value) == str(ref_err.value)

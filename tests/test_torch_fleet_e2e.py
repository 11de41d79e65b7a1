"""The port's fleet end to end on the CPU: real ``python -m
hdbscan_tpu_torch serve --device cpu`` replica subprocesses behind the
port's router, each answer held bitwise to the reference's in-process
``Predictor`` on the same integer-grid artifact (ROADMAP's parity
standard). The legs twin ``tests/e2e/test_fleet_e2e.py`` and the fleet leg
of ``tests/e2e/test_obs_e2e.py``:

- **Re-warm** (in process): LRU thrash over tenants builds no kernel after
  the first warmup (on the CPU none ever builds), and every tenant answers
  as the reference's predictor.
- **Multi-tenant, through the command**: ``fleet --tenants-dir D
  fleet_replicas=2 --device cpu`` with ``consistent_hash``, an LRU of 2 and
  a quota: every tenant on the replica the reference's ring names, bitwise
  answers, evictions and per-replica series in the aggregated
  ``/metrics`` (``check_metrics.py``), 429 + ``Retry-After`` over quota, a
  client error for an unknown tenant, the router's trace through
  ``check_trace.py`` and ``--join`` with the replicas' traces, and exit 0
  on SIGTERM.
- **Chaos**: SIGKILL a replica under load: requests re-route in place, the
  replica respawns and replays its WAL with no acked ingest lost.
- **Elasticity**: scale up from one replica (the standby given the one
  build directory, healthy before ring admission, builds nothing), its
  answers bitwise, least-loaded spill under a burst, drain back down.
- **Fit-as-a-service**: four tenants served while a ``FitScheduler`` runs
  real fits on the CPU device and publishes through the registry's swap;
  a poisoned job fails alone, no request errors, no generation regresses,
  and every published generation answers as the reference's predictor.
- **Join**: every ``router_span`` joins exactly one replica
  ``request_span`` on the propagated ``X-Request-Id``.

Replicas get ``OMP_NUM_THREADS=1`` (the suite runs six workers).
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from hdbscan_tpu.fleet.router import FleetRouter as RefRouter
from hdbscan_tpu.serve import ClusterModel as RefModel
from hdbscan_tpu.serve.predict import Predictor as RefPredictor
from hdbscan_tpu_torch import HDBSCANParams, obs
from hdbscan_tpu_torch.fleet import ArtifactStore, FitScheduler, FleetRouter, TenantRegistry
from hdbscan_tpu_torch.models import hdbscan
from hdbscan_tpu_torch.utils.tracing import JsonlSink, Tracer
from scripts import check_metrics, check_trace
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CENTERS = np.asarray([(0.0, 0.0, 0.0), (24.0, 24.0, 24.0), (0.0, 32.0, 0.0)])
PARAMS = dict(min_points=5, min_cluster_size=25, processing_units=512)
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _grid(seed, n=360):
    rng = np.random.default_rng(seed)
    return np.round(CENTERS[np.arange(n) % 3] + rng.normal(0, 2.0, (n, 3)))


@pytest.fixture(scope="module")
def fleet_model(tmp_path_factory):
    """One small fitted artifact on an integer grid (the tenants are
    copies of it) and the queries."""
    pts = _grid(11)
    params = HDBSCANParams(**PARAMS)
    model = hdbscan.fit(pts, params, device="cpu").to_cluster_model(pts, params, device="cpu")
    path = model.save(str(tmp_path_factory.mktemp("fleet-model") / "model.npz"))
    return path, pts


def _want(path, X):
    """The reference's in-process answer, as the HTTP body rounds it."""
    labels, prob, score = RefPredictor(RefModel.load(path), max_batch=64).predict(np.asarray(X))
    return {"labels": labels.tolist(), "probabilities": [round(p, 6) for p in prob.tolist()],
            "outlier_scores": [round(s, 6) for s in score.tolist()]}


def _post(base, path, obj, headers=None, timeout=120):
    """POST returning (status, headers, body) without raising on 4xx/5xx."""
    req = urllib.request.Request(base + path, json.dumps(obj).encode(),
                                 {"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, {k.lower(): v for k, v in r.headers.items()}, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, {k.lower(): v for k, v in e.headers.items()}, json.loads(e.read() or b"{}")


def _get(base, path, timeout=30):
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        return r.read().decode()


def _same(out, want):
    return all(out[k] == want[k] for k in ("labels", "probabilities", "outlier_scores"))


def test_tenant_rewarm_builds_nothing_and_answers_as_reference(fleet_model, tmp_path):
    """LRU thrash over same-shaped tenants: after the first tenant's warmup
    no further load builds a kernel (``tenant_load.jit_compiles == 0``),
    and every answer is the reference predictor's."""
    from hdbscan_tpu_torch.utils.telemetry import compile_counter

    model_path, pts = fleet_model
    trace = str(tmp_path / "tenants.jsonl")
    tracer = Tracer(sinks=[JsonlSink(trace)])
    reg = TenantRegistry({f"t{i}": model_path for i in range(4)}, max_batch=64, lru_size=2,
                         tracer=tracer, device="cpu")
    X = pts[:16]
    want = RefPredictor(RefModel.load(model_path), max_batch=64).predict(X)
    reg.predict("t0", X)
    counter = compile_counter()
    before = counter()
    for tenant in ("t1", "t2", "t3", "t0", "t1"):  # loads, evicts, re-warms
        out, info = reg.predict(tenant, X)
        assert info["tenant"] == tenant
        for got, w in zip(out, want):
            np.testing.assert_array_equal(got, w)
    assert counter() - before == 0
    assert reg.generation("t0") == 2  # evicted, then re-warmed: a new generation
    tracer.close()
    events, errors = check_trace.validate_trace(trace)
    assert not errors, errors
    loads = [e for e in events if e["stage"] == "tenant_load"]
    evicts = [e for e in events if e["stage"] == "tenant_evict"]
    assert len(loads) >= 6 and evicts and all(e["resident"] <= 2 for e in evicts)
    assert all(e["jit_compiles"] == 0 for e in loads)


def _start_fleet_cli(argv, log_path, spool, timeout=120.0):
    """``python -m hdbscan_tpu_torch fleet ...`` in the background (the
    artifact spool under ``spool``); returns (process, base url) once it
    prints its address."""
    env = {**os.environ, **ONE_THREAD, "HDBSCAN_TPU_ARTIFACT_SPOOL": spool}
    log = open(log_path, "wb")
    proc = subprocess.Popen([sys.executable, "-m", "hdbscan_tpu_torch", "fleet", *argv],
                            cwd=REPO, stdout=log, stderr=log, stdin=subprocess.DEVNULL, env=env)
    log.close()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with open(log_path, encoding="utf-8", errors="replace") as f:
            m = re.search(r"hdbscan-tpu fleet: (http://[\d.]+:\d+) ", f.read())
        if m:
            return proc, m.group(1)
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    proc.kill()
    with open(log_path, encoding="utf-8", errors="replace") as f:
        pytest.fail(f"fleet did not start: {f.read()[-3000:]}")


def test_fleet_command_serves_every_tenant_as_the_reference(fleet_model, tmp_path):
    model_path, pts = fleet_model
    tenants = [f"t{i}" for i in range(8)]
    tdir = tmp_path / "tenants"
    tdir.mkdir()
    blob = open(model_path, "rb").read()
    for t in tenants:
        (tdir / f"{t}.npz").write_bytes(blob)
    # tenant t7 is another fit (seed 2): a tenant answers with its own model
    other = _grid(2)
    p = HDBSCANParams(**PARAMS)
    hdbscan.fit(other, p, device="cpu").to_cluster_model(other, p, device="cpu").save(
        str(tdir / "t7.npz"), compress=False)
    X = pts[:16].tolist()
    want = {t: _want(str(tdir / f"{t}.npz"), X) for t in tenants}
    ref_ring = RefRouter(model_path, replicas=2, policy="consistent_hash")
    ref_homes = {t: ref_ring._route_order("/predict", json.dumps(
        {"points": X, "tenant": t}).encode())[0].rid for t in tenants}

    trace, rdir = str(tmp_path / "router.jsonl"), str(tmp_path / "replicas")
    proc, base = _start_fleet_cli(
        ["--model", model_path, "--device", "cpu", "--tenants-dir", str(tdir),
         "--trace-out", trace, "--replica-trace-dir", rdir, "fleet_replicas=2",
         "fleet_policy=consistent_hash", "fleet_health_interval=2.0", "predict_batch=64",
         "tenant_lru=2", "tenant_quota=5", "artifact_store=shared",
         f"compile_cache={tmp_path / 'build'}", "autoscale=true", "fleet_min=2",
         "fleet_max=2"],
        str(tmp_path / "fleet.log"), str(tmp_path / "spool"))
    try:
        homes = {}
        for _ in range(2):  # round 2 re-touches: LRU churn on each replica
            for t in tenants:
                status, headers, out = _post(base, "/predict", {"points": X, "tenant": t})
                assert status == 200, out
                assert out["tenant"] == t and out["generation"] >= 1
                assert _same(out, want[t]), f"{t} differs from the reference's predictor"
                homes.setdefault(t, headers["x-replica"])
                assert headers["x-replica"] == homes[t], f"tenant {t} flapped replicas"
        assert homes == ref_homes  # the same md5 ring in both packages
        scrape = _get(base, "/metrics")
        parsed, errors = check_metrics.validate_exposition(scrape, "fleet")
        assert errors == [], errors
        samples = parsed["samples"]
        assert sum(v for (n, _), v in samples.items()
                   if n == "hdbscan_tpu_tenant_evictions_total") > 0
        assert {dict(lb)["replica"] for (n, lb), _ in samples.items()
                if n == "hdbscan_tpu_fleet_requests_total"} >= set(homes.values())
        assert any(n.startswith("hdbscan_tpu_artifact_") for n, _ in samples)
        codes, retry_after = [], None
        for _ in range(14):  # a burst of 5 rps per tenant per replica
            status, headers, _ = _post(base, "/predict", {"points": X[:1], "tenant": "t0"})
            codes.append(status)
            if status == 429:
                retry_after = headers.get("retry-after")
        assert 429 in codes and retry_after is not None and float(retry_after) > 0.0
        time.sleep(1.5)  # tokens refill
        assert _post(base, "/predict", {"points": X[:1], "tenant": "t0"})[0] == 200
        assert _post(base, "/predict", {"points": X, "tenant": "nope"})[0] in (400, 404)
        health = json.loads(_get(base, "/healthz"))
        assert health["status"] == "ok" and set(health["replicas"]) == {"0", "1"}
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    assert rc == 0  # a clean drain
    with open(tmp_path / "fleet.log", encoding="utf-8") as f:
        assert "autoscaler on [2, 2] replicas" in f.read()
    events, errors = check_trace.validate_trace(trace)
    assert not errors, errors
    routes = [e for e in events if e["stage"] == "fleet_route"]
    assert routes and all(e["policy"] == "consistent_hash" for e in routes)
    assert {e["status"] for e in routes} >= {200, 429}
    replicas = sorted(os.path.join(rdir, f) for f in os.listdir(rdir))
    assert len(replicas) == 2
    assert check_trace.join_fleet(trace, replicas) == 0
    for path in replicas:
        evs, errs = check_trace.validate_trace(path)
        assert not errs, errs
        assert any(e["stage"] == "artifact_map" for e in evs)


def test_fleet_chaos_sigkill_reroutes_and_replays_wal(fleet_model, tmp_path):
    model_path, pts = fleet_model
    trace = str(tmp_path / "chaos.jsonl")
    tracer = Tracer(sinks=[JsonlSink(trace)])
    rng = np.random.default_rng(3)
    want = _want(model_path, pts[:8].tolist())
    # A long probe interval: the requests, not a probe, find the dead
    # replica first, so the in-place re-route is what the trace records.
    router = FleetRouter(model_path, replicas=2, policy="least_loaded", health_interval_s=5.0,
                         ingest=True, wal_root=str(tmp_path / "wal"), device="cpu",
                         replica_args=["predict_batch=64"], replica_env=ONE_THREAD,
                         tracer=tracer, run_dir=str(tmp_path))
    with router:
        base = f"http://{router.host}:{router.port}"
        acked = {"0": 0, "1": 0}

        def ingest(n_rows=16):
            batch = np.round(CENTERS[np.arange(n_rows) % 3] + rng.normal(0, 2.0, (n_rows, 3)))
            status, headers, out = _post(base, "/ingest", {"points": batch.tolist()})
            if status == 200:
                acked[headers["x-replica"]] += out["rows"]
            return status

        for _ in range(6):  # least_loaded ties break by rid: replica 0, the victim
            assert ingest() == 200
        assert acked["0"] > 0
        outcomes = {"served": 0, "shed": 0, "failed": 0, "offered": 0, "other": 0}
        lock = threading.Lock()
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                status, _, out = _post(base, "/predict", {"points": pts[:8].tolist()})
                with lock:
                    outcomes["offered"] += 1
                    if status == 200:
                        outcomes["served"] += 1
                        outcomes["other"] += not _same(out, want)
                    elif status in (429, 503):
                        outcomes["shed"] += 1
                    else:
                        outcomes["failed"] += 1
                time.sleep(0.02)

        load = [threading.Thread(target=hammer, daemon=True) for _ in range(2)]
        for t in load:
            t.start()
        time.sleep(0.5)
        victim = router.replicas[0].proc
        os.kill(victim.pid, signal.SIGKILL)
        victim.wait(timeout=30)  # gone: its port now refuses
        t0 = time.monotonic()
        status, headers, _ = _post(base, "/predict", {"points": pts[:8].tolist()})
        assert status == 200 and headers["x-replica"] == "1"
        assert time.monotonic() - t0 < 2.0  # re-routed in place, not after a probe
        assert ingest() == 200  # an unsent ingest re-dispatches safely too
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            h = router.health()["replicas"]["0"]
            if h["restarts"] >= 1 and h["up"]:
                break
            time.sleep(0.25)
        else:
            pytest.fail(f"replica 0 never respawned: {router.health()}")
        health = json.loads(_get(f"http://127.0.0.1:{router.replicas[0].port}", "/healthz"))
        assert health["stream"]["wal"]["last_recover"]["rows"] == acked["0"], "acked rows lost"
        assert health["stream"]["rows_seen"] >= acked["0"]
        assert ingest() == 200
        stop.set()
        for t in load:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in load), "a request hung"
    assert router.drain_ok is True
    tracer.close()
    assert outcomes["offered"] > 0 and outcomes["other"] == 0
    assert outcomes["served"] + outcomes["shed"] + outcomes["failed"] == outcomes["offered"]
    assert outcomes["failed"] == 0 and outcomes["shed"] == 0, outcomes
    events, errors = check_trace.validate_trace(trace)
    assert not errors, errors
    routes = [e for e in events if e["stage"] == "fleet_route"]
    assert any(e["attempts"] > 1 and e["status"] == 200 for e in routes)
    probes = [e for e in events if e["stage"] == "replica_health"]
    assert any(not e["ok"] for e in probes) and any(e["restarts"] >= 1 for e in probes)


def test_fleet_scale_up_warm_spawn_and_scale_down(fleet_model, tmp_path):
    """The standby gets the one build directory (``compile_cache=<dir>``),
    is admitted only after a healthy probe with every bucket warmed and no
    build, answers bitwise, takes load, and drains back down."""
    model_path, pts = fleet_model
    trace = str(tmp_path / "scale.jsonl")
    tracer = Tracer(sinks=[JsonlSink(trace)])
    build = str(tmp_path / "build")
    X = pts[:16].tolist()
    want = _want(model_path, X)
    router = FleetRouter(model_path, replicas=1, policy="least_loaded", health_interval_s=0.3,
                         compile_cache=build, device="cpu", replica_args=["predict_batch=64"],
                         replica_env=ONE_THREAD, tracer=tracer, run_dir=str(tmp_path))
    with router:
        base = f"http://{router.host}:{router.port}"
        status, _, out = _post(base, "/predict", {"points": X})
        assert status == 200 and _same(out, want)
        h0 = json.loads(_get(f"http://127.0.0.1:{router.replicas[0].port}", "/healthz"))
        assert os.path.isdir(build)  # replica 0 opened the shared build directory
        rid = router.scale_up(reason="manual", timeout=120)
        assert rid == "1" and [r.rid for r in router.replicas] == ["0", "1"]
        assert router.health()["replicas"]["1"]["up"] is True
        assert f"compile_cache={build}" in router._replica_cmd(router.replicas[1])
        h1 = json.loads(_get(f"http://127.0.0.1:{router.replicas[1].port}", "/healthz"))
        assert h1["warmup"]["jit_compiles"] == 0, h1["warmup"]
        assert h1["warmup"]["buckets"] == h0["warmup"]["buckets"]
        status, _, out = _post(f"http://127.0.0.1:{router.replicas[1].port}", "/predict",
                               {"points": X})
        assert status == 200 and _same(out, want)
        served_by, burst_errors = set(), []
        lock = threading.Lock()

        def one_shot():
            status, headers, out = _post(base, "/predict", {"points": X})
            with lock:
                if status != 200 or not _same(out, want):
                    burst_errors.append((status, out))
                else:
                    served_by.add(headers["x-replica"])

        burst = [threading.Thread(target=one_shot) for _ in range(16)]
        for th in burst:
            th.start()
        for th in burst:
            th.join(timeout=60)
        assert burst_errors == [] and served_by == {"0", "1"}, (burst_errors[:3], served_by)
        parsed, errors = check_metrics.validate_exposition(_get(base, "/metrics"), "fleet")
        assert errors == [], errors
        assert sum(v for (n, lb), v in parsed["samples"].items()
                   if n == "hdbscan_tpu_scale_events_total"
                   and dict(lb) == {"direction": "up", "ok": "true"}) == 1
        assert router.scale_down(rid, reason="manual", timeout=60) is True
        assert [r.rid for r in router.replicas] == ["0"]
        status, headers, _ = _post(base, "/predict", {"points": X})
        assert status == 200 and headers["x-replica"] == "0"
        assert router.scale_down(reason="anchor", timeout=60) is False
    assert router.drain_ok is True
    tracer.close()
    events, errors = check_trace.validate_trace(trace)
    assert not errors, errors
    scales = [e for e in events if e["stage"] == "scale_event"]
    ups = [e for e in scales if e["direction"] == "up"]
    downs = [e for e in scales if e["direction"] == "down"]
    assert len(ups) == 1 and ups[0]["ok"] and ups[0]["replicas"] == 2
    assert len(downs) == 1 and downs[0]["ok"] and downs[0]["replicas"] == 1
    assert ups[0]["replica"] == downs[0]["replica"] == "1"


def test_fit_as_a_service_four_tenants_no_mixed_generations(fleet_model, tmp_path):
    """Real fits on the CPU device publish new generations through the
    registry's swap while four tenants are hammered: zero request errors,
    per-thread generations never regress, a poisoned job fails alone, and
    each published artifact answers as the reference's predictor."""
    model_path, pts = fleet_model
    trace = str(tmp_path / "fitsvc.jsonl")
    tracer = Tracer(sinks=[JsonlSink(trace)])
    tenants = [f"t{i}" for i in range(4)]
    store = ArtifactStore(spool_dir=str(tmp_path / "spool"), tracer=tracer)
    reg = TenantRegistry({t: model_path for t in tenants}, max_batch=64, lru_size=4,
                         tracer=tracer, artifact_store=store, device="cpu")
    sched = FitScheduler(str(tmp_path / "models"), params=HDBSCANParams(**PARAMS),
                         publish=lambda tenant, path, model: reg.swap(tenant, path),
                         workers=2, tracer=tracer, device="cpu")
    X = pts[:16]
    for t in tenants:
        reg.predict(t, X)
    errors_seen = []
    seen_gens = {(t, w): [] for t in tenants for w in range(3)}
    stop = threading.Event()

    def hammer(w):
        rng = np.random.default_rng(w)
        while not stop.is_set():
            t = tenants[rng.integers(len(tenants))]
            try:
                out, info = reg.predict(t, X)
                assert info["tenant"] == t and len(out[0]) == 16
                seen_gens[(t, w)].append(info["generation"])
            except Exception as exc:  # noqa: BLE001 — the assertion target
                errors_seen.append(f"{t}: {type(exc).__name__}: {exc}")
            time.sleep(0.002)

    threads = [threading.Thread(target=hammer, args=(w,), daemon=True) for w in range(3)]
    for th in threads:
        th.start()
    try:
        jobs = [sched.submit(t, _grid(29 + i), reason="drift") for i, t in enumerate(tenants)]
        poison = sched.submit("t0", np.array([["nope"] * 3] * 360))
        assert sched.join(timeout=300) is True
        time.sleep(0.3)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30)
        sched.close()
    assert not any(th.is_alive() for th in threads) and errors_seen == [], errors_seen[:5]
    for j in jobs:
        assert j.state == "published" and j.generation == 2, (j.job_id, j.state, j.error)
    assert poison.state == "failed" and poison.error
    assert sched.stats()["published"] == 4 and sched.stats()["failed"] == 1
    for (t, w), gens in seen_gens.items():
        assert gens == sorted(gens), f"{t} regressed in thread {w}: {gens}"
    for t, j in zip(tenants, jobs):
        out, info = reg.predict(t, X)
        assert info["generation"] == reg.generation(t) >= 2
        want = RefPredictor(RefModel.load(j.path), max_batch=64).predict(X)
        for got, w in zip(out, want):
            np.testing.assert_array_equal(got, w)
    tracer.close()
    events, errors = check_trace.validate_trace(trace)
    assert not errors, errors
    fit_events = [e for e in events if e["stage"] == "fit_job"]
    published = [e for e in fit_events if e["state"] == "published"]
    failed = [e for e in fit_events if e["state"] == "failed"]
    assert len(published) == 4 and {e["tenant"] for e in published} == set(tenants)
    assert all(e["generation"] == 2 for e in published)
    assert len(failed) == 1 and failed[0]["tenant"] == "t0"
    arts = [e for e in events if e["stage"] == "artifact_map"]
    assert sum(1 for e in arts if not e["hit"]) >= 1 and sum(1 for e in arts if e["hit"]) >= 3


def test_fleet_router_replica_join_is_complete(fleet_model, tmp_path):
    model_path, pts = fleet_model
    router_trace, replica_dir = str(tmp_path / "router.jsonl"), str(tmp_path / "replica-traces")
    tracer = Tracer(sinks=[JsonlSink(router_trace)])
    router = FleetRouter(model_path, replicas=2, policy="least_loaded", health_interval_s=0.5,
                         replica_args=["predict_batch=64"], replica_env=ONE_THREAD,
                         device="cpu", tracer=tracer, replica_trace_dir=replica_dir,
                         run_dir=str(tmp_path))
    X = pts[:8].tolist()
    seen_ids = []
    with router:
        base = f"http://{router.host}:{router.port}"
        for i in range(24):
            headers = {"X-Request-Id": f"client-{i}"} if i % 4 == 0 else {}
            status, rheaders, _ = _post(base, "/predict", {"points": X}, headers)
            assert status == 200 and rheaders["x-request-id"]
            if i % 4 == 0:
                assert rheaders["x-request-id"] == f"client-{i}"
            seen_ids.append(rheaders["x-request-id"])
    tracer.close()
    assert len(set(seen_ids)) == 24
    replica_traces = sorted(os.path.join(replica_dir, f) for f in os.listdir(replica_dir))
    assert len(replica_traces) == 2
    join = obs.merge_fleet_traces(router_trace, replica_traces)["join"]
    assert join["complete"] is True and join["matched"] == join["replied"] == 24
    assert join["orphans"] == [] and join["duplicates"] == []
    assert check_trace.join_fleet(router_trace, replica_traces) == 0
    events, errors = check_trace.validate_trace(router_trace)
    assert errors == [], errors
    assert {e["request_id"] for e in events if e["stage"] == "router_span"} == set(seen_ids)


def test_fleet_without_a_card_fails_instead_of_moving_to_the_cpu(fleet_model, tmp_path):
    """No ``--device`` means the card: with no card every replica exits
    (no fallback) and the fleet command fails with exit 2; the router never
    moves a replica to the CPU."""
    import torch

    from hdbscan_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the replicas would run on it")
    model_path, _ = fleet_model
    router = FleetRouter(model_path, replicas=1, run_dir=str(tmp_path))
    assert "--device" not in router._replica_cmd(router.replicas[0])
    rc = main(["fleet", "--model", model_path, "fleet_replicas=1",
               "fleet_health_interval=0.1", f"compile_cache={tmp_path / 'build'}"])
    assert rc == 2

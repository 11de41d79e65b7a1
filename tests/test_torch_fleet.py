"""The port's fleet routing, tenant registry and metrics aggregation
(``hdbscan_tpu_torch/fleet``, ``utils/metrics``) against the reference's
(``hdbscan_tpu/fleet``), without spawning replicas; each case runs both
packages on the same inputs:

- the consistent-hash ring places every tenant on the same replica id in
  both packages, stays stable, spreads tenants, moves ~1/N of keys when
  the fleet grows, and sends a down replica last;
- ``least_loaded`` orders replicas as the reference's does;
- ``_replica_environ`` pins a replica on the card to ``i % devices``
  through ``CUDA_VISIBLE_DEVICES`` (keyed off the replicas' device) and
  leaves CPU replicas alone; ``_replica_cmd`` runs the port's ``serve``,
  forwards ``--device`` and the shared build directory;
- ``close()`` SIGKILLs a replica that ignores SIGTERM past the drain bound;
- ``TenantRegistry`` under one fake clock emits the reference's LRU,
  generation, quota and SLO outcomes, and an evicted tenant's predictor
  leaves no reference behind;
- ``registry_from_exposition`` + ``merge`` of the same expositions render
  the same aggregate text in both packages.
"""

import gc
import json
import signal
import subprocess
import sys
import threading
import time
import weakref

import numpy as np
import pytest

from hdbscan_tpu import fleet as ref_fleet
from hdbscan_tpu.fault.policy import ShedRequest as RefShed
from hdbscan_tpu.utils import metrics as ref_metrics
from hdbscan_tpu_torch import fleet
from hdbscan_tpu_torch.fault.policy import ShedRequest
from hdbscan_tpu_torch.utils import metrics
from scripts import check_metrics
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401

PKGS = {"port": fleet, "ref": ref_fleet}


def _router(pkg=fleet, **kw):
    kw.setdefault("replicas", 4)
    return pkg.FleetRouter("/nonexistent/model.npz", **kw)


def _body(tenant=None, n=8):
    payload = {"points": [[0.0, 0.0, 0.0]] * n}
    if tenant is not None:
        payload["tenant"] = tenant
    return json.dumps(payload).encode()


def _first(router, body):
    return router._route_order("/predict", body)[0].rid


# -- constructor validation ----------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [
        {"replicas": 0},
        {"policy": "round_robin"},
        {"health_interval_s": 0.0},
        {"health_interval_s": -1.0},
        {"drain_s": 0.0},
        {"devices": 2, "device": "cuda:1"},
    ],
)
def test_router_ctor_rejects_bad_knobs(kw):
    with pytest.raises(ValueError):
        _router(**kw)
    if "device" not in kw:  # the port's own knob
        with pytest.raises(ValueError):
            _router(ref_fleet, **kw)
    assert fleet.POLICIES == ref_fleet.POLICIES


# -- consistent-hash ring ------------------------------------------------------


def test_ring_same_tenant_same_replica():
    port, ref = (_router(p, policy="consistent_hash") for p in (fleet, ref_fleet))
    for tenant in ("acme", "globex", "t0", "t1"):
        first = {_first(port, _body(tenant)) for _ in range(5)}
        assert len(first) == 1, f"tenant {tenant!r} flapped across {first}"
        assert first == {_first(ref, _body(tenant))}


def test_ring_spreads_tenants_and_falls_back_to_body_digest():
    port, ref = (_router(p, policy="consistent_hash") for p in (fleet, ref_fleet))
    placed = [_first(port, _body(f"tenant-{i}")) for i in range(64)]
    assert placed == [_first(ref, _body(f"tenant-{i}")) for i in range(64)]
    assert len(set(placed)) == len(port.replicas)  # every replica owns keys
    # no tenant field: the key is a digest of the body, the same in both
    assert _first(port, _body(None, n=4)) == _first(port, _body(None, n=4))
    rng = np.random.default_rng(0)
    for _ in range(16):
        body = json.dumps({"points": rng.integers(0, 60, (3, 3)).tolist()}).encode()
        assert _first(port, body) == _first(ref, body)
    # integer tenant ids hash like their decimal string
    ibody = json.dumps({"tenant": 7, "points": []}).encode()
    sbody = json.dumps({"tenant": "7", "points": []}).encode()
    assert _first(port, ibody) == _first(port, sbody) == _first(ref, ibody)


def test_ring_growth_moves_few_keys():
    """Adding a replica re-homes ~1/N of tenants, the same ones in both
    packages."""
    keys = [f"tenant-{i}" for i in range(400)]
    moved = {}
    for name, pkg in PKGS.items():
        small = _router(pkg, replicas=4, policy="consistent_hash")
        big = _router(pkg, replicas=5, policy="consistent_hash")
        moved[name] = [k for k in keys if _first(small, _body(k)) != _first(big, _body(k))]
    assert moved["port"] == moved["ref"]
    assert 0 < len(moved["port"]) < len(keys) // 2


def test_ring_down_replica_goes_last_but_stays_probed():
    router = _router(policy="consistent_hash")
    for r in router.replicas:
        router._mark(r, True)
    body = _body("sticky")
    owner = router._route_order("/predict", body)[0]
    router._mark(owner, False)
    order = router._route_order("/predict", body)
    assert order[0].rid != owner.rid
    assert order[-1].rid == owner.rid  # still probed if everything else dies
    router._mark(owner, True)
    assert router._route_order("/predict", body)[0].rid == owner.rid


def test_rebuild_ring_tracks_membership():
    orders = {}
    for name, pkg in PKGS.items():
        router = _router(pkg, replicas=3, policy="consistent_hash")
        router.replicas = router.replicas[:2]
        router._rebuild_ring()
        orders[name] = [r.rid for r in router._route_order("/predict", _body("acme"))]
    assert orders["port"] == orders["ref"] and sorted(orders["port"]) == ["0", "1"]


# -- least-loaded ordering -----------------------------------------------------


def test_least_loaded_orders_by_inflight_then_failures():
    got = {}
    for name, pkg in PKGS.items():
        router = _router(pkg, policy="least_loaded")
        r0, r1, r2, r3 = router.replicas
        for r in router.replicas:
            r.up = True
        r0.in_flight, r1.in_flight, r2.in_flight, r3.in_flight = 3, 0, 0, 1
        r1.failures, r2.failures = 2, 0
        first = [r.rid for r in router._route_order("/predict", _body())]
        r2.up = False  # down: last despite zero load
        got[name] = (first, [r.rid for r in router._route_order("/predict", _body())])
    assert got["port"] == got["ref"] == (["2", "1", "3", "0"], ["1", "3", "0", "2"])


# -- device pinning and the replica's command ----------------------------------


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_replica_environ_pins_devices(device):
    """Replicas on the card get CUDA_VISIBLE_DEVICES = i % devices, keyed
    off their device (None is the card); TPU_VISIBLE_CHIPS is gone."""
    router = _router(replicas=4, devices=2, device=device,
                     replica_env={"JAX_PLATFORMS": "tpu"})
    envs = [router._replica_environ(r) for r in router.replicas]
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1", "0", "1"]
    for r, env in zip(router.replicas, envs):
        assert env["HDBSCAN_TPU_REPLICA_ID"] == r.rid
        assert "TPU_VISIBLE_CHIPS" not in env


def test_replica_environ_cpu_leaves_devices_alone(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    for kw in ({"device": "cpu", "devices": 2},
               {"device": "cpu", "devices": 2, "replica_env": {"JAX_PLATFORMS": "cuda"}},
               {"device": None}):
        env = _router(**kw)._replica_environ(_router(**kw).replicas[0])
        assert "CUDA_VISIBLE_DEVICES" not in env and "TPU_VISIBLE_CHIPS" not in env


def test_replica_cmd_runs_the_port_and_forwards_device_and_build_dir(tmp_path):
    """The replica is ``python -m hdbscan_tpu_torch serve`` with the
    router's ``--device`` and the one build directory as
    ``compile_cache=<dir>`` (no environment variable); an explicit
    ``compile_cache=`` in the replica args wins, and with the cache off
    each replica follows its own knob."""
    from hdbscan_tpu_torch.ops import cuda_build

    build = str(tmp_path / "build")
    router = _router(compile_cache=build, device="cpu", tenants_dir="/t",
                     replica_args=["predict_batch=64"])
    r = router.replicas[1]
    cmd = router._replica_cmd(r)
    assert cmd[:4] == [sys.executable, "-m", "hdbscan_tpu_torch", "serve"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert cmd[cmd.index("--tenants-dir") + 1] == "/t"
    assert cmd[-2:] == ["predict_batch=64", f"compile_cache={build}"]
    env = router._replica_environ(r)
    assert not any(k.startswith("JAX_COMPILATION") for k in env)
    auto = _router()
    assert f"compile_cache={cuda_build.BUILD_DIR}" in auto._replica_cmd(auto.replicas[0])
    assert "--device" not in auto._replica_cmd(auto.replicas[0])  # the card
    mine = _router(compile_cache=build, replica_args=["compile_cache=/elsewhere"])
    assert [a for a in mine._replica_cmd(mine.replicas[0]) if a.startswith("compile_cache=")] \
        == ["compile_cache=/elsewhere"]
    off = _router(compile_cache="off")
    assert not any(a.startswith("compile_cache=") for a in off._replica_cmd(off.replicas[0]))


# -- close() drain bound -------------------------------------------------------


def _attach_proc(router, code):
    r = router.replicas[0]
    r.proc = subprocess.Popen([sys.executable, "-c", code])
    return r


def test_close_reports_dirty_drain_on_sigterm_ignorer():
    """A replica that shrugs off SIGTERM is SIGKILLed at the drain bound
    and close() returns False — serve_forever turns that into exit 1."""
    router = _router(replicas=1)
    r = _attach_proc(
        router,
        "import signal, time\n"
        "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
        "time.sleep(120)\n",
    )
    time.sleep(0.3)  # let the child install its handler
    t0 = time.monotonic()
    assert router.close(drain_s=0.5) is False
    assert time.monotonic() - t0 < 10.0
    assert r.proc.poll() is not None  # SIGKILLed, not leaked
    assert router.drain_ok is False
    assert router.close() is False  # the first verdict sticks


def test_close_clean_drain_returns_true():
    router = _router(replicas=1)
    r = _attach_proc(router, "import time; time.sleep(120)")
    assert router.close(drain_s=10.0) is True
    assert r.proc.returncode == -signal.SIGTERM
    assert router.drain_ok is True


# -- TenantRegistry ------------------------------------------------------------


class _FakeModel:
    def __init__(self, path):
        self.path = path
        self.selected_ids = np.arange(3)

    @classmethod
    def load(cls, path):
        return cls(path)


class _FakePredictor:
    max_bucket = 64

    def __init__(self, model, **kw):
        self.model = model
        self.kw = kw

    def warmup(self):
        return {"jit_compiles": 0}

    def bucket_for(self, n):
        return 16

    def predict(self, X, with_membership=False):
        n = len(X)
        return np.full(n, 1), np.full(n, 0.5)


@pytest.fixture
def fake_serving(monkeypatch):
    """Both registries load through serve.artifact / serve.predict at call
    time: cheap fakes run the LRU, quota and generation logic."""
    from hdbscan_tpu.serve import artifact as ref_art
    from hdbscan_tpu.serve import predict as ref_pred
    from hdbscan_tpu_torch.serve import artifact, predict

    for mod in (artifact, ref_art):
        monkeypatch.setattr(mod, "ClusterModel", _FakeModel)
    for mod in (predict, ref_pred):
        monkeypatch.setattr(mod, "Predictor", _FakePredictor)


class _ListTracer:
    def __init__(self):
        self.events = []

    def __call__(self, stage, **fields):
        fields.pop("wall_s", None)  # a timing
        self.events.append({"stage": stage, **fields})


def _registry(pkg=fleet, n_tenants=4, **kw):
    paths = {f"t{i}": f"/fake/t{i}.npz" for i in range(n_tenants)}
    return pkg.TenantRegistry(paths, **kw)


def test_tenant_registry_rejects_bad_knobs():
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="lru_size"):
            _registry(pkg, lru_size=0)
        with pytest.raises(ValueError, match="quota_rps"):
            _registry(pkg, quota_rps=-1.0)
        with pytest.raises(ValueError, match="quota_rps"):
            _registry(pkg, quota_rps=float("inf"))


def test_tenant_lru_evicts_coldest_and_rewarm_bumps_generation(fake_serving):
    """The same touches give the reference's trace events, resident order
    and generations; the port's predictors get the registry's device."""
    seen = {}
    for name, pkg in PKGS.items():
        tracer = _ListTracer()
        kw = {"device": "cpu"} if pkg is fleet else {}
        reg = _registry(pkg, lru_size=2, tracer=tracer, **kw)
        for t in ("t0", "t1", "t0", "t2"):
            reg.checkout(t)
        assert reg.resident() == ["t0", "t2"]
        assert reg.checkout("t1").generation == 2  # re-warm: a NEW generation
        with pytest.raises(KeyError, match="t99"):
            reg.checkout("t99")
        seen[name] = (tracer.events, reg.stats(), reg.generation("t0"))
        if pkg is fleet:
            assert reg.checkout("t1").predictor.kw["device"] == "cpu"
    assert seen["port"][0] == seen["ref"][0]
    assert seen["port"][1:] == seen["ref"][1:]
    evicts = [e for e in seen["port"][0] if e["stage"] == "tenant_evict"]
    assert [e["tenant"] for e in evicts] == ["t1", "t0"]
    assert evicts[0]["generation"] == 1 and evicts[0]["requests"] == 1
    assert evicts[0]["resident"] == 2


def test_tenant_quota_sheds_429_with_retry_hint(fake_serving):
    """One fake clock: the same sheds, Retry-After hints and stats."""
    out = {}
    for name, pkg in PKGS.items():
        clock = [1000.0]
        reg = _registry(pkg, lru_size=4, quota_rps=2.0, clock=lambda: clock[0])
        log = []
        for t, dt in (("t0", 0.0), ("t0", 0.1), ("t0", 0.1), ("t1", 0.0), ("t0", 0.3),
                      ("t0", 0.5), ("t0", 0.0)):
            clock[0] += dt
            try:
                reg.checkout(t)
                log.append((t, "ok"))
            except (ShedRequest, RefShed) as e:
                assert type(e) is (ShedRequest if pkg is fleet else RefShed)
                log.append((t, e.status, e.reason, round(e.retry_after_s, 12)))
        out[name] = (log, reg.stats())
    assert out["port"] == out["ref"]
    assert ("t0", 429, "tenant_quota") in [x[:3] for x in out["port"][0]]
    assert all(x[3] > 0 for x in out["port"][0] if len(x) == 4)
    assert out["port"][1]["shed"]["t0"] >= 1


def test_tenant_predict_info_and_slo_verdicts(fake_serving):
    got = {}
    for name, pkg in PKGS.items():
        reg = _registry(pkg, lru_size=4)
        X = np.zeros((8, 3))
        out, info = reg.predict("t0", X)
        assert len(out[0]) == 8 and "selected_ids" not in info
        _, minfo = reg.predict("t0", X, with_membership=True)
        verdicts = reg.slo_verdicts()
        for v in verdicts.values():  # latencies are timings
            v["observed"] = {k: x for k, x in v["observed"].items() if not k.endswith("_s")}
            v["targets"] = {k: (t["max"], t["ok"]) for k, t in v["targets"].items()}
        got[name] = (info, minfo, verdicts)
    assert got["port"] == got["ref"]
    info, minfo, verdicts = got["port"]
    assert info == {"tenant": "t0", "generation": 1, "bucket": 16}
    assert minfo["selected_ids"] == [0, 1, 2]
    assert verdicts["t0"]["ok"] is True and verdicts["t0"]["observed"]["requests"] == 2
    assert fleet.DEFAULT_TENANT_SLO == ref_fleet.DEFAULT_TENANT_SLO


def test_tenant_swap_replaces_resident_and_bumps_generation(fake_serving):
    for pkg in PKGS.values():
        reg = _registry(pkg, lru_size=4)
        e1 = reg.checkout("t0")
        e2 = reg.swap("t0", "/fake/t0-v2.npz")
        assert e2.generation == e1.generation + 1
        assert reg.checkout("t0").model.path == "/fake/t0-v2.npz"


def test_from_dir_requires_artifacts(tmp_path):
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="no .npz"):
            pkg.TenantRegistry.from_dir(str(tmp_path))
    (tmp_path / "acme.npz").write_bytes(b"x")
    (tmp_path / "notes.txt").write_bytes(b"x")
    assert fleet.TenantRegistry.from_dir(str(tmp_path)).tenants() == ["acme"]


def test_tenant_concurrent_predict_under_eviction_churn(fake_serving):
    """8 tenants hammering a 3-slot LRU from 4 threads: zero errors,
    per-thread generations never regress, the LRU bound holds."""
    tracer = _ListTracer()
    reg = _registry(n_tenants=8, lru_size=3, tracer=tracer)
    errors = []
    seen_gens = {(f"t{i}", w): [] for i in range(8) for w in range(4)}

    def hammer(worker):
        rng = np.random.default_rng(worker)
        X = np.zeros((4, 3))
        for _ in range(60):
            tenant = f"t{rng.integers(0, 8)}"
            try:
                _, info = reg.predict(tenant, X)
            except Exception as exc:  # noqa: BLE001 — the assert below
                errors.append((tenant, repr(exc)))
                continue
            seen_gens[(tenant, worker)].append(info["generation"])

    threads = [threading.Thread(target=hammer, args=(w,), daemon=True) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert errors == []
    for (tenant, worker), gens in seen_gens.items():
        assert gens == sorted(gens), f"{tenant} regressed in thread {worker}: {gens}"
    assert {t for (t, _), g in seen_gens.items() if g} == {f"t{i}" for i in range(8)}
    evicts = [e for e in tracer.events if e["stage"] == "tenant_evict"]
    assert evicts and all(1 <= e["resident"] <= 3 for e in evicts)
    assert len(reg.resident()) <= 3
    assert len([e for e in tracer.events if e["stage"] == "tenant_load"]) > 8
    assert sum(reg.stats()["requests"].values()) == 4 * 60


def test_evicted_tenant_leaves_no_reference_behind(tmp_path):
    """Eight real tenants through an LRU of two, with metrics, a tracer and
    the artifact store attached: only the resident tenants' predictors
    (and so their device tables) stay alive — an evicted one is collected
    with nothing left pinning it."""
    from hdbscan_tpu_torch.config import HDBSCANParams
    from hdbscan_tpu_torch.models import exact
    from hdbscan_tpu_torch.utils.tracing import Tracer

    rng = np.random.default_rng(5)
    x = rng.integers(0, 40, size=(300, 3)).astype(np.float64)
    p = HDBSCANParams(min_points=5, min_cluster_size=20)
    path = exact.fit(x, p, device="cpu").to_cluster_model(x, p).save(
        str(tmp_path / "m.npz"), compress=False)
    reg = fleet.TenantRegistry(
        {f"t{i}": path for i in range(8)}, max_batch=16, lru_size=2, device="cpu",
        metrics=metrics.MetricsRegistry(), tracer=Tracer(),
        artifact_store=fleet.ArtifactStore(spool_dir=str(tmp_path / "spool")))
    refs = []
    for i in range(8):
        out, _ = reg.predict(f"t{i}", x[:4])
        assert len(out[0]) == 4
        refs.append(weakref.ref(reg.checkout(f"t{i}").predictor))
    gc.collect()
    alive = [i for i, r in enumerate(refs) if r() is not None]
    assert alive == [6, 7] and reg.resident() == ["t6", "t7"]


# -- metrics aggregation -------------------------------------------------------


def _replica_registry(mod, rid, routes):
    reg = mod.MetricsRegistry()
    c = reg.counter("t_requests_total", "reqs", labelnames=("route", "status"))
    g = reg.gauge("t_in_flight", "inflight")
    h = reg.histogram("t_latency_seconds", "lat", labelnames=("route",),
                      buckets=mod.DEFAULT_LATENCY_BUCKETS)
    for i, route in enumerate(routes):
        c.inc(10 * (int(rid) + 1) + i, route=route, status="200")
        for v in (0.001 * (int(rid) + 1), 0.02, 0.3, 1e6):
            h.observe(v, route=route)
    g.set(float(rid))
    return reg


def test_fleet_merge_n_registries_overlapping_and_disjoint_labels():
    """The router's aggregation: the same N replica expositions, re-parsed
    with a ``replica`` label and folded into one registry, render the same
    text in both packages; nothing collides, nothing is lost."""
    routes = {"0": ("/predict", "/ingest"), "1": ("/predict",), "2": ("/swap",)}
    scrapes = {rid: _replica_registry(ref_metrics, rid, r).render()
               for rid, r in routes.items()}
    renders = {}
    for name, mod in (("port", metrics), ("ref", ref_metrics)):
        agg = mod.MetricsRegistry()
        agg.counter("t_requests_total", "reqs",
                    labelnames=("replica", "route", "status")).inc(
            1, replica="router", route="/predict", status="503")
        for rid, text in scrapes.items():
            agg.merge(mod.registry_from_exposition(text, {"replica": rid}))
        renders[name] = agg.render()
        c = agg.get("t_requests_total")
        assert c.value(replica="0", route="/predict", status="200") == 10.0
        assert c.value(replica="2", route="/swap", status="200") == 30.0
        assert c.value(replica="router", route="/predict", status="503") == 1.0
        g = agg.get("t_in_flight")
        assert [g.value(replica=r) for r in "012"] == [0.0, 1.0, 2.0]
    assert renders["port"] == renders["ref"]
    parsed, errors = check_metrics.validate_exposition(renders["port"], "agg")
    assert errors == []
    for (name, labels), _ in parsed["samples"].items():
        assert dict(labels).get("replica"), (name, labels)


def test_fleet_merge_histogram_state_exact():
    """Histogram folding through the text round trip is exact at bucket
    resolution and equal in both packages: counts, sums, the overflow
    bucket's max (+Inf after a parse) and nearest-rank quantiles."""
    scrapes = {rid: _replica_registry(ref_metrics, rid, ("/predict",)).render()
               for rid in "012"}
    out = {}
    for name, mod in (("port", metrics), ("ref", ref_metrics)):
        agg = mod.MetricsRegistry()
        for rid, text in scrapes.items():
            agg.merge(mod.registry_from_exposition(text, {"replica": rid}))
        flat = mod.registry_from_exposition(scrapes["0"])
        flat.merge(mod.registry_from_exposition(scrapes["1"]))
        fh, h = flat.get("t_latency_seconds"), agg.get("t_latency_seconds")
        assert fh.count(route="/predict") == 8
        assert fh.total(route="/predict") == pytest.approx(
            (0.001 + 0.02 + 0.3 + 1e6) + (0.002 + 0.02 + 0.3 + 1e6))
        out[name] = (agg.render(), flat.render(),
                     [h.quantile(q, replica="1", route="/predict") for q in (0.5, 0.75, 1.0)],
                     [fh.quantile(q, route="/predict") for q in (0.25, 0.5, 1.0)])
    assert out["port"] == out["ref"]
    assert out["port"][2][-1] == float("inf")  # the overflow bucket's max


def test_registry_from_exposition_rejects_garbage():
    for mod in (metrics, ref_metrics):
        with pytest.raises(ValueError, match="unparseable"):
            mod.registry_from_exposition("# TYPE x counter\nx{a=\"1\"} 1 2 3\n")
        with pytest.raises(ValueError, match="no preceding"):
            mod.registry_from_exposition("y 1\n")
        assert mod.registry_from_exposition(
            '# TYPE z gauge\nz{q="a\\"b\\\\c"} 2\n').get("z").value(q='a"b\\c') == 2.0

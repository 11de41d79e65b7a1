"""The port's fleet control plane (``hdbscan_tpu_torch/fleet``: the
autoscaler, the artifact store, the fit scheduler, the router's scaling
seams) against the reference's, without replicas, and the kernel build's
thread safety (``ops/cuda_build``):

- ``Autoscaler.decide`` and ``tick`` give the reference's decisions on the
  same sequence of signals (hysteresis, bounds, cooldown);
- ``ArtifactStore`` keys by content digest, maps the spool, falls back to
  ``ClusterModel.load`` on a corrupt spool; a spool either package writes
  loads in the other, and a ``compress=False`` artifact from either
  package loads in both;
- ``FitScheduler`` walks queued → running → published|failed once per
  job, sheds over quota (429) and over its bound (503), isolates a failed
  fit, and runs the real dense fit on its ``device``;
- the router's ``signals``, ``_free_rid`` and scale ops without a loop
  answer as the reference's;
- two threads that first reach one kernel source together build it once
  and load it once.
"""

import os
import stat
import threading
import time
import types

import numpy as np
import pytest

from hdbscan_tpu import fleet as ref_fleet
from hdbscan_tpu.fault.policy import ShedRequest as RefShed
from hdbscan_tpu.fleet.artifacts import file_digest as ref_file_digest
from hdbscan_tpu_torch import HDBSCANParams
from hdbscan_tpu_torch.fault.policy import ShedRequest
from hdbscan_tpu_torch.fleet import ArtifactStore, Autoscaler, FitScheduler, FleetRouter
from hdbscan_tpu_torch.fleet.artifacts import file_digest
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


class _ListTracer:
    def __init__(self):
        self.events = []

    def __call__(self, stage, **fields):
        self.events.append({"stage": stage, **fields})


# -- Autoscaler ----------------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [
        {"min_replicas": 0},
        {"min_replicas": 3, "max_replicas": 2},
        {"high_load": 1.0, "low_load": 1.0},
        {"up_after": 0},
        {"interval_s": 0.0},
        {"cooldown_s": -1.0},
    ],
)
def test_autoscaler_rejects_bad_knobs(kw):
    for cls in (Autoscaler, ref_fleet.Autoscaler):
        with pytest.raises(ValueError):
            cls(router=None, **kw)


def _scaler(cls=Autoscaler, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("high_load", 4.0)
    kw.setdefault("low_load", 0.5)
    kw.setdefault("up_after", 2)
    kw.setdefault("down_after", 3)
    return cls(router=None, **kw)


def _sig(replicas=2, load=1.0, p99=None):
    out = {"replicas": replicas, "in_flight_per_up": load}
    if p99 is not None:
        out["p99_s"] = p99
    return out


def test_decide_needs_consecutive_hot_ticks():
    s = _scaler(up_after=3)
    assert s.decide(_sig(load=9.0)) is None
    assert s.decide(_sig(load=9.0)) is None
    assert s.decide(_sig(load=9.0)) == ("up", "queue_depth")
    assert s.decide(_sig(load=9.0)) is None  # the streak resets after firing


def test_decide_contrary_tick_resets_streak():
    s = _scaler(up_after=2)
    assert s.decide(_sig(load=9.0)) is None
    assert s.decide(_sig(load=1.0)) is None  # a cool tick wipes the vote
    assert s.decide(_sig(load=9.0)) is None
    assert s.decide(_sig(load=9.0)) == ("up", "queue_depth")


def test_decide_down_is_slower_and_bounded():
    s = _scaler(down_after=3)
    assert s.decide(_sig(load=0.0)) is None
    assert s.decide(_sig(load=0.0)) is None
    assert s.decide(_sig(load=0.0)) == ("down", "idle")
    for _ in range(10):  # at min_replicas the idle fleet never shrinks
        assert s.decide(_sig(replicas=1, load=0.0)) is None


def test_decide_respects_max_replicas():
    s = _scaler(up_after=1)
    for _ in range(5):
        assert s.decide(_sig(replicas=4, load=9.0)) is None


def test_decide_p99_signal_votes_up_and_vetoes_down():
    s = _scaler(up_after=2, high_p99_s=0.2)
    assert s.decide(_sig(load=1.0, p99=0.5)) is None
    assert s.decide(_sig(load=1.0, p99=0.5)) == ("up", "p99")
    assert _scaler(down_after=1, high_p99_s=0.2).decide(_sig(load=0.0, p99=0.5)) is None
    assert _scaler(down_after=1, high_p99_s=0.0).decide(
        _sig(load=0.0, p99=0.5)) == ("down", "idle")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decide_equals_reference_on_a_signal_sequence(seed):
    """500 seeded signals in bursts (replica counts, loads, p99s, absent
    p99s) give the reference's decision at every tick."""
    rng = np.random.default_rng(seed)
    kw = dict(min_replicas=1, max_replicas=int(rng.integers(2, 6)), high_load=3.0,
              low_load=0.5, high_p99_s=float(rng.choice([0.0, 0.2])),
              up_after=int(rng.integers(1, 4)), down_after=int(rng.integers(1, 6)))
    port, ref = _scaler(**kw), _scaler(ref_fleet.Autoscaler, **kw)
    decisions = []
    while len(decisions) < 500:  # bursts of one regime, 1-8 ticks each
        sig = _sig(replicas=int(rng.integers(1, 7)), load=float(rng.choice([0.0, 0.2, 1.0, 5.0])),
                   p99=None if rng.random() < 0.3 else float(rng.choice([0.05, 0.4])))
        for _ in range(int(rng.integers(1, 9))):
            decisions.append(port.decide(sig))
            assert decisions[-1] == ref.decide(sig)
    assert {d[0] for d in decisions if d} == {"up", "down"}


class _FakeScalingRouter:
    def __init__(self, replicas=2, load=9.0):
        self.replicas = list(range(replicas))
        self.load = load
        self.ups = 0
        self.downs = 0

    def signals(self):
        return {"replicas": len(self.replicas), "in_flight_per_up": self.load}

    def scale_up(self, reason="manual", timeout=None):
        self.ups += 1
        self.replicas.append(len(self.replicas))
        return str(len(self.replicas) - 1)

    def scale_down(self, rid=None, reason="manual", timeout=None):
        self.downs += 1
        self.replicas.pop()
        return True


def test_tick_scales_and_holds_through_cooldown():
    router = _FakeScalingRouter(replicas=2, load=9.0)
    s = Autoscaler(router, up_after=1, cooldown_s=30.0)
    assert s.tick(now=0.0) == ("up", "queue_depth")
    assert router.ups == 1 and s.scaled_up == 1
    assert s.tick(now=0.0) is None  # cooldown
    assert router.ups == 1
    s._hold_until = 0.0
    assert s.tick(now=0.0) == ("up", "queue_depth")
    assert router.ups == 2


def test_tick_scales_down_idle_fleet():
    got = []
    for cls in (Autoscaler, ref_fleet.Autoscaler):
        router = _FakeScalingRouter(replicas=3, load=0.0)
        s = cls(router, down_after=2, cooldown_s=0.0)
        got.append(([s.tick(now=0.0), s.tick(now=0.0)], router.downs, s.stats()))
    assert got[0] == got[1]
    assert got[0][0] == [None, ("down", "idle")] and got[0][1] == 1


def test_autoscaler_loop_grows_to_min_replicas():
    router = _FakeScalingRouter(replicas=1, load=1.0)
    s = Autoscaler(router, min_replicas=3, interval_s=0.05)
    s.start()
    try:
        deadline = time.monotonic() + 5.0
        while len(router.replicas) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        s.stop()
    assert len(router.replicas) == 3
    assert s.stats()["scaled_up"] == 2 and s.stats()["running"] is False


# -- ArtifactStore -------------------------------------------------------------


@pytest.fixture(scope="module")
def saved_model(tmp_path_factory):
    """One port fit on an integer grid, saved uncompressed twice (byte
    identical), once compressed, and once by the reference package from
    the port's arrays."""
    from hdbscan_tpu.serve.artifact import ClusterModel as RefModel
    from hdbscan_tpu_torch.models import exact

    rng = np.random.default_rng(7)
    data = np.round(np.vstack([rng.normal(c, 2.0, size=(60, 3)) for c in (0.0, 30.0, 60.0)]))
    params = HDBSCANParams(min_points=8, min_cluster_size=8)
    model = exact.fit(data, params, device="cpu").to_cluster_model(data, params)
    root = tmp_path_factory.mktemp("artifacts")
    a = model.save(str(root / "acme.npz"), compress=False)
    b = model.save(str(root / "globex.npz"), compress=False)
    c = model.save(str(root / "zipped.npz"))
    fields = {k: getattr(model, k) for k in (
        "mode", "params", "fingerprint", "data", "core", "labels", "last_cluster", "parent",
        "birth", "selected", "sel_anc", "eps_min", "eps_max", "schema", "rpf")}
    r = RefModel(**fields).save(str(root / "ref_raw.npz"), compress=False)
    return data, params, model, a, b, c, r


def _arrays(m):
    return [np.asarray(getattr(m, k)) for k in (
        "data", "core", "labels", "last_cluster", "parent", "birth", "selected", "sel_anc",
        "eps_min", "eps_max")]


def _same_model(m1, m2):
    assert (m1.mode, m1.params, m1.fingerprint, m1.schema) == (
        m2.mode, m2.params, m2.fingerprint, m2.schema)
    for x, y in zip(_arrays(m1), _arrays(m2)):
        np.testing.assert_array_equal(x, y)


def test_store_dedups_byte_identical_artifacts(saved_model, tmp_path):
    data, _, _, a, b, *_ = saved_model
    assert file_digest(a) == file_digest(b) == ref_file_digest(a)
    tracer = _ListTracer()
    store = ArtifactStore(spool_dir=str(tmp_path / "spool"), tracer=tracer)
    m1, m2, m3 = store.load(a), store.load(b), store.load(a)
    assert m1 is m2 and m1 is m3
    np.testing.assert_array_equal(np.asarray(m1.data), data)
    hits = [e["hit"] for e in tracer.events if e["stage"] == "artifact_map"]
    assert hits == [False, True, True]  # the miss-then-hits check_trace pins
    assert tracer.events[0]["spooled"] is True
    stats = store.stats()
    assert stats["resident"] == 1 and stats["resident_bytes"] > 0
    assert stats["refs"][file_digest(a)] == 3


def test_store_mmaps_spooled_members(saved_model, tmp_path):
    a = saved_model[3]
    arr = np.asarray(ArtifactStore(spool_dir=str(tmp_path / "spool")).load(a).data)
    assert isinstance(arr, np.memmap) or isinstance(arr.base, np.memmap)
    arr2 = np.asarray(ArtifactStore(spool_dir=str(tmp_path / "s2"), mmap=False).load(a).data)
    assert not isinstance(arr2, np.memmap)


def test_store_second_instance_reuses_spool(saved_model, tmp_path):
    a = saved_model[3]
    spool = str(tmp_path / "spool")
    ArtifactStore(spool_dir=spool).load(a)
    tracer = _ListTracer()
    model = ArtifactStore(spool_dir=spool, tracer=tracer).load(a)
    assert tracer.events[0]["hit"] is False and tracer.events[0]["spooled"] is False
    assert model.summary()["n_train"] == 180


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_spool_written_by_either_package_loads_in_the_other(saved_model, tmp_path, writer):
    """Both packages resolve one default spool directory and share its
    layout: the store that did not write the spool maps it (no re-spool),
    and its model equals the artifact's."""
    _, _, model, a, *_ = saved_model
    spool = str(tmp_path / "spool")
    first, second = ((ArtifactStore, ref_fleet.ArtifactStore) if writer == "port"
                     else (ref_fleet.ArtifactStore, ArtifactStore))
    first(spool_dir=spool).load(a)
    assert sorted(os.listdir(os.path.join(spool, file_digest(a)))) == sorted(
        ["meta.json"] + [f"{k}.npy" for k in (
            "data", "core", "labels", "last_cluster", "parent", "birth", "selected",
            "sel_anc", "eps_min", "eps_max")])
    tracer = _ListTracer()
    got = second(spool_dir=spool, tracer=tracer).load(a)
    assert tracer.events[0]["spooled"] is False
    assert isinstance(np.asarray(got.data).base, np.memmap) or isinstance(
        np.asarray(got.data), np.memmap)
    _same_model(got, model)


def test_default_spool_dir_is_the_references(monkeypatch, tmp_path):
    from hdbscan_tpu.fleet.artifacts import _default_spool_dir as ref_default
    from hdbscan_tpu_torch.fleet.artifacts import _default_spool_dir

    monkeypatch.delenv("HDBSCAN_TPU_ARTIFACT_SPOOL", raising=False)
    assert _default_spool_dir() == ref_default()
    monkeypatch.setenv("HDBSCAN_TPU_ARTIFACT_SPOOL", str(tmp_path))
    assert _default_spool_dir() == ref_default() == str(tmp_path)


def test_uncompressed_artifacts_load_in_both_packages(saved_model):
    """``save(compress=False)`` writes ``np.savez``: the port's and the
    reference's uncompressed artifacts, and the compressed one, load in
    both packages to the same model."""
    from hdbscan_tpu.serve.artifact import ClusterModel as RefModel
    from hdbscan_tpu_torch.serve import ClusterModel

    _, _, model, a, _, c, r = saved_model
    assert os.path.getsize(a) > os.path.getsize(c)  # stored, not deflated
    for path in (a, c, r):
        for cls in (ClusterModel, RefModel):
            _same_model(cls.load(path), model)


def test_store_corrupt_spool_falls_back_to_npz(saved_model, tmp_path):
    data, a = saved_model[0], saved_model[3]
    spool = str(tmp_path / "spool")
    ArtifactStore(spool_dir=spool).load(a)
    with open(os.path.join(spool, file_digest(a), "data.npy"), "wb") as f:
        f.write(b"not a npy file")
    tracer = _ListTracer()
    model = ArtifactStore(spool_dir=spool, tracer=tracer).load(a)
    np.testing.assert_array_equal(np.asarray(model.data), data)
    assert tracer.events[0]["hit"] is False


def test_store_raises_on_missing_artifact(tmp_path):
    with pytest.raises(OSError):
        ArtifactStore(spool_dir=str(tmp_path / "spool")).load(str(tmp_path / "missing.npz"))


# -- FitScheduler --------------------------------------------------------------


class _FakeFitModel:
    """Stands in for ClusterModel: save() writes a real file."""

    def save(self, path, compress=True):
        with open(path, "wb") as f:
            f.write(b"model-bytes" if compress else b"raw-model-bytes")
        return path


class _FakeFitResult:
    def to_cluster_model(self, points, params, device=None):
        return _FakeFitModel()


def _fake_fit(points, params, trace=None):
    if points is None:
        raise ValueError("no points")
    return _FakeFitResult()


@pytest.mark.parametrize("kw", [{"workers": 0}, {"queue_bound": 0}, {"quota_rps": -1.0}])
def test_scheduler_rejects_bad_knobs(tmp_path, kw):
    for cls in (FitScheduler, ref_fleet.FitScheduler):
        with pytest.raises(ValueError):
            cls(str(tmp_path), fit_fn=_fake_fit, **kw)


def test_scheduler_publishes_through_callback(tmp_path):
    tracer = _ListTracer()
    published = []

    class _Entry:
        generation = 7

    sched = FitScheduler(str(tmp_path), fit_fn=_fake_fit, tracer=tracer,
                         publish=lambda t, p, m: published.append((t, p)) or _Entry())
    try:
        job = sched.submit("acme", np.zeros((4, 3)), reason="drift")
        assert job.wait(30.0)
        assert job.state == "published" and job.generation == 7
        assert job.path.endswith("acme_gen0001.npz") and os.path.exists(job.path)
        with open(job.path, "rb") as f:
            assert f.read() == b"raw-model-bytes"  # jobs publish uncompressed
        assert published == [("acme", job.path)]
        states = [e["state"] for e in tracer.events
                  if e["stage"] == "fit_job" and e["job"] == job.job_id]
        assert states == ["queued", "running", "published"]
        assert [e for e in tracer.events if e.get("state") == "running"][0]["queued_s"] >= 0.0
        job2 = sched.submit("acme", np.zeros((4, 3)))
        assert job2.wait(30.0) and job2.path.endswith("acme_gen0002.npz")
        assert sched.stats()["published"] == 2
    finally:
        sched.close()


def test_scheduler_failed_fit_is_isolated(tmp_path):
    tracer = _ListTracer()
    results = []
    sched = FitScheduler(str(tmp_path), fit_fn=_fake_fit, tracer=tracer,
                         on_result=lambda ok, err: results.append((ok, err)))
    try:
        bad = sched.submit("acme", None)  # _fake_fit raises on None
        assert bad.wait(30.0) and bad.state == "failed" and "no points" in bad.error
        assert results == [(False, bad.error)]
        assert [e for e in tracer.events if e.get("state") == "failed"][0]["error"] == bad.error
        good = sched.submit("acme", np.zeros((2, 3)))  # the worker survived
        assert good.wait(30.0) and good.state == "published"
        assert results[-1] == (True, None) and sched.stats()["failed"] == 1
    finally:
        sched.close()


def test_scheduler_quota_sheds_429(tmp_path):
    """One fake clock: the same sheds and Retry-After hints as the
    reference's scheduler."""
    out = []
    for cls, shed_cls in ((FitScheduler, ShedRequest), (ref_fleet.FitScheduler, RefShed)):
        clock = [100.0]
        sched = cls(str(tmp_path / cls.__module__), fit_fn=_fake_fit, quota_rps=1.0,
                    clock=lambda: clock[0])
        log = []
        try:
            for tenant, dt in (("acme", 0.0), ("acme", 0.0), ("globex", 0.0), ("acme", 0.4),
                               ("acme", 0.6)):
                clock[0] += dt
                try:
                    sched.submit(tenant, np.zeros((2, 3)))
                    log.append("ok")
                except shed_cls as e:
                    log.append((e.status, e.reason, round(e.retry_after_s, 12)))
            log.append(sched.stats()["shed"])
        finally:
            sched.close()
        out.append(log)
    assert out[0] == out[1]
    assert out[0][1][:2] == (429, "fit_quota") and out[0][1][2] > 0


def test_scheduler_full_queue_sheds_503(tmp_path):
    release = threading.Event()

    def _slow_fit(points, params, trace=None):
        release.wait(30.0)
        return _FakeFitResult()

    sched = FitScheduler(str(tmp_path), fit_fn=_slow_fit, workers=1, queue_bound=1)
    try:
        first = sched.submit("t0", np.zeros((2, 3)))  # occupies the worker
        deadline = time.monotonic() + 5.0
        while first.state == "queued" and time.monotonic() < deadline:
            time.sleep(0.01)
        sched.submit("t1", np.zeros((2, 3)))  # fills the queue
        with pytest.raises(ShedRequest) as exc:
            sched.submit("t2", np.zeros((2, 3)))
        assert exc.value.status == 503 and exc.value.reason == "fit_queue_full"
    finally:
        release.set()
        sched.close()


def test_scheduler_close_rejects_submit(tmp_path):
    sched = FitScheduler(str(tmp_path), fit_fn=_fake_fit)
    sched.close()
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit("t0", np.zeros((2, 3)))


def test_scheduler_real_fit_on_its_device_equals_reference(tmp_path):
    """The default fit (``fit_and_publish(..., device=...)``): the dense
    fit on the scheduler's device, published uncompressed, whose model
    equals the reference scheduler's on the same integer-grid rows."""
    import jax

    from hdbscan_tpu import HDBSCANParams as RefParams
    from hdbscan_tpu.serve.artifact import ClusterModel as RefModel
    from hdbscan_tpu_torch.serve import ClusterModel

    rng = np.random.default_rng(11)
    c = np.array([[0.0, 0.0, 0.0], [24.0, 24.0, 24.0], [0.0, 32.0, 0.0]])
    x = np.round(c[np.arange(300) % 3] + rng.normal(0, 2.0, (300, 3)))
    p = dict(min_points=5, min_cluster_size=25, processing_units=512)
    port = FitScheduler(str(tmp_path / "port"), params=HDBSCANParams(**p), device="cpu")
    ref = ref_fleet.FitScheduler(str(tmp_path / "ref"), params=RefParams(**p))
    try:
        with jax.enable_x64(False):
            jobs = [s.submit("acme", x) for s in (port, ref)]
            assert all(j.wait(120.0) for j in jobs), [j.error for j in jobs]
    finally:
        port.close()
        ref.close()
    assert [j.state for j in jobs] == ["published", "published"], [j.error for j in jobs]
    got, want = ClusterModel.load(jobs[0].path), RefModel.load(jobs[1].path)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.parent, want.parent)
    np.testing.assert_allclose(got.core, want.core, rtol=1e-6)


# -- router scaling seams ------------------------------------------------------


def _router(cls=FleetRouter, **kw):
    kw.setdefault("replicas", 2)
    return cls("/nonexistent/model.npz", **kw)


def test_router_signals_reflect_inflight_and_latency_window():
    got = []
    for cls in (FleetRouter, ref_fleet.FleetRouter):
        router = _router(cls)
        r0, _ = router.replicas
        router._mark(r0, True)
        first = router.signals()
        r0.in_flight = 3
        router._lat.extend([0.01] * 98 + [0.5, 0.5])
        got.append((first, router.signals()))
    assert got[0] == got[1]
    first, sig = got[0]
    assert first["replicas"] == 2 and first["up"] == 1 and "p99_s" not in first
    assert sig["in_flight"] == 3 and sig["in_flight_per_up"] == 3.0
    assert sig["p99_s"] == 0.5 and sig["p50_s"] == 0.01


def test_router_free_rid_reuses_lowest_gap():
    router = _router(replicas=3)
    assert router._free_rid() == "3"
    router.replicas = [r for r in router.replicas if r.rid != "1"]
    assert router._free_rid() == "1"


def test_router_scale_ops_require_running_loop():
    router = _router()
    assert router.scale_up() is None  # no asyncio loop yet
    assert router.scale_down() is False


# -- the kernel build's lock ---------------------------------------------------


def test_two_threads_build_and_load_one_source_once(tmp_path, monkeypatch):
    """Two threads that first reach one kernel source at once (a server's
    fit-job workers) end with one build, one library load and no error: a
    fake compiler sleeps, then writes its ``-o`` file."""
    from hdbscan_tpu_torch.ops import cuda_build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\nsleep 0.5\nout=\n"
        'while [ $# -gt 0 ]; do [ "$1" = -o ] && out="$2"; shift; done\n'
        'printf lib > "$out"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    loads = []

    class _FakeLib:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, name):
            return types.SimpleNamespace(name=name)

    build = tmp_path / "build"
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", _FakeLib)
    monkeypatch.setattr(cuda_build, "_build_dir", [str(build)])
    for name, value in (("_libs", {}), ("_fns", {}), ("_built", set()), ("BUILDS", 0),
                        ("CACHE_HITS", 0)):
        monkeypatch.setattr(cuda_build, name, value)
    barrier = threading.Barrier(2)
    got, errors = [], []

    def first_use():
        barrier.wait()
        try:
            got.append(cuda_build.kernel("uf_scan"))
        except Exception as e:  # noqa: BLE001 — the assertion target
            errors.append(repr(e))

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert errors == []
    assert len(got) == 2 and got[0] is got[1]
    assert cuda_build.BUILDS == 1 and cuda_build.CACHE_HITS == 0
    assert loads == [cuda_build._so_path("uf_scan.cu")]
    assert sorted(os.listdir(build)) == [os.path.basename(loads[0])]  # no torn .tmp left
    # a later process finds the library and loads it without a build
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "_fns", {})
    monkeypatch.setattr(cuda_build, "_built", set())
    cuda_build.kernel("uf_scan")
    assert cuda_build.BUILDS == 1 and cuda_build.CACHE_HITS == 1 and len(loads) == 2
    assert sorted(os.listdir(build)) == [os.path.basename(loads[0])]  # still the one library

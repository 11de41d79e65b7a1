"""The port's streaming pieces (``hdbscan_tpu_torch/stream``, the rest of
``fault/policy.py``) against the reference's, driven by the same seeded
numpy inputs: the ingest buffer (absorb routing, bubble summaries, the
reservoir and its RNG, the re-fit pool) and the drift detector (PSI and KS
statistics, trace events) are equal as state dicts and outputs; the
refitter's publish, failure and backoff behavior and the circuit breaker's
transitions under a fake clock are the same call for call; a re-fit on the
CPU publishes a model equal to the reference's re-fit of the same pool.
"""

import json
import random
import threading
import types

import numpy as np
import pytest

import jax

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.fault import policy as ref_policy
from hdbscan_tpu.serve.artifact import ClusterModel as RefModel
from hdbscan_tpu.stream import buffer as ref_buffer
from hdbscan_tpu.stream import drift as ref_drift
from hdbscan_tpu.stream import refit as ref_refit
from hdbscan_tpu.utils.metrics import MetricsRegistry as RefRegistry
from hdbscan_tpu.utils.tracing import Tracer as RefTracer
from hdbscan_tpu_torch.config import HDBSCANParams
from hdbscan_tpu_torch.fault import policy
from hdbscan_tpu_torch.serve.artifact import ClusterModel
from hdbscan_tpu_torch.stream import buffer, drift, refit
from hdbscan_tpu_torch.utils.metrics import MetricsRegistry
from hdbscan_tpu_torch.utils.tracing import Tracer
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401

#: (port module, reference module) pairs the twin tests run side by side.
BUFFERS = (buffer, ref_buffer)
DRIFTS = (drift, ref_drift)


def _fake_model(data):
    """The buffer reads only ``model.data``."""
    return types.SimpleNamespace(data=np.asarray(data, np.float64))


def _grid(seed, n, d=3, lo=0, hi=16):
    return np.random.default_rng(seed).integers(lo, hi, (n, d)).astype(np.float64)


def _state(obj) -> str:
    """A state dict as canonical JSON (floats in shortest round-trip form,
    so equal strings mean bitwise-equal values)."""
    return json.dumps(obj.state_dict(), sort_keys=True)


# -- IngestBuffer and BubbleSummary -------------------------------------------


@pytest.mark.parametrize("frac,reservoir", [(0.25, 4096), (0.0, 16), (1.5, 0)])
def test_buffer_equals_reference(frac, reservoir):
    """The same absorb sequence (exact duplicates, near-duplicates at the
    threshold, noise, repeated novel batches, a reservoir wrapped many times
    over) leaves equal states, stats, novel chunks and re-fit pools, and a
    reset re-keys both to the new model's rows."""
    train = _grid(0, 60)
    bufs = [mod.IngestBuffer(_fake_model(train), absorb_eps_frac=frac,
                             reservoir_size=reservoir, seed=3) for mod in BUFFERS]
    rng = np.random.default_rng(1)
    for i in range(12):
        pts = np.concatenate([train[rng.integers(0, 60, 5)], _grid(10 + i, 20, lo=20, hi=40)])
        labels = rng.integers(0, 4, len(pts))
        prob = np.round(rng.uniform(0.5, 1.0, len(pts)), 2)
        outs = [b.absorb(pts, labels, prob) for b in bufs]
        assert outs[0] == outs[1]
        assert sum(outs[0]) == len(pts)
    assert _state(bufs[0]) == _state(bufs[1])
    assert bufs[0].stats() == bufs[1].stats()
    assert bufs[0].novel_chunk_count == bufs[1].novel_chunk_count
    for a, b in zip(bufs[0].novel_chunks(), bufs[1].novel_chunks()):
        assert a.tobytes() == b.tobytes()
    for originals in (0, 7):
        a, b = (buf.refit_points(originals=originals, seed=5) for buf in bufs)
        assert a.tobytes() == b.tobytes()
    new = _grid(9, 40, lo=50, hi=60)
    for buf in bufs:
        buf.reset(_fake_model(new))
        assert buf.absorb(new[:4], np.zeros(4, np.int64), np.zeros(4)) == (4, 0)
    assert _state(bufs[0]) == _state(bufs[1])


def test_buffer_load_state_and_bubbles_cross_package():
    """A state dict either package writes loads into the other and goes on
    absorbing the same way; bubble summaries agree on every statistic."""
    train = _grid(2, 30)
    src = ref_buffer.IngestBuffer(_fake_model(train), reservoir_size=8, seed=1)
    pts = _grid(3, 50, lo=0, hi=8)
    src.absorb(pts, np.arange(50) % 3, np.full(50, 0.9))
    dst = buffer.IngestBuffer(_fake_model(train), reservoir_size=8, seed=99)
    dst.load_state(json.loads(json.dumps(src.state_dict())))
    more = _grid(4, 30, lo=0, hi=8)
    for b in (src, dst):
        b.absorb(more, np.arange(30) % 2, np.full(30, 0.5))
    assert _state(src) == _state(dst)
    rows = _grid(5, 9, d=2)
    a, b = buffer.BubbleSummary(2), ref_buffer.BubbleSummary(2)
    for bub in (a, b):
        bub.add(rows[:4])
        bub.add(rows[4:])
    assert a.as_dict() == b.as_dict() and a.radius == b.radius
    np.testing.assert_array_equal(a.centroid, b.centroid)
    assert buffer.BubbleSummary.from_dict(b.as_dict()).as_dict() == b.as_dict()
    assert np.isnan(buffer.BubbleSummary(3).centroid).all() and buffer.BubbleSummary(3).radius == 0
    with pytest.raises(ValueError, match="dims"):
        dst.absorb(np.zeros((2, 4)), np.zeros(2, np.int64), np.zeros(2))


def test_buffer_metrics_equal_reference():
    regs = [MetricsRegistry(), RefRegistry()]
    train = _grid(6, 20)
    for reg, mod in zip(regs, BUFFERS):
        buf = mod.IngestBuffer(_fake_model(train), metrics=reg)
        buf.absorb(np.concatenate([train[:3], _grid(7, 5, lo=30, hi=40)]),
                   np.zeros(8, np.int64), np.zeros(8))
    assert regs[0].render() == regs[1].render()


# -- DriftDetector ------------------------------------------------------------


def _scores(rng, n, loc):
    return np.clip(rng.normal(loc, 0.08, n), 0, 1)


@pytest.mark.parametrize("stat,threshold", [("psi", 2.0), ("ks", 0.5)])
def test_drift_equals_reference(stat, threshold):
    """Baseline, updates in distribution, a score shift, an assignment
    shift onto unseen labels, the min-rows gate and a rebaseline: every
    check's output and trace event, and the state dicts, are equal."""
    tracers = [Tracer(), RefTracer()]
    rng = np.random.default_rng(2)
    base = _scores(rng, 2000, 0.3), rng.integers(1, 4, 2000)
    dets = [mod.DriftDetector(*base, stat=stat, threshold=threshold, min_rows=256, tracer=t)
            for mod, t in zip(DRIFTS, tracers)]
    steps = [(rng.integers(1, 4, 100), _scores(rng, 100, 0.3)),
             (rng.integers(1, 4, 500), _scores(rng, 500, 0.3)),
             (rng.integers(1, 4, 500), _scores(rng, 500, 0.85)),
             (np.full(300, 99, np.int64), _scores(rng, 300, 0.3))]
    checks = []
    for i, (labels, scores) in enumerate(steps):
        outs = []
        for det in dets:
            det.update(labels, scores)
            outs.append(det.check(generation=i))
        assert outs[0] == outs[1]
        checks.append(outs[0]["drifted"])
        assert _state(dets[0]) == _state(dets[1])
    assert checks[0] is False and checks[-1] is True
    rebase = _scores(rng, 500, 0.9), rng.integers(1, 3, 500)
    after = rng.integers(1, 3, 10), _scores(rng, 10, 0.9)
    for det in dets:
        det.rebaseline(*rebase)
        det.update(*after)
    assert _state(dets[0]) == _state(dets[1])
    got = [[(e.name, e.fields) for e in t.events] for t in tracers]
    assert got[0] == got[1] and len(got[0]) == len(steps)
    loaded = drift.DriftDetector([0.5], [1], stat=stat, threshold=threshold)
    loaded.load_state(dets[1].state_dict())
    assert _state(loaded) == _state(dets[1])


def test_drift_validation_equals_reference():
    for mod in DRIFTS:
        with pytest.raises(ValueError, match="'psi'"):
            mod.DriftDetector([0.1], [1], stat="chi2")
        with pytest.raises(ValueError, match="threshold"):
            mod.DriftDetector([0.1], [1], threshold=0.0)


# -- Refitter ---------------------------------------------------------------


class _FakeResult:
    def __init__(self, points):
        self.points = points

    def to_cluster_model(self, data, params, **_):
        model = types.SimpleNamespace(n_train=len(data))
        model.save = lambda path: open(path, "w").write("artifact") or path
        return model


@pytest.mark.parametrize("mod", [refit, ref_refit], ids=["port", "reference"])
def test_refitter_publishes_in_background(mod, tmp_path):
    """One re-fit at a time on a worker thread; generation-numbered paths."""
    published = []
    started, release = threading.Event(), threading.Event()

    def fit_fn(points, params):
        started.set()
        assert release.wait(timeout=10)
        return _FakeResult(points)

    r = mod.Refitter(params=None, model_dir=str(tmp_path), fit_fn=fit_fn,
                     on_publish=lambda p, m, why: published.append((p, m, why)))
    assert r.request(np.zeros((10, 2)), "drift") is True
    assert started.wait(timeout=10) and r.busy
    assert r.request(np.zeros((5, 2)), "budget") is False
    release.set()
    assert r.join(timeout=10)
    assert r.refits_ok == 1 and r.refits_failed == 0
    (path, model, reason), = published
    assert reason == "drift" and model.n_train == 10 and path.endswith("model_gen0001.npz")
    assert r.request(np.zeros((4, 2)), "drift") is True and r.join(timeout=10)
    assert published[-1][0].endswith("model_gen0002.npz")


def test_refitter_failure_and_backoff_equal_reference(tmp_path):
    """A failing fit never publishes; the failure's trace event, metrics,
    result hook and jittered backoff window are the reference's."""
    runs = []
    for mod, tracer, reg in ((refit, Tracer(), MetricsRegistry()),
                             (ref_refit, RefTracer(), RefRegistry())):
        results = []

        def fit_fn(points, params):
            raise RuntimeError("fit exploded")

        r = mod.Refitter(params=None, model_dir=str(tmp_path), fit_fn=fit_fn, tracer=tracer,
                         metrics=reg, on_result=lambda ok, err: results.append((ok, err)),
                         on_publish=lambda *a: pytest.fail("a failed re-fit published"),
                         backoff_base_s=30.0, backoff_cap_s=60.0)
        assert r.request(np.zeros((3, 2)), "drift") and r.join(timeout=10)
        assert r.request(np.zeros((3, 2)), "drift") is False  # inside the backoff
        ev = [(e.name, {k: v for k, v in e.fields.items() if k != "wall_s"})
              for e in tracer.events]
        runs.append((r.refits_failed, r.refits_ok, r.last_error, results, ev, reg.render()))
        assert 15.0 <= r.backoff_remaining_s() <= 30.0
    assert runs[0] == runs[1]
    # The jittered windows: both packages draw the same sequence.
    a, b = random.Random(0), random.Random(0)
    assert [policy.backoff_s(i, base_s=0.5, cap_s=30.0, rng=a) for i in range(8)] == [
        ref_policy.backoff_s(i, base_s=0.5, cap_s=30.0, rng=b) for i in range(8)]


@pytest.fixture
def x32():
    """The reference at its production setting (float32) for the whole
    test, worker threads included: the re-fit runs on one."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def test_refit_publishes_the_reference_model(x32, tmp_path):
    """The default re-fit (the dense fit, here on the CPU) of one pool
    publishes the artifact the reference's re-fit publishes: labels, cores,
    tree tables and digests equal."""
    rng = np.random.default_rng(8)
    c = rng.uniform(0, 40, size=(3, 3))
    pool = np.round(c[rng.integers(0, 3, 400)] + rng.normal(0, 2, (400, 3)))
    paths = {}
    for name, mod, params, kw in (("port", refit, HDBSCANParams, {"device": "cpu"}),
                                  ("ref", ref_refit, RefParams, {})):
        done = []
        r = mod.Refitter(params(min_points=8, min_cluster_size=30), str(tmp_path / name),
                         on_publish=lambda p, m, why: done.append(p), **kw)
        assert r.request(pool, "drift") and r.join(timeout=120)
        assert r.refits_ok == 1, r.last_error
        paths[name] = done[0]
    got, want = ClusterModel.load(paths["port"]), RefModel.load(paths["ref"])
    assert got.fingerprint == want.fingerprint and got.params == want.params
    for f in ("data", "core", "labels", "last_cluster", "parent", "birth", "selected",
              "sel_anc", "eps_min", "eps_max"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


# -- fault/policy: retry and the circuit breaker -------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_circuit_breaker_equals_reference():
    """The same allow / success / failure sequence under a fake clock: the
    states, ``state_info``, trace events and ``on_state`` calls are equal,
    and the gauge encoding is the reference's."""
    assert policy.CIRCUIT_STATE_VALUES == ref_policy.CIRCUIT_STATE_VALUES
    runs = []
    for mod, tracer in ((policy, Tracer()), (ref_policy, RefTracer())):
        clock, seen = _Clock(), []
        cb = mod.CircuitBreaker("refit", failures=2, reset_s=5.0, tracer=tracer,
                                on_state=lambda name, st: seen.append((name, st)), clock=clock)
        log = []
        for op, dt in (("allow", 0), ("fail", 1), ("allow", 0), ("fail", 1), ("allow", 1),
                       ("info", 0), ("allow", 4), ("fail", 0), ("allow", 0), ("allow", 6),
                       ("ok", 0), ("info", 0), ("fail", 0), ("ok", 0)):
            clock.t += dt
            if op == "allow":
                log.append(cb.allow())
            elif op == "fail":
                cb.record_failure()
            elif op == "ok":
                cb.record_success()
            else:
                log.append(cb.state_info())
            log.append(cb.state)
        runs.append((log, seen, [(e.name, e.fields) for e in tracer.events]))
    assert runs[0] == runs[1]
    assert "open" in runs[0][0] and "half_open" in runs[0][0]
    for mod in (policy, ref_policy):
        with pytest.raises(ValueError, match="failures"):
            mod.CircuitBreaker(failures=0)
        with pytest.raises(ValueError, match="reset_s"):
            mod.CircuitBreaker(reset_s=0.0)


def test_retry_decorator_equals_reference():
    """``retry`` retries matching exceptions with the same backoff sleeps
    and trace events, and re-raises the last failure."""
    runs = []
    for mod, tracer in ((policy, Tracer()), (ref_policy, RefTracer())):
        sleeps, calls = [], []

        @mod.retry(attempts=3, base_s=0.1, seed=7, sleep=sleeps.append, tracer=tracer,
                   retry_on=(OSError,), name="flaky")
        def flaky(x):
            calls.append(x)
            if len(calls) < 3:
                raise OSError(f"try {len(calls)}")
            return x * 2

        assert flaky(21) == 42

        @mod.retry(attempts=2, sleep=sleeps.append)
        def broken():
            raise KeyError("always")

        with pytest.raises(KeyError):
            broken()
        runs.append((sleeps, calls, [(e.name, e.fields) for e in tracer.events]))
    assert runs[0] == runs[1]

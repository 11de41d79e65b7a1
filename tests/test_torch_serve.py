"""The port's serving path (``hdbscan_tpu_torch/serve``: the model artifact,
the predictor and the micro-batcher, and ``ops/rpforest``'s query routing)
against the reference's, on the CPU.

Inputs are integer grids made with numpy from a seed, so every distance,
root and division is exact or correctly rounded in both packages. Models
come from the port's fits (600-3,000 rows), fitted once per module. The
reference builds and saves its own artifact from the same fit result and
the port its own; each package loads the other's file.

Tolerances. Artifacts: every array and the JSON record equal. Predictions
(``xla``, ``fused``, ``rpforest`` at euclidean, manhattan, cosine and
pearson, on a model with zero-norm training rows and queries that include
zero-norm rows): labels, probabilities and outlier scores bitwise equal to
the reference's ``Predictor`` on the same saved file; membership within
rtol 1e-6 (its row sum may add in another order). Routing: leaves equal at
3 <= d <= 8 (where both sum features in order); elsewhere equal wherever
every projection on the path clears its threshold by more than 1e-4.
"""

import functools
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.ops import rpforest as ref_rpf
from hdbscan_tpu.serve import artifact as ref_art
from hdbscan_tpu.serve import predict as ref_pred
from hdbscan_tpu_torch.config import HDBSCANParams
from hdbscan_tpu_torch.fault import inject
from hdbscan_tpu_torch.fault.policy import DeadlineExceeded, ShedRequest
from hdbscan_tpu_torch.models import exact, hdbscan, mr_hdbscan
from hdbscan_tpu_torch.ops import rpforest as port_rpf
from hdbscan_tpu_torch.serve import (
    MODEL_SCHEMA,
    ClusterModel,
    MicroBatcher,
    Predictor,
    approximate_predict,
    membership_vectors,
    outlier_scores,
)
from hdbscan_tpu_torch.utils.tracing import JsonlSink, Tracer
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECK_TRACE = os.path.join(REPO, "scripts", "check_trace.py")
_ARRAYS = ("data", "core", "labels", "last_cluster", "parent", "birth", "selected",
           "sel_anc", "eps_min", "eps_max")


def _grid(seed: int, n: int, d: int = 3, centres: int = 5, hi: int = 60) -> np.ndarray:
    """Blobs on an integer grid plus 10% uniform noise rows."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, hi, size=(centres, d))
    m = n - n // 10
    x = np.round(c[rng.integers(0, centres, m)] + rng.normal(0, 3, size=(m, d)))
    return np.concatenate([x, rng.integers(0, hi, size=(n - m, d))]).astype(np.float64)


def _queries(x: np.ndarray, seed: int, rows: int = 240) -> np.ndarray:
    """The bench sampler's shape: training rows, every fourth a bitwise
    duplicate and the rest jittered by N(0, 1) on the grid, plus uniform
    rows and a zero row (zero norm at cosine and pearson)."""
    rng = np.random.default_rng(seed)
    q = x[rng.integers(0, len(x), rows)].copy()
    jit = np.arange(rows) % 4 != 0
    q[jit] = np.round(q[jit] + rng.normal(0, 1, size=(int(jit.sum()), x.shape[1])))
    far = rng.integers(0, 80, size=(12, x.shape[1])).astype(np.float64)
    return np.concatenate([q, far, np.zeros((1, x.shape[1]))])


def _ref_params(params: HDBSCANParams) -> RefParams:
    import dataclasses

    return RefParams(**dataclasses.asdict(params))


# -- fits, once per module -----------------------------------------------------

#: name -> (fit function, data seed, rows, parameters)
_FITS = {
    "exact": (exact.fit, 1, 1500, dict(min_points=8, min_cluster_size=40)),
    "mr": (mr_hdbscan.fit, 2, 2000, dict(min_points=6, min_cluster_size=40,
                                         processing_units=512)),
    "dedup": (exact.fit, 3, 1200, dict(min_points=5, min_cluster_size=30, dedup_points=True)),
    "consensus": (mr_hdbscan.fit, 4, 1500, dict(min_points=6, min_cluster_size=40,
                                                processing_units=512, consensus_draws=3)),
    "rpforest": (exact.fit, 5, 2000, dict(min_points=8, min_cluster_size=40,
                                          knn_index="rpforest", rpf_trees=3,
                                          rpf_leaf_size=256)),
    "min_points_1": (hdbscan.fit, 6, 600, dict(min_points=1, min_cluster_size=10)),
}


@functools.lru_cache(maxsize=None)
def _fit(name: str):
    fn, seed, n, kw = _FITS[name]
    x = _grid(seed, n)
    if name == "dedup":
        x = np.concatenate([x, x[:300]])  # exact duplicates
    params = HDBSCANParams(**kw)
    return x, params, fn(x, params, device="cpu")


@functools.lru_cache(maxsize=None)
def _metric_model(metric: str, tmp: str) -> str:
    """A d = 4 grid model at ``metric`` with two zero rows among the
    training rows and the port's forest attached; saved by the port."""
    x = _grid(10, 1500, d=4)
    x[[17, 901]] = 0.0
    params = HDBSCANParams(min_points=8, min_cluster_size=40, dist_function=metric)
    res = exact.fit(x, params, device="cpu")
    forest = port_rpf.build_forest(x, trees=3, leaf_size=256, seed=0, device="cpu")
    path = os.path.join(tmp, f"{metric}.npz")
    ClusterModel.from_fit_result(res, x, params, forest=forest).save(path)
    return path


@pytest.fixture(scope="module")
def tmp_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("serve"))


def _assert_models_equal(a, b):
    for f in _ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                      err_msg=f)
        assert np.asarray(getattr(a, f)).dtype == np.asarray(getattr(b, f)).dtype, f
    assert (a.schema, a.mode, a.params, a.fingerprint) == (b.schema, b.mode, b.params,
                                                           b.fingerprint)
    assert (a.rpf is None) == (b.rpf is None)
    if a.rpf is not None:
        for key in ("trees", "depth", "leaf_size", "normals", "thresholds", "members",
                    "leaf_mask"):
            np.testing.assert_array_equal(np.asarray(a.rpf[key]), np.asarray(b.rpf[key]))


# -- artifacts -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["exact", "mr", "dedup", "consensus", "rpforest"])
def test_artifact_both_directions(tmp_dir, name):
    """The port's and the reference's ``from_fit_result`` of one fit give the
    same artifact (serving tables, forest and fingerprint included); each
    package loads the file the other saved, and both predict alike on it."""
    x, params, res = _fit(name)
    port = ClusterModel.from_fit_result(res, x, params, device="cpu")
    ref = ref_art.ClusterModel.from_fit_result(res, x, _ref_params(params))
    _assert_models_equal(port, ref)
    assert port.mode == ("mr" if name in ("mr", "consensus") else "exact")
    p_path = port.save(os.path.join(tmp_dir, f"port_{name}.npz"))
    r_path = ref.save(os.path.join(tmp_dir, f"ref_{name}.npz"))
    _assert_models_equal(ref_art.ClusterModel.load(p_path, params=_ref_params(params), data=x),
                         port)
    loaded = ClusterModel.load(r_path, params=params, data=x)
    _assert_models_equal(loaded, ref)
    assert loaded.summary() == ref.summary()
    q = _queries(x, 0)
    backend = "rpforest" if name == "rpforest" else "xla"
    got = Predictor(loaded, backend=backend, device="cpu").predict(q)
    want = ref_pred.Predictor(ref_art.ClusterModel.load(p_path), backend=backend).predict(q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_consensus_model_keeps_consensus_labels():
    x, params, res = _fit("consensus")
    model = res.to_cluster_model(x, params, device="cpu")
    np.testing.assert_array_equal(model.labels, res.labels)
    assert res.consensus_info is not None


def test_schema_1_loads_without_index(tmp_dir):
    x, params, res = _fit("rpforest")
    model = ClusterModel.from_fit_result(res, x, params, device="cpu")
    assert model.rpf is not None and model.schema == MODEL_SCHEMA == "hdbscan-tpu-model/2"
    model.rpf, model.schema = None, "hdbscan-tpu-model/1"
    path = model.save(os.path.join(tmp_dir, "v1.npz"))
    for cls in (ClusterModel, ref_art.ClusterModel):
        v1 = cls.load(path)
        assert v1.schema == "hdbscan-tpu-model/1" and v1.rpf is None
    with pytest.raises(ValueError, match="rp-forest index"):
        Predictor(ClusterModel.load(path), backend="rpforest", device="cpu")


def _bad_schema(model, path):
    model.schema = "hdbscan-tpu-model/99"
    model.save(path)
    return {}


def _corrupt(model, path):
    model.data = model.data.copy()
    model.data[0, 0] += 1.0  # stored digest no longer matches
    model.save(path)
    return {}


def _fingerprint(model, path):
    model.save(path)
    return {"params": HDBSCANParams(min_points=9, min_cluster_size=40)}


@pytest.mark.parametrize("make", [_bad_schema, _corrupt, _fingerprint],
                         ids=["schema", "corrupt", "fingerprint"])
def test_load_refusals_match_reference(tmp_dir, make):
    x, params, res = _fit("exact")
    path = os.path.join(tmp_dir, f"bad_{make.__name__}.npz")
    kw = make(ClusterModel.from_fit_result(res, x, params), path)
    with pytest.raises(ValueError) as port_err:
        ClusterModel.load(path, **kw)
    ref_kw = {k: _ref_params(v) for k, v in kw.items()}
    with pytest.raises(ValueError) as ref_err:
        ref_art.ClusterModel.load(path, **ref_kw)
    assert str(port_err.value) == str(ref_err.value)


def test_save_fault_sites(tmp_dir):
    """``artifact_save`` torn leaves no file; ``digest`` publishes a file
    whose last byte is flipped (flipping it back restores the model);
    ``artifact_load`` raises the injected fault."""
    x, params, res = _fit("exact")
    model = ClusterModel.from_fit_result(res, x, params)
    path = os.path.join(tmp_dir, "faulty.npz")
    try:
        inject.install("artifact_save:mode=torn,count=1")
        with pytest.raises(inject.InjectedFault):
            model.save(path)
        assert not os.path.exists(path)
        inject.install("artifact_save:mode=digest,count=1")
        model.save(path)
        with open(path, "rb") as f:
            raw = f.read()
        with open(path, "wb") as f:
            f.write(raw[:-1] + bytes([raw[-1] ^ 0xFF]))
        _assert_models_equal(ClusterModel.load(path), model)
        inject.install("artifact_load:count=1")
        with pytest.raises(inject.InjectedFault):
            ClusterModel.load(path)
    finally:
        inject.clear()
    assert sorted(f for f in os.listdir(tmp_dir) if f.endswith(".tmp")) == []


# -- predictions against the reference -------------------------------------------


@pytest.mark.parametrize("metric", ["euclidean", "manhattan", "cosine", "pearson"])
@pytest.mark.parametrize("backend", ["xla", "fused", "rpforest"])
def test_predict_matches_reference(tmp_dir, backend, metric):
    path = _metric_model(metric, tmp_dir)
    port = Predictor(ClusterModel.load(path), backend=backend, device="cpu")
    ref = ref_pred.Predictor(ref_art.ClusterModel.load(path), backend=backend)
    assert port.backend == ref.backend
    x = ClusterModel.load(path).data
    q = _queries(x, 1)
    q[-2] = 7.0  # a constant row: zero norm at pearson
    got = port.predict(q, with_membership=True)
    want = ref.predict(q, with_membership=True)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6, atol=0)
    if backend != "rpforest":  # the training rows reproduce the fit's labels
        fit = port.predict(x[:400])[0]
        np.testing.assert_array_equal(fit, ClusterModel.load(path).labels[:400])


def test_predict_chunks_like_one_call(tmp_dir):
    """A request above the bucket ceiling chunks; the chunks give the rows
    one bucket would."""
    path = _metric_model("euclidean", tmp_dir)
    model = ClusterModel.load(path)
    q = np.concatenate([_queries(model.data, s) for s in range(3)])
    whole = Predictor(model, max_batch=1024, device="cpu").predict(q, with_membership=True)
    parts = Predictor(model, max_batch=64, device="cpu").predict(q, with_membership=True)
    for a, b in zip(whole, parts):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["exact", "mr", "dedup", "min_points_1"])
def test_training_round_trip(name):
    """Predicting the training rows reproduces the fit's labels (every row
    for the exact and dedup fits; the clustered rows for the MR and
    min_points=1 fits, as the reference's tests hold them)."""
    x, params, res = _fit(name)
    labels, prob = approximate_predict(res.to_cluster_model(x, params), x, device="cpu")
    fit = np.asarray(res.labels)
    mask = fit > 0 if name in ("mr", "min_points_1") else np.ones(len(x), bool)
    np.testing.assert_array_equal(labels[mask], fit[mask])
    assert np.all(prob[fit > 0][labels[fit > 0] > 0] > 0)


def test_functional_api_matches_predictor():
    x, params, res = _fit("exact")
    model = ClusterModel.from_fit_result(res, x, params)
    q = _queries(x, 2)
    labels, prob, score, mvec = Predictor(model, device="cpu").predict(q, with_membership=True)
    np.testing.assert_array_equal(approximate_predict(model, q, device="cpu")[0], labels)
    np.testing.assert_array_equal(outlier_scores(model, q, device="cpu"), score)
    np.testing.assert_array_equal(membership_vectors(model, q, device="cpu"), mvec)
    assert mvec.shape == (len(q), len(model.selected_ids))
    with pytest.raises(ValueError, match="dims"):
        approximate_predict(model, np.zeros((4, 7)), device="cpu")


def test_no_card_no_fallback():
    """Without a card and without ``device="cpu"`` the predictor refuses."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    x, params, res = _fit("exact")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(ClusterModel.from_fit_result(res, x, params))


def test_buckets_warmup_and_trace(tmp_dir):
    x, params, res = _fit("exact")
    model = ClusterModel.from_fit_result(res, x, params)
    path = os.path.join(tmp_dir, "predict_trace.jsonl")
    tracer = Tracer(sinks=[JsonlSink(path, static={"process": 0})])
    pred = Predictor(model, max_batch=200, tracer=tracer, device="cpu")
    ref = ref_pred.Predictor(ref_art.ClusterModel.from_fit_result(res, x, _ref_params(params)),
                             max_batch=200)
    assert pred.buckets == ref.buckets == [8, 16, 32, 64, 128, 256]
    assert [pred.bucket_for(r) for r in (1, 8, 9, 200, 300)] == [8, 8, 16, 256, 256]
    info = pred.warmup()
    assert set(info) == {"buckets", "wall_s", "jit_compiles", "cache_hits"}
    assert info["jit_compiles"] == 0 and info["cache_hits"] == 0
    pred.predict(x[:600])
    tracer.close()
    batches = [e for e in tracer.events if e.name == "predict_batch"]
    assert [(e.fields["bucket"], e.fields["rows"]) for e in batches] == [
        (256, 256), (256, 256), (128, 88)]
    assert [e.fields["batch_seq"] for e in batches] == [0, 1, 2]
    assert [e.name for e in tracer.events][0] == "predict_warmup"
    out = subprocess.run([sys.executable, CHECK_TRACE, path], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_predict_dispatch_fault():
    x, params, res = _fit("exact")
    pred = Predictor(ClusterModel.from_fit_result(res, x, params), device="cpu")
    try:
        inject.install("predict_dispatch:count=1")
        with pytest.raises(inject.InjectedFault):
            pred.predict(x[:5])
        pred.predict(x[:5])  # count=1: the next dispatch runs
    finally:
        inject.clear()


# -- the micro-batcher -----------------------------------------------------------


@pytest.fixture(scope="module")
def predictor():
    x, params, res = _fit("exact")
    return x, Predictor(ClusterModel.from_fit_result(res, x, params), device="cpu")


def test_batcher_concurrent_submitters(predictor):
    x, pred = predictor
    want = pred.predict(x[:400])
    out = [None] * 20
    with MicroBatcher(pred, linger_s=0.02) as mb:
        def worker(i):
            out[i] = mb.predict(x[i * 20 : (i + 1) * 20])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(20)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert mb.stats["rows"] == 400 and mb.stats["batches"] < 20  # coalesced
    for i, got in enumerate(out):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w[i * 20 : (i + 1) * 20])


def test_batcher_close_drains_and_rejects_after(predictor):
    x, pred = predictor
    mb = MicroBatcher(pred, linger_s=0.5)
    futs = [mb.submit(x[i : i + 3]) for i in range(0, 30, 3)]
    mb.close()
    for i, f in zip(range(0, 30, 3), futs):
        np.testing.assert_array_equal(f.result(timeout=30)[0], pred.predict(x[i : i + 3])[0])
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(x[:2])


def test_batcher_sheds_and_drops_expired(predictor):
    """The same script through the port's batcher and the reference's over
    one predictor: the same shed, the same deadline refusals and drops,
    and the same statistics."""
    from hdbscan_tpu.serve.batcher import MicroBatcher as RefBatcher

    x, pred = predictor
    seen = []
    for cls in (MicroBatcher, RefBatcher):
        with cls(pred, linger_s=0.2, max_queue=1) as mb:
            first = mb.submit(x[:2])
            time.sleep(0.05)  # the worker holds the first while lingering
            second = mb.submit(x[2:4], meta={"deadline": time.perf_counter() + 0.01})
            with pytest.raises(Exception) as shed:
                mb.submit(x[4:6])
            with pytest.raises(Exception) as late:
                mb.submit(x[:1], meta={"deadline": time.perf_counter() - 1.0})
            labels = first.result(timeout=30)[0]
            with pytest.raises(Exception) as dropped:
                second.result(timeout=30)
            seen.append(((type(shed.value).__name__, str(shed.value), shed.value.status,
                          shed.value.reason, shed.value.retry_after_s),
                         (type(late.value).__name__, str(late.value)),
                         (type(dropped.value).__name__, str(dropped.value)),
                         labels.tolist(), dict(mb.stats)))
    assert seen[0] == seen[1]
    assert seen[0][0][0] == ShedRequest.__name__ and seen[0][0][2:4] == (503, "queue_full")
    assert seen[0][1][0] == seen[0][2][0] == DeadlineExceeded.__name__
    assert seen[0][4]["shed"] == 1 and seen[0][4]["deadline_drops"] == 1


# -- routing down a stored forest --------------------------------------------------


def _ref_leaves(forest, q):
    return np.stack([
        np.asarray(ref_rpf.route_queries(jnp.asarray(q, jnp.float32), jnp.asarray(forest.normals[t]),
                                         jnp.asarray(forest.thresholds[t]), forest.depth))
        for t in range(forest.trees)
    ])


def _port_forest(forest):
    import dataclasses

    return port_rpf.forest_from_numpy(**dataclasses.asdict(forest))


@pytest.mark.parametrize("d", [3, 4, 5, 6, 7, 8])
def test_route_queries_bitwise(d):
    """At 3 <= d <= 8 the port's build equals the reference's and routing
    continuous queries gives the same leaves."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(1500, d))
    q = np.concatenate([rng.normal(size=(300, d)), x[:50]]).astype(np.float32)
    with jax.enable_x64(False):
        ref = ref_rpf.build_forest(x, trees=3, leaf_size=64, seed=1)
        want = _ref_leaves(ref, q)
    port = port_rpf.build_forest(x, trees=3, leaf_size=64, seed=1, device="cpu")
    np.testing.assert_array_equal(port.thresholds, ref.thresholds)
    np.testing.assert_array_equal(port.members, ref.members)
    got = port_rpf.route_queries(torch.as_tensor(q), torch.as_tensor(port.normals),
                                 torch.as_tensor(port.thresholds), port.depth)
    np.testing.assert_array_equal(got.numpy(), want)
    one = port_rpf.route_queries(torch.as_tensor(q), torch.as_tensor(port.normals[1]),
                                 torch.as_tensor(port.thresholds[1]), port.depth)
    np.testing.assert_array_equal(one.numpy(), want[1])


@pytest.mark.parametrize("d", [2, 12, 40])
def test_route_queries_off_threshold(d):
    """Elsewhere XLA's einsum sums in another order: with the reference's
    forest handed over, leaves agree for every query whose projections on
    its path clear their thresholds by more than 1e-4."""
    rng = np.random.default_rng(100 + d)
    x = rng.normal(size=(1500, d))
    q = rng.normal(size=(400, d)).astype(np.float32)
    with jax.enable_x64(False):
        ref = ref_rpf.build_forest(x, trees=3, leaf_size=64, seed=2)
        want = _ref_leaves(ref, q)
    port = _port_forest(ref)
    got = port_rpf.route_queries(torch.as_tensor(q), torch.as_tensor(port.normals),
                                 torch.as_tensor(port.thresholds), port.depth).numpy()
    clear = np.ones(len(q), bool)
    for t in range(ref.trees):  # float64 walk of the reference's path
        node = np.zeros(len(q), np.int64)
        for level in range(ref.depth):
            heap = (1 << level) - 1 + node
            proj = np.einsum("bd,bd->b", q.astype(np.float64),
                             ref.normals[t][heap].astype(np.float64))
            clear &= np.abs(proj - ref.thresholds[t][heap]) > 1e-4
            node = node * 2 + (proj >= ref.thresholds[t][heap])
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(got[:, clear], want[:, clear])

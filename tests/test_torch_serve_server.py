"""The port's HTTP server (``hdbscan_tpu_torch/serve/server.py``) and the
``serve`` command on the CPU: every response equals the in-process
predict on the same model, the trace passes ``scripts/check_trace.py`` and
two scrapes pass ``scripts/check_metrics.py``, swaps are blue/green under
load and refuse a fingerprint mismatch or a corrupt artifact, and the
features that are not ported refuse by name (ROADMAP A11, A12) before
any socket opens; ``/ingest`` on a server started without ingest mode
answers as the reference's does (the streaming server itself is held to
the reference by ``test_torch_stream_server.py``). Servers bind port 0 and close in a ``finally``;
every HTTP call has a timeout.

Against the reference: the port's server and ``hdbscan_tpu.serve``'s
``ClusterServer``, both on the CPU over the same saved model, get the same
requests. Status codes and JSON bodies are equal, apart from request ids
and timings; ``/healthz`` carries the same keys (the port adds
``device``), the same per-route counts and the same batcher statistics;
the two ``/metrics`` scrapes name the same families of the same types; a
queue bound of 1 sheds the same 503 with the same ``Retry-After``.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from hdbscan_tpu_torch.config import HDBSCANParams
from hdbscan_tpu_torch.models import exact
from hdbscan_tpu_torch.serve import ClusterModel, ClusterServer, Predictor
from hdbscan_tpu_torch.utils.tracing import JsonlSink, Tracer
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
TIMEOUT = 30


def _grid(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 60, size=(5, 3))
    x = np.round(c[rng.integers(0, 5, n)] + rng.normal(0, 3, size=(n, 3)))
    return np.concatenate([x, rng.integers(0, 60, size=(n // 10, 3))]).astype(np.float64)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Two fits under one parameter set (a swap may change the data) and
    one under another; each saved. Returns (dir, {name: path}, params)."""
    d = tmp_path_factory.mktemp("server")
    params = HDBSCANParams(min_points=8, min_cluster_size=30)
    paths = {}
    for name, seed, p in (("a", 0, params), ("b", 1, params),
                          ("other", 2, HDBSCANParams(min_points=5, min_cluster_size=30))):
        x = _grid(seed, 1000)
        paths[name] = exact.fit(x, p, device="cpu").to_cluster_model(x, p).save(
            str(d / f"{name}.npz"))
    return str(d), paths, params


def _call(url, path, obj=None, headers=None):
    """(status, headers, body) of one request; POST when ``obj`` is given
    (raw when it is bytes)."""
    data = obj if obj is None or isinstance(obj, bytes) else json.dumps(obj).encode()
    req = urllib.request.Request(url + path, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def _run_script(name, *args):
    out = subprocess.run([sys.executable, os.path.join(SCRIPTS, name), *args],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_http_round_trip(models):
    d, paths, _ = models
    model = ClusterModel.load(paths["a"])
    want = Predictor(model, device="cpu")
    trace = os.path.join(d, "serve.jsonl")
    tracer = Tracer(sinks=[JsonlSink(trace, static={"process": 0})])
    srv = ClusterServer(model, port=0, tracer=tracer, device="cpu")
    try:
        srv.start()
        url = f"http://{srv.host}:{srv.port}"
        rng = np.random.default_rng(5)
        for rows in (1, 7, 256, 300):
            q = np.round(model.data[rng.integers(0, model.n_train, rows)]
                         + rng.normal(0, 1, size=(rows, 3)))
            status, hdr, body = _call(url, "/predict", {"points": q.tolist()})
            assert status == 200 and hdr["X-Request-Id"]
            out = json.loads(body)
            labels, prob, score = want.predict(q)
            assert out["labels"] == labels.tolist() and out["generation"] == 1
            assert out["probabilities"] == [round(p, 6) for p in prob.tolist()]
            assert out["outlier_scores"] == [round(s, 6) for s in score.tolist()]
        status, _, body = _call(url, "/predict", {"points": q[:9].tolist(), "membership": True})
        out = json.loads(body)
        mvec = want.predict(q[:9], with_membership=True)[3]
        assert status == 200 and out["membership"] == np.round(mvec, 6).tolist()
        assert out["selected_ids"] == model.selected_ids.tolist()
        status, _, body = _call(url, "/healthz")
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok" and health["device"] == "cpu"
        assert health["warmup"]["jit_compiles"] == 0 and health["buckets"][0] == 8
        assert health["requests"]["/predict"] == {"requests": 5, "errors": 0}
        scrapes = []
        for _ in range(2):
            status, _, body = _call(url, "/metrics")
            assert status == 200 and "hdbscan_tpu_predict_batch_rows_bucket" in body
            scrapes.append(os.path.join(d, f"scrape{len(scrapes)}.txt"))
            with open(scrapes[-1], "w") as f:
                f.write(body)
            _call(url, "/predict", {"points": q[:3].tolist()})
        status, _, body = _call(url, "/swap", {"path": paths["b"]})
        assert status == 200 and json.loads(body)["generation"] == 2
        status, _, body = _call(url, "/predict", {"points": q.tolist()})
        want_b = Predictor(ClusterModel.load(paths["b"]), device="cpu").predict(q)[0]
        assert json.loads(body)["labels"] == want_b.tolist()
        assert json.loads(body)["generation"] == 2
        assert _call(url, "/nowhere")[0] == 404
        assert _call(url, "/predict", {"nopoints": 1})[0] == 400
    finally:
        srv.close()
        tracer.close()
    stages = [e.name for e in tracer.events]
    assert stages.count("request_span") == 9 and "model_swap" in stages
    assert stages.count("predict_warmup") == 2
    _run_script("check_trace.py", trace)
    _run_script("check_metrics.py", *scrapes)


def test_swap_under_concurrent_load(models):
    """Clients keep predicting while the model swaps back and forth: every
    response is 200 and equals the predict of the generation it names."""
    _, paths, _ = models
    ma, mb = ClusterModel.load(paths["a"]), ClusterModel.load(paths["b"])
    q = np.round(ma.data[:40] + 0.5)
    want = {"a": Predictor(ma, device="cpu").predict(q)[0].tolist(),
            "b": Predictor(mb, device="cpu").predict(q)[0].tolist()}
    srv = ClusterServer(ma, port=0, device="cpu", linger_s=0.001)
    errors, seen = [], []
    stop = threading.Event()
    try:
        srv.start()
        url = f"http://{srv.host}:{srv.port}"

        def client():
            while not stop.is_set():
                status, _, body = _call(url, "/predict", {"points": q.tolist()})
                out = json.loads(body)
                name = "a" if out.get("generation", 0) % 2 else "b"
                if status != 200 or out["labels"] != want[name]:
                    errors.append((status, out.get("generation")))
                seen.append(out.get("generation"))

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        for i in range(4):
            time.sleep(0.1)
            srv.swap_model(paths["b" if i % 2 == 0 else "a"])
        time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        stop.set()
        srv.close()
    assert not errors and srv.generation == 5 and len(set(seen)) >= 2


@pytest.mark.parametrize("bad", ["fingerprint", "corrupt"])
def test_swap_refusals(models, bad):
    d, paths, _ = models
    path = paths["other"]
    if bad == "corrupt":
        m = ClusterModel.load(paths["b"])
        m.data = m.data.copy()
        m.data[3, 1] += 2.0
        path = m.save(os.path.join(d, "corrupt.npz"))
    srv = ClusterServer(ClusterModel.load(paths["a"]), port=0, device="cpu")
    try:
        srv.start()
        url = f"http://{srv.host}:{srv.port}"
        status, _, body = _call(url, "/swap", {"path": path})
        assert status == 400
        assert ("fingerprint mismatch" if bad == "fingerprint" else "corrupt") in body
        assert _call(url, "/swap", {})[0] == 409  # nothing staged
        assert srv.generation == 1 and srv.last_swap is None
    finally:
        srv.close()


@pytest.mark.parametrize(
    "kw,item",
    [
        ({"tenants": "tenants"}, "A12"),
        ({"params": HDBSCANParams(watchdog_s=5.0)}, "A11"),
    ],
)
def test_unported_features_refused(kw, item):
    """The refusal comes first: the model passed is not even a model."""
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        ClusterServer(object(), port=0, device="cpu", **kw)


def test_http_refusals_deadlines_and_close(models):
    _, paths, _ = models
    srv = ClusterServer(ClusterModel.load(paths["a"]), port=0, device="cpu")
    try:
        srv.start()
        url = f"http://{srv.host}:{srv.port}"
        pts = {"points": [[1.0, 2.0, 3.0]]}
        status, _, body = _call(url, "/ingest", pts)  # the reference's answer
        assert status == 409 and json.loads(body) == {"error": "server started without ingest mode"}
        status, _, body = _call(url, "/predict", {**pts, "tenant": "t0"})
        assert status == 409 and "ROADMAP A12" in body
        assert _call(url, "/predict", pts, {"X-Deadline-Ms": "0.000001"})[0] == 504
        assert _call(url, "/predict", pts, {"X-Deadline-Ms": "bogus"})[0] == 400
        assert _call(url, "/predict", {"points": [[1.0, 2.0]]})[0] == 400  # dims
        assert _call(url, "/predict", pts, {"X-Deadline-Ms": "5000"})[0] == 200
    finally:
        srv.close()
    srv.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        srv.batcher.submit(np.zeros((1, 3)))


def test_serve_command_answers_and_drains_on_sigterm(models):
    """``python -m hdbscan_tpu_torch serve`` binds port 0, writes the port
    file, answers, and exits 0 on SIGTERM."""
    d, paths, _ = models
    port_file = os.path.join(d, "port.txt")
    trace = os.path.join(d, "cli_serve.jsonl")
    proc = subprocess.Popen(
        [sys.executable, "-m", "hdbscan_tpu_torch", "serve", "--model", paths["a"],
         "--port", "0", "--port-file", port_file, "--trace-out", trace, "--device", "cpu",
         "predict_batch=64"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.time() + 120
        while not os.path.exists(port_file) and time.time() < deadline:
            assert proc.poll() is None, proc.communicate()
            time.sleep(0.1)
        time.sleep(0.05)
        with open(port_file) as f:
            port = int(f.read())
        q = ClusterModel.load(paths["a"]).data[:100]
        status, _, body = _call(f"http://127.0.0.1:{port}", "/predict", {"points": q.tolist()})
        want = Predictor(ClusterModel.load(paths["a"]), device="cpu").predict(q)[0]
        assert status == 200 and json.loads(body)["labels"] == want.tolist()
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "hdbscan-tpu serve: http://127.0.0.1:" in err and "buckets [8, 16, 32, 64]" in err
    _run_script("check_trace.py", trace)


# -- the port's server against the reference's ------------------------------


@pytest.fixture(scope="module")
def twins(models):
    """The port's server and the reference's on the CPU over the same saved
    model, with the same batch ceiling: (port url, reference url, port
    server, reference server, model)."""
    from hdbscan_tpu.serve import ClusterModel as RefModel
    from hdbscan_tpu.serve import ClusterServer as RefServer

    _, paths, _ = models
    model = ClusterModel.load(paths["a"])
    port = ClusterServer(model, port=0, device="cpu", max_batch=64)
    ref = None
    try:
        ref = RefServer(RefModel.load(paths["a"]), port=0, max_batch=64)
        port.start()
        ref.start()
        yield (f"http://{port.host}:{port.port}", f"http://{ref.host}:{ref.port}", port, ref,
               model)
    finally:
        port.close()
        if ref is not None:
            ref.close()


def _twin_queries(model, rows, seed):
    rng = np.random.default_rng(seed)
    return np.round(model.data[rng.integers(0, model.n_train, rows)]
                    + rng.normal(0, 1, size=(rows, model.data.shape[1])))


_TWIN_REQUESTS = {
    "predict_1": ("/predict", {"rows": 1}, None),
    "predict_7": ("/predict", {"rows": 7}, None),
    "predict_256": ("/predict", {"rows": 256}, None),
    "predict_300": ("/predict", {"rows": 300}, None),
    "membership": ("/predict", {"rows": 9, "membership": True}, None),
    "bad_json": ("/predict", b"{not json", None),
    "missing_points": ("/predict", {"nopoints": 1}, None),
    "wrong_dims": ("/predict", {"points": [[1.0, 2.0]]}, None),
    "deadline_past": ("/predict", {"rows": 3}, {"X-Deadline-Ms": "0.000001"}),
    "deadline_bogus": ("/predict", {"rows": 3}, {"X-Deadline-Ms": "bogus"}),
    "deadline_negative": ("/predict", {"rows": 3}, {"X-Deadline-Ms": "-5"}),
    "unknown_get": ("/nowhere", None, None),
    "unknown_post": ("/nowhere", {"rows": 1}, None),
    "swap_nothing_staged": ("/swap", {}, None),
    "ingest_off": ("/ingest", {"rows": 3}, None),
}


@pytest.mark.parametrize("case", list(_TWIN_REQUESTS))
def test_responses_equal_reference_server(twins, case):
    """One request to each server: equal status and equal JSON body (the
    port's dispatch is bitwise with the reference's on the CPU, and the
    response rounds the same way), the ``X-Request-Id`` header on the same
    responses."""
    url_port, url_ref, _, _, model = twins
    path, body, headers = _TWIN_REQUESTS[case]
    if isinstance(body, dict) and "rows" in body:
        body = {**{k: v for k, v in body.items() if k != "rows"},
                "points": _twin_queries(model, body["rows"], len(case)).tolist()}
    got, want = _call(url_port, path, body, headers), _call(url_ref, path, body, headers)
    assert got[0] == want[0], (got, want)
    assert json.loads(got[2]) == json.loads(want[2])
    assert ("X-Request-Id" in got[1]) == ("X-Request-Id" in want[1])


def test_healthz_and_metrics_equal_reference_server(twins):
    """After the same requests: ``/healthz`` has the reference's keys plus
    ``device``, with equal model summary, backend, buckets, warmup keys,
    batcher statistics and per-route counts; the two scrapes name the same
    metric families of the same types."""
    url_port, url_ref, _, _, model = twins
    q = _twin_queries(model, 5, 99).tolist()
    for url in (url_port, url_ref):
        assert _call(url, "/predict", {"points": q})[0] == 200
    got, want = (json.loads(_call(u, "/healthz")[2]) for u in (url_port, url_ref))
    assert set(got) == set(want) | {"device"}
    for key in ("status", "model", "backend", "buckets", "generation", "swaps", "requests",
                "in_flight"):
        assert got[key] == want[key], key
    assert set(got["warmup"]) == set(want["warmup"])
    assert got["batcher"] == want["batcher"]

    def families(text):
        return {tuple(line.split()[2:4]) for line in text.splitlines()
                if line.startswith("# TYPE ")}

    got, want = (families(_call(u, "/metrics")[2]) for u in (url_port, url_ref))
    assert got == want


def test_queue_bound_sheds_like_reference(models):
    """``serve_queue_bound=1`` with the dispatch held: the first request
    dispatches, the second queues, the third is shed — by both servers
    with the same 503, body and ``Retry-After``, and both held requests
    are then served."""
    from hdbscan_tpu.serve import ClusterModel as RefModel
    from hdbscan_tpu.serve import ClusterServer as RefServer

    _, paths, _ = models
    kw = dict(port=0, max_batch=8, linger_s=0.0, queue_bound=1, warmup=False)
    servers = [ClusterServer(ClusterModel.load(paths["a"]), device="cpu", **kw)]
    gate = threading.Event()
    results = []
    try:
        servers.append(RefServer(RefModel.load(paths["a"]), **kw))
        pts = {"points": [[1.0, 2.0, 3.0]]}
        for srv in servers:
            srv.start()
            url = f"http://{srv.host}:{srv.port}"
            gate.clear()
            pred = srv._handle.predictor
            orig = pred.predict
            pred.predict = lambda x, orig=orig: (gate.wait(TIMEOUT), orig(x))[1]
            held, threads = [], []
            for want_q in (0, 1):  # one dispatching, one queued
                threads.append(threading.Thread(
                    target=lambda: held.append(_call(url, "/predict", pts)[0])))
                threads[-1].start()
                deadline = time.monotonic() + TIMEOUT
                while srv.batcher._q.qsize() != want_q and time.monotonic() < deadline:
                    time.sleep(0.001)
                time.sleep(0.05)  # the worker holds the first in the gated predict
            status, hdr, body = _call(url, "/predict", pts)
            gate.set()
            for t in threads:
                t.join(TIMEOUT)
            results.append((status, hdr.get("Retry-After"), json.loads(body), sorted(held),
                            srv.batcher.stats["shed"]))
    finally:
        gate.set()
        for srv in servers:
            srv.close()
    assert results[0] == results[1]
    assert results[0][0] == 503 and results[0][2]["reason"] == "queue_full"
    assert results[0][3] == [200, 200] and results[0][4] == 1

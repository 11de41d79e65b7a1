"""Streaming on the port's server (``ClusterServer(ingest=True)``) and the
``serve --ingest`` command on the CPU, against the reference's server and
command over the same saved model and the same ingest batches.

- The re-fit leg: in-distribution batches, then a shifted half that flags
  drift and kicks a background re-fit (the dense fit, the reference at its
  float32 production setting), which publishes under ``model_dir`` and
  swaps in. Every ``/ingest`` response, the ``/healthz`` stream block,
  the post-swap predictions and the ``/metrics`` families are the
  reference's; the trace passes ``scripts/check_trace.py``.
- The maintenance leg (``stream_maintain=incremental`` with a WAL): equal
  responses, the maintainer's ``state_dict`` (MST and edit-journal sha256)
  equal to the reference's after every batch, the padded maintained model
  predicting as the reference's, and recovery on reopen in either package
  verifying the watermark; the fallback ladder demotes to a re-fit as the
  reference's does.
- The stream options one at a time against the reference's server.
- The command: ``serve --ingest --model-dir`` of both packages as
  subprocesses answering equally; the port's killed with SIGKILL and
  restarted on its WAL recovers to the state it acknowledged.

The data lie on an integer grid, where the port's predictor is bitwise the
reference's. Servers bind port 0 and close in a ``finally``.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.serve import ClusterModel as RefModel
from hdbscan_tpu.serve import ClusterServer as RefServer
from hdbscan_tpu_torch.config import HDBSCANParams
from hdbscan_tpu_torch.models import hdbscan
from hdbscan_tpu_torch.serve import ClusterModel, ClusterServer, Predictor
from hdbscan_tpu_torch.utils.tracing import JsonlSink, Tracer
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60
CENTERS = np.array([[0.0, 0.0, 0.0], [24.0, 24.0, 24.0], [0.0, 32.0, 0.0]])
NOVEL = np.array([60.0, -30.0, 20.0])
BASE = dict(min_points=8, min_cluster_size=25)
#: /healthz stream fields that carry times or paths.
VOLATILE = ("refit_last_error_at", "wal")
#: The /healthz stream fields the WAL restores (drift checks and model
#: refreshes are not journaled, in either package).
RESTORED = ("rows_seen", "absorbed_exact", "absorbed_near", "buffered", "bubbles", "drift_rows")
MAINTAINED = ("active", "fallbacks", "n", "inserts", "splices", "pending_edges")


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    """One dense fit of three grid blobs, saved; both packages load it."""
    rng = np.random.default_rng(0)
    x = np.round(CENTERS[np.arange(600) % 3] + rng.normal(0, 2, (600, 3)))
    p = HDBSCANParams(**BASE)
    d = tmp_path_factory.mktemp("stream")
    return hdbscan.fit(x, p, device="cpu").to_cluster_model(x, p).save(str(d / "model.npz"))


@pytest.fixture
def x32():
    """The reference at its production setting (float32) for the whole
    test, its re-fit worker thread included."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def _batch(seed, rows, center=None):
    rng = np.random.default_rng(seed)
    c = CENTERS[np.arange(rows) % 3] if center is None else center
    return np.round(c + rng.normal(0, 2, (rows, 3)))


def _call(url, path, obj=None):
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url + path, data=data)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _post(url, path, obj):
    status, body = _call(url, path, obj)
    assert status == 200, body
    return json.loads(body)


def _stream(health):
    return {k: v for k, v in health["stream"].items() if k not in VOLATILE}


def _restored(health):
    st = health["stream"]
    return ({k: st[k] for k in RESTORED}, {k: st["maintain"][k] for k in MAINTAINED})


def _families(text):
    return {tuple(line.split()[2:4]) for line in text.splitlines() if line.startswith("# TYPE ")}


def _servers(path, tmp, knobs, wal=False, tracer=None):
    """The port's and the reference's servers over ``path`` with the same
    stream knobs, each with its own model (and WAL) directory; ``tracer``
    traces the port's."""
    def dirs(name):
        return dict(model_dir=str(tmp / f"{name}_models"),
                    wal_dir=str(tmp / f"{name}_wal") if wal else None)

    port = ClusterServer(ClusterModel.load(path), port=0, device="cpu", max_batch=64,
                         ingest=True, params=HDBSCANParams(**BASE, **knobs), tracer=tracer,
                         **dirs("port"))
    try:
        ref = RefServer(RefModel.load(path), port=0, max_batch=64, ingest=True,
                        params=RefParams(**BASE, **knobs), **dirs("ref"))
    except BaseException:
        port.close()
        raise
    return port, ref


def _wait_generation(servers, gen):
    deadline = time.monotonic() + 120
    while any(s.generation < gen for s in servers) and time.monotonic() < deadline:
        time.sleep(0.05)
    for s in servers:
        assert s.generation == gen, s.health()["stream"]
        assert s.refitter.join(timeout=TIMEOUT)


def test_drift_refit_swap_equals_reference(model_path, tmp_path, x32):
    """The re-fit leg over HTTP, the port traced."""
    trace = str(tmp_path / "trace.jsonl")
    tracer = Tracer(sinks=[JsonlSink(trace, static={"process": 0})])
    port, ref = _servers(model_path, tmp_path, dict(stream_refit_budget=100_000), wal=True,
                         tracer=tracer)
    try:
        urls = [f"http://{s.host}:{s.port}" for s in (port.start(), ref.start())]
        batches = [_batch(i, 64) for i in range(4)] + [_batch(10 + i, 64, NOVEL)
                                                       for i in range(4)]
        kicked = False
        for i, pts in enumerate(batches):
            got, want = (_post(u, "/ingest", {"points": pts.tolist()}) for u in urls)
            assert got == want, i
            if got["refit_started"]:
                kicked = True
                _wait_generation((port, ref), 2)
        assert kicked and port.generation == 2
        assert port.refitter.last_path.endswith("model_gen0001.npz")
        q = np.concatenate([_batch(30, 20), _batch(31, 20, NOVEL)])
        got, want = (_post(u, "/predict", {"points": q.tolist()}) for u in urls)
        assert got == want and got["generation"] == 2
        got, want = (_post(u, "/ingest", {"points": q.tolist()}) for u in urls)
        assert got == want
        health = [json.loads(_call(u, "/healthz")[1]) for u in urls]
        assert _stream(health[0]) == _stream(health[1])
        assert health[0]["stream"]["wal"]["seq"] == health[1]["stream"]["wal"]["seq"]
        assert _families(_call(urls[0], "/metrics")[1]) == _families(_call(urls[1],
                                                                           "/metrics")[1])
        assert "hdbscan_tpu_circuit_state" in _call(urls[0], "/metrics")[1]
    finally:
        port.close()
        ref.close()
        tracer.close()
    stages = [e.name for e in tracer.events]
    for stage in ("stream_ingest", "drift_check", "model_swap", "wal_append", "request_span"):
        assert stage in stages
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "check_trace.py"), trace],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_maintenance_and_recovery_equal_reference(model_path, tmp_path):
    """The maintenance leg, in process: equal responses and maintainer
    digests after every batch, the maintained model's predictions, and the
    WAL watermark verified on reopen across the packages."""
    knobs = dict(stream_maintain="incremental", maintain_refresh_every=16,
                 stream_snapshot_every=2, stream_refit_budget=32)
    port, ref = _servers(model_path, tmp_path, knobs, wal=True)
    try:
        for i in range(6):
            pts = _batch(40 + i, 12, NOVEL + 8 * i)
            got, want = port.ingest(pts), ref.ingest(pts)
            assert got == want, i
            assert port.maintainer.state_dict() == ref.maintainer.state_dict(), i
        stats = port.maintain_stats()
        assert stats == ref.maintain_stats() and stats["refreshes"] >= 2
        assert port.generation == ref.generation == 1 + stats["refreshes"]
        assert port.refitter.refits_ok == 0  # the active maintainer holds the budget
        assert port.model.fingerprint == ref.model.fingerprint  # the padded model
        q = np.concatenate([_batch(60, 16, NOVEL + 8 * i) for i in range(6)] + [_batch(61, 9)])
        got, want = port.predict(q), ref.predict(q)
        assert got == want and max(got["labels"]) > 0
        mark = port.maintainer.state_dict()
    finally:
        port.close()
        ref.close()
    params = HDBSCANParams(**BASE, **knobs)
    for wal in ("port_wal", "ref_wal"):
        for kind in ("port", "ref"):
            cls = ClusterServer if kind == "port" else RefServer
            kw = {"device": "cpu"} if kind == "port" else {}
            srv = cls((ClusterModel if kind == "port" else RefModel).load(model_path), port=0,
                      max_batch=64, ingest=True, wal_dir=str(tmp_path / wal),
                      params=params if kind == "port" else RefParams(**BASE, **knobs),
                      model_dir=str(tmp_path / "reopen"), **kw)
            try:
                assert srv.maintainer is not None, srv.maintain_last_error
                assert srv.maintainer.state_dict() == mark, (wal, kind)
                assert srv.journal.last_recover["snapshot"] is True
            finally:
                srv.close()


def test_maintain_fallback_demotes_to_refit_like_reference(model_path, tmp_path, x32):
    knobs = dict(stream_maintain="incremental", maintain_refresh_every=1,
                 maintain_dirty_max_frac=1e-9, stream_refit_budget=100_000,
                 stream_drift_threshold=50.0)
    port, ref = _servers(model_path, tmp_path, knobs)
    try:
        pts = _batch(70, 8, NOVEL)
        got, want = port.ingest(pts), ref.ingest(pts)
        assert got == want
        assert got["maintained"]["fallback"] is True and got["refit_started"] is True
        assert port.maintain_stats() == ref.maintain_stats()
        assert "dirty fraction" in port.maintain_last_error
        _wait_generation((port, ref), 2)
        q = _batch(71, 30)
        assert port.predict(q) == ref.predict(q)
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("option", ["ingest", "model_dir", "wal_dir", "stream_maintain",
                                    "stream_wal_dir"])
def test_stream_options_equal_reference(model_path, tmp_path, option):
    """Each stream option alone, as the reference's server takes it:
    without ``ingest=True`` the server keeps no stream (and ``/ingest`` is
    refused the same way), with it one batch answers equally and the
    ``/healthz`` stream blocks agree."""
    wal = str(tmp_path / f"{option}_wal")
    kw = {"ingest": {"ingest": True}, "model_dir": {"model_dir": str(tmp_path / "m")},
          "wal_dir": {"ingest": True, "wal_dir": wal},
          "stream_maintain": {"ingest": True},
          "stream_wal_dir": {"ingest": True}}[option]
    knobs = {"stream_maintain": {"stream_maintain": "incremental"},
             "stream_wal_dir": {"stream_wal_dir": wal}}.get(option, {})
    servers = [ClusterServer(ClusterModel.load(model_path), port=0, device="cpu", max_batch=64,
                             params=HDBSCANParams(**BASE, **knobs), **kw)]
    try:
        servers.append(RefServer(RefModel.load(model_path), port=0, max_batch=64,
                                 params=RefParams(**BASE, **knobs), **kw))
        pts = _batch(80, 20, NOVEL)
        outs = []
        for srv in servers:
            try:
                outs.append(srv.ingest(pts))
            except RuntimeError as e:
                outs.append(str(e))
        assert outs[0] == outs[1]
        health = [srv.health() for srv in servers]
        assert ("stream" in health[0]) == ("stream" in health[1]) == kw.get("ingest", False)
        if kw.get("ingest"):
            assert _stream(health[0]) == _stream(health[1])
            assert ("wal" in health[0]["stream"]) == ("wal" in health[1]["stream"]) == (
                option in ("wal_dir", "stream_wal_dir"))
    finally:
        for srv in servers:
            srv.close()


def _start_cli(argv, port_file, env=None):
    proc = subprocess.Popen([sys.executable, "-m", *argv, "--port", "0", "--port-file",
                             port_file], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    deadline = time.time() + 120
    while not os.path.exists(port_file) and time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(proc.communicate())
        time.sleep(0.05)
    time.sleep(0.05)
    with open(port_file) as f:
        return proc, f"http://127.0.0.1:{int(f.read())}"


def test_serve_ingest_cli_equals_reference_and_survives_sigkill(model_path, tmp_path):
    """``serve --ingest --model-dir`` with a WAL and maintenance, the port's
    command beside the reference's: equal ``/ingest`` answers and stream
    state; the port's process killed with SIGKILL and restarted on its WAL
    comes back to the state it acknowledged, its watermark verified."""
    knobs = ["maintain=incremental", "maintain_refresh=16", "snapshot_every=2",
             "refit_budget=100000", "predict_batch=8"]
    port_file = str(tmp_path / "port.txt")
    ref_file = str(tmp_path / "ref.txt")
    argv = ["serve", "--model", model_path, "--ingest"]
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    procs = []
    try:
        port, url = _start_cli(["hdbscan_tpu_torch", *argv, "--model-dir",
                                str(tmp_path / "pm"), f"wal_dir={tmp_path / 'pw'}", *knobs,
                                "--device", "cpu"], port_file)
        procs.append(port)
        ref, ref_url = _start_cli(["hdbscan_tpu", *argv, "--model-dir", str(tmp_path / "rm"),
                                   f"wal_dir={tmp_path / 'rw'}", *knobs], ref_file, env)
        procs.append(ref)
        for i in range(5):
            pts = _batch(90 + i, 10, NOVEL + 8 * i).tolist()
            assert _post(url, "/ingest", {"points": pts}) == _post(ref_url, "/ingest",
                                                                    {"points": pts})
        before = json.loads(_call(url, "/healthz")[1])
        assert _stream(before) == _stream(json.loads(_call(ref_url, "/healthz")[1]))
        assert before["stream"]["maintain"]["splices"] >= 2
        port.send_signal(signal.SIGKILL)
        port.communicate(timeout=TIMEOUT)
        ref.send_signal(signal.SIGTERM)
        _, err = ref.communicate(timeout=TIMEOUT)
        assert ref.returncode == 0, err
        assert "ingest on (psi drift @ 2.0, auto reload)" in err
        os.unlink(port_file)
        port, url = _start_cli(["hdbscan_tpu_torch", *argv, "--model-dir",
                                str(tmp_path / "pm"), f"wal_dir={tmp_path / 'pw'}", *knobs,
                                "--device", "cpu"], port_file)
        procs.append(port)
        after = json.loads(_call(url, "/healthz")[1])
        assert _restored(after) == _restored(before)
        assert after["stream"]["maintain"]["active"] is True
        assert after["stream"]["wal"]["last_recover"]["snapshot"] is True
        port.send_signal(signal.SIGTERM)
        _, err = port.communicate(timeout=TIMEOUT)
        assert port.returncode == 0, err
        assert "ingest on (psi drift @ 2.0, auto reload)" in err
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

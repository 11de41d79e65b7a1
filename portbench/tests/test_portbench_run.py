"""Runs of the harness on the CPU at small sizes: the result's keys, and
``correct`` turning false under each fault a cell can have, planted in the
port underneath the timed path."""

import time

import numpy as np
import pytest
import torch

from conftest import small_cell
from portbench import harness, spec

CPU = [torch.device("cpu")]
SMALL = {"config": {"n": 2000, "min_cluster_size": 40}}
SERVE = {"config": {"n": 2000, "min_cluster_size": 40},
         "traffic": {"pool_rows": 20_000, "clients": 4, "sample_requests": 8}}


def run(cell, seed=123456789012, trace=False, devices=CPU):
    return harness.run(cell, seed, 0.5, trace, devices, time.perf_counter())


def test_result_keys_fit():
    r = run(small_cell("skin.fit", **SMALL))
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] and set(r["metrics"]) == {"fit_s", "setup_s"}
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["checks"]) == {"core_gap", "mst_gap", "mst_excess", "label_rows"}


def test_result_keys_traced_and_serving():
    r = run(small_cell("hepmass28.fit", **SMALL), trace=True)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "checks"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert "finalize_s.fit" in r["metrics"]
    r = run(small_cell("skin.predict", **SERVE))
    assert r["correct"] and set(r["metrics"]) == {"predict_rows_s", "predict_p95_ms", "setup_s"}
    assert set(r["checks"]) == {"label_rows", "prob_gap", "fit_label_rows", "fit_mst_excess"}


def _wrap(monkeypatch, mod, name, make):
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, make(orig))


def fault_answer_altered(monkeypatch):
    from hdbscan_tpu_torch.models import exact

    def make(orig):
        def fit(data, params, **kw):
            res = orig(data, params, **kw)
            res.labels = res.labels.copy()
            res.labels[0] = res.labels.max() + 1
            return res
        return fit
    _wrap(monkeypatch, exact, "fit", make)


def fault_half_left_out(monkeypatch):
    from hdbscan_tpu_torch.models import exact

    def make(orig):
        def fit(data, params, **kw):
            half = orig(data[: len(data) // 2], params, **kw)
            rest = len(data) - len(half.labels)
            half.labels = np.concatenate([half.labels, np.zeros(rest, np.int64)])
            half.core_distances = np.concatenate([half.core_distances, np.zeros(rest)])
            return half
        return fit
    _wrap(monkeypatch, exact, "fit", make)


def fault_step_unchanged(monkeypatch):
    from hdbscan_tpu_torch.ops import cuda_segmin

    def make(orig):
        def scan(*a, **kw):  # a Borůvka round that finds nothing leaves the state as it was
            w, j = orig(*a, **kw)
            return torch.full_like(w, float("inf")), j
        return scan
    _wrap(monkeypatch, cuda_segmin, "min_outgoing_all_rows", make)


@pytest.mark.parametrize("fault", [fault_answer_altered, fault_half_left_out,
                                   fault_step_unchanged])
def test_fit_faults_fail(monkeypatch, fault):
    cell = small_cell("skin.fit", **SMALL)
    fault(monkeypatch)
    assert not run(cell)["correct"]


def test_exchange_left_out_fails(monkeypatch):
    """The fit loop over a mesh (traffic ``mesh``) of four CPU shards,
    sharded as on four cards; with the ring's hand-over returning each shard
    its own panel the run is not correct, without it it is."""
    from hdbscan_tpu_torch.parallel import ring, shard

    over = {"config": {"n": 2048, "min_cluster_size": 40,
                       "params": {"knn_index": "exact", "fit_sharding": "sharded"}},
            "traffic": {"mesh": True}}
    cell = small_cell("hepmass28.fit", **over)
    assert run(cell, devices=CPU * 4)["correct"]

    def own(mesh, panels, step, rows):
        return dict(panels)
    for mod in (ring, shard):
        if hasattr(mod, "ring_shift"):
            monkeypatch.setattr(mod, "ring_shift", own)
    assert not run(cell, devices=CPU * 4)["correct"]


def fault_predict_altered(monkeypatch):
    from hdbscan_tpu_torch.serve.predict import Predictor

    def make(orig):
        def predict(self, X, with_membership=False):
            labels, prob, score = orig(self, X, with_membership)
            labels = labels.copy()
            labels[0] = labels.max() + 1
            return labels, prob, score
        return predict
    _wrap(monkeypatch, Predictor, "predict", make)


def fault_predict_half(monkeypatch):
    from hdbscan_tpu_torch.serve.predict import Predictor

    def make(orig):
        def predict(self, X, with_membership=False):
            h = (len(X) + 1) // 2
            labels, prob, score = orig(self, X[:h], with_membership)
            pad = len(X) - h
            return (np.concatenate([labels, np.zeros(pad, np.int64)]),
                    np.concatenate([prob, np.zeros(pad)]), np.concatenate([score, np.zeros(pad)]))
        return predict
    _wrap(monkeypatch, Predictor, "predict", make)


@pytest.mark.parametrize("fault", [fault_predict_altered, fault_predict_half])
def test_predict_faults_fail(monkeypatch, fault):
    cell = small_cell("skin.predict", **SERVE)
    loop = spec.kind("closed_loop").Loop
    orig = loop.setup

    def setup(self):  # the fault goes in under the timed path, after set-up
        orig(self)
        fault(monkeypatch)
    monkeypatch.setattr(loop, "setup", setup)
    assert not run(cell)["correct"]

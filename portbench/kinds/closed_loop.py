"""Closed-loop serving: a fit of copy 0 saved with ``ClusterModel.save`` and
loaded back is served by ``MicroBatcher(Predictor(...))``; ``clients``
threads each send a request and the next when the reply arrives. A
request's rows are a slice of a seeded pool of novel queries; its size is
drawn from ``sizes`` log-uniform values between ``min_rows`` and
``max_rows`` that every seed shares, in a seeded order a client.

Traffic keys: ``clients``, ``min_rows``, ``max_rows``, ``sizes``,
``pool_rows``, ``backend``, ``max_batch``, ``linger_s``,
``sample_requests``, ``trace_seconds``. The end-to-end metrics are
``predict_rows_s`` and ``predict_p95_ms``.
"""

from __future__ import annotations

import math
import os
import tempfile
import threading
import time

import numpy as np

from portbench import compare, data as datagen, generator, reference


class Loop(generator.Loop):
    SPANS = (
        ("hdbscan_tpu_torch.serve.predict", "Predictor._stage", "stage"),
        ("hdbscan_tpu_torch.serve.predict", "Predictor._dispatch", "dispatch"),
        ("hdbscan_tpu_torch.serve.batcher", "MicroBatcher._collect", "batcher_collect"),
    )

    def __init__(self, cell: dict, seed: int, devices: list):
        super().__init__(cell, seed, devices)
        self.records: list = []
        self.lock = threading.Lock()

    def setup(self) -> None:
        from hdbscan_tpu_torch.models import exact
        from hdbscan_tpu_torch.serve.artifact import ClusterModel
        from hdbscan_tpu_torch.serve.batcher import MicroBatcher
        from hdbscan_tpu_torch.serve.predict import Predictor

        t = self.traffic
        self.params = generator.params_for(self.config)
        self.data0 = self.data(0)
        fit = self.fit = exact.fit(self.data0, self.params, device=self.devices[0])
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "model.npz")
            ClusterModel.from_fit_result(fit, self.data0, self.params).save(path)
            self.model = ClusterModel.load(path)
        self.predictor = Predictor(self.model, backend=t["backend"], max_batch=t["max_batch"],
                                   device=self.devices[0])
        self.predictor.warmup()
        self.batcher = MicroBatcher(self.predictor, linger_s=t["linger_s"])
        rng = datagen.rng_for(self.seed, 1)
        self.pool = datagen.novel_queries(self.data0, t["pool_rows"], rng)
        lo, hi = math.log(t["min_rows"]), math.log(t["max_rows"])
        self.sizes = np.round(np.exp(np.linspace(lo, hi, t["sizes"]))).astype(np.int64)
        self.orders = [rng.permutation(self.sizes) for _ in range(t["clients"])]
        self.offsets = rng.integers(0, t["pool_rows"] - t["max_rows"], size=(t["clients"], 1 << 16))
        for b in self.predictor.buckets:  # the batcher's path at every bucket
            self.batcher.predict(self.pool[:b])

    def request(self, client: int, k: int) -> tuple[int, int]:
        """(pool offset, rows) of client ``client``'s ``k``-th request."""
        size = int(self.orders[client][k % len(self.sizes)])
        off = int(self.offsets[client][k % self.offsets.shape[1]])
        return off, size

    def client(self, c: int, t_end: float) -> None:
        k = 0
        while time.perf_counter() < t_end:
            off, size = self.request(c, k)
            meta: dict = {}
            t_submit = time.perf_counter()
            try:
                labels, prob, _ = self.batcher.submit(self.pool[off:off + size], meta).result()
                ok = True
            except Exception:  # noqa: BLE001 - a failed request is counted as missing
                labels = prob = None
                ok = False
            t_done = time.perf_counter()
            with self.lock:
                self.records.append((t_submit, t_done, off, size, ok, labels, prob,
                                     meta.get("t_dispatch")))
            k += 1

    def window(self, seconds: float, traced: bool = False) -> dict:
        before = dict(self.batcher.stats)
        t0 = time.perf_counter()
        t_end = t0 + seconds
        threads = [threading.Thread(target=self.client, args=(c, t_end))
                   for c in range(self.traffic["clients"])]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        after = self.batcher.stats
        self.batches = {key: after[key] - before[key] for key in ("rows", "batches")}
        self.window_s = seconds
        recs = self.records
        failed = sum(1 for r in recs if not r[4])
        rows = sum(r[3] for r in recs if r[4] and r[1] <= t_end)
        lat = np.array([(r[1] - r[0]) * 1e3 if r[4] else np.inf for r in recs])
        p95 = float(np.percentile(lat, 95)) if len(lat) else float("inf")
        return {"attempted": len(recs), "failed": failed,
                "metrics": {"predict_rows_s": rows / seconds, "predict_p95_ms": p95}}

    def context(self) -> dict:
        n, d = self.model.data.shape
        return {"batcher": self.batches, "training_shape": (n, d),
                "k": max(self.config["min_points"] - 1, 1),
                "queue_ms": [(r[7] - r[0]) * 1e3 for r in self.records
                             if r[4] and r[7] is not None]}

    def release(self) -> None:
        self.batcher.close()
        del self.predictor, self.batcher

    def check(self, limits: dict) -> dict:
        ok = [r for r in self.records if r[4]]
        if not ok:
            return {name: float("inf") for name in limits}
        rng = datagen.rng_for(self.seed, 1 << 21)
        take = min(len(ok), self.traffic["sample_requests"])
        longest = max(range(len(ok)), key=lambda i: ok[i][3])
        picks = {longest, *rng.choice(len(ok), take - 1, replace=False).tolist()}
        queries = np.concatenate([self.pool[ok[i][2]:ok[i][2] + ok[i][3]] for i in picks])
        labels = np.concatenate([ok[i][5] for i in picks])
        prob = np.concatenate([ok[i][6] for i in picks])
        self.records = []
        numbers, self.ref_seconds = predict_numbers(self.data0, self.fit, queries, labels, prob,
                                                    self.config, self.devices[:1])
        return numbers


def predict_numbers(data, fit, queries, labels, prob, config, devices) -> tuple[dict, dict]:
    """(the serving numbers, the reference's seconds): the served fit judged
    as a fit cell judges one (``fit_label_rows``, ``fit_mst_excess``), then
    the answers to ``queries`` against the reference's predictions from
    that fit."""
    fit_numbers, ref = reference.judge_fit(data, fit.labels, fit.core_distances, fit.mst,
                                           config["min_points"], config["min_cluster_size"],
                                           devices)
    out = {"fit_label_rows": fit_numbers["label_rows"],
           "fit_mst_excess": fit_numbers["mst_excess"]}
    if ref is None:
        return dict(out, label_rows=len(queries), prob_gap=float("inf")), None
    mapping = compare.matching(fit.labels, ref["labels"])
    ref_labels, ref_prob = reference.predict(ref, data, queries, config["min_points"])
    return (dict(out, **compare.predict_numbers(labels, prob, ref_labels, ref_prob, mapping)),
            ref["seconds"])


def readings(cell: dict, seed: int, side: str, precision: str, devices: list,
             rows: int) -> dict:
    """The cell's numbers for the served fit of the seed's first data copy
    and ``rows`` seeded query rows."""
    config, traffic = cell["config"], cell["traffic"]
    data = datagen.generate(config, seed, 0, cell["base"])
    fit, other = generator.side_fit(cell, data, side, precision, devices)
    queries = datagen.novel_queries(data, rows, datagen.rng_for(seed, 1))
    if side == "control":
        labels, prob = reference.predict(other, data, queries, config["min_points"])
    else:
        from hdbscan_tpu_torch.serve.artifact import ClusterModel
        from hdbscan_tpu_torch.serve.predict import Predictor

        model = ClusterModel.from_fit_result(fit, data, generator.params_for(config))
        pred = Predictor(model, backend=traffic["backend"], max_batch=traffic["max_batch"],
                         device=devices[0])
        labels, prob, _ = pred.predict(queries)
    return predict_numbers(data, fit, queries, labels, prob, config, devices[:1])[0]

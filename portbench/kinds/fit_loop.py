"""Fits back to back through ``models/exact.fit``, each on the next of
``copies`` seeded copies of the configuration's data (cycled), on one card,
or over a mesh of every card the cell takes where ``mesh`` is true
(``fit_sharding`` as the configuration states, ``auto`` picking the
sharded program on two or more cards, as the command line does).

Traffic keys: ``copies``, ``mesh``, ``trace_seconds``. Set-up fits copy 0
once at full size: that builds and loads every kernel the fits run, and
takes the one-time cost of the first full-size fit (on an H100 0.3-1.0 s
of a 10 s fit at 500,000 x 28 that a fit of a slice leaves to the window).
The end-to-end metric is ``fit_s``: the whole window over the fits
completed in it, the window ending with the last fit.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np

from portbench import data as datagen, generator, reference


def _exact():
    from hdbscan_tpu_torch.models import exact

    return exact


class Loop(generator.Loop):
    SPANS = (
        ("hdbscan_tpu_torch.models.exact", "fit", "fit"),
        ("hdbscan_tpu_torch.ops.tiled", "knn_core_distances", "core_distances"),
        ("hdbscan_tpu_torch.parallel.shard", "shard_core_distances", "core_distances"),
        ("hdbscan_tpu_torch.core.mst_device", "boruvka_mst_device", "boruvka_rounds"),
        ("hdbscan_tpu_torch.parallel.shard", "shard_boruvka_mst", "boruvka_rounds"),
        ("hdbscan_tpu_torch.core.mst_device", "forest_events_device", "forest_events"),
        ("hdbscan_tpu_torch.models.exact", "_fetch", "fetch"),
        ("hdbscan_tpu_torch.core.mst_device", "assemble_merge_forest", "host_forest"),
        ("hdbscan_tpu_torch.models._finalize", "finalize_clustering", "host_finalize"),
    )

    def __init__(self, cell: dict, seed: int, devices: list):
        super().__init__(cell, seed, devices)
        self.results: list = []
        self.events: list = []
        self.fit_walls: list = []
        self.done = 0

    def setup(self) -> None:
        self.params = generator.params_for(self.config)
        self.kw = generator.program_kw(self.traffic, self.devices)
        self.copies = [self.data(c) for c in range(self.traffic["copies"])]
        _exact().fit(self.copies[0], self.params, **self.kw)
        self.sync()

    def window(self, seconds: float, traced: bool = False) -> dict:
        trace = (lambda stage, **f: self.events.append((stage, f))) if traced else None
        t0 = time.perf_counter()
        i = failed = 0
        while time.perf_counter() - t0 < seconds:
            copy = i % len(self.copies)
            try:
                t = time.perf_counter()
                res = _exact().fit(self.copies[copy], self.params, trace=trace, **self.kw)
                self.fit_walls.append(time.perf_counter() - t)
                self.results.append((copy, res.labels, res.core_distances, res.mst))
            except Exception:  # noqa: BLE001 - a failed fit is counted, not fatal
                traceback.print_exc(file=sys.stderr)
                failed += 1
            i += 1
        self.window_s = time.perf_counter() - t0
        self.done = i - failed
        return {"attempted": i, "failed": failed,
                "metrics": {"fit_s": self.window_s / self.done if self.done else float("inf")}}

    def context(self) -> dict:
        return {"fits": self.done, "events": self.events}

    def notes(self) -> list:
        w = self.fit_walls
        if not w:
            return []
        q = np.quantile(w, [0, 0.25, 0.5, 0.75, 1])
        rest = f"{np.median(w[1:]):.4f}" if len(w) > 1 else "none"
        return ["portbench: fit walls s (min, q1, median, q3, max) "
                + " ".join(f"{x:.4f}" for x in q),
                f"portbench: first fit {w[0]:.4f} s, median of the rest {rest} s"]

    def release(self) -> None:
        self.kw.pop("mesh", None)

    def check(self, limits: dict) -> dict:
        if not self.results:
            return {name: float("inf") for name in limits}
        pick = int(datagen.rng_for(self.seed, 1 << 20).integers(len(self.results)))
        copy, labels, core, mst = self.results[pick]
        self.results = []
        numbers, ref = reference.judge_fit(self.copies[copy], labels, core, mst,
                                           self.config["min_points"],
                                           self.config["min_cluster_size"], self.devices)
        self.ref_seconds = ref and ref["seconds"]
        return numbers


def readings(cell: dict, seed: int, side: str, precision: str, devices: list,
             rows: int) -> dict:
    """The cell's numbers for a fit of the seed's first data copy."""
    config = cell["config"]
    data = datagen.generate(config, seed, 0, cell["base"])
    fit, _ = generator.side_fit(cell, data, side, precision, devices)
    return reference.judge_fit(data, fit.labels, fit.core_distances, fit.mst,
                               config["min_points"], config["min_cluster_size"], devices)[0]

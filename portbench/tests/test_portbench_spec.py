"""The harness finds every part of a cell by name, and a new configuration,
traffic mix, loop, data generator or per-layer metric needs only new files
and entries."""

import json
import os
import shutil
import time

import pytest
import torch

from portbench import generator, harness, spec

DUMMY_GENERATOR = '''"""Two blobs on the grid, for the test."""
import numpy as np


def generate(config, rng):
    half = config["n"] // 2
    a = rng.normal(40.0, 3.0, (half, config["dims"]))
    b = rng.normal(200.0, 3.0, (config["n"] - half, config["dims"]))
    return np.round(np.concatenate([a, b]))
'''

DUMMY_KIND = '''"""Fits of the whole set back to back, ``fits`` at most, for the test."""
import time

from portbench import generator, reference


class Loop(generator.Loop):
    SPANS = (("hdbscan_tpu_torch.models.exact", "fit", "dummy_fit"),)

    def setup(self):
        self.x = self.data(0)
        self.params = generator.params_for(self.config)

    def window(self, seconds, traced=False):
        from hdbscan_tpu_torch.models import exact

        t0 = time.perf_counter()
        self.fits = []
        while time.perf_counter() - t0 < seconds and len(self.fits) < self.traffic["fits"]:
            self.fits.append(exact.fit(self.x, self.params, device=self.devices[0]))
        self.window_s = time.perf_counter() - t0
        return {"attempted": len(self.fits), "failed": 0,
                "metrics": {"fit_s": self.window_s / len(self.fits)}}

    def context(self):
        return {"dummy_fits": len(self.fits)}

    def check(self, limits):
        res = self.fits[-1]
        return reference.judge_fit(self.x, res.labels, res.core_distances, res.mst,
                                   self.config["min_points"], self.config["min_cluster_size"],
                                   self.devices)[0]


def readings(cell, seed, side, precision, devices, rows):
    raise NotImplementedError
'''

DUMMY_METRIC = '''"""Calls of the port's fit that its own recorder saw, a fit of the loop."""
import importlib

from portbench import recorder


def record():
    return recorder.CallRecorder(importlib.import_module("hdbscan_tpu_torch.models.exact"), "fit")


def read(ctx):
    return ctx["recorded"].count / ctx["dummy_fits"] if ctx["dummy_fits"] else None
'''


def test_every_cell_resolves():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        assert cell["config"]["name"] == w["config"]
        kind = spec.kind(cell["traffic"]["kind"])
        assert callable(kind.readings) and issubclass(kind.Loop, generator.Loop)
        assert callable(spec.data_generator(cell["config"]["data"]["generator"]).generate)
        assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert callable(spec.metric(m["name"]).read)
        assert set(cell["limits"])


def test_config_files_hold_what_benchmark_names():
    bench = spec.load_benchmark()
    root = spec.ROOT
    for c in bench["configs"]:
        with open(os.path.join(root, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_dummy_entries_need_only_new_files(tmp_path):
    """A configuration with a data generator of its own, a traffic mix with
    a loop of its own and a per-layer metric with a recorder of its own,
    each a new file: the harness runs the cell, traced and not, and no file
    that was there changes."""
    base = tmp_path / "portbench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    (base / "data" / "dummy_blobs.py").write_text(DUMMY_GENERATOR)
    (base / "kinds" / "dummy_kind.py").write_text(DUMMY_KIND)
    (base / "metrics" / "dummy_fits.dummy.py").write_text(DUMMY_METRIC)
    (base / "configs" / "dummy.json").write_text(json.dumps(
        {"name": "dummy", "n": 300, "dims": 2, "min_points": 4, "min_cluster_size": 30,
         "params": {}, "data": {"generator": "dummy_blobs"}}))
    (base / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"kind": "dummy_kind", "fits": 2, "trace_seconds": 5}))
    (base / "limits" / "dummy.dummy-mix.json").write_text(json.dumps(
        {"core_gap": 0.0, "mst_gap": 0.0, "mst_excess": 0.0, "label_rows": 0}))
    bench = spec.load_benchmark()
    bench["configs"].append({"name": "dummy", "source": "x", "file": "portbench/configs/dummy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy.dummy-mix", "config": "dummy",
                               "traffic": "dummy-mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "dummy_fits.dummy", "unit": "fits", "better": "lower",
                               "source": "program_counter", "layer": "x", "moves": "fit_s",
                               "workloads": ["dummy.dummy-mix"]})
    bench["end_to_end"][0]["workloads"].append("dummy.dummy-mix")
    cell = spec.cell("dummy.dummy-mix", bench, base=str(base))
    assert [m["name"] for m in cell["per_layer"]] == ["dummy_fits.dummy"]
    assert {m["name"] for m in cell["end_to_end"]} == {"fit_s", "setup_s"}
    cpu = [torch.device("cpu")]
    r = harness.run(cell, 5, 30.0, False, cpu, time.perf_counter())
    assert r["correct"] and r["attempted"] == 2 and set(r["metrics"]) == {"fit_s", "setup_s"}
    r = harness.run(cell, 6, 30.0, True, cpu, time.perf_counter())
    assert r["correct"] and r["metrics"] == {"dummy_fits.dummy": {"value": 1.0, "unit": "fits"}}
    assert r["breakdown"]["idle_gaps"] == []  # no device ran: nothing idle to name
    for p, b in before.items():
        assert p.read_bytes() == b


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        spec.cell("no.such-cell")
    with pytest.raises(FileNotFoundError):
        spec.metric("no_such_metric")
    with pytest.raises(FileNotFoundError):
        spec.kind("no_such_kind")
    with pytest.raises(FileNotFoundError):
        spec.data_generator("no_such_generator")

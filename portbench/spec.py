"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root lists the cells (configuration,
traffic, chips) and the metrics. Each part is a file of its own, found by
its name under the benchmark's folder:

- ``configs/<config>.json``: the configuration; its ``data.generator``
  names ``data/<generator>.py`` (``generate(config, rng)``);
- ``traffic/<traffic>.json``: the traffic mix's parameters; its ``kind``
  names ``kinds/<kind>.py`` (a ``Loop`` class and ``readings``);
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``, and
  optionally ``record()``, the recorder it needs around the traced window;
- ``limits/<cell>.json``: the limit of each number that decides ``correct``.

A later configuration, mix, loop, data generator or metric is a new file
here and a new entry in ``BENCHMARK.json``; no file that is here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(folder: str, name: str, base: str = HERE) -> dict:
    path = os.path.join(base, folder, f"{name}.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {folder} file {path}")
    with open(path) as f:
        return json.load(f)


_MODULES: dict = {}


def module(folder: str, name: str, base: str = HERE):
    """The module ``<base>/<folder>/<name>.py``, loaded once by its path."""
    path = os.path.join(base, folder, f"{name}.py")
    if path not in _MODULES:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no {folder} module {path}")
        spec = importlib.util.spec_from_file_location(
            f"portbench_{folder}_{name}".replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def metric(name: str, base: str = HERE):
    """The reader module of per-layer metric ``name``."""
    return module("metrics", name, base)


def kind(name: str, base: str = HERE):
    """The loop module of traffic kind ``name``."""
    return module("kinds", name, base)


def data_generator(name: str, base: str = HERE):
    """The data generator module ``name``."""
    return module("data", name, base)


def _reports(m: dict, cell: str, cell_e2e: set) -> bool:
    if "workloads" in m:
        return cell in m["workloads"]
    return m.get("moves", m["name"]) in cell_e2e


def cell(name: str, bench: dict | None = None, base: str = HERE) -> dict:
    """Everything a run of cell ``name`` needs: its entry, configuration,
    traffic, limits, its end-to-end and per-layer metrics, and ``base``,
    the folder the parts were found in."""
    bench = load_benchmark() if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    return {
        "entry": entry,
        "config_entry": configs[entry["config"]],
        "config": _json("configs", entry["config"], base),
        "traffic": _json("traffic", entry["traffic"], base),
        "limits": _json("limits", name, base),
        "end_to_end": e2e,
        "per_layer": [m for m in bench["per_layer"] if _reports(m, name, names)],
        "base": base,
    }

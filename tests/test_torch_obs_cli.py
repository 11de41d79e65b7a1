"""The port's command line with the observability layer on the CPU, held to
the reference CLI (the twins of ``tests/e2e/test_obs_e2e.py``'s tier-1
legs and ``tests/e2e/test_telemetry_artifacts.py``'s single-process legs).

One integer grid goes through three routes — ``dense`` (the single-block
fit), ``mr`` (MR-HDBSCAN*) and ``sharded`` (the exact fit over a mesh of
four CPU shards, ``--device cpu,cpu,cpu,cpu``) — each once with every A11
flag (``--trace-out --report --flight-dir --assert-not-replicated
heartbeat= watchdog=``) and once without. Held:

- the five files are byte-equal with and without the flags, and equal to
  the reference CLI's (the sharded route: to the reference's ``exact.fit``
  plus ``write_outputs``, since its own sharded CLI route fails under the
  installed jax);
- the trace and report pass ``scripts/check_trace.py`` and the empty
  flight directory ``check_flight.py --allow-empty``;
- against the reference CLI's trace and report on the same file: the same
  observability stages and audited phases and the same report sections,
  apart from what earlier slices route differently (the port's finalize
  builds the merge forest through K3's device route where the reference's
  CPU run builds it on the host, and its glue pads fewer columns, so a
  660-row MR fit credits under 0.05 GFLOP and has no roofline row);
- the sharded route's timeline and roofline sections, and a replication
  gate that answers ``single_device`` for one CPU;
- ``--assert-not-replicated`` exits 3 when the (monkeypatched) per-device
  samples show a replicated buffer and passes sharded ones; a
  ``phase_stall`` fault writes a ``watchdog_stall`` bundle and a crash an
  ``exception`` bundle, both valid under ``check_flight.py``;
- ``predict --report`` writes a ``predict_latency`` section that
  recomputes from its trace.
"""

import contextlib
import io
import json
import math
import os

import jax
import numpy as np
import pytest

from hdbscan_tpu.cli import main as ref_main
from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.models import exact as ref_exact
from hdbscan_tpu.models.hdbscan import write_outputs as ref_write
from hdbscan_tpu.utils.io import load_points as ref_load
from hdbscan_tpu_torch import obs
from hdbscan_tpu_torch.cli import main as port_main
from hdbscan_tpu_torch.fault import inject
from hdbscan_tpu_torch.obs import audit
from hdbscan_tpu_torch.utils.telemetry import REPORT_SCHEMA
from scripts import check_flight, check_trace
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401

BASE = ["minPts=8", "minClSize=30", "seed=0"]
ROUTES = {
    "dense": (["processing_units=2000"], "cpu", ", exact, "),
    "mr": (["processing_units=256", "k=0.1"], "cpu", ", mr (3 levels), "),
    "sharded": (["processing_units=2000", "fit_sharding=sharded"], "cpu,cpu,cpu,cpu",
                ", exact-sharded, "),
}
OBS_FLAGS = ["--assert-not-replicated", "heartbeat=0.2", "watchdog=30"]
#: The stages the observability layer emits.
OBS_STAGES = {"mem_sample", "mem_phase_peak", "heartbeat", "device_timeline",
              "straggler_flag", "watchdog_stall", "replication_gate", "flight_dump"}
#: Stages of the port's routes the reference's CPU run does not emit, and
#: back: earlier slices' routing (the device merge-forest build in the
#: finalize, the MR pipeline's per-stage events) and the gate, which the
#: reference runs without here (its eight virtual devices would trip it).
PORT_ONLY = {"tree_build_device", "host_sync", "device_timeline", "global_cores", "block_fit",
             "level_stages", "replication_gate"}
REF_ONLY = {"tree_merge_forest"}


def _run(main, argv):
    """``main(argv)`` with stdout and stderr captured: (rc, out, err)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _files(out_dir) -> dict:
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), "rb") as f:
            out[name] = f.read()
    return out


def _stages(path) -> set:
    with open(path) as f:
        return {json.loads(line)["stage"] for line in f}


@pytest.fixture(scope="module")
def grid_file(tmp_path_factory):
    """660 points on an integer grid (five blobs and uniform noise)."""
    rng = np.random.default_rng(3)
    c = rng.uniform(0, 60, size=(5, 3))
    x = np.round(c[rng.integers(0, 5, 600)] + rng.normal(0, 3, size=(600, 3)))
    x = np.concatenate([x, rng.integers(0, 60, size=(60, 3))])
    path = tmp_path_factory.mktemp("obs_grid") / "grid.tsv"
    np.savetxt(path, x, delimiter="\t", fmt="%d")
    return str(path)


@pytest.fixture(scope="module")
def runs(grid_file, tmp_path_factory):
    """Every route with the flags and without, and the reference's run of
    it: {route: {dir, rc, out, err, ref_dir}}."""
    root = tmp_path_factory.mktemp("obs_cli")
    out = {}
    for route, (extra, device, _) in ROUTES.items():
        d = root / route
        d.mkdir()
        argv = ["fit", f"file={grid_file}", *BASE, *extra]
        rc, so, se = _run(port_main, argv + [
            f"out_dir={d / 'port'}", "--device", device, "--trace-out", str(d / "trace.jsonl"),
            "--report", str(d / "report.json"), "--flight-dir", str(d / "flight"), *OBS_FLAGS])
        plain = _run(port_main, argv + [f"out_dir={d / 'plain'}", "--device", device])
        with jax.enable_x64(False):
            if route == "sharded":
                params = RefParams.from_args(argv[1:] + [f"out_dir={d / 'ref'}"])
                ref_write(ref_exact.fit(ref_load(grid_file), params), params)
            else:
                ref = _run(ref_main, argv + [f"out_dir={d / 'ref'}", "--trace-out",
                                             str(d / "ref.jsonl"), "--report",
                                             str(d / "ref.json")])
                assert ref[0] == 0, ref[2][-2000:]
        out[route] = dict(dir=d, rc=rc, out=so, err=se, plain_rc=plain[0])
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_files_equal_without_flags_and_reference(runs, route):
    run = runs[route]
    assert run["rc"] == 0 and run["plain_rc"] == 0, run["err"][-2000:]
    assert ROUTES[route][2] in run["out"].splitlines()[0]
    port = _files(run["dir"] / "port")
    assert len(port) == 5
    assert port == _files(run["dir"] / "plain")
    assert port == _files(run["dir"] / "ref")


@pytest.mark.parametrize("route", list(ROUTES))
def test_trace_report_and_flight_dir_validate(runs, route):
    d = runs[route]["dir"]
    events, errors = check_trace.validate_trace(str(d / "trace.jsonl"))
    assert errors == [], errors
    report, errors = check_trace.validate_report(str(d / "report.json"), trace_events=events)
    assert errors == [], errors
    assert check_trace.main([str(d / "trace.jsonl"), str(d / "report.json")]) == 0
    assert report["schema"] == REPORT_SCHEMA
    # A healthy run leaves no bundle and no directory.
    assert not (d / "flight").exists()
    (d / "flight").mkdir()
    assert check_flight.main(["--allow-empty", str(d / "flight")]) == 0
    stages = {e["stage"] for e in events}
    assert {"mem_sample", "mem_phase_peak", "replication_gate"} <= stages
    # The dense block has no progress loop (as the reference's has none).
    assert ("heartbeat" in stages) == (route != "dense")
    assert "watchdog_stall" not in stages
    gate = [e for e in events if e["stage"] == "replication_gate"]
    assert len(gate) == 1 and gate[0]["ok"] is True and gate[0]["phases"] >= 1
    assert gate[0]["worst_fraction"] == 0.0  # one CPU: the single-device answer
    beats = [e for e in events if e["stage"] == "heartbeat"]
    assert all(0.0 <= e["progress"] <= 1.0 for e in beats)
    peaks = {e["phase"] for e in events if e["stage"] == "mem_phase_peak"}
    watermarks = report["memory"]["watermarks"]
    assert set(watermarks) == peaks
    for wm in watermarks.values():
        assert wm["samples"] >= 2 and wm["source"] == "live_arrays"
        assert 0 <= wm["max_device_bytes"] <= wm["total_bytes"]
    assert report["memory"]["start"]["source"] == report["memory"]["end"]["source"] == \
        "live_arrays"


@pytest.mark.parametrize("route", ["dense", "mr"])
def test_stages_and_sections_match_reference(runs, route):
    d = runs[route]["dir"]
    port, ref = _stages(d / "trace.jsonl"), _stages(d / "ref.jsonl")
    assert port - ref <= PORT_ONLY and ref - port <= REF_ONLY
    assert port & OBS_STAGES - {"device_timeline", "replication_gate"} == \
        ref & OBS_STAGES
    with open(d / "report.json") as f:
        rep = json.load(f)
    with open(d / "ref.json") as f:
        ref_rep = json.load(f)
    assert set(ref_rep) - {"roofline"} <= set(rep)
    assert set(rep) - set(ref_rep) <= {"mst_device", "timeline", "roofline"}
    assert set(rep["memory"]) == set(ref_rep["memory"]) == {"start", "end", "watermarks"}
    assert set(ref_rep["memory"]["watermarks"]) <= set(rep["memory"]["watermarks"])
    assert set(rep["memory"]["watermarks"]) - set(ref_rep["memory"]["watermarks"]) <= \
        {"tree_build_device"}
    for key in ("argv", "params", "backends", "topology", "env", "peak_flops", "sharding",
                "compile_cache", "package_version"):
        assert key in rep["manifest"] and key in ref_rep["manifest"]
    assert rep["manifest"]["torch_version"] and "cuda_version" in rep["manifest"]
    assert set(rep["manifest"]["compile_cache"]) == set(ref_rep["manifest"]["compile_cache"])


def test_sharded_timeline_and_roofline(runs):
    """The mesh of four CPU shards: per-shard device_timeline rows that
    telescope within 1e-6, the report's timeline table covering every
    traced phase, and a roofline that classifies each, tagged cpu_smoke."""
    d = runs["sharded"]["dir"]
    events, _ = check_trace.validate_trace(str(d / "trace.jsonl"))
    with open(d / "report.json") as f:
        rep = json.load(f)
    tl = [e for e in events if e["stage"] == "device_timeline"]
    mesh_rows = [e for e in tl if e["phase"] != "tree_build_device"]
    assert {e["device"] for e in mesh_rows} == set(range(4))
    for e in tl:
        assert math.isclose(e["compute_s"] + e["comm_s"] + e["host_s"], e["wall_s"],
                            rel_tol=0.0, abs_tol=1e-6)
        assert e["attribution"] == "model"
    assert any(e["comm_bytes"] > 0 for e in tl)
    table = rep["timeline"]
    assert set(table) == {e["phase"] for e in tl} >= {"ring_knn_scan", "shard_mst_device"}
    for name in ("ring_knn_scan", "shard_mst_device"):
        assert table[name]["rounds"] >= 1 and table[name]["devices"] == 4
        assert 0.0 <= table[name]["comm_frac"] <= 1.0 and table[name]["skew"] >= 1.0
    roof = rep["roofline"]
    assert roof["tags"] == ["cpu_smoke"] and roof["ridge_intensity"] > 0
    assert roof["peak_gflops_s"] == 67000.0 and roof["peak_gbytes_s"] == 3350.0
    assert set(table) <= set(roof["phases"])
    assert all(row["bound"] in ("compute", "memory", "comm") for row in roof["phases"].values())
    summary = [e for e in events if e["stage"] == "shard_mst_device"][0]
    assert len([e for e in tl if e["phase"] == "shard_mst_device"]) == 4 * summary["rounds"]


def test_manifest_records_argv_and_build_cache(runs):
    with open(runs["dense"]["dir"] / "report.json") as f:
        man = json.load(f)["manifest"]
    assert man["argv"][0].startswith("file=") and "--trace-out" in man["argv"]  # pre-pop
    assert man["params"]["min_points"] == 8
    assert man["backends"]["default_backend"] == "cpu"
    assert man["topology"] == {"platform": "cpu", "device_count": 1, "local_device_count": 1,
                               "process_count": 1, "process_index": 0,
                               "devices": [{"id": 0, "kind": "cpu", "process_index": 0}]}
    # The CPU builds no kernel: nothing to count, and the default directory.
    assert man["compile_cache"]["jit_compiles"] == 0 == man["compile_cache"]["cache_hits"]
    assert man["compile_cache"]["dir"].endswith(os.path.join(".torch_build", "cuda"))


# -- the telemetry artifacts' single-process legs ---------------------------


def test_ring_scan_roundtrip(grid_file, tmp_path):
    """``scan_backend=ring`` over four CPU shards: ring events satisfy the
    validator's invariants (``ppermute_steps == devices - 1``, one wall
    event a shard and summary) and the report round-trips with the
    backend recorded."""
    trace, report = str(tmp_path / "trace.jsonl"), str(tmp_path / "report.json")
    rc, _, err = _run(port_main, ["fit", f"file={grid_file}", *BASE, "processing_units=256",
                                  "k=0.1", "scan_backend=ring", f"out_dir={tmp_path / 'out'}",
                                  "--device", "cpu,cpu,cpu,cpu", "--trace-out", trace,
                                  "--report", report])
    assert rc == 0, err[-2000:]
    events, errors = check_trace.validate_trace(trace)
    assert errors == []
    summaries = [e for e in events if "ppermute_steps" in e]
    assert summaries and all(e["devices"] == 4 and e["ppermute_steps"] == 3 for e in summaries)
    walls = [e for e in events if e["stage"] == "ring_device_wall"]
    assert len(walls) == 4 * len(summaries)
    rep, errors = check_trace.validate_report(report, trace_events=events)
    assert errors == []
    assert rep["manifest"]["backends"]["scan_backend"] == "ring"
    assert {"ring_boruvka_scan"} <= set(rep["timeline"])


def test_no_flags_no_artifacts(grid_file, tmp_path):
    """Both flags absent: five outputs and nothing else; no layer stays
    installed after a run."""
    before = set(os.listdir(tmp_path))
    rc, _, _ = _run(port_main, ["fit", f"file={grid_file}", *BASE, "processing_units=2000",
                                f"out_dir={tmp_path / 'out'}", "--device", "cpu"])
    assert rc == 0
    assert set(os.listdir(tmp_path)) - before == {"out"}
    assert not [f for f in os.listdir(tmp_path / "out") if f.endswith((".jsonl", ".json"))]
    assert obs.auditor() is obs.heartbeats() is obs.timeline() is obs.flight() is None


def test_summary_prints_all_stages(grid_file, tmp_path):
    rc, _, err = _run(port_main, ["fit", f"file={grid_file}", *BASE, "processing_units=2000",
                                  f"out_dir={tmp_path / 'out'}", "--device", "cpu"])
    assert rc == 0 and "phases:" in err
    for stage in ("load_points", "block_edges", "fit", "write_outputs"):
        assert f"{stage}: n=" in err
    walls = [float(line.split("wall_s=")[1]) for line in err.split("phases:")[1].splitlines()
             if "wall_s=" in line]
    assert walls == sorted(walls, reverse=True)


# -- the gate, the watchdog and the flight recorder -------------------------


@pytest.mark.parametrize("replicated", [True, False], ids=["replicated", "sharded"])
def test_assert_not_replicated_on_per_device_samples(grid_file, tmp_path, monkeypatch,
                                                     replicated):
    """Fed per-device samples through ``obs/audit.sample_per_device``: a
    buffer of all n rows on each of four devices exits 3 with a
    ``replication_gate`` bundle; a quarter on each passes."""
    n, itemsize = 660, 8
    per = n * itemsize if replicated else n * itemsize // 4
    calls = [0]

    def sampler(source="auto"):
        calls[0] += 1
        return {f"cuda:{i}": 0 if calls[0] == 1 else per for i in range(4)}, "memory_stats"

    monkeypatch.setattr(audit, "sample_per_device", sampler)
    flight, trace = tmp_path / "flight", str(tmp_path / "trace.jsonl")
    rc, _, err = _run(port_main, ["fit", f"file={grid_file}", *BASE, "processing_units=2000",
                                  f"out_dir={tmp_path / 'out'}", "--device", "cpu",
                                  "--assert-not-replicated", "--flight-dir", str(flight),
                                  "--trace-out", trace])
    if replicated:
        assert rc == 3 and "error: replicated device buffer:" in err
        bundles = os.listdir(flight)
        assert len(bundles) == 1 and bundles[0].endswith("-replication_gate.json")
        assert check_flight.main([str(flight)]) == 0
        assert not (tmp_path / "out").exists()  # the gate runs before the files
    else:
        assert rc == 0, err[-2000:]
        events, errors = check_trace.validate_trace(trace)
        assert errors == []
        gate = [e for e in events if e["stage"] == "replication_gate"][0]
        assert 0 < gate["worst_fraction"] < 1.0
        assert not flight.exists()


def test_phase_stall_writes_a_watchdog_bundle(grid_file, tmp_path):
    """A ``phase_stall`` fault in the MR route's level beat outlasts
    ``watchdog``: a ``watchdog_stall`` event and bundle, and the fit
    still writes its five files."""
    flight, trace = tmp_path / "flight", str(tmp_path / "trace.jsonl")
    inject.install("phase_stall:count=1,delay_s=1.0")
    try:
        rc, _, err = _run(port_main, ["fit", f"file={grid_file}", *BASE,
                                      "processing_units=256", "k=0.1", "watchdog=0.2",
                                      "heartbeat=0.01", f"out_dir={tmp_path / 'out'}",
                                      "--device", "cpu", "--trace-out", trace,
                                      "--flight-dir", str(flight)])
    finally:
        inject.clear()
    assert rc == 0, err[-2000:]
    assert "[obs-watchdog] no heartbeat for" in err
    events, errors = check_trace.validate_trace(trace)
    assert errors == []
    stalls = [e for e in events if e["stage"] == "watchdog_stall"]
    assert stalls and stalls[0]["phases"] == ["mr_levels"]
    bundles = sorted(os.listdir(flight))
    assert bundles and all(b.endswith("-watchdog_stall.json") for b in bundles)
    bundle, errors = check_flight.validate_bundle(str(flight / bundles[0]))
    assert errors == [] and bundle["reason"] == "watchdog_stall"
    assert bundle["manifest"]["argv"][0].startswith("file=") and "watchdog" in bundle
    assert len(_files(tmp_path / "out")) == 5


def test_unhandled_exception_dumps_a_bundle(grid_file, tmp_path, monkeypatch):
    from hdbscan_tpu_torch.models import hdbscan

    def broken(*a, **kw):
        raise RuntimeError("injected fit failure")

    monkeypatch.setattr(hdbscan, "fit", broken)
    flight = tmp_path / "flight"
    with pytest.raises(RuntimeError, match="injected fit failure"):
        _run(port_main, ["fit", f"file={grid_file}", *BASE, "processing_units=2000",
                         f"out_dir={tmp_path / 'out'}", "--device", "cpu",
                         "--flight-dir", str(flight)])
    bundles = os.listdir(flight)
    assert len(bundles) == 1 and bundles[0].endswith("-exception.json")
    bundle, errors = check_flight.validate_bundle(str(flight / bundles[0]))
    assert errors == [] and "injected fit failure" in bundle["extra"]["error"]
    assert obs.flight() is None  # uninstalled by the driver's finally


def test_predict_report_latency_recomputes_from_trace(grid_file, tmp_path):
    model = str(tmp_path / "model.npz")
    rc, _, err = _run(port_main, ["fit", f"file={grid_file}", *BASE, "processing_units=2000",
                                  f"out_dir={tmp_path / 'out'}", "--device", "cpu",
                                  "--model-out", model])
    assert rc == 0, err[-2000:]
    trace, report = str(tmp_path / "p.jsonl"), str(tmp_path / "p.json")
    rc, out, err = _run(port_main, ["predict", "--model", model, "--points", grid_file,
                                    "--device", "cpu", "predict_batch=64", "--trace-out", trace,
                                    "--report", report])
    assert rc == 0, err[-2000:]
    events, errors = check_trace.validate_trace(trace)
    assert errors == []
    rep, errors = check_trace.validate_report(report, trace_events=events)
    assert errors == []
    lat = rep["predict_latency"]
    assert lat["count"] == sum(1 for e in events if e["stage"] == "predict_batch") >= 11
    assert lat["rows"] == 660 and lat["p50_s"] <= lat["p99_s"] <= lat["max_s"]
    assert rep["manifest"]["argv"][0] == "predict"

"""Mesh timelines, the roofline and the flight recorder of the port
(``hdbscan_tpu_torch/obs/timeline.py``, ``roofline.py``, ``flightrec.py``)
on the CPU, held to the reference's (the twin of
``tests/unit/test_timeline.py``).

The model constants differ by design — the port's comm model is one
H100's NVLink 4 (450 GB/s a direction) and its peaks the H100's, the
reference's a TPU link and chip — so the comparisons set both packages'
constants to one value first. Then the port's recorder emits the
reference's ``device_timeline`` and ``straggler_flag`` events for the same
walls, its phase tables and detector state are the reference's, and the
roofline section is the reference's on the same aggregates. The real scans
run on a mesh of four CPU shards (``parallel/mesh.get_mesh``): the ring
k-NN scan, an injected straggler shard (the ``phase_stall`` site in
``parallel/ring._per_device_walls``) and the sharded device Borůvka, whose
one wall a shard the recorder replays as modelled rounds.
"""

import glob
import importlib
import json
import math
import os
import threading
import time

import numpy as np
import pytest
import torch

from hdbscan_tpu.obs import roofline as ref_roofline
from hdbscan_tpu.utils import flops as ref_flops
from hdbscan_tpu.utils.tracing import Tracer as RefTracer
from hdbscan_tpu_torch import obs
from hdbscan_tpu_torch.config import HDBSCANParams
from hdbscan_tpu_torch.fault import inject
from hdbscan_tpu_torch.models import exact
from hdbscan_tpu_torch.obs import roofline
from hdbscan_tpu_torch.obs.audit import MemoryAuditor
from hdbscan_tpu_torch.obs.flightrec import FlightRecorder
from hdbscan_tpu_torch.obs.heartbeat import Heartbeats
from hdbscan_tpu_torch.obs.roofline import COMM_BOUND_FRAC, classify_bound, roofline_section
from hdbscan_tpu_torch.obs.timeline import MODEL_COMM_BYTES_S, TimelineRecorder, _split_exec
from hdbscan_tpu_torch.parallel.mesh import get_mesh
from hdbscan_tpu_torch.parallel.ring import ring_knn_core_distances
from hdbscan_tpu_torch.utils import flops as flops_mod
from hdbscan_tpu_torch.utils.tracing import JsonlSink, Tracer
from scripts import check_flight, check_trace
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401

# The facades' ``timeline()`` accessors shadow the submodules' names.
timeline = importlib.import_module("hdbscan_tpu_torch.obs.timeline")
ref_timeline = importlib.import_module("hdbscan_tpu.obs.timeline")

TILES = dict(row_tile=64, col_tile=128)
N_DEV = 4


@pytest.fixture(autouse=True)
def _clean_installs():
    """Never leak a process-global recorder or fault plan across tests."""
    yield
    obs.clear()
    inject.clear()


@pytest.fixture
def same_models(monkeypatch):
    """Both packages' comm model and peaks set to one value: the split and
    the roofline then compare exactly."""
    for mod in (timeline, ref_timeline):
        monkeypatch.setattr(mod, "MODEL_COMM_BYTES_S", 100e9)
    for mod in (flops_mod, ref_flops):
        monkeypatch.setattr(mod, "PEAK_FLOPS", 50e12)
    for mod in (roofline, ref_roofline):
        monkeypatch.setattr(mod, "PEAK_BYTES_S", 2e12)


def _events(tracer, stage):
    return [e for e in tracer.events if e.name == stage]


def _fields(tracer, stage):
    return [dict(e.fields, wall_s=e.wall_s) for e in _events(tracer, stage)]


def _blobs(n, d=5, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6.0, size=(4, d))
    pts = np.concatenate(
        [rng.normal(c, 0.8, size=(n // 4, d)) for c in centers]
        + [rng.normal(size=(n - 4 * (n // 4), d))]
    )
    return pts.astype(np.float64)


def _cpu_mesh():
    return get_mesh([torch.device("cpu")] * N_DEV)


class _Counter:
    """hdbscan_tpu_straggler_flags_total test double."""

    def __init__(self):
        self.calls = []

    def inc(self, value=1.0, **labels):
        self.calls.append((value, labels))


def _seeded_rounds(seed, rounds=12, n_dev=8):
    """Seeded per-round walls with a slow device now and then, host
    segments and traffic."""
    rng = np.random.default_rng(seed)
    slow = rng.integers(n_dev)
    out = []
    for _ in range(rounds):
        walls = rng.uniform(0.008, 0.012, n_dev)
        if rng.random() < 0.7:
            walls[slow] *= rng.uniform(2.0, 4.0)
        out.append(dict(walls=[(d, float(w)) for d, w in enumerate(walls)],
                        upload_s=float(rng.uniform(0, 0.004)),
                        fetch_s=float(rng.uniform(0, 0.004)),
                        comm_bytes=int(rng.integers(0, 1 << 24)),
                        flops=float(rng.uniform(0, 1e10))))
    return out


# -- the cost-model split ---------------------------------------------------


def test_split_exec_telescopes_exactly():
    comp, comm = _split_exec(0.5, comm_bytes=MODEL_COMM_BYTES_S, flops=flops_mod.PEAK_FLOPS)
    # Equal model times -> an even split; the halves sum back exactly.
    assert comp == pytest.approx(0.25)
    assert comm == pytest.approx(0.25)
    assert comp + comm == 0.5


def test_split_exec_degenerate_cases():
    assert _split_exec(0.0, 1e9, 1e12) == (0.0, 0.0)
    assert _split_exec(0.3, 0, 0.0) == (0.3, 0.0)
    comp, comm = _split_exec(0.3, 1e9, 0.0)
    assert comp == 0.0 and comm == 0.3


def test_model_constants_are_the_cards():
    """NVLink 4 on an H100 SXM and the H100's FP32 and HBM3 rates."""
    assert MODEL_COMM_BYTES_S == 450e9
    assert flops_mod.PEAK_FLOPS == 67e12
    assert roofline.PEAK_BYTES_S == 3.35e12


# -- record_round: equal to the reference's on the same walls ---------------


@pytest.mark.parametrize("seed", [0, 1])
def test_record_round_events_equal_reference(seed, same_models):
    tracer, ref_tracer = Tracer(), RefTracer()
    port = TimelineRecorder(straggler_rounds=2, trace=tracer, straggler_counter=_Counter())
    ref = ref_timeline.TimelineRecorder(straggler_rounds=2, trace=ref_tracer,
                                        straggler_counter=_Counter())
    for rnd, r in enumerate(_seeded_rounds(seed)):
        kw = {k: v for k, v in r.items() if k != "walls"}
        assert port.record_round("scan", rnd, r["walls"], **kw) == \
            ref.record_round("scan", rnd, r["walls"], **kw)
    for stage in ("device_timeline", "straggler_flag"):
        assert _fields(tracer, stage) == _fields(ref_tracer, stage)
    assert _events(tracer, "straggler_flag"), "the seeded walls must flag a straggler"
    assert port.phase_table() == ref.phase_table()
    assert port.state() == ref.state()
    assert port.straggler_counter.calls == ref.straggler_counter.calls


def test_record_round_events_telescope():
    tracer = Tracer()
    rec = TimelineRecorder(trace=tracer)
    walls = [(d, 0.010 + 0.001 * d) for d in range(8)]
    stats = rec.record_round("ring_knn_scan", 0, walls, upload_s=0.004, fetch_s=0.003,
                             comm_bytes=7 * 2**20, flops=4.2e9)
    evs = _events(tracer, "device_timeline")
    assert len(evs) == 8
    for e in evs:
        f = e.fields
        assert f["attribution"] == "model" and f["comm_bytes"] == 7 * 2**20
        total = f["compute_s"] + f["comm_s"] + f["host_s"]
        assert math.isclose(total, e.wall_s, rel_tol=0.0, abs_tol=1e-6)
        assert f["host_s"] == pytest.approx(0.007, abs=1e-9)
    assert stats["skew"] == pytest.approx(0.017 / 0.0135, rel=1e-4)
    assert stats["flagged"] == []


def test_record_modeled_rounds_equal_reference(same_models):
    tracer, ref_tracer = Tracer(), RefTracer()
    port, ref = TimelineRecorder(trace=tracer), ref_timeline.TimelineRecorder(trace=ref_tracer)
    walls = [(d, 0.05 + 0.01 * d) for d in range(4)]
    kw = dict(upload_s=0.002, fetch_s=0.003, comm_bytes=1_000_003, flops=3e9)
    assert port.record_modeled_rounds("shard_mst_device", 7, walls, **kw) == \
        ref.record_modeled_rounds("shard_mst_device", 7, walls, **kw)
    assert _fields(tracer, "device_timeline") == _fields(ref_tracer, "device_timeline")
    assert port.phase_table() == ref.phase_table()


def test_record_round_empty_is_noop():
    rec = TimelineRecorder()
    assert rec.record_round("p", 0, []) is None
    assert rec.phase_table() == {}


def test_phase_table_accumulates_and_derives():
    rec = TimelineRecorder()
    for rnd in range(3):
        rec.record_round("scan", rnd, [(d, 0.010) for d in range(8)],
                         comm_bytes=2**20, flops=1e9)
    tbl = rec.phase_table()["scan"]
    assert tbl["rounds"] == 3 and tbl["devices"] == 8
    assert tbl["comm_bytes"] == 3 * 8 * 2**20
    assert tbl["flops"] == pytest.approx(3e9)
    assert tbl["wall_s"] == pytest.approx(0.030, abs=1e-8)
    assert 0.0 <= tbl["comm_frac"] <= 1.0 and tbl["skew"] >= 1.0


def test_straggler_trips_after_k_rounds_and_resets():
    tracer = Tracer()
    counter = _Counter()
    rec = TimelineRecorder(skew_threshold=2.0, straggler_rounds=3,
                           straggler_counter=counter, trace=tracer)

    def round_walls(slow_dev=None):
        return [(d, 0.030 if d == slow_dev else 0.010) for d in range(8)]

    for rnd in range(2):
        assert rec.record_round("scan", rnd, round_walls(slow_dev=7))["flagged"] == []
    assert _events(tracer, "straggler_flag") == []
    for rnd in (2, 3):
        assert rec.record_round("scan", rnd, round_walls(slow_dev=7))["flagged"] == [7]
    flags = _events(tracer, "straggler_flag")
    assert [e.fields["streak"] for e in flags] == [3, 4]
    for e in flags:
        assert e.fields["device"] == 7
        assert e.fields["ratio"] >= e.fields["threshold"] == 2.0
        assert e.wall_s >= e.fields["median_s"] > 0
    assert counter.calls == [(1.0, {"device": "7"}), (1.0, {"device": "7"})]
    assert rec.record_round("scan", 4, round_walls())["flagged"] == []
    assert rec.record_round("scan", 5, round_walls(slow_dev=7))["flagged"] == []
    st = rec.state()
    assert st["flags_total"] == 2 and st["flags"] == {"7": 2}
    assert st["streaks"] == {"7": 1} and st["rounds"] == 6


def test_straggler_needs_multiple_devices_and_positive_median():
    rec = TimelineRecorder(skew_threshold=1.0, straggler_rounds=1)
    assert rec.record_round("p", 0, [(0, 5.0)])["flagged"] == []
    stats = rec.record_round("p", 1, [(0, 0.0), (1, 0.0)])
    assert stats["flagged"] == [] and stats["skew"] == 1.0


def test_recorder_knob_validation():
    with pytest.raises(ValueError, match="skew_threshold"):
        TimelineRecorder(skew_threshold=0.5)
    with pytest.raises(ValueError, match="straggler_rounds"):
        TimelineRecorder(straggler_rounds=0)


# -- through the port's real scans ------------------------------------------


def test_ring_scan_timeline_telescopes_and_validates(tmp_path):
    """The ring k-NN scan over four CPU shards: device_timeline rows for
    every shard that telescope within 1e-6, skew stats on the summary, a
    heartbeat per shard, and a trace check_trace accepts."""
    path = str(tmp_path / "trace.jsonl")
    tracer = Tracer(sinks=[JsonlSink(path)])
    rec = TimelineRecorder(trace=tracer)
    with obs.installed(timeline=rec, heartbeats=Heartbeats(tracer, heartbeat_s=1e-6)):
        ring_knn_core_distances(_blobs(256), 5, "euclidean", mesh=_cpu_mesh(), trace=tracer,
                                **TILES)
    tracer.close()
    evs = _events(tracer, "device_timeline")
    assert {e.fields["device"] for e in evs} == set(range(N_DEV))
    for e in evs:
        f = e.fields
        assert math.isclose(f["compute_s"] + f["comm_s"] + f["host_s"], e.wall_s,
                            rel_tol=0.0, abs_tol=1e-6)
        assert f["comm_bytes"] > 0
    summary = _events(tracer, "ring_knn_scan")[0].fields
    assert summary["skew"] >= 1.0
    assert summary["max_device_wall_s"] >= summary["median_device_wall_s"]
    beats = [e.fields for e in _events(tracer, "heartbeat") if e.fields["phase"] == "ring_knn_scan"]
    assert beats[-1]["progress"] == 1.0 and beats[-1]["total"] == N_DEV
    _, errors = check_trace.validate_trace(path)
    assert errors == []
    assert rec.phase_table()["ring_knn_scan"]["rounds"] == 1


def test_injected_straggler_flagged_within_k_rounds():
    """The phase_stall site inflates the last shard's wall; the detector
    flags it within K rounds of a real ring scan."""
    mesh, data = _cpu_mesh(), _blobs(256)
    tracer, counter = Tracer(), _Counter()
    rec = TimelineRecorder(skew_threshold=2.0, straggler_rounds=3, straggler_counter=counter,
                           trace=tracer)
    with obs.installed(timeline=rec):
        inject.install("phase_stall:count=3,delay_s=0.25")
        for _ in range(3):
            ring_knn_core_distances(data, 5, "euclidean", mesh=mesh, **TILES)
    flags = _events(tracer, "straggler_flag")
    assert len(flags) == 1
    assert flags[0].fields["device"] == N_DEV - 1 and flags[0].fields["streak"] == 3
    assert counter.calls == [(1.0, {"device": str(N_DEV - 1)})]
    assert rec.state()["flags"] == {str(N_DEV - 1): 1}


def test_sharded_device_boruvka_replays_modeled_rounds(tmp_path):
    """The sharded exact fit's device Borůvka gives one wall a shard; the
    recorder replays it as one modelled row a round and shard, the
    summary carries ``rounds`` and the trace validates."""
    path = str(tmp_path / "trace.jsonl")
    tracer = Tracer(sinks=[JsonlSink(path)])
    rec = TimelineRecorder(trace=tracer)
    params = HDBSCANParams(min_points=5, min_cluster_size=10, fit_sharding="sharded",
                           mst_backend="device")
    with obs.installed(timeline=rec):
        exact.fit(_blobs(300, d=3), params, device="cpu", mesh=_cpu_mesh(), trace=tracer,
                  **TILES)
    tracer.close()
    summary = _events(tracer, "shard_mst_device")[0].fields
    rows = [e.fields for e in _events(tracer, "device_timeline")
            if e.fields["phase"] == "shard_mst_device"]
    assert len(rows) == summary["rounds"] * N_DEV
    assert rec.phase_table()["shard_mst_device"]["rounds"] == summary["rounds"]
    assert {r["round"] for r in rows} == set(range(summary["rounds"]))
    _, errors = check_trace.validate_trace(path)
    assert errors == []


# -- roofline ---------------------------------------------------------------


def test_classify_bound():
    ridge = flops_mod.PEAK_FLOPS / roofline.PEAK_BYTES_S
    assert classify_bound(None, ridge, 0.9) == "comm"
    assert classify_bound(ridge * 2, ridge, COMM_BOUND_FRAC) == "comm"
    assert classify_bound(ridge * 2, ridge, 0.1) == "compute"
    assert classify_bound(ridge / 2, ridge, 0.1) == "memory"
    assert classify_bound(None, ridge, None) == "memory"


def test_roofline_section_equal_reference(same_models):
    rec = TimelineRecorder()
    ref = ref_timeline.TimelineRecorder()
    for r, rnd in zip(_seeded_rounds(3, rounds=4), range(4)):
        kw = {k: v for k, v in r.items() if k != "walls"}
        rec.record_round("scan", rnd, r["walls"], **kw)
        ref.record_round("scan", rnd, r["walls"], **kw)
    agg = {"scan": {"gflops": 1.0, "gbytes": 0.5, "wall_s": 0.010},
           "tree": {"gflops": 0.0, "gbytes": 2.0, "wall_s": 0.5},
           "idle": {"gflops": 0.0, "gbytes": 0.0, "wall_s": 1.0}}
    sec = roofline_section(agg, rec.phase_table(), tags=["cpu_smoke"])
    assert sec == ref_roofline.roofline_section(agg, ref.phase_table(), tags=["cpu_smoke"])
    assert set(sec["phases"]) == {"scan", "tree"}
    row = sec["phases"]["scan"]
    assert row["arithmetic_intensity"] == pytest.approx(2.0)
    assert row["rounds"] == 4 and row["devices"] == 8 and row["mfu"] > 0


def test_roofline_section_empty_is_none_and_tags():
    assert roofline_section({}, {}) is None
    assert roofline_section({"p": {"gflops": 0.0, "gbytes": 0.0}}) is None
    assert roofline.default_tags("cpu") == ["cpu_smoke"]
    assert roofline.default_tags(torch.device("cuda", 0)) == []


# -- flight recorder --------------------------------------------------------


def test_flight_dumps_on_watchdog_stall(tmp_path):
    """A watchdog stall auto-dumps one self-contained bundle that
    check_flight validates."""
    flight_dir = str(tmp_path / "flight")
    tracer = Tracer()
    flight = FlightRecorder(flight_dir, manifest={"argv": ["test"]}, tracer=tracer)
    tracer.add_sink(flight)
    inject.install("phase_stall:count=1,delay_s=0.5")
    hub = Heartbeats(tracer=tracer, heartbeat_s=0.01, watchdog_s=0.1)
    with obs.installed(heartbeats=hub):
        with hub.task("stalled_phase", total=2) as t:
            t.beat(1)
    hub.close()
    assert hub.stalls >= 1
    assert len(flight.dumps) == len(glob.glob(os.path.join(flight_dir, "flight-*.json"))) \
        == hub.stalls
    bundle, errors = check_flight.validate_bundle(flight.dumps[0])
    assert errors == []
    assert bundle["reason"] == "watchdog_stall" and bundle["manifest"] == {"argv": ["test"]}
    assert any(r["stage"] == "watchdog_stall" for r in bundle["events"])
    assert all(r["stage"] == "heartbeat" for r in bundle["heartbeats"])
    assert "--- thread" in bundle["stacks"]
    assert check_flight.main([flight_dir]) == 0


def test_flight_zero_dumps_on_healthy_run(tmp_path):
    flight_dir = str(tmp_path / "flight")
    tracer = Tracer()
    flight = FlightRecorder(flight_dir, tracer=tracer)
    tracer.add_sink(flight)
    hub = Heartbeats(tracer=tracer, heartbeat_s=0.01, watchdog_s=0.5)
    with hub.task("healthy", total=4) as t:
        for done in range(4):
            t.beat(done)
            threading.Event().wait(0.02)
    hub.close()
    assert flight.dumps == [] and not os.path.exists(flight_dir)
    assert check_flight.main([str(tmp_path), "--allow-empty"]) == 0
    assert check_flight.main([str(tmp_path)]) == 1


def test_flight_manual_dump_emits_event(tmp_path):
    tracer = Tracer()
    flight = FlightRecorder(str(tmp_path), tracer=tracer)
    tracer.add_sink(flight)
    tracer("some_phase", wall_s=0.25, detail="x")
    aud = MemoryAuditor(source="live_arrays", interval_s=0.005)
    rec = TimelineRecorder()
    with obs.installed(auditor=aud, timeline=rec):
        with obs.mem_phase("wm_phase"):
            time.sleep(0.03)
        path = flight.dump("manual", extra={"why": "test"})
    bundle, errors = check_flight.validate_bundle(path)
    assert errors == []
    assert "wm_phase" in bundle["watermarks"] and "cpu:0" in bundle["device_peaks"]
    assert bundle["straggler"]["rounds"] == 0
    assert bundle["extra"] == {"why": "test"} and bundle["events_seen"] >= 1
    evs = _events(tracer, "flight_dump")
    assert len(evs) == 1 and evs[0].fields["reason"] == "manual"
    assert evs[0].fields["path"] == path
    with pytest.raises(ValueError, match="reason"):
        flight.dump("because")


def test_flight_ring_is_bounded(tmp_path):
    tracer = Tracer()
    flight = FlightRecorder(str(tmp_path), capacity=16, heartbeat_tail=2, tracer=tracer)
    tracer.add_sink(flight)
    for i in range(64):
        tracer("spam", wall_s=0.001, i=i)
    snap = flight.snapshot()
    assert len(snap["events"]) == 16 and snap["events_seen"] == 64
    assert snap["events"][-1]["i"] == 63
    with pytest.raises(ValueError, match="capacity"):
        FlightRecorder(str(tmp_path), capacity=8)


# -- trace rotation ---------------------------------------------------------


def test_jsonl_sink_rotates_and_check_trace_accepts(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    sink = JsonlSink(path, rotate_bytes=4096)
    tracer = Tracer(sinks=[sink])
    for i in range(200):
        tracer("rotation_filler", wall_s=0.001, i=i)
    tracer.close()
    assert sink.rotations >= 1
    assert sorted(glob.glob(path + "*")) == [path, path + ".1"]
    assert os.path.getsize(path + ".1") <= 4096
    with open(path + ".1") as f:
        rotated = [json.loads(line) for line in f]
    with open(path) as f:
        live = [json.loads(line) for line in f]
    assert live[0]["seq"] == rotated[-1]["seq"] + 1
    events, errors = check_trace.validate_trace(path)
    assert errors == [] and len(events) == len(rotated) + len(live)


def test_check_trace_rejects_rotated_seq_gap(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tracer = Tracer(sinks=[JsonlSink(path, rotate_bytes=4096)])
    for i in range(200):
        tracer("rotation_filler", wall_s=0.001, i=i)
    tracer.close()
    with open(path) as f:
        lines = f.readlines()
    with open(path, "w") as f:
        f.writelines(lines[1:])
    _, errors = check_trace.validate_trace(path)
    assert any("rotated set discontinuous" in e for e in errors)


def test_check_trace_flags_broken_port_timeline(tmp_path):
    """The validator rejects a port-written device_timeline row whose
    segments do not telescope, and a round that skips ahead."""
    good = str(tmp_path / "good.jsonl")
    tracer = Tracer(sinks=[JsonlSink(good)])
    TimelineRecorder(trace=tracer).record_round("scan", 0, [(0, 0.01), (1, 0.012)],
                                                comm_bytes=1024, flops=1e6)
    tracer.close()
    assert check_trace.validate_trace(good)[1] == []
    with open(good) as f:
        rows = [json.loads(line) for line in f]
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write(json.dumps(dict(rows[0], compute_s=rows[0]["compute_s"] + 0.5)) + "\n")
        f.write(json.dumps(dict(rows[1], round=2)) + "\n")
        f.write(json.dumps(dict(rows[1], seq=2, round=4)) + "\n")
    errors = check_trace.validate_trace(bad)[1]
    assert any("telescope" in e for e in errors)
    assert any("skipped ahead" in e for e in errors)


# -- audit: zero-sample phases stay honest ----------------------------------


def test_audit_zero_sample_phase_gets_sampled_false_row():
    tracer = Tracer()
    aud = MemoryAuditor(tracer=tracer, interval_s=0.005, source="live_arrays")
    aud._source_pref = "memory_stats"  # every sample now raises on the CPU
    with aud.phase("unsampled"):
        pass
    row = aud.watermark_table()["unsampled"]
    assert row["sampled"] is False and row["samples"] == 0 and row["max_device_bytes"] == 0
    peak = _events(tracer, "mem_phase_peak")[0].fields
    assert peak["sampled"] is False and peak["samples"] == 0
    errors = check_trace._check_obs("t", 1, "mem_phase_peak", dict(
        peak, schema="hdbscan-tpu-trace/1", stage="mem_phase_peak"))
    assert errors == []

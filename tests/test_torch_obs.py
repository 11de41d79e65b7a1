"""The port's observability layer (``hdbscan_tpu_torch/obs``): the memory
auditor and its replication gate, heartbeats and the hang watchdog, the
facade, and fleet span correlation, on the CPU, held to the reference's
``hdbscan_tpu/obs`` (the twin of ``tests/unit/test_obs.py``).

The ``live_arrays`` source counts the live torch tensors' storages once
each on ``cpu:0``. The gate's multi-device arithmetic runs on the same
per-device samples fed to both packages' auditors through their
module-level ``sample_per_device`` (a CPU has one device and the card
machine one card): the same verdicts, the same summaries and the same
error text. Heartbeats give the reference's progress sequence for the same
beats; the span join and the fleet merge give the reference's dicts on the
same events.
"""

import threading

import numpy as np
import pytest
import torch

from hdbscan_tpu import obs as ref_obs
from hdbscan_tpu.obs import audit as ref_audit
from hdbscan_tpu.obs.heartbeat import Heartbeats as RefHeartbeats
from hdbscan_tpu.utils.tracing import Tracer as RefTracer
from hdbscan_tpu_torch import obs
from hdbscan_tpu_torch.fault import inject
from hdbscan_tpu_torch.obs import audit
from hdbscan_tpu_torch.obs.audit import MemoryAuditor, ReplicatedBufferError, sample_per_device
from hdbscan_tpu_torch.obs.heartbeat import Heartbeats
from hdbscan_tpu_torch.utils.tracing import JsonlSink, Tracer
from scripts import check_trace
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_installs():
    """Never leak a process-global auditor, hub or fault plan across tests."""
    yield
    obs.clear()
    ref_obs.clear()
    inject.clear()


def _events(tracer, stage):
    return [e for e in tracer.events if e.name == stage]


# -- sampling ---------------------------------------------------------------


def test_live_arrays_attributes_tensor_to_device():
    keep = torch.arange(4096, dtype=torch.float64)  # 32 KiB pinned live
    per_dev, src = sample_per_device(source="live_arrays")
    assert src == "live_arrays"
    assert per_dev["cpu:0"] >= keep.numel() * keep.element_size()
    assert set(per_dev) == {"cpu:0"}
    del keep


def test_live_arrays_counts_a_storage_once():
    """Views and aliases of one storage count once, as an allocator
    counts them (the reference's buffer-pointer dedup)."""
    base, _ = sample_per_device(source="live_arrays")
    keep = torch.zeros(1 << 16, dtype=torch.float32)  # 256 KiB
    views = [keep[1:], keep.view(256, 256), keep.t() if keep.dim() == 2 else keep[::2]]
    per_dev, _ = sample_per_device(source="live_arrays")
    grown = per_dev["cpu:0"] - base["cpu:0"]
    assert keep.untyped_storage().nbytes() <= grown < 2 * keep.untyped_storage().nbytes()
    del keep, views


def test_memory_stats_forced_raises_on_cpu():
    with pytest.raises(RuntimeError, match="memory_stats unavailable"):
        sample_per_device(source="memory_stats")


def test_sample_source_validated():
    with pytest.raises(ValueError, match="source must be"):
        sample_per_device(source="psutil")


def test_auditor_phase_watermarks_and_events():
    tracer = Tracer()
    aud = MemoryAuditor(tracer=tracer, interval_s=0.005, source="live_arrays")
    with aud.phase("alloc"):
        keep = torch.ones((2048, 8), dtype=torch.float64)  # 128 KiB
    nbytes = keep.numel() * keep.element_size()
    table = aud.watermark_table()
    assert set(table) == {"alloc"}
    wm = table["alloc"]
    assert wm["source"] == "live_arrays" and wm["sampled"] is True
    assert wm["samples"] >= 2  # entry + exit at minimum
    assert wm["max_device_bytes"] >= nbytes
    assert wm["per_device"]["cpu:0"] >= nbytes
    # The peak event dominates every sample, as check_trace enforces.
    samples = _events(tracer, "mem_sample")
    peaks = _events(tracer, "mem_phase_peak")
    assert len(peaks) == 1 and len(samples) == wm["samples"]
    peak = peaks[0].fields
    assert peak["max_device_bytes"] == wm["max_device_bytes"]
    assert all(s.fields["max_device_bytes"] <= peak["max_device_bytes"] for s in samples)
    assert aud.device_peaks()["cpu:0"] >= nbytes
    del keep


def test_auditor_merges_repeated_phases():
    aud = MemoryAuditor(interval_s=0.005, source="live_arrays")
    with aud.phase("p"):
        pass
    first = aud.watermark_table()["p"]["samples"]
    with aud.phase("p"):
        pass
    assert aud.watermark_table()["p"]["samples"] >= first + 2


def test_auditor_knob_validation():
    with pytest.raises(ValueError, match="interval_s"):
        MemoryAuditor(interval_s=0.0)
    with pytest.raises(ValueError, match="source"):
        MemoryAuditor(source="top")


# -- the replication gate, port against reference on the same samples -------


def _feed(monkeypatch, samples):
    """Both packages' auditors read per-device bytes from ``samples`` (a
    function of the call count) through their module-level sampler."""
    calls = {"port": 0, "ref": 0}

    def sampler(side):
        def fn(source="auto"):
            i = calls[side]
            calls[side] += 1
            return dict(samples(i)), "memory_stats"
        return fn

    monkeypatch.setattr(audit, "sample_per_device", sampler("port"))
    monkeypatch.setattr(ref_audit, "sample_per_device", sampler("ref"))


def _both_phases(name):
    """One audited phase in each package; the long interval leaves the
    entry and exit samples only, so both see the same sample sequence."""
    port = MemoryAuditor(interval_s=60.0)
    ref = ref_audit.MemoryAuditor(interval_s=60.0)
    for aud in (port, ref):
        with aud.phase(name):
            pass
    return port, ref


N, ITEMSIZE = 4096, 8  # threshold = 0.5 * 32768 = 16384 B a device


def test_gate_trips_on_replicated_buffer(monkeypatch):
    """Eight devices each holding all n rows trip both gates alike."""
    _feed(monkeypatch, lambda i: {f"cuda:{d}": (0 if i == 0 else N * ITEMSIZE)
                                  for d in range(8)})
    port, ref = _both_phases("replicated")
    with pytest.raises(ReplicatedBufferError, match="replicated") as got:
        port.assert_not_replicated(N, ITEMSIZE)
    with pytest.raises(ref_audit.ReplicatedBufferError) as want:
        ref.assert_not_replicated(N, ITEMSIZE)
    assert str(got.value) == str(want.value)


def test_gate_passes_sharded_buffer(monkeypatch):
    _feed(monkeypatch, lambda i: {f"cuda:{d}": (0 if i == 0 else N * ITEMSIZE // 8)
                                  for d in range(8)})
    port, ref = _both_phases("sharded")
    out = port.assert_not_replicated(N, ITEMSIZE)
    assert out == ref.assert_not_replicated(N, ITEMSIZE)
    assert out["phases"] == ["sharded"]
    assert 0 < out["worst_fraction"] < 1.0
    assert out["threshold_bytes"] == pytest.approx(0.5 * N * ITEMSIZE)
    assert port.watermark_table()["sharded"]["per_device"] == \
        ref.watermark_table()["sharded"]["per_device"]


def test_gate_one_card_mesh_is_single_device(monkeypatch):
    """A mesh that names one card four times is one device: the allocator
    of ``cuda:0`` holds every shard, and the gate answers single_device
    however large the phase grew (the reference's rule)."""
    _feed(monkeypatch, lambda i: {"cuda:0": 0 if i == 0 else 4 * N * ITEMSIZE})
    port, ref = _both_phases("shard_boruvka_scan")
    out = port.assert_not_replicated(N, ITEMSIZE)
    assert out == ref.assert_not_replicated(N, ITEMSIZE)
    assert out["single_device"] is True and out["worst_fraction"] == 0.0


def test_allocator_peak_rising_in_a_phase_is_its_peak(monkeypatch):
    """On the card a buffer that lives between two samples is caught by
    the allocator's high-water mark: when it rose during the phase, the
    phase reached it; when it did not, the samples decide."""
    peaks = iter([{"cuda:0": 1000}, {"cuda:0": 9000},   # rose: 9000 in the phase
                  {"cuda:0": 9000}, {"cuda:0": 9000}])  # flat: the samples' 300
    monkeypatch.setattr(audit, "sample_per_device",
                        lambda source="auto": ({"cuda:0": 300}, "memory_stats"))
    monkeypatch.setattr(audit, "_memory_stats_peaks", lambda: next(peaks))
    tracer = Tracer()
    aud = MemoryAuditor(tracer=tracer, interval_s=60.0)
    with aud.phase("block_fit"):
        pass
    with aud.phase("finalize"):
        pass
    table = aud.watermark_table()
    assert table["block_fit"]["per_device"] == {"cuda:0": 9000}
    assert table["block_fit"]["max_device_bytes"] == 9000 <= table["block_fit"]["total_bytes"]
    assert table["finalize"]["max_device_bytes"] == 300
    peak_events = {e.fields["phase"]: e.fields for e in _events(tracer, "mem_phase_peak")}
    assert peak_events["block_fit"]["max_device_bytes"] == 9000
    assert aud.device_peaks() == {"cuda:0": 9000}


def test_gate_single_device_watermarks_pass():
    """With one device in the watermarks, "replicated vs sharded" is
    meaningless — the gate reports the bypass instead of tripping."""
    aud = MemoryAuditor(interval_s=0.005, source="live_arrays")
    aud._watermarks["fit"] = {
        "source": "live_arrays",
        "samples": 2,
        "max_device_bytes": 10**9,
        "total_bytes": 10**9,
        "per_device": {"cpu:0": 10**9},
        "wall_s": 0.1,
    }
    out = aud.assert_not_replicated(n=4096, itemsize=8)
    assert out["single_device"] is True
    assert out["worst_fraction"] == 0.0


def test_gate_refuses_to_pass_vacuously():
    aud = MemoryAuditor(source="live_arrays")
    with pytest.raises(RuntimeError, match="cannot pass vacuously"):
        aud.assert_not_replicated(n=10, itemsize=8)
    with pytest.raises(ValueError, match="never audited"):
        with aud.phase("real"):
            pass
        aud.assert_not_replicated(n=10, itemsize=8, phases=["imaginary"])


def test_gate_parameter_validation():
    aud = MemoryAuditor(source="live_arrays")
    with pytest.raises(ValueError, match="n must be"):
        aud.assert_not_replicated(n=0, itemsize=8)
    with pytest.raises(ValueError, match="itemsize"):
        aud.assert_not_replicated(n=10, itemsize=0)
    with pytest.raises(ValueError, match="slack"):
        aud.assert_not_replicated(n=10, itemsize=8, slack=0.0)


# -- heartbeats + watchdog --------------------------------------------------


def test_heartbeat_progress_monotone_and_eta(tmp_path):
    """The port's hub emits the reference's heartbeat sequence for the same
    beats (ETAs aside: they read the clock), and its trace validates."""
    path = str(tmp_path / "hb.jsonl")
    tracer = Tracer(sinks=[JsonlSink(path)])
    ref_tracer = RefTracer()
    seq = {}
    for side, hub in (("port", Heartbeats(tracer=tracer, heartbeat_s=1e-6)),
                      ("ref", RefHeartbeats(tracer=ref_tracer, heartbeat_s=1e-6))):
        with hub.task("boruvka", total=10) as t:
            for done in (2, 5, 4, 10):  # 4 then 10: progress must not regress
                t.beat(done)
        hub.close()
        events = _events(tracer if side == "port" else ref_tracer, "heartbeat")
        seq[side] = [{k: v for k, v in e.fields.items() if k != "eta_s"} for e in events]
    tracer.close()
    assert seq["port"] == seq["ref"]
    progress = [e["progress"] for e in seq["port"]]
    assert progress[0] == 0.0 and progress[-1] == 1.0
    assert progress == sorted(progress)
    assert any("eta_s" in e.fields for e in _events(tracer, "heartbeat"))
    events, errors = check_trace.validate_trace(path)
    assert errors == []
    assert sum(1 for e in events if e.get("stage") == "heartbeat") == len(progress)


def test_heartbeat_throttles_between_entry_and_exit():
    tracer = Tracer()
    hub = Heartbeats(tracer=tracer, heartbeat_s=60.0)
    with hub.task("ring", total=100) as t:
        for done in range(100):
            t.beat(done)
    hub.close()
    beats = _events(tracer, "heartbeat")
    assert len(beats) == 2  # entry + exit only; 100 beats all throttled
    assert beats[-1].fields["progress"] == 1.0


def test_task_ids_unique_across_tasks():
    hub = Heartbeats(heartbeat_s=0.5)
    ids = []
    for _ in range(3):
        with hub.task("p") as t:
            ids.append(t.task_id)
    hub.close()
    assert len(set(ids)) == 3


def test_watchdog_dumps_on_stalled_phase():
    """A stalled phase (the fault harness's ``phase_stall`` site) makes the
    watchdog dump every thread's stack within ``watchdog_s``."""

    class Counter:
        n = 0

        def inc(self):
            self.n += 1

    tracer = Tracer()
    counter = Counter()
    inject.install("phase_stall:count=1,delay_s=0.5")
    hub = Heartbeats(tracer=tracer, heartbeat_s=0.01, watchdog_s=0.1, stall_counter=counter)
    with hub.task("stalled_phase", total=2) as t:
        t.beat(1)  # injected 0.5 s stall before the liveness refresh
    hub.close()
    assert hub.stalls >= 1
    assert counter.n == hub.stalls
    stalls = _events(tracer, "watchdog_stall")
    assert len(stalls) == hub.stalls
    ev = stalls[0].fields
    assert ev["phases"] == ["stalled_phase"]
    assert ev["stalled_s"] > 0.1
    assert ev["threads"] >= 2
    assert "--- thread" in ev["stacks"]
    assert hub.state()["stalls"] == hub.stalls


def test_watchdog_zero_false_positives_on_healthy_loop():
    tracer = Tracer()
    hub = Heartbeats(tracer=tracer, heartbeat_s=0.01, watchdog_s=0.3)
    with hub.task("healthy", total=8) as t:
        for done in range(8):
            t.beat(done)
            threading.Event().wait(0.05)  # 0.4 s of work, beats every 50 ms
    hub.close()
    assert hub.stalls == 0
    assert _events(tracer, "watchdog_stall") == []


def test_watchdog_idle_is_not_a_stall():
    hub = Heartbeats(heartbeat_s=0.01, watchdog_s=0.05)
    threading.Event().wait(0.2)  # no active tasks: silence is fine
    hub.close()
    assert hub.stalls == 0


def test_heartbeat_knob_validation():
    with pytest.raises(ValueError, match="heartbeat_s"):
        Heartbeats(heartbeat_s=0.0)
    with pytest.raises(ValueError, match="watchdog_s"):
        Heartbeats(watchdog_s=-1.0)


def test_config_knobs_validated_eagerly():
    from hdbscan_tpu_torch.config import HDBSCANParams

    with pytest.raises(ValueError, match="heartbeat_s"):
        HDBSCANParams(heartbeat_s=0.0)
    with pytest.raises(ValueError, match="watchdog_s"):
        HDBSCANParams(watchdog_s=-0.5)
    p = HDBSCANParams.from_args(["heartbeat=2.5", "watchdog=30", "skew_threshold=3",
                                 "straggler_rounds=5", "compile_cache=off"])
    assert (p.heartbeat_s, p.watchdog_s) == (2.5, 30.0)
    assert (p.obs_skew_threshold, p.obs_straggler_rounds, p.compile_cache) == (3.0, 5, "off")


# -- the facade -------------------------------------------------------------


def test_facade_noops_when_uninstalled():
    assert obs.auditor() is None and obs.heartbeats() is None
    with obs.mem_phase("anything"):
        pass
    with obs.task("anything", total=3) as t:
        t.beat(1)  # the null task swallows beats
    obs.beat("anything", 1, total=2)
    assert obs.watchdog_state() is None and obs.straggler_state() is None
    with pytest.raises(RuntimeError, match="no MemoryAuditor installed"):
        obs.assert_not_replicated(n=10, itemsize=8)


def test_facade_scoped_install_restores():
    aud = MemoryAuditor(source="live_arrays")
    hub = Heartbeats(heartbeat_s=0.5)
    with obs.installed(auditor=aud, heartbeats=hub):
        assert obs.auditor() is aud and obs.heartbeats() is hub
        with obs.mem_phase("scoped"):
            pass
        assert obs.watchdog_state()["active_tasks"] == []
    assert obs.auditor() is None and obs.heartbeats() is None
    assert "scoped" in aud.watermark_table()


def test_facade_install_clear():
    aud = MemoryAuditor(source="live_arrays")
    obs.install(auditor=aud)
    assert obs.auditor() is aud
    assert obs.heartbeats() is None  # independent layers
    obs.install(heartbeats=Heartbeats(heartbeat_s=1.0))
    assert obs.auditor() is aud  # untouched by the second install
    obs.clear()
    assert obs.auditor() is None and obs.heartbeats() is None


def test_facade_disarm_releases_only_its_hub():
    """A server disarms the hub it armed: the watchdog thread stops, the
    hub uninstalls, other layers stay; a hub installed since stays too."""
    aud = MemoryAuditor(source="live_arrays")
    hub = Heartbeats(heartbeat_s=0.5, watchdog_s=5.0)
    obs.install(auditor=aud, heartbeats=hub)
    obs.disarm(hub)
    assert obs.heartbeats() is None and obs.auditor() is aud
    assert hub._watchdog_thread is None
    other = Heartbeats(heartbeat_s=0.5)
    obs.install(heartbeats=other)
    obs.disarm(hub)
    assert obs.heartbeats() is other


# -- fleet span correlation -------------------------------------------------


def _router_span(rid, replied=True):
    return {
        "stage": "router_span",
        "request_id": rid,
        "route": "/predict",
        "policy": "consistent_hash",
        "replica": "replica_0",
        "status": 200 if replied else 503,
        "attempts": 1,
        "queue_s": 0.001,
        "wall_s": 0.002,
        "replied": replied,
    }


def _replica_span(rid, stage="request_span"):
    return {"stage": stage, "request_id": rid, "route": "/predict"}


def _random_join(seed):
    """Seeded router and replica events: replied and refused spans, ids
    answered once, twice or never."""
    rng = np.random.default_rng(seed)
    router, replicas = [], []
    for i in range(40):
        rid = f"r{seed}-{i}"
        router.append(_router_span(rid, replied=bool(rng.random() < 0.8)))
        for _ in range(int(rng.choice([0, 1, 1, 1, 2]))):
            replicas.append(_replica_span(rid, str(rng.choice(["request_span",
                                                               "request_shed"]))))
    return router, replicas


def test_join_spans_complete_chain():
    router = [_router_span("r1-1"), _router_span("r1-2")]
    replicas = [_replica_span("r1-1"), _replica_span("r1-2", "request_shed")]
    out = obs.join_spans(router, replicas)
    assert out == ref_obs.join_spans(router, replicas)
    assert out["complete"] is True
    assert out["matched"] == out["replied"] == 2
    assert out["orphans"] == [] and out["duplicates"] == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_spans_flags_orphans_and_duplicates(seed):
    router, replicas = _random_join(seed)
    out = obs.join_spans(router, replicas)
    assert out == ref_obs.join_spans(router, replicas)
    assert out["complete"] is False and out["orphans"] and out["duplicates"]
    assert out["router_spans"] == 40


def test_join_cli_mode_and_fleet_merge(tmp_path):
    """check_trace.py --join validates the port's files then requires a
    100% join; ``merge_fleet_traces`` gives the reference's merge."""
    from hdbscan_tpu.obs.correlate import merge_fleet_traces as ref_merge

    router_path = str(tmp_path / "router.jsonl")
    replica_path = str(tmp_path / "replica.jsonl")
    rt = Tracer(sinks=[JsonlSink(router_path)])
    for ev in (_router_span("a"), _router_span("b", replied=False)):
        ev = dict(ev)
        rt(ev.pop("stage"), **ev)
    rt.close()
    rep = Tracer(sinks=[JsonlSink(replica_path)])
    rep("request_span", request_id="a", route="/predict", status=200, rows=1, bucket=1,
        coalesced=1, generation=1, parse_s=0.0, queue_s=0.0, assemble_s=0.0,
        predict_s=0.0, respond_s=0.0)
    rep.close()
    assert check_trace.join_fleet(router_path, [replica_path]) == 0
    merged = obs.merge_fleet_traces(router_path, [replica_path])
    assert merged == ref_merge(router_path, [replica_path])
    assert merged["join"]["complete"] is True
    empty = str(tmp_path / "empty.jsonl")
    et = Tracer(sinks=[JsonlSink(empty)])
    et("noop")
    et.close()
    assert check_trace.join_fleet(router_path, [empty]) == 1

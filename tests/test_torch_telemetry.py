"""The port's run telemetry (``utils/tracing.py``'s sinks and counters,
``utils/telemetry.py``, ``utils/cache.py``) on the CPU, held to the
reference's (the twin of ``tests/unit/test_telemetry.py``).

The same events, made from a seed with numpy, go into a port ``Tracer``
and a reference one: ``phase_aggregates``, ``build_report`` and each of
its sections (``knn_index``, ``mst_device``, ``stream``,
``request_spans``, ``controlplane``, ``timeline``, ``memory.watermarks``,
``predict_latency``, ``roofline``), ``latency_percentiles``,
``slo_verdict`` and ``merge_host_traces`` give equal dicts. The peaks the
MFU and roofline figures divide by differ by design (the port's are the
H100's), so those comparisons set both packages' peaks to one value.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from hdbscan_tpu.obs import roofline as ref_roofline
from hdbscan_tpu.utils import flops as ref_flops
from hdbscan_tpu.utils import telemetry as ref_telemetry
from hdbscan_tpu.utils.tracing import Tracer as RefTracer
from hdbscan_tpu_torch.config import HDBSCANParams
from hdbscan_tpu_torch.obs import roofline
from hdbscan_tpu_torch.ops import cuda_build
from hdbscan_tpu_torch.utils import cache, flops, telemetry
from hdbscan_tpu_torch.utils.tracing import (
    TRACE_SCHEMA,
    JsonlSink,
    Tracer,
    stderr_tracer,
    xla_profile,
)
from scripts import check_trace
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401

timeline = importlib.import_module("hdbscan_tpu_torch.obs.timeline")
ref_timeline = importlib.import_module("hdbscan_tpu.obs.timeline")


@pytest.fixture
def same_peaks(monkeypatch):
    for mod in (flops, ref_flops):
        monkeypatch.setattr(mod, "PEAK_FLOPS", 50e12)
    for mod in (roofline, ref_roofline):
        monkeypatch.setattr(mod, "PEAK_BYTES_S", 2e12)
    for mod in (timeline, ref_timeline):
        monkeypatch.setattr(mod, "MODEL_COMM_BYTES_S", 100e9)


def _both(events):
    """A port and a reference tracer fed the same ``(stage, fields)``."""
    port, ref = Tracer(), RefTracer()
    for stage, fields in events:
        port(stage, **dict(fields))
        ref(stage, **dict(fields))
    return port, ref


def _run_events(seed):
    """Seeded events of every kind the report's sections read."""
    rng = np.random.default_rng(seed)
    w = lambda: round(float(rng.uniform(0.001, 0.5)), 6)  # noqa: E731
    ev = []
    for _ in range(5):
        ev.append(("core_distances", dict(wall_s=w(), gflops=float(rng.uniform(0, 9)),
                                          gbytes=float(rng.uniform(0, 2)),
                                          jit_compiles=int(rng.integers(0, 3)))))
        ev.append(("block_fit", dict(wall_s=w(), pad_gflops=float(rng.uniform(0, 1)),
                                     cache_hits=int(rng.integers(0, 2)))))
    ev.append(("knn_index_build", dict(wall_s=w(), trees=4, depth=7, leaf_size=128,
                                       max_leaf=200, n=5000)))
    for _ in range(3):
        ev.append(("knn_index_query", dict(wall_s=w(), recall_at_k=float(rng.uniform(0.9, 1)))))
        ev.append(("knn_index_rescan", dict(wall_s=w(), improved=int(rng.integers(0, 90)))))
    for r in range(4):
        ev.append(("mst_round", dict(round=r, components=100 >> r, edges_added=5)))
    ev.append(("host_sync", dict(wall_s=w(), arrays=6, bytes=int(rng.integers(1, 1 << 20)))))
    ev.append(("tree_build_device", dict(wall_s=w(), fallback=bool(rng.random() < 0.5))))
    for g in range(1, 4):
        rows = int(rng.integers(1, 300))
        ev.append(("stream_ingest", dict(wall_s=w(), rows=rows,
                                         absorbed=int(rng.integers(0, rows + 1)))))
        ev.append(("drift_check", dict(drifted=bool(rng.random() < 0.5))))
        ev.append(("model_refit", dict(wall_s=w(), ok=bool(rng.random() < 0.7))))
        ev.append(("model_swap", dict(wall_s=w(), generation=g + 1,
                                      pause_s=float(rng.uniform(0, 1e-4)))))
    for i in range(25):
        segs = rng.uniform(0, 0.01, 5)
        ev.append(("request_span", dict(wall_s=float(segs.sum()), rows=int(rng.integers(1, 64)),
                                        coalesced=int(rng.integers(1, 4)),
                                        **dict(zip(("parse_s", "queue_s", "assemble_s",
                                                    "predict_s", "respond_s"),
                                                   map(float, segs))))))
        ev.append(("predict_batch", dict(wall_s=w(), rows=int(rng.integers(1, 256)))))
    for i in range(3):
        ev.append(("scale_event", dict(wall_s=w(), direction=["up", "down"][i % 2],
                                       ok=i != 2, reason="load")))
        ev.append(("fit_job", dict(state=["queued", "published", "failed"][i],
                                   tenant=f"t{i % 2}", queued_s=w())))
        ev.append(("artifact_map", dict(hit=i > 0, digest=f"d{i % 2}", bytes=1000 * (i + 1),
                                        spooled=i == 1, resident=i + 1)))
    for phase in ("core_distances", "boruvka_mst", "core_distances"):
        ev.append(("mem_phase_peak", dict(wall_s=w(), phase=phase, source="live_arrays",
                                          samples=int(rng.integers(1, 9)), sampled=True,
                                          devices=1,
                                          max_device_bytes=int(rng.integers(0, 1 << 30)),
                                          total_bytes=int(rng.integers(0, 1 << 30)))))
    walls = [(d, float(x)) for d, x in enumerate(rng.uniform(0.01, 0.02, 4))]
    return ev, walls


# -- sinks and counters -----------------------------------------------------


class TestJsonlSink:
    def test_line_contract(self, tmp_path):
        """Every line: schema tag, increasing seq, stage, float wall_s,
        static fields, sanitised numpy and torch fields."""
        path = str(tmp_path / "trace.jsonl")
        t = Tracer(sinks=[JsonlSink(path, static={"process": 3})])
        t("alpha", wall_s=0.5, rows=np.int64(7), frac=np.float32(0.25), n=torch.tensor(3))
        t("beta", flag=np.bool_(True), arr=np.arange(2), ten=torch.arange(2))
        t.close()
        lines = [json.loads(s) for s in open(path) if s.strip()]
        assert [ev["seq"] for ev in lines] == [0, 1]
        for ev in lines:
            assert ev["schema"] == TRACE_SCHEMA and ev["process"] == 3
            assert isinstance(ev["stage"], str) and isinstance(ev["wall_s"], float)
        assert lines[0]["rows"] == 7 and lines[0]["frac"] == 0.25 and lines[0]["n"] == 3
        assert lines[1]["flag"] is True and lines[1]["arr"] == [0, 1] == lines[1]["ten"]

    def test_close_idempotent_and_flush_per_line(self, tmp_path):
        path = str(tmp_path / "trace.jsonl")
        t = Tracer(sinks=[JsonlSink(path)])
        t("work", wall_s=1.0)
        assert json.loads(open(path).readline())["stage"] == "work"
        t.close()
        t.close()

    def test_stream_sugar_and_stderr_tracer(self, tmp_path, capsys):
        out = open(tmp_path / "log.txt", "w+")
        t = Tracer(stream=out)
        t("work", n=1, wall_s=0.25)
        out.seek(0)
        assert "stage=work" in out.read()
        out.close()
        stderr_tracer()("live", n=2)
        assert "stage=live wall_s=0.000 n=2" in capsys.readouterr().err

    def test_add_sink(self, tmp_path):
        path = str(tmp_path / "late.jsonl")
        t = Tracer()
        t("before")
        t.add_sink(JsonlSink(path))
        t("after", wall_s=0.5)
        t.close()
        assert [json.loads(s)["stage"] for s in open(path)] == ["after"]


class TestTracerCounters:
    def test_delta_attribution(self):
        """Counter deltas since the previous emit ride the next event; zero
        deltas are omitted — the reference's attribution, event for event."""
        box = [0]
        port = Tracer(counters={"jit_compiles": lambda: box[0]})
        ref = RefTracer(counters={"jit_compiles": lambda: box[0]})
        for step, stage in ((2, "phase_a"), (0, "phase_b"), (3, "phase_c")):
            box[0] += step
            port(stage, wall_s=0.1)
            ref(stage, wall_s=0.1)
        assert [e.fields for e in port.events] == [e.fields for e in ref.events]
        assert port.events[0].fields["jit_compiles"] == 2
        assert "jit_compiles" not in port.events[1].fields
        assert port.events[2].fields["jit_compiles"] == 3

    def test_build_counters_count_builds_and_hits(self, monkeypatch):
        """``jit_compiles`` counts the kernel sources this process built
        with nvcc, ``cache_hits`` the libraries it loaded without a build."""
        builds, hits = telemetry.compile_counter(), telemetry.cache_hit_counter()
        b0, h0 = builds(), hits()
        monkeypatch.setattr(cuda_build, "BUILDS", cuda_build.BUILDS + 2)
        monkeypatch.setattr(cuda_build, "CACHE_HITS", cuda_build.CACHE_HITS + 5)
        assert (builds() - b0, hits() - h0) == (2, 5)

    def test_summary_sorted_by_wall_desc(self):
        t = Tracer()
        t("cheap", wall_s=0.1)
        t("dear", wall_s=2.0)
        t("cheap", wall_s=0.2)
        lines = t.summary().splitlines()
        assert lines[0].startswith("dear:") and lines[1] == "cheap: n=2 wall_s=0.300"


def test_json_sanitize_equals_reference_on_numpy():
    obj = {"i": np.int32(3), "f": np.float64(0.5), "b": np.bool_(False),
           "a": np.array([[1, 2]]), "t": (1, np.int8(2)), "n": None}
    assert telemetry.json_sanitize(obj) == ref_telemetry.json_sanitize(obj)
    assert telemetry.json_sanitize({"x": torch.tensor([1.5, 2.0])}) == {"x": [1.5, 2.0]}
    assert isinstance(telemetry.json_sanitize(object()), str)


# -- aggregates, sections and the report against the reference --------------


class TestReport:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_phase_aggregates_equal_reference(self, seed, same_peaks):
        events, _ = _run_events(seed)
        port, ref = _both(events)
        agg = telemetry.phase_aggregates(port.events)
        assert agg == ref_telemetry.phase_aggregates(ref.events)
        assert list(agg) == sorted(agg, key=lambda k: -agg[k]["wall_s"])
        assert agg["core_distances"]["jit_compiles"] == sum(
            f.get("jit_compiles", 0) for s, f in events if s == "core_distances")

    def test_accepts_jsonl_dicts(self, same_peaks):
        events = [{"stage": "scan", "wall_s": 1.5, "gflops": 3.0}, {"stage": "scan", "wall_s": 0.5}]
        agg = telemetry.phase_aggregates(events)
        assert agg == ref_telemetry.phase_aggregates(events)
        assert agg["scan"] == {"count": 2, "wall_s": 2.0, "gflops": 3.0,
                               "gflops_s": 1.5, "mfu": round(3e9 / 2.0 / flops.PEAK_FLOPS, 6)}

    @pytest.mark.parametrize("seed", [0, 1])
    def test_build_report_and_every_section_equal_reference(self, seed, same_peaks):
        events, walls = _run_events(seed)
        port, ref = _both(events)
        tl = timeline.TimelineRecorder(trace=port)
        rtl = ref_timeline.TimelineRecorder(trace=ref)
        for r in range(3):
            tl.record_round("ring_knn_scan", r, walls, upload_s=0.001, comm_bytes=4096, flops=1e9)
            rtl.record_round("ring_knn_scan", r, walls, upload_s=0.001, comm_bytes=4096,
                             flops=1e9)
        memory = {"start": {"source": "live_arrays"}, "end": {"source": "live_arrays"}}
        for live in (tl.phase_table(), None):  # the live table, then the trace's
            got = telemetry.build_report(port, manifest={"m": 1}, memory=memory,
                                         timeline=live, roofline_tags=["cpu_smoke"])
            want = ref_telemetry.build_report(ref, manifest={"m": 1}, memory=memory,
                                              timeline=None if live is None
                                              else rtl.phase_table(),
                                              roofline_tags=["cpu_smoke"])
            assert got == want
        assert got["schema"] == telemetry.REPORT_SCHEMA == ref_telemetry.REPORT_SCHEMA
        assert {"knn_index", "mst_device", "stream", "request_spans", "controlplane",
                "memory", "timeline", "roofline"} <= set(got)
        assert got["memory"]["watermarks"]["core_distances"]["samples"] > 0
        for section in ("predict_latency_section", "request_span_section", "stream_section",
                        "knn_index_section", "mst_device_section", "controlplane_section",
                        "timeline_section", "memory_watermark_section"):
            assert getattr(telemetry, section)(port) == getattr(ref_telemetry, section)(ref)
        assert telemetry.predict_latency_section(port)["count"] == 25

    def test_empty_sections_are_omitted(self):
        t = Tracer()
        t("scan", wall_s=0.125)
        t("scan", wall_s=0.25)
        report = telemetry.build_report(t)
        assert set(report) == {"schema", "manifest", "phases", "total_wall_s", "event_count"}
        assert abs(report["phases"]["scan"]["wall_s"] - t.total("scan")) < 1e-6
        assert telemetry.predict_latency_section(t) is None

    @pytest.mark.parametrize("n", [0, 1, 7, 100, 1001])
    def test_latency_percentiles_equal_reference(self, n):
        walls = np.random.default_rng(n).exponential(0.01, n).tolist()
        got = telemetry.latency_percentiles(walls)
        assert got == ref_telemetry.latency_percentiles(walls)
        assert got["count"] == n

    def test_slo_verdict_equal_reference(self):
        observed = {"p99_s": 0.02, "rows_per_s": 900.0, "p50_s": 0.004}
        targets = {"p99_s": {"max": 0.05}, "rows_per_s": {"min": 1000.0},
                   "p50_s": {"min": 0.001, "max": 0.01}, "missing": {"max": 1.0}}
        got = telemetry.slo_verdict(observed, targets)
        assert got == ref_telemetry.slo_verdict(observed, targets)
        assert got["ok"] is False and got["targets"]["p99_s"]["ok"] is True


class TestManifestAndMemory:
    def test_manifest_fields(self, monkeypatch):
        monkeypatch.setenv("HDBSCAN_TPU_TRACE", "1")
        m = telemetry.run_manifest(HDBSCANParams(min_points=5), argv=["file=x"],
                                   extra={"tag": "t"})
        ref = ref_telemetry.run_manifest(None)
        assert set(ref) - {"jax_version", "sharding", "params"} <= set(m)
        assert m["params"]["min_points"] == 5 and m["argv"] == ["file=x"]
        assert m["torch_version"] == torch.__version__ and "cuda_version" in m
        assert m["topology"]["platform"] == "cpu" and m["topology"]["device_count"] == 1
        assert m["backends"]["default_backend"] == "cpu"
        assert m["env"]["HDBSCAN_TPU_TRACE"] == "1" and m["tag"] == "t"
        assert m["peak_flops"] == flops.PEAK_FLOPS == 67e12
        assert m["sharding"]["fit_sharding"] == "auto" and m["sharding"]["partition_rules"]
        json.dumps(m)

    def test_memory_sample_shape(self):
        keep = torch.ones(1000, dtype=torch.float64)
        s = telemetry.sample_device_memory()
        assert s["source"] == "live_arrays"
        assert s["live_array_count"] >= 1 and s["live_array_bytes"] >= 8000
        json.dumps(s)
        del keep


class TestHostMerge:
    def test_trace_path_for_process(self):
        for args in (("t.jsonl", 0, 1), ("t.jsonl", 2, 4), ("a/b.trace", 1, 2)):
            assert telemetry.trace_path_for_process(*args) == \
                ref_telemetry.trace_path_for_process(*args)
        assert telemetry.trace_path_for_process("t.jsonl", 2, 4) == "t.2.jsonl"
        assert telemetry.host_trace_paths("t.jsonl", 2) == ["t.0.jsonl", "t.1.jsonl"]

    def test_merge_two_hosts_and_missing_equal_reference(self, tmp_path, same_peaks):
        base = str(tmp_path / "trace.jsonl")
        rng = np.random.default_rng(4)
        for pid in (0, 1):
            t = Tracer(sinks=[JsonlSink(telemetry.trace_path_for_process(base, pid, 3),
                                        static={"process": pid})])
            for _ in range(4):
                t("scan", wall_s=float(rng.uniform(0, 1)), gflops=float(rng.uniform(0, 5)))
            t("tree", wall_s=0.5)
            t.close()
        paths = telemetry.host_trace_paths(base, 3)
        merged = telemetry.merge_host_traces(paths)
        assert merged == ref_telemetry.merge_host_traces(paths)
        assert merged["1"]["scan"]["count"] == 4
        assert merged["2"] == {"missing": True}

    def test_read_trace_roundtrip(self, tmp_path):
        path = str(tmp_path / "t.jsonl")
        t = Tracer(sinks=[JsonlSink(path)])
        t("a", wall_s=0.5, rows=3)
        t.close()
        events = telemetry.read_trace(path)
        assert events == ref_telemetry.read_trace(path)
        assert events[0]["stage"] == "a" and events[0]["rows"] == 3


class TestCheckTraceScript:
    def test_valid_artifacts_pass(self, tmp_path):
        trace, report = str(tmp_path / "t.jsonl"), str(tmp_path / "r.json")
        t = Tracer(sinks=[JsonlSink(trace)])
        t("scan", wall_s=0.5, gflops=1.0)
        t("scan", wall_s=0.25)
        t("predict_batch", wall_s=0.125, rows=3, bucket=4, batch_seq=0, backend="xla", pred=1)
        t.close()
        rep = telemetry.build_report(t)
        rep["predict_latency"] = telemetry.predict_latency_section(t)
        telemetry.write_report(report, rep)
        events, errors = check_trace.validate_trace(trace)
        assert len(events) == 3 and errors == []
        assert check_trace.validate_report(report, trace_events=events)[1] == []
        assert check_trace.main([trace, report]) == 0

    def test_wall_mismatch_detected(self, tmp_path):
        trace, report = str(tmp_path / "t.jsonl"), str(tmp_path / "r.json")
        t = Tracer(sinks=[JsonlSink(trace)])
        t("scan", wall_s=0.5)
        t.close()
        rep = telemetry.build_report(t)
        rep["phases"]["scan"]["wall_s"] += 1e-3
        telemetry.write_report(report, rep)
        events, _ = check_trace.validate_trace(trace)
        _, errors = check_trace.validate_report(report, trace_events=events)
        assert any("wall_s" in e for e in errors)


# -- the kernel build cache and the profiler --------------------------------


class TestCompileCache:
    @pytest.fixture(autouse=True)
    def _restore(self, monkeypatch):
        monkeypatch.delenv("HDBSCAN_TPU_NO_CACHE", raising=False)
        saved = list(cuda_build._build_dir)
        yield
        cuda_build._build_dir[:] = saved

    def test_resolution(self, tmp_path, monkeypatch):
        assert cache.resolve_cache_dir("auto") == cache.resolve_cache_dir(None) == \
            cuda_build.BUILD_DIR
        assert cache.resolve_cache_dir("off") is None
        assert cache.resolve_cache_dir(str(tmp_path)) == str(tmp_path)
        monkeypatch.setenv("HDBSCAN_TPU_NO_CACHE", "1")
        assert cache.resolve_cache_dir(str(tmp_path)) is None

    def test_build_dir_read_at_build_time(self, tmp_path):
        """The knob moves where kernels are built and loaded from: the
        library path follows the directory at each call."""
        target = str(tmp_path / "kernels")
        assert cache.enable_persistent_compilation_cache(target) == target
        assert os.path.isdir(target) and cuda_build.build_dir() == target
        assert os.path.dirname(cuda_build._so_path("segmin.cu")) == target
        assert cache.enable_persistent_compilation_cache("auto") == cuda_build.BUILD_DIR
        assert os.path.dirname(cuda_build._so_path("segmin.cu")) == cuda_build.BUILD_DIR

    def test_off_builds_into_a_fresh_process_directory(self):
        assert cache.enable_persistent_compilation_cache("off") is None
        fresh = cuda_build.build_dir()
        assert fresh != cuda_build.BUILD_DIR and os.path.isdir(fresh)
        assert os.listdir(fresh) == []
        assert cache.enable_persistent_compilation_cache("off") is None
        assert cuda_build.build_dir() == fresh  # one directory a process


def test_xla_profile_writes_a_chrome_trace(tmp_path):
    """``xla_profile`` (the reference's name) records a torch.profiler
    trace of the block into ``logdir``."""
    with xla_profile(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "prof" / files[0]) as f:
        assert "traceEvents" in json.load(f)


def test_check_trace_is_stdlib_only():
    """The validator runs where artifacts land, without torch or numpy."""
    import ast

    src = open(check_trace.__file__).read()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] in ("__future__", "json", "math", "os", "sys"), mod

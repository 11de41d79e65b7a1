"""The port's tracing (``hdbscan_tpu_torch/utils/tracing.py``) against the
reference's ``hdbscan_tpu/utils/tracing.py``: the same events give the same
``hdbscan-tpu-trace/1`` lines, the same rotation, the same in-memory ring
and the same summary; torch values are written as numbers. Then the port's
spans: nothing read or recorded while none is installed, every thread's
spans collected with their parents, device markers held until complete,
the profile's clock, the Chrome trace of ``xla_profile``, a request's id
through the batcher, and the span fields ``scripts/check_trace.py`` checks.
"""

import io
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from hdbscan_tpu.utils import tracing as ref_tracing
from hdbscan_tpu_torch.utils import tracing as port_tracing
from hdbscan_tpu_torch.utils.telemetry import json_sanitize
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


#: Instant events (explicit walls, so every line is deterministic) with the
#: field types the fits emit: numpy scalars and arrays, tuples, nested
#: dicts, bools, None and strings.
_EVENTS = [
    ("load_points", dict(rows=np.int64(600), dims=3, wall_s=0.000378)),
    ("mst_round", dict(round=0, components=np.int32(17), edges_added=np.int64(583),
                       sharded=True)),
    ("block_edges", dict(n=600, wall_s=np.float64(1.25))),
    ("level", dict(level=1, sizes=np.arange(4), shape=(3, 4), extra=None,
                   nested={"a": np.float32(0.5), 2: [np.bool_(True)]})),
    ("fit", dict(mode="exact", rows=600, wall_s=1.5)),
    ("write_outputs", dict(wall_s=0.004)),
]


def _emit_all(tracer, events=_EVENTS):
    for name, fields in events:
        tracer(name, **dict(fields))


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("static", [None, {"process": 0}])
def test_jsonl_lines_equal_reference(tmp_path, static):
    paths = {}
    for tag, mod in (("ref", ref_tracing), ("port", port_tracing)):
        paths[tag] = str(tmp_path / f"{tag}.jsonl")
        tracer = mod.Tracer(sinks=[mod.JsonlSink(paths[tag], static=static)])
        _emit_all(tracer)
        tracer.close()
    assert _read(paths["port"]) == _read(paths["ref"])
    first = json.loads(_read(paths["port"]).splitlines()[0])
    assert first["schema"] == port_tracing.TRACE_SCHEMA == ref_tracing.TRACE_SCHEMA


@pytest.mark.parametrize("rotate_bytes", [1, 300, 700, 10_000])
def test_rotation_equal_reference(tmp_path, rotate_bytes):
    sinks = {}
    for tag, mod in (("ref", ref_tracing), ("port", port_tracing)):
        (tmp_path / tag).mkdir()
        sink = mod.JsonlSink(str(tmp_path / tag / "t.jsonl"), rotate_bytes=rotate_bytes)
        tracer = mod.Tracer(sinks=[sink])
        _emit_all(tracer, _EVENTS * 3)
        tracer.close()
        sinks[tag] = sink
    assert sinks["port"].rotations == sinks["ref"].rotations
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref"))
    for name in os.listdir(tmp_path / "ref"):
        assert _read(tmp_path / "port" / name) == _read(tmp_path / "ref" / name), name


def test_rotation_refuses_negative_bytes(tmp_path):
    with pytest.raises(ValueError, match="rotate_bytes"):
        port_tracing.JsonlSink(str(tmp_path / "t.jsonl"), rotate_bytes=-1)


@pytest.mark.parametrize("max_events", [None, 1, 3, 8])
def test_ring_and_summary_equal_reference(max_events):
    tracers = {}
    for tag, mod in (("ref", ref_tracing), ("port", port_tracing)):
        tracer = mod.Tracer(max_events=max_events)
        _emit_all(tracer, _EVENTS * 4)
        tracers[tag] = tracer
    ref, port = tracers["ref"], tracers["port"]
    assert [(e.name, e.wall_s) for e in port.events] == [(e.name, e.wall_s) for e in ref.events]
    assert port.events_dropped == ref.events_dropped
    assert port.summary() == ref.summary()
    for name in ("fit", "block_edges", "absent"):
        assert port.total(name) == ref.total(name)
        assert port.walls(name) == ref.walls(name)


def test_max_events_refuses_negative():
    with pytest.raises(ValueError, match="max_events"):
        port_tracing.Tracer(max_events=-1)


def test_logfmt_equal_reference():
    outs = {}
    for tag, mod in (("ref", ref_tracing), ("port", port_tracing)):
        stream = io.StringIO()
        tracer = mod.Tracer(stream=stream)
        _emit_all(tracer)
        outs[tag] = (stream.getvalue(), [(e.name, e.wall_s) for e in tracer.events])
    assert outs["port"] == outs["ref"]


def test_stage_times_a_block():
    tracer = port_tracing.Tracer()
    with tracer.stage("finalize", n=3):
        pass
    (ev,) = tracer.events
    assert ev.name == "finalize" and ev.fields == {"n": 3} and ev.wall_s >= 0.0


def test_torch_values_are_numbers(tmp_path):
    path = str(tmp_path / "t.jsonl")
    tracer = port_tracing.Tracer(sinks=[port_tracing.JsonlSink(path)])
    tracer("boruvka_mst", rounds=torch.tensor(7), wall_s=torch.tensor(0.5, dtype=torch.float64),
           weight=torch.tensor(1.25), done=torch.tensor(True), sizes=torch.arange(3))
    tracer.close()
    rec = json.loads(_read(path))
    assert rec["rounds"] == 7 and isinstance(rec["rounds"], int)
    assert rec["wall_s"] == 0.5
    assert rec["weight"] == 1.25 and rec["done"] is True and rec["sizes"] == [0, 1, 2]
    assert json_sanitize({"x": (np.int16(2), torch.tensor([1.5]))}) == {"x": [2, [1.5]]}



# -- spans (utils/tracing.span) ------------------------------------------------


class _RaisingCount:
    def __next__(self):
        raise AssertionError("a span id was taken with nothing installed")


def test_span_uninstalled_records_nothing_and_reads_no_clock(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("read with nothing installed")

    monkeypatch.setattr(port_tracing.time, "perf_counter_ns", boom)
    monkeypatch.setattr(port_tracing, "_IDS", _RaisingCount())
    monkeypatch.setattr(torch.cuda, "Event", boom)
    assert port_tracing._INSTALLED is None
    with port_tracing.span("a", device=torch.device("cuda", 0), rows=3) as sp:
        sp.set(more=1)
        sp.device_stop()
    assert not sp and sp is port_tracing.span("b")
    assert port_tracing.begin("c") is None


def test_span_hook_gets_its_stage_once():
    """A span with a ``trace`` hook gives the hook one event under the
    hook's stage name with the span's wall and fields; an installed tracer
    that is also the hook gets it once, any other under the span's name."""
    hook, other = port_tracing.Tracer(), port_tracing.Tracer()
    with port_tracing.install(hook), port_tracing.install(other), port_tracing.install(hook):
        with port_tracing.span("boruvka.round", hook=hook, stage="mst_round", round=0) as sp:
            sp.set(components=3)
    (ev,) = hook.events
    (ev2,) = other.events
    assert ev.name == "mst_round" and ev2.name == "boruvka.round"
    assert ev.wall_s == ev2.wall_s == (ev.fields["t1_ns"] - ev.fields["t0_ns"]) / 1e9
    # The hook's event is a stage; the other tracer's is the span alone.
    assert dict(ev.fields, span=True) == ev2.fields and ev.fields["components"] == 3
    assert not port_tracing.is_span_only(ev.fields) and port_tracing.is_span_only(ev2.fields)
    assert ev.fields["parent_id"] is None and ev.fields["root_id"] == ev.fields["span_id"]
    assert "device_ms" not in ev.fields  # no card
    # Only a hook, nothing installed: the hook still gets the event.
    calls = []
    with port_tracing.span("fetch", hook=lambda s, **f: calls.append((s, f)), stage="host_sync"):
        pass
    assert calls[0][0] == "host_sync" and calls[0][1]["wall_s"] >= 0
    assert port_tracing._INSTALLED is None


def test_thread_started_before_install_is_collected():
    go, done = threading.Event(), threading.Event()

    def work():
        assert go.wait(10)
        with port_tracing.span("outer", k=1):
            with port_tracing.span("inner"):
                pass
        done.set()

    th = threading.Thread(target=work, name="span-worker")
    th.start()
    tracer = port_tracing.Tracer()
    with port_tracing.install(tracer):
        with port_tracing.span("main"):  # another thread's stack: not the worker's parent
            go.set()
            assert done.wait(10)
    th.join(10)
    assert not th.is_alive()
    (outer,), (inner,), (main,) = (tracer.spans(n) for n in ("outer", "inner", "main"))
    o, i = outer.fields, inner.fields
    assert o["thread"] == i["thread"] == "span-worker" and main.fields["thread"] != "span-worker"
    assert o["parent_id"] is None and o["root_id"] == o["span_id"] and o["k"] == 1
    assert i["parent_id"] == i["root_id"] == o["span_id"]
    assert o["t0_ns"] <= i["t0_ns"] <= i["t1_ns"] <= o["t1_ns"]


def test_spans_from_many_threads_keep_their_ids():
    """Spans opened on more threads than cores, with a short switch
    interval: every span is collected once, ids are unique and each child
    names its own thread's parent."""
    import sys

    tracer = port_tracing.Tracer()
    n_threads, n_spans = 16, 100
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with port_tracing.span("outer"):
                    with port_tracing.span("inner"):
                        pass

        with port_tracing.install(tracer):
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(prev)
    outer, inner = tracer.spans("outer"), tracer.spans("inner")
    assert len(outer) == len(inner) == n_threads * n_spans
    ids = [e.fields["span_id"] for e in outer + inner]
    assert len(set(ids)) == len(ids)
    by_id = {e.fields["span_id"]: e.fields for e in outer}
    for e in inner:
        parent = by_id[e.fields["parent_id"]]
        assert parent["tid"] == e.fields["tid"]
        assert parent["t0_ns"] <= e.fields["t0_ns"] <= e.fields["t1_ns"] <= parent["t1_ns"]


class _FakeEvent:
    """A CUDA event stand-in: completes when ``done`` is set."""

    done = False
    made = 0

    def __init__(self, enable_timing=False):
        _FakeEvent.made += 1
        self.recorded = False

    def record(self, stream=None):
        self.recorded = True

    def query(self):
        return _FakeEvent.done

    def elapsed_time(self, end):
        assert _FakeEvent.done and self.recorded and end.recorded
        return 2.5


class _FakeStream:
    device_index = 0


def test_device_span_waits_for_its_markers(monkeypatch):
    """A device-timed span whose end marker has not completed is held back,
    then emitted with its ``device_ms`` by the first span that ends after
    the card caught up; one that completed at once is emitted at once. The
    events are pooled: a span made after both have been read makes none."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(_FakeEvent, "done", False)
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(port_tracing, "_EVENTS", {})
    card = torch.device("cuda", 0)
    tracer = port_tracing.Tracer()
    with port_tracing.install(tracer):
        with port_tracing.span("core_distances", device=card):
            pass
        assert tracer.events == [] and len(port_tracing._PENDING) == 1
        _FakeEvent.done = True
        with port_tracing.span("fetch"):
            pass
        with port_tracing.span("boruvka.round", device=card) as sp:
            sp.device_stop()
    assert port_tracing._PENDING == []
    assert [e.name for e in tracer.events] == ["core_distances", "fetch", "boruvka.round"]
    assert tracer.events[0].fields["device_ms"] == tracer.events[2].fields["device_ms"] == 2.5
    assert "device_ms" not in tracer.events[1].fields
    assert _FakeEvent.made == 2 and len(port_tracing._EVENTS[0]) == 2


def test_span_lands_on_the_profile_clock():
    """A span around a main-thread ``record_function``, put on the profile's
    clock with ``trace_start_ns()``, lands within 1 ms of that event."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tracer = port_tracing.Tracer()
    with port_tracing.install(tracer), profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        with port_tracing.span("aligned"):
            with record_function("mark"):
                time.sleep(0.02)
    start = prof.profiler.kineto_results.trace_start_ns()
    (mark,) = [e for e in prof.events() if e.name == "mark"]
    (sp,) = tracer.spans("aligned")
    assert abs(tracer.profile_us(sp.fields["t0_ns"], start) - mark.time_range.start) < 1000
    assert abs(tracer.profile_us(sp.fields["t1_ns"], start) - mark.time_range.end) < 1000


def test_xla_profile_holds_a_worker_threads_span(tmp_path):
    """The profiler records no other thread than its own; ``xla_profile``
    merges the installed tracer's spans, a worker thread's included, into
    its Chrome trace inside the profile's window."""
    tracer = port_tracing.Tracer()

    def work():
        with port_tracing.span("worker.step", rows=4):
            time.sleep(0.005)

    with port_tracing.install(tracer), port_tracing.xla_profile(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
        th = threading.Thread(target=work, name="profile-worker")
        th.start()
        th.join(10)
        torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / name) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "span"]
    (step,) = [e for e in spans if e["name"] == "worker.step"]
    assert step["args"]["rows"] == 4 and step["tid"] == tracer.spans()[0].fields["tid"]
    own = [e for e in events if e.get("ph") == "X" and e.get("cat") != "span"]
    lo = min(e["ts"] for e in own)
    hi = max(e["ts"] + e.get("dur", 0) for e in own)
    assert lo <= step["ts"] and step["ts"] + step["dur"] <= hi
    assert {"ph": "M", "name": "thread_name", "pid": os.getpid(), "tid": step["tid"],
            "args": {"name": "profile-worker"}} in events


def _served_model():
    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import exact
    from hdbscan_tpu_torch.serve.artifact import ClusterModel

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(c, 1.0, size=(150, 3)) for c in (0.0, 9.0)])
    params = HDBSCANParams(min_points=6, min_cluster_size=20)
    return ClusterModel.from_fit_result(exact.fit(x, params, device="cpu"), x, params), x


def test_request_id_runs_from_submit_through_dispatch():
    from hdbscan_tpu_torch.serve.batcher import MicroBatcher
    from hdbscan_tpu_torch.serve.predict import Predictor

    model, x = _served_model()
    batcher = MicroBatcher(Predictor(model, max_batch=16, device="cpu"), linger_s=0.05)
    tracer = port_tracing.Tracer()
    with port_tracing.install(tracer):
        named = batcher.submit(x[:20], {"request_id": "req-a"})
        fresh = batcher.submit(x[20:23])
        named.result(10), fresh.result(10)
        batcher.close()
    reqs = {e.fields["span_id"]: e for e in tracer.spans("batcher.request")}
    assert "req-a" in reqs and len(reqs) == 2
    (fresh_id,) = set(reqs) - {"req-a"}
    assert reqs["req-a"].fields["rows"] == 20 and reqs[fresh_id].fields["rows"] == 3
    dispatch = {e.fields["span_id"]: e for e in tracer.spans("batcher.dispatch")}
    carried = {rid: d for d, e in dispatch.items() for rid in e.fields["requests"]}
    assert set(carried) == {"req-a", fresh_id}
    for rid, d in carried.items():
        req, disp = reqs[rid].fields, dispatch[d].fields
        assert req["t0_ns"] <= disp["t0_ns"] and req["t1_ns"] <= disp["t1_ns"]
        assert disp["thread"] == "predict-batcher" and req["thread"] != disp["thread"]
    for name in ("predict.bucket", "batcher.fanout"):
        assert tracer.spans(name)
        for e in tracer.spans(name):
            assert e.fields["parent_id"] in dispatch
    buckets = tracer.spans("predict.bucket")
    ids = {e.fields["span_id"] for e in buckets}
    stages = tracer.spans("predict.stage")
    assert len(stages) == len(buckets) and all(e.fields["parent_id"] in ids for e in stages)
    assert sum(e.fields["rows"] for e in buckets) == 23
    assert all(e.fields["pad_rows"] == e.fields["bucket"] - e.fields["rows"] for e in buckets)
    assert {e.name for e in tracer.events} >= {"batcher.wait", "batcher.linger"}


def test_span_lines_pass_check_trace(tmp_path):
    from scripts import check_trace

    path = str(tmp_path / "t.jsonl")
    tracer = port_tracing.Tracer(sinks=[port_tracing.JsonlSink(path)])
    with port_tracing.install(tracer):
        with port_tracing.span("fit", rows=3):
            with port_tracing.span("core_distances", hook=tracer, n=3):
                pass
    tracer("load_points", rows=3)
    tracer.close()
    _, errors = check_trace.validate_trace(path)
    assert errors == []
    lines = [json.loads(line) for line in open(path)]
    assert [r["stage"] for r in lines] == ["core_distances", "fit", "load_points"]
    bad = dict(lines[0], t1_ns=lines[0]["t0_ns"] - 1, seq=9)
    with open(path, "a") as f:
        f.write(json.dumps(bad) + "\n")
    _, errors = check_trace.validate_trace(path)
    assert len(errors) == 1 and "t0_ns" in errors[0]


def test_report_phases_leave_span_only_events_out(tmp_path):
    """A report's phase table counts the stages of ``trace`` hooks and the
    tracer's own events, not the spans an installed tracer got alone (a
    root ``fit.root`` beside the command's ``fit`` stage), and
    ``check_trace`` agrees. With ``ring_spans=False`` the in-memory list
    keeps no span-only event; the JSON lines keep them all."""
    from hdbscan_tpu_torch.utils import telemetry
    from scripts import check_trace

    path = str(tmp_path / "t.jsonl")
    tracer = port_tracing.Tracer(sinks=[port_tracing.JsonlSink(path)], ring_spans=False)
    with port_tracing.install(tracer):
        with port_tracing.span("fit.root", rows=3):
            with port_tracing.span("core_distances", hook=tracer, n=3):
                pass
            with port_tracing.span("finalize"):
                pass
    tracer("fit", rows=3, wall_s=0.5)
    tracer.close()
    assert [e.name for e in tracer.events] == ["core_distances", "fit"]
    report = telemetry.build_report(tracer)
    assert list(report["phases"]) == ["fit", "core_distances"]
    assert report["phases"]["fit"]["count"] == 1
    assert report["total_wall_s"] == round(0.5 + tracer.total("core_distances"), 6)
    lines, errors = check_trace.validate_trace(path)
    assert errors == []
    assert [r["stage"] for r in lines] == ["core_distances", "finalize", "fit.root", "fit"]
    assert [r.get("span", False) for r in lines] == [False, True, True, False]
    report_path = str(tmp_path / "r.json")
    telemetry.write_report(report_path, report)
    _, errors = check_trace.validate_report(report_path, lines)
    assert errors == []


def test_device_events_only_for_a_tracer_that_wants_them(monkeypatch):
    """A device span records CUDA events only where a hook or an installed
    tracer wants ``device_ms``: a tracer installed with ``device=False``
    alone gets the span without them."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(_FakeEvent, "done", True)
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(port_tracing, "_EVENTS", {})
    card = torch.device("cuda", 0)
    quiet, timed = port_tracing.Tracer(), port_tracing.Tracer()
    with port_tracing.install(quiet, device=False):
        with port_tracing.span("predict.bucket", device=card):
            pass
        assert _FakeEvent.made == 0 and "device_ms" not in quiet.events[-1].fields
        with port_tracing.span("boruvka.round", hook=timed, stage="mst_round", device=card):
            pass
        assert _FakeEvent.made == 2 and timed.events[-1].fields["device_ms"] == 2.5
        with port_tracing.install(timed):
            with port_tracing.span("predict.bucket", device=card):
                pass
    assert _FakeEvent.made == 2  # the pool's pair again
    assert quiet.events[-1].fields["device_ms"] == timed.events[-1].fields["device_ms"] == 2.5
    assert not port_tracing._DEVICE and port_tracing._INSTALLED is None

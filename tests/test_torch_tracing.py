"""The port's tracing (``hdbscan_tpu_torch/utils/tracing.py``) against the
reference's ``hdbscan_tpu/utils/tracing.py``: the same events give the same
``hdbscan-tpu-trace/1`` lines, the same rotation, the same in-memory ring
and the same summary; torch values are written as numbers.
"""

import io
import json
import os

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


"""The port's stream journal (``hdbscan_tpu_torch/stream/wal.py``) against
the reference's ``hdbscan_tpu/stream/wal.py``: the same on-disk format, so
a journal either package writes recovers in the other, bitwise.

Each recovery case runs for every (writer, reader) pair of packages: a
journaled run is abandoned mid-stream (what SIGKILL leaves: every append
fsync'd, nothing closed), a fresh process of the other (or the same)
package opens the directory, finishes the stream, and lands on the
uninterrupted run's buffer and drift state (the reservoir RNG included).
Also held: the WAL files themselves are byte-equal between the packages,
snapshot cadence and truncation, a stale digest starting fresh, a torn
final line dropped and a torn middle line or a seq gap refused, restart
after a swap, a reservoir wrapped many times over, the maintenance
watermark round trip, and the trace events against
``scripts/check_trace.py``.
"""

import json
import os
import types

import numpy as np
import pytest

from hdbscan_tpu.stream import buffer as ref_buffer
from hdbscan_tpu.stream import drift as ref_drift
from hdbscan_tpu.stream import wal as ref_wal
from hdbscan_tpu_torch.stream import buffer, drift, wal
from hdbscan_tpu_torch.utils.tracing import JsonlSink, Tracer

#: package -> (buffer, drift, wal) modules.
PKGS = {"port": (buffer, drift, wal), "ref": (ref_buffer, ref_drift, ref_wal)}
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]


def _model(seed=0, n=64, dims=3):
    rng = np.random.default_rng(seed)
    return types.SimpleNamespace(data=rng.normal(0, 1, (n, dims)))


def _fresh(pkg, model, seed=0, reservoir=32):
    """A (buffer, drift) pair of ``pkg`` in its post-construction state."""
    b, d, _ = PKGS[pkg]
    buf = b.IngestBuffer(model, reservoir_size=reservoir, seed=seed)
    rng = np.random.default_rng(seed + 100)
    return buf, d.DriftDetector(rng.uniform(0, 1, 512), rng.integers(-1, 3, 512))


def _journal(pkg, path, **kw):
    return PKGS[pkg][2].StreamJournal(str(path), **kw)


def _chunk(rng, rows=16, dims=3):
    """One predicted batch: (points, labels, prob, scores)."""
    return (rng.normal(0, 2, (rows, dims)), rng.integers(-1, 3, rows),
            rng.uniform(0, 1, rows), rng.uniform(0, 1, rows))


def _ingest(journal, buf, drift_, chunk):
    """The server's order: absorb/update, then append + snapshot."""
    pts, labels, prob, scores = chunk
    buf.absorb(pts, labels, prob)
    drift_.update(labels, scores)
    if journal is not None:
        journal.append_ingest(pts, labels, prob, scores)
        journal.maybe_snapshot(buf, drift_)


def _same(a, b):
    assert json.dumps(a.state_dict(), sort_keys=True) == json.dumps(b.state_dict(),
                                                                    sort_keys=True)


@pytest.mark.parametrize("writer,reader", PAIRS)
@pytest.mark.parametrize("reservoir,snapshot_every,crash_at", [(32, 4, 6), (8, 5, 13)],
                         ids=["tail-replay", "wrapped-reservoir"])
def test_recovery_is_bitwise_across_packages(tmp_path, writer, reader, reservoir,
                                             snapshot_every, crash_at):
    """Crash after ``crash_at`` chunks, recover with the other package,
    finish: state and re-fit pool equal the uninterrupted run's."""
    model = _model()
    rng = np.random.default_rng(11)
    chunks = [_chunk(rng) for _ in range(20)]
    ref_buf, ref_drift_ = _fresh("ref", model, seed=3, reservoir=reservoir)
    for c in chunks:
        _ingest(None, ref_buf, ref_drift_, c)
    if reservoir == 8:
        assert ref_buf.state_dict()["rows_seen"] > 8 * 10  # the reservoir wrapped

    buf_a, drift_a = _fresh(writer, model, seed=3, reservoir=reservoir)
    jr_a = _journal(writer, tmp_path, snapshot_every=snapshot_every)
    jr_a.open("digest-1", buf_a, drift_a)
    for c in chunks[:crash_at]:
        _ingest(jr_a, buf_a, drift_a, c)

    buf_b, drift_b = _fresh(reader, model, seed=3, reservoir=reservoir)
    jr_b = _journal(reader, tmp_path, snapshot_every=snapshot_every)
    info = jr_b.open("digest-1", buf_b, drift_b)
    assert info["snapshot"] is True and not info["stale_discarded"]
    assert info["records"] == (crash_at + 1) % snapshot_every
    for c in chunks[crash_at:]:
        _ingest(jr_b, buf_b, drift_b, c)
    _same(buf_b, ref_buf)
    _same(drift_b, ref_drift_)
    np.testing.assert_array_equal(buf_b.refit_points(originals=16, seed=7),
                                  ref_buf.refit_points(originals=16, seed=7))
    jr_a.close()
    jr_b.close()


def test_journal_files_equal_reference(tmp_path):
    """The same stream journaled by each package leaves byte-equal
    ``wal.jsonl`` and ``snapshot.json`` files and equal stats."""
    model = _model(1)
    rng = np.random.default_rng(2)
    chunks = [_chunk(rng) for _ in range(7)]
    stats = []
    for pkg in ("port", "ref"):
        buf, drift_ = _fresh(pkg, model)
        jr = _journal(pkg, tmp_path / pkg, snapshot_every=3)
        jr.open("d", buf, drift_)
        for c in chunks:
            _ingest(jr, buf, drift_, c)
        jr.close()
        st = jr.stats()
        stats.append({k: v for k, v in st.items() if k not in ("dir", "last_recover")})
    assert stats[0] == stats[1] and stats[0]["since_snapshot"] == 2
    for name in ("wal.jsonl", "snapshot.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    snap = json.loads((tmp_path / "port" / "snapshot.json").read_text())
    assert snap["schema"] == "hdbscan-tpu-wal-snapshot/1" and snap["watermark"] == 6
    assert [json.loads(r)["seq"] for r in
            (tmp_path / "port" / "wal.jsonl").read_text().splitlines()] == [6, 7]


@pytest.mark.parametrize("reader", ["port", "ref"])
def test_stale_digest_and_stale_wal_start_fresh(tmp_path, reader):
    model = _model()
    buf, drift_ = _fresh("port", model)
    jr = _journal("port", tmp_path / "a", snapshot_every=2)
    jr.open("old-digest", buf, drift_)
    rng = np.random.default_rng(3)
    for _ in range(4):
        _ingest(jr, buf, drift_, _chunk(rng))
    jr.close()
    buf2, drift2 = _fresh(reader, model)
    jr2 = _journal(reader, tmp_path / "a", snapshot_every=2)
    info = jr2.open("NEW-digest", buf2, drift2)
    assert info["stale_discarded"] is True and info["records"] == 0
    assert buf2.stats()["rows_seen"] == 0
    _ingest(jr2, buf2, drift2, _chunk(rng))
    assert buf2.stats()["rows_seen"] == 16
    jr2.close()
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "wal.jsonl").write_text(
        json.dumps({"seq": 0, "kind": "begin", "digest": "other"}) + "\n")
    buf3, drift3 = _fresh(reader, model)
    jr3 = _journal(reader, tmp_path / "b")
    info = jr3.open("mine", buf3, drift3)
    assert info["stale_discarded"] is True and info["records"] == 0
    jr3.close()


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_torn_tail_dropped_torn_middle_and_gap_refused(tmp_path, writer, reader):
    model = _model()
    buf, drift_ = _fresh(writer, model)
    jr = _journal(writer, tmp_path, snapshot_every=100)
    jr.open("d", buf, drift_)
    rng = np.random.default_rng(4)
    for _ in range(3):
        _ingest(jr, buf, drift_, _chunk(rng))
    jr.close()
    wal_path = tmp_path / "wal.jsonl"
    good = wal_path.read_text()
    wal_path.write_text(good + '{"seq": 4, "kind": "ingest", "points": [[1.')
    buf2, drift2 = _fresh(reader, model)
    info = _journal(reader, tmp_path, snapshot_every=100).open("d", buf2, drift2)
    assert info["torn_tail_dropped"] is True and info["records"] == 3
    _same(buf2, buf)
    lines = good.splitlines()
    for broken, match in (([lines[0], lines[1][: len(lines[1]) // 2], *lines[2:]],
                           "corrupt WAL record"),
                          ([lines[0], lines[1], *lines[3:]], "WAL seq gap")):
        wal_path.write_text("\n".join(broken) + "\n")
        with pytest.raises(ValueError, match=match):
            _journal(reader, tmp_path, snapshot_every=100).open("d", *_fresh(reader, model))


def test_restart_rekeys_after_swap(tmp_path):
    model = _model()
    buf, drift_ = _fresh("port", model)
    jr = _journal("port", tmp_path, snapshot_every=100)
    jr.open("gen1", buf, drift_)
    rng = np.random.default_rng(7)
    for _ in range(3):
        _ingest(jr, buf, drift_, _chunk(rng))
    assert jr.stats()["seq"] == 4
    jr.restart("gen2")
    assert jr.stats()["seq"] == 1
    assert not os.path.exists(tmp_path / "snapshot.json")
    assert [json.loads(r) for r in (tmp_path / "wal.jsonl").read_text().splitlines()] == [
        {"seq": 0, "kind": "begin", "digest": "gen2"}]
    jr.close()


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_snapshot_only_recovery_and_maintain_watermark(tmp_path, writer, reader):
    """Recovery purely from a snapshot (no WAL tail) resumes a wrapped
    reservoir bitwise, and the maintenance watermark comes back verbatim;
    without a snapshot it is None."""
    model = _model()
    rng = np.random.default_rng(12)
    chunks = [_chunk(rng) for _ in range(12)]
    ref_buf, ref_drift_ = _fresh("ref", model, seed=4, reservoir=8)
    for c in chunks:
        _ingest(None, ref_buf, ref_drift_, c)
    buf_a, drift_a = _fresh(writer, model, seed=4, reservoir=8)
    jr_a = _journal(writer, tmp_path, snapshot_every=10_000)
    jr_a.open("digest-s", buf_a, drift_a)
    for c in chunks[:9]:
        _ingest(jr_a, buf_a, drift_a, c)
    mark = {"n": 80, "inserts": 16, "splices": 2, "spliced_edges": 18, "evicted_edges": 3,
            "pending_edges": 0, "journal_len": 18, "journal_sha": "ab" * 32,
            "mst_sha": "cd" * 32}
    jr_a.snapshot(buf_a, drift_a, maintain=mark)
    buf_b, drift_b = _fresh(reader, model, seed=4, reservoir=8)
    jr_b = _journal(reader, tmp_path, snapshot_every=10_000)
    info = jr_b.open("digest-s", buf_b, drift_b)
    assert info["snapshot"] is True and info["records"] == 0 and info["maintain"] == mark
    for c in chunks[9:]:
        _ingest(jr_b, buf_b, drift_b, c)
    _same(buf_b, ref_buf)
    _same(drift_b, ref_drift_)
    jr_a.close()
    jr_b.close()
    jr_c = _journal(reader, tmp_path / "fresh")
    assert jr_c.open("digest-s", *_fresh(reader, model))["maintain"] is None
    jr_c.close()


def test_trace_events_pass_check_trace(tmp_path):
    from scripts import check_trace

    trace = str(tmp_path / "trace.jsonl")
    tracer = Tracer(sinks=[JsonlSink(trace)])
    buf, drift_ = _fresh("port", _model())
    jr = _journal("port", tmp_path / "wal", snapshot_every=3, tracer=tracer)
    jr.open("d", buf, drift_)
    rng = np.random.default_rng(8)
    for _ in range(5):
        _ingest(jr, buf, drift_, _chunk(rng))
    jr.restart("d2")
    _ingest(jr, buf, drift_, _chunk(rng))
    jr.close()
    tracer.close()
    events, errors = check_trace.validate_trace(trace)
    assert not errors, errors
    appends = [e for e in events if e["stage"] == "wal_append"]
    assert appends[0]["kind"] == "begin" and len(appends) == 8
    recovers = [e for e in events if e["stage"] == "wal_recover"]
    assert len(recovers) == 1 and recovers[0]["records"] == 0
    with pytest.raises(ValueError):
        wal.StreamJournal(str(tmp_path / "never"), snapshot_every=0)

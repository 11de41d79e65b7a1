"""StreamJournal: crash-safe durability for the ingest path (WAL + snapshot).

A host-only copy of ``hdbscan_tpu/stream/wal.py``.

MR-HDBSCAN* gets stream durability for free from MapReduce lineage
re-execution; the serving port has to write it down. The journal makes the
per-process ingest state — :class:`~hdbscan_tpu_torch.stream.buffer.IngestBuffer`
(reservoir, bubble summaries, novel rows) and
:class:`~hdbscan_tpu_torch.stream.drift.DriftDetector` sketches — survive a
SIGKILL with *bitwise* fidelity:

- **WAL** (``wal.jsonl``): every accepted ingest batch is appended as one
  JSON line ``{seq, kind: "ingest", points, labels, prob, scores, rows}``
  and fsync'd before the HTTP 200 is acked, so an acked ingest is durable.
  Python's ``json`` emits shortest round-trip float reprs, so replayed rows
  are bitwise-identical to the originals.
- **Snapshot** (``snapshot.json``): every ``snapshot_every`` appends the
  full buffer+drift state is written via the repo's atomic-persist idiom
  (temp file in the target dir, fsync, ``os.replace``, fsync dir — see
  ``utils/checkpoint.py`` / ``serve/artifact.py``) and the WAL truncated,
  bounding both file size and recovery replay.

Recovery (:meth:`StreamJournal.open`) restores the snapshot (if any) and
replays the WAL tail through ``buffer.absorb`` / ``drift.update``. Because
the buffer is deterministic given its seed and the exact absorb sequence
(including the captured reservoir RNG state), the recovered refit pool is
bitwise-identical to an uninterrupted run. A torn final line (the one
unsynced write a crash can leave) is dropped; any seq discontinuity raises.

The journal is keyed to the served model's data digest: a digest mismatch
on open (new model fitted between runs) or a blue/green swap
(:meth:`restart`) wipes the journal rather than replaying stale state.

**Reservoir-wrap guarantee.** The buffer's Vitter algorithm-R reservoir
stays bitwise-recoverable arbitrarily far past capacity (n >> capacity):
``state_dict`` captures both the monotone ``stream_index`` and the full
reservoir RNG ``bit_generator`` state, so post-recovery replacement draws
``j = rng.integers(0, i + 1)`` continue the *same* random sequence at the
*same* stream positions as the uninterrupted process. No wrap counter or
epoch is needed — the pair (index, RNG state) is the entire decision
state of algorithm R. ``tests/test_torch_stream_wal.py`` pins this with a
reservoir wrapped many times over.

**Incremental-maintenance watermark.** When ``stream_maintain=
incremental`` the snapshot carries an optional ``maintain`` dict — the
maintainer's counters plus sha256 digests of its MST edit journal and
canonical MST arrays (``incremental.HierarchyMaintainer.state_dict``).
Maintenance is NOT replayed from the WAL directly: it is a deterministic
fold over the buffer's novel chunks (``IngestBuffer.novel_chunks``),
which the ordinary buffer recovery already restores bitwise. Recovery
re-runs the fold and *verifies* it passes through the persisted digests
at the recorded insert count; a mismatch demotes to the re-fit path
rather than serving a silently-diverged hierarchy.

Trace schemas (scripts/check_trace.py): ``wal_append`` per record with a
per-``(process, wal)`` contiguous ``wal_seq``, and ``wal_recover`` once per
open. Metrics: ``hdbscan_tpu_wal_appends_total`` /
``wal_snapshots_total`` / ``wal_recovered_records_total``.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time

import numpy as np

__all__ = ["StreamJournal"]

SNAPSHOT_SCHEMA = "hdbscan-tpu-wal-snapshot/1"
_WAL_NAME = "wal.jsonl"
_SNAP_NAME = "snapshot.json"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class StreamJournal:
    """JSONL write-ahead log + periodic snapshot for one ingest pipeline.

    Parameters
    ----------
    dir:
        Journal directory (created if missing); holds ``wal.jsonl`` and
        ``snapshot.json``.
    name:
        Journal name carried in trace events (``wal`` field) so multiple
        journals per process stay distinguishable.
    snapshot_every:
        Appends between snapshots (each snapshot truncates the WAL).
    """

    def __init__(self, dir: str, *, name: str = "ingest", snapshot_every: int = 64,
                 tracer=None, metrics=None):
        if snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, got {snapshot_every}")
        self.dir = str(dir)
        self.name = str(name)
        self.snapshot_every = int(snapshot_every)
        self.tracer = tracer
        os.makedirs(self.dir, exist_ok=True)
        self._wal_path = os.path.join(self.dir, _WAL_NAME)
        self._snap_path = os.path.join(self.dir, _SNAP_NAME)
        self._lock = threading.Lock()
        self._f = None
        self._seq = 0
        self._digest = ""
        self._since_snapshot = 0
        self.last_recover: dict | None = None
        self._m_appends = self._m_snapshots = self._m_recovered = None
        if metrics is not None:
            self._m_appends = metrics.counter(
                "hdbscan_tpu_wal_appends_total",
                "Records appended (and fsync'd) to the stream WAL.",
            )
            self._m_snapshots = metrics.counter(
                "hdbscan_tpu_wal_snapshots_total",
                "Stream state snapshots written (each truncates the WAL).",
            )
            self._m_recovered = metrics.counter(
                "hdbscan_tpu_wal_recovered_records_total",
                "WAL records replayed during crash recovery.",
            )

    # -- low-level append --------------------------------------------------

    def _open_wal(self, mode: str) -> None:
        # caller holds the lock
        if self._f is not None:
            self._f.close()
        self._f = open(self._wal_path, mode, encoding="utf-8")

    def _append_locked(self, kind: str, rows: int, fields: dict) -> int:
        # caller holds the lock; returns the record's seq
        if self._f is None:
            self._open_wal("a")
        seq = self._seq
        rec = {"seq": seq, "kind": kind}
        rec.update(fields)
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        self._seq = seq + 1
        self._since_snapshot += 1
        if self._m_appends is not None:
            self._m_appends.inc()
        if self.tracer is not None:
            # ``wal_seq`` not ``seq``: the JSONL sink's envelope already
            # carries a per-process ``seq`` that event fields must not shadow.
            self.tracer("wal_append", wal=self.name, wal_seq=seq, kind=kind,
                        rows=int(rows))
        return seq

    def append_ingest(self, points, labels, probabilities, scores) -> int:
        """Log one accepted ingest batch; durable (fsync'd) on return."""
        X = np.asarray(points, np.float64)
        if X.ndim == 1:
            X = X[None, :]
        fields = {
            "points": X.tolist(),
            "labels": np.asarray(labels, np.int64).reshape(-1).tolist(),
            "prob": np.asarray(probabilities, np.float64).reshape(-1).tolist(),
            "scores": np.asarray(scores, np.float64).reshape(-1).tolist(),
            "rows": int(len(X)),
        }
        with self._lock:
            return self._append_locked("ingest", len(X), fields)

    # -- snapshot ----------------------------------------------------------

    def maybe_snapshot(self, buffer, drift, maintain: dict | None = None) -> bool:
        """Snapshot buffer+drift state if ``snapshot_every`` appends have
        accumulated; truncates the WAL on success. The caller must hold the
        same lock that orders its ``absorb``/``update`` calls (the server's
        ingest lock) so the state captured matches the WAL watermark.
        ``maintain``: optional incremental-maintenance watermark dict
        (see module docstring) captured under the same lock."""
        with self._lock:
            if self._since_snapshot < self.snapshot_every:
                return False
            self._snapshot_locked(buffer, drift, maintain)
            return True

    def snapshot(self, buffer, drift, maintain: dict | None = None) -> None:
        """Unconditional snapshot + WAL truncation (same caller contract)."""
        with self._lock:
            self._snapshot_locked(buffer, drift, maintain)

    def _snapshot_locked(self, buffer, drift, maintain: dict | None = None) -> None:
        payload = {
            "schema": SNAPSHOT_SCHEMA,
            "digest": self._digest,
            "watermark": self._seq,
            "buffer": buffer.state_dict(),
            "drift": drift.state_dict() if drift is not None else None,
            "maintain": maintain,
        }
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(payload, f, separators=(",", ":"))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._snap_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        # Records below the watermark are folded into the snapshot: truncate.
        self._open_wal("w")
        self._f.flush()
        os.fsync(self._f.fileno())
        _fsync_dir(self.dir)
        self._since_snapshot = 0
        if self._m_snapshots is not None:
            self._m_snapshots.inc()

    # -- recovery ----------------------------------------------------------

    def _read_wal_records(self) -> tuple[list[dict], bool]:
        """Parse ``wal.jsonl``; a torn *final* line (the one write a crash
        can leave half-flushed) is dropped and reported, anything else
        malformed raises."""
        if not os.path.exists(self._wal_path):
            return [], False
        with open(self._wal_path, "r", encoding="utf-8") as f:
            lines = f.read().split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        records: list[dict] = []
        torn = False
        for i, line in enumerate(lines):
            try:
                records.append(json.loads(line))
            except ValueError:
                if i == len(lines) - 1:
                    torn = True
                    break
                raise ValueError(
                    f"corrupt WAL record at {self._wal_path}:{i + 1}"
                ) from None
        return records, torn

    def open(self, digest: str, buffer, drift) -> dict:
        """Attach to the journal directory for a model with data ``digest``.

        If the on-disk journal belongs to the same digest, restore the
        snapshot and replay the WAL tail into ``buffer``/``drift``; else
        start fresh. Returns a recovery summary (also kept as
        ``last_recover`` for /healthz) and emits one ``wal_recover`` trace
        event.
        """
        t0 = time.perf_counter()
        digest = str(digest or "")
        with self._lock:
            snap = None
            if os.path.exists(self._snap_path):
                with open(self._snap_path, "r", encoding="utf-8") as f:
                    snap = json.load(f)
                if snap.get("schema") != SNAPSHOT_SCHEMA:
                    raise ValueError(
                        f"unknown snapshot schema {snap.get('schema')!r} "
                        f"at {self._snap_path}"
                    )
            records, torn = self._read_wal_records()

            stale = False
            if snap is not None and snap.get("digest") != digest:
                stale = True
            if snap is None and records:
                first = records[0]
                if first.get("kind") != "begin" or first.get("digest") != digest:
                    stale = True

            if stale:
                snap, records, torn = None, [], False
                self._wipe_locked()

            replayed = rows = 0
            snapshot_used = snap is not None
            if snap is not None:
                buffer.load_state(snap["buffer"])
                if drift is not None and snap.get("drift") is not None:
                    drift.load_state(snap["drift"])
                expected = int(snap["watermark"])
            else:
                expected = 0

            for rec in records:
                seq = int(rec.get("seq", -1))
                if seq != expected:
                    raise ValueError(
                        f"WAL seq gap in {self._wal_path}: "
                        f"expected {expected}, got {seq}"
                    )
                expected = seq + 1
                if rec.get("kind") == "ingest":
                    X = np.asarray(rec["points"], np.float64)
                    labels = np.asarray(rec["labels"], np.int64)
                    prob = np.asarray(rec["prob"], np.float64)
                    scores = np.asarray(rec["scores"], np.float64)
                    buffer.absorb(X, labels, prob)
                    if drift is not None:
                        drift.update(labels, scores)
                    replayed += 1
                    rows += len(X)

            self._digest = digest
            self._seq = expected
            self._since_snapshot = len(records)
            self._open_wal("a")
            fresh = snap is None and not records
            if fresh:
                self._append_locked("begin", 0, {"digest": digest})

        wall_s = time.perf_counter() - t0
        info = {
            "records": int(replayed),
            "rows": int(rows),
            "snapshot": bool(snapshot_used),
            "stale_discarded": bool(stale),
            "torn_tail_dropped": bool(torn),
            "wall_s": round(wall_s, 6),
            # Incremental-maintenance watermark (counters + digests) from
            # the restored snapshot, for the server's replay verification.
            "maintain": snap.get("maintain") if snapshot_used else None,
        }
        self.last_recover = info
        if self._m_recovered is not None and replayed:
            self._m_recovered.inc(replayed)
        if self.tracer is not None:
            self.tracer("wal_recover", wal=self.name, records=int(replayed),
                        rows=int(rows), snapshot=bool(snapshot_used))
        return info

    def _wipe_locked(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        for path in (self._wal_path, self._snap_path):
            if os.path.exists(path):
                os.unlink(path)
        _fsync_dir(self.dir)
        self._seq = 0
        self._since_snapshot = 0

    def restart(self, digest: str) -> None:
        """Re-key the journal after a blue/green swap: the old generation's
        state was consumed by the refit, so wipe and begin fresh."""
        with self._lock:
            self._wipe_locked()
            self._digest = str(digest or "")
            self._open_wal("a")
            self._append_locked("begin", 0, {"digest": self._digest})

    # -- introspection / lifecycle ----------------------------------------

    def stats(self) -> dict:
        with self._lock:
            out = {
                "dir": self.dir,
                "seq": int(self._seq),
                "since_snapshot": int(self._since_snapshot),
                "snapshot_every": self.snapshot_every,
            }
        if self.last_recover is not None:
            out["last_recover"] = self.last_recover
        return out

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

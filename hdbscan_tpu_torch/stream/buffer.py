"""IngestBuffer: absorb a point stream into bubble summaries + a novelty buffer.

A host-only copy of ``hdbscan_tpu/stream/buffer.py``.

Arriving points are first routed through the served predict path
(``serve/predict.py``), which yields per-row ``(label, probability,
outlier_score)``.  The buffer then splits rows three ways:

- **Exact duplicates** of fitted training rows (bitwise row match against a
  prebuilt hash set, the streaming twin of ``core/dedup.deduplicate``'s
  lexsort grouping) are absorbed unconditionally — they carry no new
  geometry, only weight.
- **Near-duplicates**: rows attaching to a selected cluster at a
  mutual-reachability level ``eps_q`` within a configurable fraction of the
  cluster's own density level, ``eps_q <= (1 + absorb_eps_frac) *
  eps_min[label]``.  Because the predict path reports ``probability =
  min(1, eps_min[label] / eps_q)`` (serve/predict.py ``_attach``), this is
  exactly ``probability >= 1 / (1 + absorb_eps_frac)`` for ``label > 0`` —
  no second distance pass needed.
- Everything else (noise attachments and low-probability fringe rows) is
  **novel** and buffered verbatim for the next re-fit.

Absorbed rows update per-cluster **bubble summaries** — the
``(count, linear_sum, squared_sum)`` CF triple of MR-HDBSCAN* data bubbles
(``core/bubbles.py`` conventions) — so absorbed mass is auditable without
retaining raw rows.  A bounded uniform **reservoir** of raw ingested rows
(Vitter's algorithm R over the full stream) plus the novelty buffer forms
the re-fit pool; the fitted training rows themselves stay available from the
model artifact.

Thread safety: all mutating entry points take an internal lock, so a server
handler pool can feed one buffer concurrently.
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["BubbleSummary", "IngestBuffer"]


class BubbleSummary:
    """CF triple for one cluster's absorbed mass: count / linear sum /
    squared sum (componentwise), mirroring ``core/bubbles.py``'s
    ``(n, LS, SS)`` statistics."""

    __slots__ = ("count", "linear_sum", "squared_sum")

    def __init__(self, dims: int):
        self.count = 0
        self.linear_sum = np.zeros(dims, np.float64)
        self.squared_sum = np.zeros(dims, np.float64)

    def add(self, rows: np.ndarray) -> None:
        self.count += len(rows)
        self.linear_sum += rows.sum(axis=0)
        self.squared_sum += np.square(rows).sum(axis=0)

    @property
    def centroid(self) -> np.ndarray:
        if self.count == 0:
            return np.full_like(self.linear_sum, np.nan)
        return self.linear_sum / self.count

    @property
    def radius(self) -> float:
        """RMS distance to the centroid (the bubble ``extent`` definition of
        core/bubbles.py), 0 for singleton/empty bubbles."""
        if self.count == 0:
            return 0.0
        c = self.centroid
        var = self.squared_sum / self.count - np.square(c)
        return float(np.sqrt(max(0.0, float(var.sum()))))

    def as_dict(self) -> dict:
        return {
            "count": int(self.count),
            "linear_sum": self.linear_sum.tolist(),
            "squared_sum": self.squared_sum.tolist(),
        }

    @classmethod
    def from_dict(cls, state: dict) -> "BubbleSummary":
        bub = cls(len(state["linear_sum"]))
        bub.count = int(state["count"])
        bub.linear_sum = np.asarray(state["linear_sum"], np.float64)
        bub.squared_sum = np.asarray(state["squared_sum"], np.float64)
        return bub


class IngestBuffer:
    """Splits an ingested stream into absorbed bubble mass vs novel rows.

    Parameters
    ----------
    model:
        The served :class:`~hdbscan_tpu_torch.serve.artifact.ClusterModel`; used
        for the exact-duplicate row set and dimensionality.
    absorb_eps_frac:
        Near-duplicate slack — absorb rows whose attachment
        mutual-reachability level is within ``(1 + frac)`` of the target
        cluster's ``eps_min``.  ``0.0`` absorbs only rows at or inside the
        cluster's own density level (probability 1.0) plus exact duplicates.
    reservoir_size:
        Capacity of the uniform reservoir of raw ingested rows kept for
        re-fits (0 disables it).
    seed:
        Reservoir RNG seed.
    metrics:
        Optional ``utils/metrics.MetricsRegistry``; :meth:`absorb` counts
        ingested and absorbed rows into the ``hdbscan_tpu_ingest_*``
        counters the ``GET /metrics`` absorb-ratio panels are built from
        (counters survive :meth:`reset`, unlike the per-model stats).
    """

    def __init__(
        self,
        model,
        absorb_eps_frac: float = 0.25,
        reservoir_size: int = 4096,
        seed: int = 0,
        metrics=None,
    ):
        if absorb_eps_frac < 0:
            raise ValueError(
                f"absorb_eps_frac must be >= 0, got {absorb_eps_frac!r}"
            )
        self._m_rows = self._m_absorbed = None
        if metrics is not None:
            self._m_rows = metrics.counter(
                "hdbscan_tpu_ingest_rows_total",
                "Rows routed through the ingest buffer.",
            )
            self._m_absorbed = metrics.counter(
                "hdbscan_tpu_ingest_absorbed_rows_total",
                "Ingested rows absorbed as bubble mass (exact + near).",
            )
        self._lock = threading.Lock()
        self.absorb_eps_frac = float(absorb_eps_frac)
        self.reservoir_size = int(reservoir_size)
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        self.reset(model)

    # -- lifecycle ---------------------------------------------------------

    def reset(self, model) -> None:
        """Re-key the buffer to a (new) model: rebuild the training-row hash
        set, clear bubbles/novel rows, and restart the reservoir.  Called at
        construction and after every blue/green swap."""
        with self._lock:
            self.model = model
            data = np.ascontiguousarray(np.asarray(model.data, np.float64))
            self._dims = data.shape[1]
            self._train_keys = {row.tobytes() for row in data}
            self.bubbles: dict[int, BubbleSummary] = {}
            self._novel: list[np.ndarray] = []
            self._novel_rows = 0
            self._reservoir: list[np.ndarray] = []
            self._stream_index = 0
            self.rows_seen = 0
            self.absorbed_exact = 0
            self.absorbed_near = 0

    # -- ingest ------------------------------------------------------------

    def absorb(
        self,
        points: np.ndarray,
        labels: np.ndarray,
        probabilities: np.ndarray,
    ) -> tuple[int, int]:
        """Route one predicted batch; returns ``(absorbed, buffered)`` row
        counts (summing to ``len(points)``)."""
        X = np.ascontiguousarray(np.asarray(points, np.float64))
        if X.ndim == 1:
            X = X[None, :]
        if X.shape[1] != self._dims:
            raise ValueError(f"ingest dims {X.shape[1]} != model dims {self._dims}")
        labels = np.asarray(labels, np.int64).reshape(-1)
        prob = np.asarray(probabilities, np.float64).reshape(-1)
        if not (len(labels) == len(prob) == len(X)):
            raise ValueError("points/labels/probabilities length mismatch")

        exact = np.fromiter(
            (row.tobytes() in self._train_keys for row in X),
            dtype=bool,
            count=len(X),
        )
        # prob >= 1/(1+frac)  <=>  eps_q <= (1+frac) * eps_min[label]
        near = (labels > 0) & (prob >= 1.0 / (1.0 + self.absorb_eps_frac))
        absorbed = exact | near

        with self._lock:
            self.rows_seen += len(X)
            self.absorbed_exact += int(np.count_nonzero(exact))
            self.absorbed_near += int(np.count_nonzero(near & ~exact))
            for lab in np.unique(labels[absorbed]):
                mask = absorbed & (labels == lab)
                bub = self.bubbles.get(int(lab))
                if bub is None:
                    bub = self.bubbles[int(lab)] = BubbleSummary(self._dims)
                bub.add(X[mask])
            novel = X[~absorbed]
            if len(novel):
                self._novel.append(novel.copy())
                self._novel_rows += len(novel)
            self._reservoir_add(X)
        n_absorbed = int(np.count_nonzero(absorbed))
        if self._m_rows is not None:
            self._m_rows.inc(len(X))
            if n_absorbed:
                self._m_absorbed.inc(n_absorbed)
        return n_absorbed, int(len(novel))

    def _reservoir_add(self, X: np.ndarray) -> None:
        """Vitter algorithm R over every ingested row (caller holds lock)."""
        if self.reservoir_size <= 0:
            return
        for row in X:
            i = self._stream_index
            self._stream_index += 1
            if len(self._reservoir) < self.reservoir_size:
                self._reservoir.append(row.copy())
            else:
                j = int(self._rng.integers(0, i + 1))
                if j < self.reservoir_size:
                    self._reservoir[j] = row.copy()

    # -- refit pool --------------------------------------------------------

    @property
    def buffered_rows(self) -> int:
        return self._novel_rows

    def novel_chunks(self) -> list:
        """The buffered novel rows as the ordered list of per-batch chunks.

        This list only ever GROWS between :meth:`reset` calls (chunks are
        never drained or reordered), which is what makes it a replayable
        event log: the incremental maintainer (``hdbscan_tpu/incremental``)
        treats maintenance as a deterministic fold over exactly this
        sequence, so WAL recovery re-inserting these chunks in order
        reproduces the maintained MST bitwise. Returns copies.
        """
        with self._lock:
            return [chunk.copy() for chunk in self._novel]

    @property
    def novel_chunk_count(self) -> int:
        """Number of buffered novel chunks (one per :meth:`absorb` call that
        produced novel rows). Comparing this across an ``absorb`` call is how
        the server's maintenance fold picks up exactly the rows that call
        buffered, without copying the whole log (:meth:`novel_chunks`)."""
        with self._lock:
            return len(self._novel)

    def novel_chunk(self, index: int) -> np.ndarray:
        """Copy of one novel chunk by position (see :attr:`novel_chunk_count`)."""
        with self._lock:
            return self._novel[index].copy()

    @property
    def absorbed_total(self) -> int:
        return self.absorbed_exact + self.absorbed_near

    def refit_points(self, originals: int = 0, seed: int = 0) -> np.ndarray:
        """Assemble the re-fit pool: novel rows + the stream reservoir +
        (optionally) a uniform sample of ``originals`` fitted training rows,
        deduplicated bitwise so absorbed weight isn't double counted."""
        with self._lock:
            parts = list(self._novel)
            if self._reservoir:
                parts.append(np.stack(self._reservoir))
            if originals > 0:
                data = np.asarray(self.model.data, np.float64)
                k = min(originals, len(data))
                rng = np.random.default_rng(seed)
                idx = rng.choice(len(data), size=k, replace=False)
                parts.append(data[np.sort(idx)])
            if not parts:
                return np.empty((0, self._dims), np.float64)
            pool = np.ascontiguousarray(np.concatenate(parts))
        _, first = np.unique(
            pool.view([("", pool.dtype)] * pool.shape[1]), return_index=True
        )
        return pool[np.sort(first)]

    # -- durability --------------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-able snapshot of the full mutable state (stream/wal.py).

        Floats round-trip bitwise through ``json`` (Python uses shortest
        round-trip repr), and the reservoir RNG state is captured, so
        ``load_state`` followed by the same future ``absorb`` calls is
        indistinguishable from never having crashed.
        """
        with self._lock:
            return {
                "rows_seen": int(self.rows_seen),
                "absorbed_exact": int(self.absorbed_exact),
                "absorbed_near": int(self.absorbed_near),
                "stream_index": int(self._stream_index),
                "rng_state": self._rng.bit_generator.state,
                "bubbles": {
                    str(lab): b.as_dict() for lab, b in sorted(self.bubbles.items())
                },
                "novel": [chunk.tolist() for chunk in self._novel],
                "reservoir": [row.tolist() for row in self._reservoir],
            }

    def load_state(self, state: dict) -> None:
        """Restore a :meth:`state_dict` snapshot (call :meth:`reset` with the
        matching model first; the training-row hash set is rebuilt there)."""
        with self._lock:
            self.rows_seen = int(state["rows_seen"])
            self.absorbed_exact = int(state["absorbed_exact"])
            self.absorbed_near = int(state["absorbed_near"])
            self._stream_index = int(state["stream_index"])
            self._rng.bit_generator.state = state["rng_state"]
            self.bubbles = {
                int(lab): BubbleSummary.from_dict(b)
                for lab, b in state["bubbles"].items()
            }
            self._novel = [
                np.ascontiguousarray(np.asarray(chunk, np.float64))
                for chunk in state["novel"]
            ]
            self._novel_rows = sum(len(chunk) for chunk in self._novel)
            self._reservoir = [
                np.asarray(row, np.float64) for row in state["reservoir"]
            ]

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "rows_seen": self.rows_seen,
                "absorbed_exact": self.absorbed_exact,
                "absorbed_near": self.absorbed_near,
                "buffered": self._novel_rows,
                "reservoir": len(self._reservoir),
                "bubbles": {
                    str(lab): b.as_dict() for lab, b in sorted(self.bubbles.items())
                },
            }

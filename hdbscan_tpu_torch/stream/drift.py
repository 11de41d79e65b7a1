"""DriftDetector: GLOSH-score + assignment-rate shift vs the fit-time baseline.

A host-only copy of ``hdbscan_tpu/stream/drift.py``.

The detector keeps two streaming sketches of the served workload:

- a fixed-bin histogram of GLOSH outlier scores (scores live in ``[0, 1]``
  by construction — serve/predict.py clips them — so 20 uniform bins cover
  the domain with no quantile estimation), and
- per-cluster assignment counts over the predict label space
  (``0`` = noise plus the model's selected cluster ids).

Both are compared against the fit-time baseline with a two-sample
statistic chosen by ``stat``:

- ``psi`` — Population Stability Index,
  ``sum((q_i - p_i) * ln(q_i / p_i))`` over smoothed bin proportions.  Note
  the textbook PSI scale (> 0.2 = shifted) does NOT transfer here: the
  baseline is the *training rows'* scores, and fresh in-distribution draws
  score systematically higher than the rows the model was fit on, reading
  ~0.3-0.5 PSI at steady state, while genuine distribution shift reads an
  order of magnitude above.  The default threshold (2.0,
  ``config.stream_drift_threshold``) separates those two regimes.
- ``ks`` — Kolmogorov–Smirnov distance, ``max_i |CDF_q(i) - CDF_p(i)|``
  over the same bins (assignment rates, being categorical, always use the
  PSI form).

The fit-time baseline comes for free from the artifact round-trip
guarantee: training rows re-predicted through the served path reproduce
their fitted labels/GLOSH scores bitwise, so a seeded sample of
``model.data`` pushed through the predictor *is* the baseline — no extra
fields in the artifact schema.

``check()`` emits a ``drift_check`` trace event (validated by
scripts/check_trace.py) and reports ``drifted`` only once at least
``min_rows`` stream rows have been scored, so cold-start noise can't
trigger a re-fit.
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["DriftDetector"]

DRIFT_STATS = ("psi", "ks")
_SMOOTH = 1e-4


def _proportions(counts: np.ndarray) -> np.ndarray:
    counts = np.asarray(counts, np.float64) + _SMOOTH
    return counts / counts.sum()


def _psi(p: np.ndarray, q: np.ndarray) -> float:
    p, q = _proportions(p), _proportions(q)
    return float(np.sum((q - p) * np.log(q / p)))


def _ks(p: np.ndarray, q: np.ndarray) -> float:
    p, q = _proportions(p), _proportions(q)
    return float(np.max(np.abs(np.cumsum(q) - np.cumsum(p))))


class DriftDetector:
    """Streaming GLOSH/assignment drift vs a fit-time baseline.

    Parameters
    ----------
    baseline_scores / baseline_labels:
        Fit-time GLOSH scores and predict-space labels (0 = noise,
        otherwise selected cluster ids) — typically a seeded sample of the
        training rows round-tripped through the served predictor (see
        :meth:`baseline_from_model`).
    stat:
        ``"psi"`` or ``"ks"`` for the score histogram.
    threshold:
        Drift flag level for the chosen statistic (and for the
        assignment-rate PSI).
    bins:
        Histogram resolution over the score domain ``[0, 1]``.
    min_rows:
        Minimum scored stream rows before ``drifted`` can be reported.
    """

    def __init__(
        self,
        baseline_scores,
        baseline_labels,
        stat: str = "psi",
        threshold: float = 2.0,
        bins: int = 20,
        min_rows: int = 256,
        tracer=None,
    ):
        if stat not in DRIFT_STATS:
            raise ValueError(
                f"stat must be one of {', '.join(map(repr, DRIFT_STATS))}, "
                f"got {stat!r}"
            )
        if not threshold > 0:
            raise ValueError(f"threshold must be > 0, got {threshold!r}")
        self.stat = stat
        self.threshold = float(threshold)
        self.bins = int(bins)
        self.min_rows = int(min_rows)
        self.tracer = tracer
        self._lock = threading.Lock()
        self._edges = np.linspace(0.0, 1.0, self.bins + 1)
        self.rebaseline(baseline_scores, baseline_labels)

    @staticmethod
    def baseline_from_model(
        model, predictor, sample: int = 2048, seed: int = 0
    ) -> tuple[np.ndarray, np.ndarray]:
        """Seeded training-row sample round-tripped through the served
        predictor; returns ``(scores, labels)`` for the constructor."""
        data = np.asarray(model.data, np.float64)
        k = min(int(sample), len(data))
        idx = np.sort(np.random.default_rng(seed).choice(len(data), k, False))
        labels, _, scores = predictor.predict(data[idx])
        return scores, labels

    # -- lifecycle ---------------------------------------------------------

    def rebaseline(self, baseline_scores, baseline_labels) -> None:
        """Install a new baseline and clear the stream sketches (called at
        construction and after every model swap)."""
        scores = np.clip(np.asarray(baseline_scores, np.float64).reshape(-1), 0, 1)
        labels = np.asarray(baseline_labels, np.int64).reshape(-1)
        with self._lock:
            self._label_ids = np.unique(np.concatenate(([0], np.unique(labels))))
            self._base_scores = np.histogram(scores, self._edges)[0]
            self._base_assign = self._label_counts(labels)
            self._cur_scores = np.zeros(self.bins, np.int64)
            self._cur_assign = np.zeros_like(self._base_assign)
            self.rows = 0
            self.checks = 0

    def _label_counts(self, labels: np.ndarray) -> np.ndarray:
        """Counts over the baseline label vocabulary plus one trailing
        overflow bin for labels outside it (novel structure is exactly what
        drift looks like, so it must count against the baseline)."""
        idx = np.searchsorted(self._label_ids, labels)
        idx = np.clip(idx, 0, len(self._label_ids) - 1)
        known = self._label_ids[idx] == labels
        counts = np.bincount(idx[known], minlength=len(self._label_ids))
        return np.append(counts, np.count_nonzero(~known)).astype(np.int64)

    # -- durability --------------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-able snapshot of baseline + stream sketches (stream/wal.py)."""
        with self._lock:
            return {
                "label_ids": self._label_ids.tolist(),
                "base_scores": self._base_scores.tolist(),
                "base_assign": self._base_assign.tolist(),
                "cur_scores": self._cur_scores.tolist(),
                "cur_assign": self._cur_assign.tolist(),
                "rows": int(self.rows),
                "checks": int(self.checks),
            }

    def load_state(self, state: dict) -> None:
        """Restore a :meth:`state_dict` snapshot (overrides the baseline
        installed at construction with the snapshot-time one)."""
        with self._lock:
            self._label_ids = np.asarray(state["label_ids"], np.int64)
            self._base_scores = np.asarray(state["base_scores"], np.int64)
            self._base_assign = np.asarray(state["base_assign"], np.int64)
            self._cur_scores = np.asarray(state["cur_scores"], np.int64)
            self._cur_assign = np.asarray(state["cur_assign"], np.int64)
            self.rows = int(state["rows"])
            self.checks = int(state["checks"])

    # -- streaming ---------------------------------------------------------

    def update(self, labels, scores) -> None:
        """Fold one predicted batch into the stream sketches."""
        scores = np.clip(np.asarray(scores, np.float64).reshape(-1), 0, 1)
        labels = np.asarray(labels, np.int64).reshape(-1)
        with self._lock:
            self._cur_scores += np.histogram(scores, self._edges)[0]
            self._cur_assign += self._label_counts(labels)
            self.rows += len(scores)

    def check(self, generation: int = 0) -> dict:
        """Compute the drift statistics, emit a ``drift_check`` trace event,
        and return ``{stat, value, assign_psi, threshold, rows, drifted}``."""
        fn = _psi if self.stat == "psi" else _ks
        with self._lock:
            value = fn(self._base_scores, self._cur_scores)
            assign_psi = _psi(self._base_assign, self._cur_assign)
            rows = self.rows
            self.checks += 1
        drifted = rows >= self.min_rows and (
            value >= self.threshold or assign_psi >= self.threshold
        )
        out = {
            "stat": self.stat,
            "value": round(value, 6),
            "assign_psi": round(assign_psi, 6),
            "threshold": self.threshold,
            "rows": int(rows),
            "drifted": bool(drifted),
        }
        if self.tracer is not None:
            self.tracer("drift_check", generation=int(generation), **out)
        return out

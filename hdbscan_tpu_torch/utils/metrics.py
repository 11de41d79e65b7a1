"""Stdlib-only metrics registry for the serving stack — a host-only copy of
``hdbscan_tpu/utils/metrics.py``.

The serving path (``serve/server.py``) needs Prometheus-style
instrumentation — request totals by route and status, an in-flight gauge,
latency and batch-size histograms, swap counters — without adding a
dependency, so this module uses only the standard library, and its
exposition is the reference's line for line.

Three instrument kinds, all safe to mutate from many threads at once
(HTTP handler threads and the micro-batcher worker):

* :class:`Counter` — monotonically increasing float per label combination.
* :class:`Gauge` — settable float (in-flight requests, model generation).
* :class:`Histogram` — fixed log-spaced buckets with cumulative counts, a
  running sum, and the max observed value.

:meth:`MetricsRegistry.render` emits the Prometheus text exposition format
(version 0.0.4) served by ``GET /metrics``; ``scripts/check_metrics.py``
validates the output with nothing but the stdlib on the other side.
"""

from __future__ import annotations

import re
import threading

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def log_buckets(start: float, factor: float, count: int) -> tuple:
    """Geometric bucket upper edges: ``start * factor**i`` for i in [0, count)."""
    if start <= 0 or factor <= 1.0 or count < 1:
        raise ValueError(
            f"log_buckets needs start > 0, factor > 1, count >= 1; got "
            f"{start!r}, {factor!r}, {count!r}"
        )
    edges, v = [], float(start)
    for _ in range(count):
        edges.append(v)
        v *= factor
    return tuple(edges)


#: 100 us .. ~105 s in doublings — covers a single-row CPU predict up to a
#: pathological sustained-load stall; 21 buckets keep the exposition small.
DEFAULT_LATENCY_BUCKETS = log_buckets(1e-4, 2.0, 21)

#: 1 .. 4096 rows in doublings — matches the predictor's pow2 bucket ladder.
DEFAULT_SIZE_BUCKETS = log_buckets(1.0, 2.0, 13)


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_value(v: float) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Metric:
    """Shared label plumbing. Children are keyed by the tuple of label
    values in declared label-name order; the registry-wide lock serializes
    every mutation and the render pass."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple, lock):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln == "le":
                raise ValueError(f"bad label name {ln!r} for metric {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._children: dict = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _label_str(self, key: tuple, extra: str = "") -> str:
        parts = [
            f'{ln}="{_escape_label(v)}"' for ln, v in zip(self.labelnames, key)
        ]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def samples(self) -> list:
        """``[(labels_dict, value), ...]`` snapshot (counters/gauges)."""
        with self._lock:
            return [
                (dict(zip(self.labelnames, key)), value)
                for key, value in sorted(self._children.items())
            ]


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease ({amount!r})")
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + float(amount)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._children.get(key, 0.0)

    def render(self, out: list) -> None:
        with self._lock:
            for key, v in sorted(self._children.items()):
                out.append(f"{self.name}{self._label_str(key)} {_fmt_value(v)}")


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + float(amount)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._children.get(key, 0.0)

    def render(self, out: list) -> None:
        with self._lock:
            for key, v in sorted(self._children.items()):
                out.append(f"{self.name}{self._label_str(key)} {_fmt_value(v)}")


class _HistState:
    __slots__ = ("counts", "sum")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1: the +Inf overflow bucket
        self.sum = 0.0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames, lock, buckets):
        super().__init__(name, help, labelnames, lock)
        edges = tuple(float(b) for b in buckets)
        if not edges or any(later <= prev for later, prev in zip(edges[1:], edges)):
            raise ValueError(f"histogram {name!r} buckets must strictly increase")
        self.buckets = edges

    def _state(self, labels: dict) -> _HistState:
        key = self._key(labels)
        st = self._children.get(key)
        if st is None:
            st = self._children[key] = _HistState(len(self.buckets))
        return st

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        with self._lock:
            st = self._state(labels)
            # Linear scan beats bisect for ~20 buckets and keeps this
            # allocation-free on the request path.
            for i, edge in enumerate(self.buckets):
                if v <= edge:
                    st.counts[i] += 1
                    break
            else:
                st.counts[-1] += 1
            st.sum += v

    def render(self, out: list) -> None:
        with self._lock:
            for key, st in sorted(self._children.items()):
                cum = 0
                for i, edge in enumerate(self.buckets):
                    cum += st.counts[i]
                    le = f'le="{edge!r}"'
                    out.append(
                        f"{self.name}_bucket{self._label_str(key, le)} {cum}"
                    )
                total = cum + st.counts[-1]
                inf_le = 'le="+Inf"'
                out.append(
                    f"{self.name}_bucket{self._label_str(key, inf_le)} {total}"
                )
                out.append(
                    f"{self.name}_sum{self._label_str(key)} {_fmt_value(st.sum)}"
                )
                out.append(f"{self.name}_count{self._label_str(key)} {total}")


class MetricsRegistry:
    """Instrument factory + Prometheus text renderer.

    ``counter``/``gauge``/``histogram`` are get-or-create: asking for an
    existing name returns the existing instrument (so decoupled layers can
    each grab the same counter by name), and a kind or label mismatch is an
    eager ``ValueError``.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict = {}  # name -> instrument, insertion-ordered

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}{m.labelnames}"
                    )
                return m
            m = cls(name, help, tuple(labelnames), self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames=(), buckets=None
    ) -> Histogram:
        return self._get_or_create(
            Histogram,
            name,
            help,
            labelnames,
            buckets=tuple(buckets) if buckets else DEFAULT_LATENCY_BUCKETS,
        )

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4), trailing newline."""
        out: list = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            m.render(out)
        return "\n".join(out) + "\n"

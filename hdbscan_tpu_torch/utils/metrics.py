"""Stdlib-only metrics registry for the serving stack — a host-only copy of
``hdbscan_tpu/utils/metrics.py``.

The serving path (``serve/server.py``) needs Prometheus-style
instrumentation — request totals by route and status, an in-flight gauge,
latency and batch-size histograms, swap/refit/drift counters — without
adding a dependency, so this module uses only the standard library, and
its exposition is the reference's line for line.

Three instrument kinds, all safe to mutate from many threads at once
(HTTP handler threads, the micro-batcher worker, the background refitter):

* :class:`Counter` — monotonically increasing float per label combination.
* :class:`Gauge` — settable float (in-flight requests, model generation).
* :class:`Histogram` — fixed log-spaced buckets with cumulative counts, a
  running sum, and the max observed value; state is mergeable across
  instances (multi-replica aggregation) and supports nearest-rank
  quantile estimates straight from the bucket counts.

:meth:`MetricsRegistry.render` emits the Prometheus text exposition format
(version 0.0.4) served by ``GET /metrics``; ``scripts/check_metrics.py``
validates the output with nothing but the stdlib on the other side. The
fleet router (``fleet/router.py``) folds its replicas' scrapes back into
one registry through :func:`registry_from_exposition` and
:meth:`MetricsRegistry.merge`.
"""

from __future__ import annotations

import math
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

    def merge(self, other: "Counter") -> None:
        """Fold another counter's children into this one (label-wise sum).

        Two-phase: snapshot ``other`` under its lock, then fold under ours —
        the locks never nest, so merging from a live registry while it is
        being scraped (or merged elsewhere) cannot deadlock.
        """
        if other.labelnames != self.labelnames:
            raise ValueError(f"cannot merge {other.name!r} into {self.name!r}")
        with other._lock:
            items = list(other._children.items())
        with self._lock:
            for key, v in items:
                self._children[key] = self._children.get(key, 0.0) + v

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

    def merge(self, other: "Gauge") -> None:
        """Fold another gauge's children into this one (label-wise SUM —
        fleet aggregation semantics: in-flight counts and up/down flags add
        across replicas; per-replica series stay distinct because the
        aggregator tags each source with a ``replica`` label first)."""
        if other.labelnames != self.labelnames:
            raise ValueError(f"cannot merge {other.name!r} into {self.name!r}")
        with other._lock:
            items = list(other._children.items())
        with self._lock:
            for key, v in items:
                self._children[key] = self._children.get(key, 0.0) + v

    def render(self, out: list) -> None:
        with self._lock:
            for key, v in sorted(self._children.items()):
                out.append(f"{self.name}{self._label_str(key)} {_fmt_value(v)}")


class _HistState:
    __slots__ = ("counts", "sum", "vmax")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1: the +Inf overflow bucket
        self.sum = 0.0
        self.vmax = -math.inf


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
            if v > st.vmax:
                st.vmax = v

    def count(self, **labels) -> int:
        with self._lock:
            st = self._children.get(self._key(labels))
            return sum(st.counts) if st else 0

    def total(self, **labels) -> float:
        with self._lock:
            st = self._children.get(self._key(labels))
            return st.sum if st else 0.0

    def quantile(self, q: float, **labels):
        """Nearest-rank quantile from bucket state.

        Returns the upper edge of the bucket holding the rank-``ceil(q*n)``
        observation, or the max observed value when that rank lands in the
        +Inf overflow bucket — so the estimate is always within one bucket
        width of the raw-sample nearest-rank quantile. None when empty.
        """
        if not 0.0 < q <= 1.0:
            raise ValueError(f"quantile q must be in (0, 1], got {q!r}")
        with self._lock:
            st = self._children.get(self._key(labels))
            if st is None:
                return None
            n = sum(st.counts)
            if n == 0:
                return None
            rank = max(1, math.ceil(q * n))
            cum = 0
            for i, edge in enumerate(self.buckets):
                cum += st.counts[i]
                if cum >= rank:
                    return edge
            return st.vmax

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram's state into this one (same bucket edges).
        Snapshot-then-fold, like :meth:`Counter.merge`."""
        if other.labelnames != self.labelnames or other.buckets != self.buckets:
            raise ValueError(f"cannot merge {other.name!r} into {self.name!r}")
        with other._lock:
            items = [
                (key, list(ost.counts), ost.sum, ost.vmax)
                for key, ost in other._children.items()
            ]
        with self._lock:
            for key, counts, osum, ovmax in items:
                st = self._children.get(key)
                if st is None:
                    st = self._children[key] = _HistState(len(self.buckets))
                for i, c in enumerate(counts):
                    st.counts[i] += c
                st.sum += osum
                if ovmax > st.vmax:
                    st.vmax = ovmax

    def _load_state(self, labels: dict, counts, total: float, vmax: float) -> None:
        """Restore per-bucket state parsed back from an exposition scrape
        (:func:`registry_from_exposition`). Additive, like :meth:`merge`."""
        if len(counts) != len(self.buckets) + 1:
            raise ValueError(
                f"histogram {self.name!r} expects {len(self.buckets) + 1} "
                f"bucket counts, got {len(counts)}"
            )
        with self._lock:
            st = self._state(labels)
            for i, c in enumerate(counts):
                st.counts[i] += c
            st.sum += float(total)
            if vmax > st.vmax:
                st.vmax = vmax

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
    existing name returns the existing instrument (so decoupled layers —
    the ingest buffer, the refitter — can each grab the same counter by
    name), and a kind or label mismatch is an eager ``ValueError``.
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

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another registry's state into this one, instrument-wise.

        The fleet-aggregation hook: the router parses each replica's
        ``/metrics`` scrape back into a registry
        (:func:`registry_from_exposition`, which tags every series with a
        ``replica`` label) and folds them all into one. Instruments missing
        here are created with the other's name/help/labels/buckets; existing
        ones merge by kind — counters and gauges sum label-wise, histograms
        fold bucket counts + sum + vmax exactly. A kind/label/bucket
        mismatch raises, same as :meth:`_get_or_create`.
        """
        with other._lock:
            theirs = list(other._metrics.values())
        for om in theirs:
            if isinstance(om, Histogram):
                mine = self.histogram(
                    om.name, om.help, om.labelnames, buckets=om.buckets
                )
            elif isinstance(om, Counter):
                mine = self.counter(om.name, om.help, om.labelnames)
            elif isinstance(om, Gauge):
                mine = self.gauge(om.name, om.help, om.labelnames)
            else:  # pragma: no cover - only three kinds exist
                raise ValueError(f"unknown instrument kind for {om.name!r}")
            mine.merge(om)

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


# -- cross-process aggregation ------------------------------------------------
#
# Fleet replicas are separate OS processes: the router holds their /metrics
# TEXT, not their registries. registry_from_exposition() inverts render() so
# the text folds back through the same merge() machinery the in-process path
# uses — scrape each replica, re-parse with a replica label, merge, re-render.

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$"
)
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESCAPES = {"\\\\": "\\", '\\"': '"', "\\n": "\n"}


def _unescape_label(value: str) -> str:
    return re.sub(
        r'\\[\\"n]', lambda m: _UNESCAPES[m.group(0)], value
    )


def _parse_labels(body: str) -> dict:
    return {
        k: _unescape_label(v) for k, v in _LABEL_PAIR_RE.findall(body or "")
    }


def registry_from_exposition(
    text: str, static_labels: dict | None = None
) -> MetricsRegistry:
    """Parse Prometheus 0.0.4 exposition text back into a live registry.

    The inverse of :meth:`MetricsRegistry.render`, up to one lossy corner:
    a reconstructed histogram's max-observed value is only known to bucket
    resolution (the highest non-empty finite edge, or +Inf when the
    overflow bucket is populated), so ``quantile()`` answers that land in
    the overflow bucket degrade from exact-max to edge/+Inf.

    ``static_labels`` are prepended to every series — the fleet router
    passes ``{"replica": rid}`` so per-replica series never collide when
    the parsed registries merge into the aggregate.

    Unparseable lines raise ``ValueError`` naming the line: a replica
    emitting garbage on /metrics should fail its scrape loudly, not
    vanish into a silently-smaller aggregate.
    """
    static = {str(k): str(v) for k, v in (static_labels or {}).items()}
    kinds: dict = {}
    helps: dict = {}
    samples: list = []  # (name, labels_dict, value) in file order
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 4:
                raise ValueError(f"metrics line {lineno}: malformed TYPE {raw!r}")
            kinds[parts[2]] = parts[3]
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) >= 3:
                helps[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"metrics line {lineno}: unparseable sample {raw!r}")
        samples.append((m.group(1), _parse_labels(m.group(2)), m.group(3)))

    def family_of(name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[: -len(suffix)] if name.endswith(suffix) else None
            if base and kinds.get(base) == "histogram":
                return base
        return name

    reg = MetricsRegistry()
    # Histogram series accumulate per (family, non-le key) before creation:
    # the bucket ladder is only known once every le edge has been seen.
    hists: dict = {}  # family -> {"labelnames", key -> {"les", "sum", "count"}}
    for name, labels, value_s in samples:
        family = family_of(name)
        kind = kinds.get(family)
        if kind is None:
            raise ValueError(
                f"metrics sample {name!r} has no preceding # TYPE line"
            )
        if kind == "histogram":
            le = labels.pop("le", None)
            merged = {**static, **labels}
            fam = hists.setdefault(
                family,
                {"labelnames": tuple(merged), "series": {}},
            )
            key = tuple(merged[ln] for ln in fam["labelnames"])
            series = fam["series"].setdefault(
                key, {"les": {}, "sum": 0.0, "count": 0}
            )
            if name.endswith("_bucket"):
                if le is None:
                    raise ValueError(
                        f"histogram bucket sample for {family!r} lacks an "
                        f"le label"
                    )
                series["les"][float(le)] = float(value_s)
            elif name.endswith("_sum"):
                series["sum"] = float(value_s)
            elif name.endswith("_count"):
                series["count"] = float(value_s)
            continue
        merged = {**static, **labels}
        if kind == "counter":
            inst = reg.counter(family, helps.get(family, ""), tuple(merged))
            inst.inc(float(value_s), **merged)
        elif kind == "gauge":
            inst = reg.gauge(family, helps.get(family, ""), tuple(merged))
            inst.inc(float(value_s), **merged)
        else:
            raise ValueError(
                f"metric {family!r} has unsupported TYPE {kind!r}"
            )

    for family, fam in hists.items():
        edges = None
        for key, series in fam["series"].items():
            finite = sorted(le for le in series["les"] if math.isfinite(le))
            if edges is None:
                edges = finite
            elif finite != edges:
                raise ValueError(
                    f"histogram {family!r} has inconsistent bucket edges "
                    f"across series"
                )
        if not edges:
            raise ValueError(f"histogram {family!r} has no finite buckets")
        hist = reg.histogram(
            family, helps.get(family, ""), fam["labelnames"], buckets=edges
        )
        for key, series in fam["series"].items():
            cum = [series["les"][e] for e in edges]
            total = series["les"].get(math.inf, series["count"])
            counts = [int(c - p) for c, p in zip(cum, [0.0] + cum[:-1])]
            counts.append(int(total - cum[-1]))
            if any(c < 0 for c in counts):
                raise ValueError(
                    f"histogram {family!r} bucket counts are not cumulative"
                )
            vmax = -math.inf
            if counts[-1] > 0:
                vmax = math.inf
            else:
                for edge, c in zip(reversed(edges), reversed(counts[:-1])):
                    if c > 0:
                        vmax = edge
                        break
            labels = dict(zip(fam["labelnames"], key))
            hist._load_state(labels, counts, series["sum"], vmax)
    return reg

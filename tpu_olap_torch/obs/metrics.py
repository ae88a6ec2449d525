"""Incremental metrics registry with Prometheus text exposition.

Counters, gauges, and fixed-bucket histograms, maintained at query
completion (QueryRunner.record) instead of re-scanned from history —
replacing the O(history) recompute behind `GET /status` with O(1)
updates, and surviving history-ring eviction exactly.

Exposition follows the Prometheus text format (version 0.0.4), stdlib
string formatting only:

    # HELP tpu_olap_queries_total Queries completed.
    # TYPE tpu_olap_queries_total counter
    tpu_olap_queries_total{path="dense",query_type="groupBy"} 42

Non-finite observations are dropped at ingest so the exposition never
emits NaN/+Inf/-Inf sample values (the `le="+Inf"` bucket LABEL is part
of the histogram grammar and always present). All mutation goes through
one registry lock; updates are a few dict ops, far below query cost.
"""

from __future__ import annotations

import math
import threading

# fixed latency buckets (ms): sub-ms through minutes, pow-ish spacing so
# p50/p95/p99 are derivable by interpolation at every scale the engine
# serves. The 0.1/0.25/0.5 head exists for the warm-cache path: with
# 1.0 as the first bound every sub-millisecond full-result-cache serve
# would collapse into one bucket, making cache-path p50 and p95
# indistinguishable. The buckets are the JAX package's, so that both
# packages render the same lines for the same observations.
LATENCY_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0, 30000.0)

# admission queue-wait buckets (ms): most admitted queries wait 0 or a
# few ms; the tail matters up to roughly one deadline (past that the
# controller sheds instead of queueing — resilience.admission)
QUEUE_WAIT_BUCKETS_MS = (0.1, 0.5, 1.0, 5.0, 10.0, 25.0, 50.0, 100.0,
                         250.0, 500.0, 1000.0, 5000.0)

# breaker-state gauge encoding (resilience.breaker exports the live
# mapping; duplicated here so dashboards can reference one module)
BREAKER_STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}

_NAME_OK = "abcdefghijklmnopqrstuvwxyz" \
           "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:"


def _fmt(v: float) -> str:
    """Sample value formatting: integral floats render bare (the common
    counter case), others via repr (shortest round-trip)."""
    if isinstance(v, float) and v.is_integer() and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(float(v))


def _escape_label(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


class _Series:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class _HistSeries:
    __slots__ = ("counts", "total", "n")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative)
        self.total = 0.0
        self.n = 0


class _Metric:
    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 kind: str, labelnames: tuple):
        for ch in name:
            if ch not in _NAME_OK:
                raise ValueError(f"bad metric name {name!r}")
        self.registry = registry
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self.series: dict = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)


class Counter(_Metric):
    def inc(self, amount: float = 1.0, **labels):
        if not math.isfinite(amount) or amount < 0:
            return
        key = self._key(labels)
        with self.registry._lock:
            s = self.series.get(key)
            if s is None:
                s = self.series[key] = _Series()
            s.value += amount

    def set_total(self, value: float, **labels):
        """Mirror an externally-maintained monotonic total (e.g. the HBM
        ledger's eviction count) — still rendered as a counter."""
        if not math.isfinite(value):
            return
        key = self._key(labels)
        with self.registry._lock:
            s = self.series.get(key)
            if s is None:
                s = self.series[key] = _Series()
            s.value = max(s.value, float(value))

    def value(self, **labels) -> float:
        s = self.series.get(self._key(labels))
        return s.value if s is not None else 0.0


class Gauge(_Metric):
    def set(self, value: float, **labels):
        if not math.isfinite(value):
            return
        key = self._key(labels)
        with self.registry._lock:
            s = self.series.get(key)
            if s is None:
                s = self.series[key] = _Series()
            s.value = float(value)

    def value(self, **labels) -> float:
        s = self.series.get(self._key(labels))
        return s.value if s is not None else 0.0


class Histogram(_Metric):
    def __init__(self, registry, name, help, labelnames,
                 buckets=LATENCY_BUCKETS_MS):
        super().__init__(registry, name, help, "histogram", labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def observe(self, value: float, **labels):
        if not math.isfinite(value):
            return
        key = self._key(labels)
        with self.registry._lock:
            s = self.series.get(key)
            if s is None:
                s = self.series[key] = _HistSeries(len(self.buckets) + 1)
            i = 0
            for i, b in enumerate(self.buckets):  # noqa: B007
                if value <= b:
                    break
            else:
                i = len(self.buckets)
            s.counts[i] += 1
            s.total += float(value)
            s.n += 1

    def quantile(self, q: float, **labels) -> float | None:
        """Derive a quantile (0..1) by linear interpolation inside the
        owning bucket — how a dashboard computes p50/p95/p99 from the
        exposed cumulative buckets. None when the series is empty."""
        s = self.series.get(self._key(labels))
        if s is None or s.n == 0:
            return None
        rank = q * s.n
        seen = 0
        lo = 0.0
        for i, c in enumerate(s.counts):
            hi = self.buckets[i] if i < len(self.buckets) \
                else self.buckets[-1]
            if seen + c >= rank and c > 0:
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
            seen += c
            lo = hi
        return self.buckets[-1]


class MetricsRegistry:
    """Name -> metric, one lock, deterministic render order."""

    def __init__(self, namespace: str = "tpu_olap"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _full(self, name: str) -> str:
        return f"{self.namespace}_{name}" if self.namespace else name

    def _get_or_make(self, cls, name, help, labelnames, **kw):
        full = self._full(name)
        with self._lock:
            m = self._metrics.get(full)
            if m is None:
                if cls is Histogram:
                    m = Histogram(self, full, help, tuple(labelnames),
                                  **kw)
                else:
                    kind = "counter" if cls is Counter else "gauge"
                    m = cls(self, full, help, kind, tuple(labelnames))
                self._metrics[full] = m
            elif not isinstance(m, cls):
                raise ValueError(f"{full} already registered as "
                                 f"{type(m).__name__}")
            return m

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets=LATENCY_BUCKETS_MS) -> Histogram:
        return self._get_or_make(Histogram, name, help, labelnames,
                                 buckets=buckets)

    def snapshot_rows(self) -> list:
        """One dict per live series — the tabular registry view behind
        `sys.metrics` (catalog.systables): scalar metrics carry `value`,
        histogram series carry observation `count` and `total` (the
        _count/_sum pair; per-bucket counts stay on /metrics)."""
        import json
        with self._lock:
            rows = []
            for m in sorted(self._metrics.values(),
                            key=lambda m: m.name):
                for key in sorted(m.series):
                    s = m.series[key]
                    labels = json.dumps(dict(zip(m.labelnames, key)),
                                        sort_keys=True)
                    if isinstance(m, Histogram):
                        rows.append({"name": m.name, "kind": m.kind,
                                     "labels": labels, "value": None,
                                     "count": s.n, "total": s.total})
                    else:
                        rows.append({"name": m.name, "kind": m.kind,
                                     "labels": labels, "value": s.value,
                                     "count": None, "total": None})
        return rows

    # ------------------------------------------------------------ render

    @staticmethod
    def _labels_str(names: tuple, values: tuple, extra: str = "") -> str:
        parts = [f'{n}="{_escape_label(v)}"'
                 for n, v in zip(names, values)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self) -> str:
        """Prometheus text exposition (content type
        `text/plain; version=0.0.4`)."""
        with self._lock:
            metrics = sorted(self._metrics.values(),
                             key=lambda m: m.name)
            lines: list[str] = []
            for m in metrics:
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
                for key in sorted(m.series):
                    s = m.series[key]
                    if isinstance(m, Histogram):
                        cum = 0
                        for i, b in enumerate(m.buckets):
                            cum += s.counts[i]
                            lab = self._labels_str(
                                m.labelnames, key, f'le="{_fmt(b)}"')
                            lines.append(
                                f"{m.name}_bucket{lab} {cum}")
                        cum += s.counts[-1]
                        lab = self._labels_str(m.labelnames, key,
                                               'le="+Inf"')
                        lines.append(f"{m.name}_bucket{lab} {cum}")
                        lab = self._labels_str(m.labelnames, key)
                        lines.append(f"{m.name}_sum{lab} "
                                     f"{_fmt(s.total)}")
                        lines.append(f"{m.name}_count{lab} {s.n}")
                    else:
                        lab = self._labels_str(m.labelnames, key)
                        lines.append(f"{m.name}{lab} {_fmt(s.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

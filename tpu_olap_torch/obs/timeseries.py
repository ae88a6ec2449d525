"""Metrics history: bounded per-series time-series rings.

A copy of the JAX package's obs/timeseries.py.

`/metrics` is point-in-time — a scrape shows where the counters are
NOW, not how they got there. The TimeseriesSampler closes that gap
in-process: a periodic `telemetry` background graph on the stage
scheduler (executor/stages.py) snapshots every live metric series into
a bounded ring per series, so the engine answers SQL over its own
recent history (`SELECT ... FROM sys.metrics_history`) and serves it
over HTTP (`GET /debug/timeseries`) with no external TSDB.

Sample shape per tick and series:

  scalar (counter/gauge)  (ts_ms, value)
  histogram               (ts_ms, total, n)  — the _sum/_count pair;
                          per-bucket history would multiply cardinality
                          for little diagnostic value (rates and means
                          derive from sum/count deltas)

Retention is per series (EngineConfig.telemetry_retention): the rings
are deques, so a long-running server's telemetry memory is flat —
series_count x retention tuples. Series that disappear from the
registry (a zeroed table gauge stays; series are never deleted today)
keep their history until process exit.

The sampler READS the registry under its lock and writes nothing back
except its own `telemetry_samples_total` counter — sampled like any
other series, one tick behind. It executes no SQL and produces no
query records, so it cannot attribute work to itself (introspection
appears nowhere in its own stats, and neither does the telemetry
plane).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

from tpu_olap_torch.obs.metrics import Histogram


class TimeseriesSampler:
    """Bounded per-series history over a MetricsRegistry."""

    def __init__(self, registry, retention: int = 360):
        self.registry = registry
        self.retention = max(2, int(retention))
        # (name, labels_json) -> deque of (ts_ms, value, count);
        # count is None for scalar series
        self._rings: dict[tuple, deque] = {}
        self._lock = threading.Lock()  # rings only; registry has its own
        self.samples = 0
        self.last_sample_ms = None
        self._m_samples = registry.counter(
            "telemetry_samples_total",
            "Sampler ticks recorded into the metrics-history rings.")

    def sample_once(self, now_ms: int | None = None) -> int:
        """Snapshot every live series. Returns the series count."""
        ts = int(now_ms if now_ms is not None else time.time() * 1000)
        points = []
        reg = self.registry
        with reg._lock:
            for m in reg._metrics.values():
                hist = isinstance(m, Histogram)
                for key, s in m.series.items():
                    labels = json.dumps(dict(zip(m.labelnames, key)),
                                        sort_keys=True)
                    if hist:
                        points.append(((m.name, labels), m.kind,
                                       float(s.total), int(s.n)))
                    else:
                        points.append(((m.name, labels), m.kind,
                                       float(s.value), None))
        with self._lock:
            for rkey, kind, value, count in points:
                ring = self._rings.get(rkey)
                if ring is None:
                    ring = self._rings[rkey] = deque(
                        maxlen=self.retention)
                ring.append((ts, kind, value, count))
            self.samples += 1
            self.last_sample_ms = ts
        self._m_samples.inc()
        return len(points)

    def rows(self, limit_per_series: int | None = None) -> list[dict]:
        """Flat tabular view — the frame behind sys.metrics_history.
        One dict per retained sample, oldest-first within a series."""
        out = []
        with self._lock:
            items = sorted(self._rings.items())
            for (name, labels), ring in items:
                pts = list(ring)
                if limit_per_series is not None:
                    pts = pts[-max(0, int(limit_per_series)):]
                for ts, kind, value, count in pts:
                    out.append({"ts_ms": ts, "name": name, "kind": kind,
                                "labels": labels, "value": value,
                                "count": count})
        return out

    def snapshot(self, limit_per_series: int | None = None) -> dict:
        """GET /debug/timeseries payload: rings grouped per series."""
        series = []
        with self._lock:
            for (name, labels), ring in sorted(self._rings.items()):
                pts = list(ring)
                if limit_per_series is not None:
                    pts = pts[-max(0, int(limit_per_series)):]
                series.append({
                    "name": name, "labels": json.loads(labels),
                    "kind": pts[-1][1] if pts else None,
                    "points": [[p[0], p[2]] if p[3] is None
                               else [p[0], p[2], p[3]] for p in pts]})
            meta = {"samples": self.samples,
                    "retention": self.retention,
                    "series": len(self._rings),
                    "last_sample_ms": self.last_sample_ms}
        return {**meta, "timeseries": series}

"""Latency SLOs: good/bad event accounting + burn-rate.

The bench's north star is a latency objective ("every SSB query < 500 ms
p50"); this module makes the serving-time version of that objective a
first-class metric instead of something recomputed from bench artifacts:

- every completed query is classified **good** (total_ms <= the
  objective, and it did not fail) or **bad** — counted in
  `tpu_olap_slo_events_total{outcome=...}`;
- the **burn rate** over a sliding window is
  `bad_fraction / error_budget` where `error_budget = 1 - slo_target`
  — the standard SRE multiple-of-budget-consumption number: 1.0 means
  the service is spending its error budget exactly as fast as the
  objective allows; 2.0 means twice as fast (alert); 0 means no bad
  events in the window. Exposed as `tpu_olap_slo_burn_rate` and in
  `GET /status`.

Knobs (EngineConfig): `slo_latency_ms` (objective; default 500 matching
BASELINE.md), `slo_target` (good fraction; default 0.99),
`slo_window_s` (burn-rate window; default 3600).

The window is a deque of per-second [second, events, bad] buckets
(pruned on write and on read), so memory is O(window_s) — independent
of QPS, keeping the "flat memory for a long-running server" contract at
any load. Burn-rate granularity is therefore one second, far below any
sane alerting window.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class SloTracker:
    def __init__(self, latency_ms: float = 500.0, target: float = 0.99,
                 window_s: float = 3600.0, metrics=None):
        self.latency_ms = float(latency_ms)
        self.target = min(max(float(target), 0.0), 0.999999)
        self.window_s = max(1.0, float(window_s))
        self._lock = threading.Lock()
        self._buckets: deque = deque()  # [monotonic second, n, bad]
        self._win_n = 0
        self._win_bad = 0
        self.good_total = 0
        self.bad_total = 0
        self._m_events = self._m_burn = None
        if metrics is not None:
            self._m_events = metrics.counter(
                "slo_events_total",
                "Queries classified against the latency SLO.",
                ("outcome",))
            self._m_burn = metrics.gauge(
                "slo_burn_rate",
                "Error-budget burn rate over the SLO window "
                "(1.0 = spending the budget exactly at the allowed "
                "rate).")
            self._m_burn.set(0.0)

    def _prune(self, now: float):
        # caller holds self._lock
        horizon = now - self.window_s
        b = self._buckets
        while b and b[0][0] < horizon:
            _, n, bad = b.popleft()
            self._win_n -= n
            self._win_bad -= bad

    def observe(self, total_ms: float, failed: bool = False):
        """Classify one completed query. `failed` queries are bad
        whatever their latency (a fast error is not a good event)."""
        bad = bool(failed) or not (total_ms <= self.latency_ms)
        now = time.monotonic()
        with self._lock:
            self._prune(now)
            sec = int(now)
            if self._buckets and self._buckets[-1][0] == sec:
                bucket = self._buckets[-1]
                bucket[1] += 1
                bucket[2] += 1 if bad else 0
            else:
                self._buckets.append([sec, 1, 1 if bad else 0])
            self._win_n += 1
            if bad:
                self._win_bad += 1
                self.bad_total += 1
            else:
                self.good_total += 1
            burn = self._burn_locked()
        if self._m_events is not None:
            self._m_events.inc(outcome="bad" if bad else "good")
        if self._m_burn is not None:
            self._m_burn.set(burn)

    def _burn_locked(self) -> float:
        if self._win_n == 0:
            return 0.0
        return (self._win_bad / self._win_n) / (1.0 - self.target)

    def burn_rate(self) -> float:
        with self._lock:
            self._prune(time.monotonic())
            return self._burn_locked()

    def snapshot(self) -> dict:
        """JSON view for GET /status."""
        with self._lock:
            self._prune(time.monotonic())
            return {
                "latency_objective_ms": self.latency_ms,
                "target": self.target,
                "window_s": self.window_s,
                "good_total": self.good_total,
                "bad_total": self.bad_total,
                "window_events": self._win_n,
                "window_bad": self._win_bad,
                "burn_rate": round(self._burn_locked(), 4),
            }

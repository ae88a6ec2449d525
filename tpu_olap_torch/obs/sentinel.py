"""Regression sentinel: the engine watches itself for drift.

A copy of the JAX package's obs/sentinel.py.

Regressions used to be caught when a human re-ran a bench. The sentinel
closes the loop in-process, from the two signals the engine already
produces at query completion (QueryRunner.record):

- **per-template latency baselines** — an EWMA plus a raw-moment
  accumulator (n, Σx, Σx² — moments merge by addition, the
  moment-sketch property of PAPERS.md 1803.01969, so per-replica
  baselines can later merge fleet-wide by summing) for every query
  template's served latency;
- **per-stage baselines** — an EWMA of each stage's busy (run_ms) and
  wait (wait_ms) from the record's `stages` list (executor/stages.py),
  so a drifted query is attributed to the STAGE whose time moved, not
  just flagged slow.

A served query slower than max(floor, factor × template EWMA) after
`sentinel_min_samples` warmup raises a `latency_drift` alert naming
the worst-moved stage. Anomalous samples do NOT update the EWMA (an
incident must not teach the baseline that slow is normal); the moment
accumulator keeps every sample so mean/variance stay honest.

Resource checks run on the telemetry tick (obs.timeseries' background
graph), over probes wired in by the runner/engine: HBM pressure vs
budget, eviction thrash, WAL sync lag, breaker-open, admission sheds.

Alert lifecycle: fire -> re-confirm (count++) while the condition
holds -> auto-clear when not re-confirmed for `sentinel_clear_after_s`.
Transitions emit `alert` / `alert_clear` events; live state is the
`alerts_active{kind}` gauge, `sys.alerts`, and the GET /debug/health
verdict. The sentinel observes ONLY non-introspection records —
record() returns before the sentinel for sys.* statements, so telemetry
queries never appear in their own baselines.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

from tpu_olap_torch.obs.workload import in_introspection

# alert kinds, in /debug/health display order
ALERT_KINDS = ("latency_drift", "hbm_pressure", "eviction_thrash",
               "wal_lag", "breaker_open", "admission_shed")


class _Baseline:
    """Per-template latency baseline: EWMA + raw moments + per-stage
    EWMAs of busy/wait. Moments are a 3-vector (n, Σx, Σx²) that merges
    with another baseline's by elementwise addition."""

    __slots__ = ("n", "ewma", "moments", "stage_ewma", "anomalies",
                 "last_ms")

    def __init__(self):
        self.n = 0
        self.ewma = None
        self.moments = [0, 0.0, 0.0]
        self.stage_ewma: dict = {}  # stage -> [run_ewma, wait_ewma]
        self.anomalies = 0
        self.last_ms = None

    def update(self, total_ms: float, stages, alpha: float,
               anomalous: bool):
        self.moments[0] += 1
        self.moments[1] += total_ms
        self.moments[2] += total_ms * total_ms
        self.last_ms = total_ms
        if anomalous:
            self.anomalies += 1
            return
        self.n += 1
        self.ewma = total_ms if self.ewma is None else \
            (1 - alpha) * self.ewma + alpha * total_ms
        for s in stages:
            name = s.get("stage")
            if not name:
                continue
            run = float(s.get("run_ms") or 0.0)
            wait = float(s.get("wait_ms") or 0.0)
            e = self.stage_ewma.get(name)
            if e is None:
                self.stage_ewma[name] = [run, wait]
            else:
                e[0] = (1 - alpha) * e[0] + alpha * run
                e[1] = (1 - alpha) * e[1] + alpha * wait

    def mean(self) -> float | None:
        n = self.moments[0]
        return self.moments[1] / n if n else None

    def variance(self) -> float | None:
        n = self.moments[0]
        if n < 2:
            return None
        m = self.moments[1] / n
        return max(0.0, self.moments[2] / n - m * m)


class RegressionSentinel:
    """Baselines + active-alert registry behind one lock."""

    def __init__(self, config, metrics=None, events=None):
        self.config = config
        self.events = events
        self._lock = threading.Lock()
        self._templates: dict[str, _Baseline] = {}
        self._active: dict[tuple, dict] = {}  # (kind, subject) -> alert
        self._history: deque = deque(
            maxlen=max(1, int(getattr(config, "sentinel_alert_limit",
                                      256))))
        self._seq = itertools.count(1)
        self._probes: dict = {}
        self._last_evictions = None
        self._last_sheds = None
        self.checks = 0
        self.observed = 0
        self._m_active = None
        if metrics is not None:
            self._m_active = metrics.gauge(
                "alerts_active",
                "Active sentinel alerts, by kind (obs.sentinel).",
                ("kind",))
            for kind in ALERT_KINDS:
                self._m_active.set(0, kind=kind)

    @property
    def enabled(self) -> bool:
        return bool(getattr(self.config, "sentinel_enabled", True))

    def add_probe(self, name: str, fn):
        """Register a resource probe (a zero-arg callable returning a
        dict) consulted on each check() tick. Later registrations with
        the same name replace (engine re-wiring after close)."""
        with self._lock:
            self._probes[name] = fn

    # ------------------------------------------------------- observe

    def observe(self, m: dict):
        """Fold one completed SERVED query record into the baselines;
        fire latency_drift when it lands past the template threshold.
        Called from QueryRunner.record() after the introspection
        early-return — introspection never reaches here, and the
        explicit guard keeps that true even for direct callers."""
        if not self.enabled or in_introspection():
            return
        total = m.get("total_ms")
        if total is None or m.get("failed") \
                or m.get("deadline_exceeded"):
            return
        total = float(total)
        tid = m.get("template_id") or \
            f"{m.get('query_type', '?')}:{m.get('datasource', '?')}"
        stages = m.get("stages") or []
        cfg = self.config
        alert = None
        with self._lock:
            b = self._templates.get(tid)
            if b is None:
                b = self._templates[tid] = _Baseline()
            anomalous = False
            if b.n >= int(cfg.sentinel_min_samples) \
                    and b.ewma is not None:
                threshold = max(float(cfg.sentinel_latency_floor_ms),
                                float(cfg.sentinel_latency_factor)
                                * b.ewma)
                if total > threshold:
                    anomalous = True
                    stage, delta = self._attribute(b, stages)
                    alert = {"subject": tid, "stage": stage,
                             "total_ms": round(total, 3),
                             "baseline_ms": round(b.ewma, 3),
                             "threshold_ms": round(threshold, 3),
                             "stage_delta_ms": round(delta, 3),
                             "query_id": m.get("query_id")}
            b.update(total, stages, float(cfg.sentinel_ewma_alpha),
                     anomalous)
            self.observed += 1
        if alert is not None:
            self.fire("latency_drift", **alert)

    @staticmethod
    def _attribute(b: _Baseline, stages) -> tuple:
        """The stage whose busy+wait moved most above its own baseline
        — 'transfer got slow', not just 'the query got slow'. Records
        without a stages block (cache hits, fallback) attribute to
        'total'."""
        worst, worst_delta = "total", 0.0
        for s in stages:
            name = s.get("stage")
            if not name:
                continue
            cur = float(s.get("run_ms") or 0.0) \
                + float(s.get("wait_ms") or 0.0)
            e = b.stage_ewma.get(name)
            delta = cur - ((e[0] + e[1]) if e is not None else 0.0)
            if delta > worst_delta:
                worst, worst_delta = name, delta
        return worst, worst_delta

    # --------------------------------------------------- alert state

    def fire(self, kind: str, subject: str = "engine", **detail):
        """Fire or re-confirm the (kind, subject) alert."""
        now_ms = int(time.time() * 1000)
        key = (kind, str(subject))
        with self._lock:
            a = self._active.get(key)
            new = a is None
            if new:
                a = {"alert_id": f"a{next(self._seq):05d}",
                     "kind": kind, "subject": str(subject),
                     "status": "active", "fired_at_ms": now_ms,
                     "last_seen_ms": now_ms, "cleared_at_ms": None,
                     "count": 1}
                a.update(detail)
                self._active[key] = a
                self._history.append(a)
            else:
                a["count"] += 1
                a["last_seen_ms"] = now_ms
                a.update(detail)
            self._refresh_gauge_locked()
        if new and self.events is not None:
            self.events.emit("alert", **{k: v for k, v in a.items()
                                         if k != "status"})

    def _clear_stale_locked(self, now_ms: int) -> list:
        clear_after_ms = float(self.config.sentinel_clear_after_s) \
            * 1000.0
        cleared = []
        for key, a in list(self._active.items()):
            if now_ms - a["last_seen_ms"] >= clear_after_ms:
                a["status"] = "cleared"
                a["cleared_at_ms"] = now_ms
                del self._active[key]
                cleared.append(a)
        if cleared:
            self._refresh_gauge_locked()
        return cleared

    def _refresh_gauge_locked(self):
        if self._m_active is None:
            return
        counts = {k: 0 for k in ALERT_KINDS}
        for kind, _subject in self._active:
            counts[kind] = counts.get(kind, 0) + 1
        for kind, n in counts.items():
            self._m_active.set(n, kind=kind)

    # ----------------------------------------------------- check tick

    def check(self):
        """Resource-drift checks + stale-alert clearing; runs on the
        telemetry background tick. Probe failures are swallowed — the
        sentinel observes the engine, it must not be able to fail it."""
        if not self.enabled:
            return
        cfg = self.config
        snaps = {}
        with self._lock:
            probes = dict(self._probes)
        for name, fn in probes.items():
            try:
                snaps[name] = fn() or {}
            except Exception:  # noqa: BLE001 — observer, not server
                snaps[name] = {}
        hbm = snaps.get("hbm", {})
        budget = hbm.get("budget")
        in_use = hbm.get("bytes_in_use")
        if budget and in_use is not None \
                and in_use / budget >= float(cfg.sentinel_hbm_pressure):
            self.fire("hbm_pressure", subject="hbm",
                      bytes_in_use=int(in_use), budget_bytes=int(budget),
                      fraction=round(in_use / budget, 4))
        evictions = hbm.get("evictions")
        if evictions is not None:
            prev, self._last_evictions = self._last_evictions, evictions
            if prev is not None and \
                    evictions - prev >= int(cfg.sentinel_eviction_thrash):
                self.fire("eviction_thrash", subject="hbm",
                          evictions_tick=int(evictions - prev),
                          evictions_total=int(evictions))
        for table, lag in (snaps.get("wal", {}) or {}).items():
            if lag >= int(cfg.sentinel_wal_lag_records):
                self.fire("wal_lag", subject=table,
                          lag_records=int(lag))
        state = snaps.get("breaker", {}).get("state")
        if state == "open":
            self.fire("breaker_open", subject="device", state=state)
        sheds = snaps.get("admission", {}).get("shed_total")
        if sheds is not None:
            prev, self._last_sheds = self._last_sheds, sheds
            if prev is not None and sheds > prev:
                self.fire("admission_shed", subject="admission",
                          sheds_tick=int(sheds - prev),
                          sheds_total=int(sheds))
        now_ms = int(time.time() * 1000)
        with self._lock:
            cleared = self._clear_stale_locked(now_ms)
            self.checks += 1
        for a in cleared:
            if self.events is not None:
                self.events.emit(
                    "alert_clear", alert_id=a["alert_id"],
                    kind=a["kind"], subject=a["subject"],
                    count=a["count"], fired_at_ms=a["fired_at_ms"])

    # ------------------------------------------------------ exports

    def active(self) -> list[dict]:
        with self._lock:
            return [dict(a) for a in self._active.values()]

    def alert_rows(self) -> list[dict]:
        """History rows (active + cleared, oldest-first) behind
        sys.alerts."""
        with self._lock:
            return [dict(a) for a in self._history]

    def counts(self) -> dict:
        """{fired, active} — the bench detail's alert census."""
        with self._lock:
            return {"fired": len(self._history),
                    "active": len(self._active)}

    def health(self) -> dict:
        """GET /debug/health verdict: ok iff no active alerts."""
        with self._lock:
            active = [dict(a) for a in self._active.values()]
            templates = len(self._templates)
            checks, observed = self.checks, self.observed
        active.sort(key=lambda a: a["fired_at_ms"])
        return {"ok": not active, "alerts": active,
                "enabled": self.enabled, "checks": checks,
                "observed": observed, "templates": templates}

    def baseline(self, template_id: str) -> dict | None:
        """One template's baseline (tests / debugging): EWMA, moment
        vector, per-stage EWMAs."""
        with self._lock:
            b = self._templates.get(template_id)
            if b is None:
                return None
            return {"n": b.n, "ewma_ms": b.ewma,
                    "moments": list(b.moments),
                    "mean_ms": b.mean(), "variance": b.variance(),
                    "anomalies": b.anomalies,
                    "stages": {k: {"run_ms": v[0], "wait_ms": v[1]}
                               for k, v in b.stage_ewma.items()}}

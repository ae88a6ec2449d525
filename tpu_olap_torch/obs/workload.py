"""Workload introspection — the query-template profiler.

A host-only copy of the JAX package's obs/workload.py. In this package
`QueryRunner.record` feeds the profiler once per record of a completed
statement (fallback statements by their masked SQL), with the runner's
metrics registry; its consumers are the cube advisor (cubes.advisor),
`sys.query_templates` and `GET /debug/workload`.

The reference stack is observable *through its own query language*:
Druid's `sys` schema and the broker query history are what drive
precomputation decisions. This module is the engine's equivalent of the
broker-side workload record: every completed query record
(QueryRunner.record, the one chokepoint every path passes through) is
fingerprinted into a literal/interval-normalized **template**, and the
profiler maintains bounded per-template rolling stats — count, latency
percentiles over a rolling window, rows/segments scanned, cache
hit-rate by tier, grouping dims, time-granularity histogram, last-seen.

Two normalization flavors share one id space:

* `fingerprint_ir(query, datasource)` — device-path query IR: the query
  JSON with the top-level `intervals` stripped (the one field a moving
  dashboard window changes — exactly `ResultCache.template_key`'s rule)
  AND the WHERE/HAVING literal values masked to `?`, so `delta = 1993`
  and `delta = 1994` are one template. Dimension specs, aggregations,
  virtual columns, and granularity are kept verbatim: changed dims or
  measures ARE a different template.
* `fingerprint_sql(sql, stmt, datasource)` — fallback-path statements:
  the SQL text with string/numeric literals masked and whitespace/case
  normalized (grouping dims recovered from the parsed statement).

The profiler output is the demand signal the cube advisor
(cubes.advisor) consumes: `recommend_rollups` ranks (datasource, dim-set,
finest-granularity) groups by total wall spent — the dim-set × grain
candidates a materialized rollup cube would have served.

Introspection suppression: `sys.*` statements (catalog/systables) run
inside `introspection_execution()`; `QueryRunner.record` drops their
records entirely — no history, no metrics, no SLO, no profiler
observation — so introspection can never recurse into its own stats.
"""

from __future__ import annotations

import contextvars
import hashlib
import json
import math
import re
import threading
import time
from collections import deque

__all__ = [
    "Fingerprint", "WorkloadProfiler", "fingerprint_ir",
    "fingerprint_sql", "in_introspection", "introspection_execution",
    "percentile", "recommend_rollups",
]

# ------------------------------------------------- introspection context

_introspection: contextvars.ContextVar = contextvars.ContextVar(
    "tpu_olap_introspection", default=None)


class introspection_execution:
    """Marks the dynamic extent of a `sys.*` introspection statement:
    QueryRunner.record drops records emitted inside it (no history, no
    metrics/SLO, no profiler observation) and the result caches bypass,
    so a query over sys.queries can never appear in sys.queries. The
    context value is a per-statement dict the SysTableProvider uses to
    memoize resolved entries, so one statement sees ONE consistent
    snapshot of each sys table (a self-join's two sides must not read
    two different moments of a live ring)."""

    def __enter__(self):
        self._token = _introspection.set({})
        return self

    def __exit__(self, *exc):
        _introspection.reset(self._token)
        return False


def in_introspection() -> bool:
    return _introspection.get() is not None


def introspection_scope() -> dict | None:
    """The active introspection statement's memo dict, or None."""
    return _introspection.get()


# ------------------------------------------------------- fingerprinting

class Fingerprint:
    """A precomputed template identity, stamped on a record under the
    transient `_wl` key by whichever site still holds the query object
    (runner._execute, the full-result cache serve, fused batch legs,
    the engine's fallback record) and consumed by record()."""

    __slots__ = ("template_id", "template", "query_type", "datasource",
                 "dims", "granularity")

    def __init__(self, template: str, query_type: str, datasource: str,
                 dims: tuple = (), granularity: str = "all"):
        self.template = template
        self.query_type = query_type
        self.datasource = datasource
        self.dims = tuple(dims)
        self.granularity = granularity
        self.template_id = "t" + hashlib.sha1(
            template.encode()).hexdigest()[:10]


# literal-bearing keys inside filter/having spec JSON (SelectorFilter
# value, InFilter values, LikeFilter pattern, BoundFilter lower/upper,
# having value) — masked so a changed WHERE literal keeps the template
_LITERAL_KEYS = frozenset(("value", "values", "pattern", "lower",
                           "upper"))
# SQL literal masks: quoted strings first (so numbers inside them are
# gone before the numeric pass), then standalone numbers
_STR_LIT_RE = re.compile(r"'(?:[^']|'')*'")
_NUM_LIT_RE = re.compile(r"\b\d+(?:\.\d+)?(?:[eE][+-]?\d+)?\b")
_WS_RE = re.compile(r"\s+")


def _mask_sql_literals(s: str) -> str:
    return _NUM_LIT_RE.sub("?", _STR_LIT_RE.sub("?", s))


def _mask_filter_tree(node):
    """Literal values -> '?' throughout a filter/having subtree.
    Expression filters carry their literals embedded in a rendered
    expression string — masked with the SQL regexes."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k in _LITERAL_KEYS:
                out[k] = "?"
            elif k == "expression" and isinstance(v, str):
                out[k] = _mask_sql_literals(v)
            else:
                out[k] = _mask_filter_tree(v)
        return out
    if isinstance(node, list):
        return [_mask_filter_tree(x) for x in node]
    return node


def _granularity_label(g) -> str:
    """Short display form of a granularity JSON ('all', 'P1D', ...)."""
    if g is None:
        return "all"
    if isinstance(g, str):
        return g
    if isinstance(g, dict):
        return g.get("period") or g.get("duration") \
            or g.get("type") or "all"
    return str(g)


# timeFormat extraction formats -> the calendar grain they demand: a
# GROUP BY year(__time) is time bucketing spelled as a dimension, and
# the cube advisor must see it as a grain, not an opaque __time dim
_TIMEFMT_GRAIN = {"YYYY": "year", "Q": "quarter", "MM": "month",
                  "dd": "day", "HH": "hour", "mm": "minute",
                  "ss": "second"}


def _dims_of(qjson: dict) -> tuple[tuple, str | None]:
    """(grouping dimension source names, time grain demanded by a
    timeFormat extraction dim or None) from a query-spec JSON — the
    dim-set half of the cube advisor's demand signal."""
    dims, tf_grain = [], None
    specs = list(qjson.get("dimensions") or ())
    one = qjson.get("dimension")  # topN carries a single dimension spec
    if one is not None:
        specs.append(one)
    for d in specs:
        if not isinstance(d, dict):
            dims.append(str(d))
            continue
        fn = d.get("extractionFn")
        fmt = fn.get("format") if isinstance(fn, dict) else None
        if d.get("dimension") == "__time" and fmt in _TIMEFMT_GRAIN:
            tf_grain = _TIMEFMT_GRAIN[fmt]
            continue
        dims.append(str(d.get("dimension") or d.get("outputName")))
    return tuple(dims), tf_grain


def fingerprint_ir(query, datasource: str) -> Fingerprint:
    """Template of a device-path query spec: full query JSON minus the
    top-level intervals (ResultCache.template_key's rule), WHERE/HAVING
    literals masked. Dims/aggs/virtual columns/granularity are kept —
    they define the template."""
    qjson = query.to_json()
    norm = {}
    for k, v in qjson.items():
        if k == "intervals":
            continue
        if k in ("filter", "having") and v is not None:
            v = _mask_filter_tree(v)
        norm[k] = v
    template = "ir:" + json.dumps(norm, sort_keys=True, default=str)
    dims, tf_grain = _dims_of(qjson)
    gran = _granularity_label(qjson.get("granularity"))
    if gran == "all" and tf_grain is not None:
        gran = tf_grain
    return Fingerprint(
        template, getattr(query, "query_type", "?") or "?", datasource,
        dims=dims, granularity=gran)


_TIME_FN_NAMES = frozenset(("year", "quarter", "month", "day",
                            "dayofmonth", "hour", "minute", "second"))


def _stmt_dims_granularity(stmt) -> tuple[tuple, str]:
    """(grouping dims, granularity label) recovered from a parsed
    fallback statement: date_trunc / calendar extractors on the time
    column read as granularity, everything else as a dimension."""
    from tpu_olap_torch.ir.expr import Col, FuncCall
    from tpu_olap_torch.planner.exprutil import render
    dims, gran = [], "all"
    for g in getattr(stmt, "group_by", None) or ():
        if isinstance(g, FuncCall) and g.name == "date_trunc" and \
                len(g.args) == 2 and getattr(g.args[0], "value", None):
            gran = str(g.args[0].value).lower()
            continue
        if isinstance(g, FuncCall) and g.name in _TIME_FN_NAMES:
            gran = g.name
            continue
        dims.append(g.name if isinstance(g, Col) else render(g))
    return tuple(dims), gran


def fingerprint_sql(sql: str, stmt=None,
                    datasource: str = "?") -> Fingerprint:
    """Template of a fallback-path statement: the SQL text with literals
    masked, whitespace collapsed, and case folded. With no SQL text (an
    internal statement built from a parsed tree), a rendered skeleton of
    the statement stands in."""
    from tpu_olap_torch.planner.exprutil import render
    text = sql or ""
    if not text and stmt is not None:
        try:
            parts = [render(e) for e, _ in stmt.projections]
            text = ("select " + ",".join(parts) + " from "
                    + str(getattr(stmt, "table", "?")))
            if getattr(stmt, "group_by", None):
                text += " group by " + ",".join(
                    render(g) for g in stmt.group_by)
        except Exception:  # noqa: BLE001 — profiling must never raise
            text = str(getattr(stmt, "table", "?"))
    norm = _WS_RE.sub(" ", _mask_sql_literals(text)).strip().lower()
    dims, gran = ((), "all") if stmt is None \
        else _stmt_dims_granularity(stmt)
    return Fingerprint("sql:" + norm, "fallback", datasource,
                       dims=dims, granularity=gran)


# ----------------------------------------------------------- percentile

def percentile(values, q: float) -> float | None:
    """Nearest-rank percentile over raw observations (q in 0..1) — the
    one definition shared by the profiler snapshot and its tests, so
    template percentiles match history-derived ground truth exactly."""
    if not values:
        return None
    vals = sorted(values)
    idx = max(0, math.ceil(q * len(vals)) - 1)
    return float(vals[min(idx, len(vals) - 1)])


# ------------------------------------------------------------- profiler

class _TemplateStats:
    __slots__ = ("template", "query_type", "datasource", "dims",
                 "count", "failures", "total_ms", "rows_scanned",
                 "segments_scanned", "cache_full_hits",
                 "cache_segment_hits", "segments_cached",
                 "latencies", "granularities", "paths",
                 "first_seen_ms", "last_seen_ms")

    def __init__(self, fp: Fingerprint | None, m: dict, window: int):
        self.template = fp.template if fp else None
        self.query_type = fp.query_type if fp \
            else str(m.get("query_type", "?"))
        self.datasource = fp.datasource if fp \
            else str(m.get("datasource", "?"))
        self.dims = fp.dims if fp else ()
        self.count = 0
        self.failures = 0
        self.total_ms = 0.0
        self.rows_scanned = 0
        self.segments_scanned = 0
        self.cache_full_hits = 0
        self.cache_segment_hits = 0   # queries with >= 1 tier-1 hit
        self.segments_cached = 0      # tier-1 segments served from cache
        self.latencies = deque(maxlen=max(16, int(window)))
        self.granularities: dict = {}
        self.paths: dict = {}
        self.first_seen_ms = self.last_seen_ms = 0


class WorkloadProfiler:
    """Bounded per-template rolling stats, fed by QueryRunner.record.

    Observation is a few dict/deque ops under one lock — far below any
    query's cost (the bench gate: < 2% qps on the warm HTTP path).
    Capacity is bounded at `max_templates`; the least-recently-SEEN
    template evicts, so a changing workload ages out naturally."""

    def __init__(self, max_templates: int = 512,
                 latency_window: int = 512, enabled: bool = True,
                 metrics=None):
        self.enabled = bool(enabled)
        self.max_templates = max(1, int(max_templates))
        self.latency_window = max(16, int(latency_window))
        self._lock = threading.Lock()
        self._templates: dict[str, _TemplateStats] = {}
        self._observations = 0
        self._m_templates = self._m_obs = self._m_evict = None
        if metrics is not None:
            self._m_templates = metrics.gauge(
                "workload_templates",
                "Query templates tracked by the workload profiler.")
            self._m_obs = metrics.counter(
                "workload_observations_total",
                "Query records folded into the workload profiler.")
            self._m_evict = metrics.counter(
                "workload_template_evictions_total",
                "Templates evicted by the profiler's capacity bound "
                "(least-recently-seen first).")

    # ------------------------------------------------------------ ingest

    def observe(self, m: dict, fp: Fingerprint | None = None):
        """Fold one completed-query record into its template's stats.
        `fp` is the precomputed fingerprint when the record site had
        the query; a record carrying only `template_id` (a batch dedup
        fan-out copy) updates the already-registered template."""
        if not self.enabled:
            return
        tid = fp.template_id if fp is not None else m.get("template_id")
        if tid is None:
            return
        now = int(time.time() * 1000)
        evicted = 0
        with self._lock:
            st = self._templates.get(tid)
            if st is None:
                st = self._templates[tid] = _TemplateStats(
                    fp, m, self.latency_window)
                st.first_seen_ms = st.last_seen_ms = now
                while len(self._templates) > self.max_templates:
                    victim = min(self._templates,
                                 key=lambda k:
                                 self._templates[k].last_seen_ms)
                    del self._templates[victim]
                    evicted += 1
            elif st.template is None and fp is not None:
                st.template = fp.template   # filled by a later full obs
                st.dims = fp.dims
            st.count += 1
            st.last_seen_ms = now
            st.total_ms += float(m.get("total_ms") or 0.0)
            st.rows_scanned += int(m.get("rows_scanned") or 0)
            st.segments_scanned += int(m.get("segments_scanned") or 0)
            if m.get("failed") or m.get("deadline_exceeded"):
                st.failures += 1
            tier = m.get("cache_tier")
            if tier == "full":
                st.cache_full_hits += 1
            elif tier == "segment":
                st.cache_segment_hits += 1
            st.segments_cached += int(m.get("segments_cached") or 0)
            st.latencies.append(float(m.get("total_ms") or 0.0))
            gran = fp.granularity if fp is not None else None
            if gran:
                st.granularities[gran] = st.granularities.get(gran, 0) + 1
            path = m.get("path")
            if path:
                st.paths[path] = st.paths.get(path, 0) + 1
            self._observations += 1
            n_live = len(self._templates)
        if self._m_obs is not None:
            self._m_obs.inc()
            self._m_templates.set(n_live)
            if evicted:
                self._m_evict.inc(evicted)

    # ----------------------------------------------------------- queries

    def snapshot(self, limit: int | None = None) -> list[dict]:
        """Per-template stat rows, most-queried first — the payload
        behind sys.query_templates, GET /debug/workload, and the cube
        advisor's input."""
        with self._lock:
            items = [(tid, st, list(st.latencies))
                     for tid, st in self._templates.items()]
        rows = []
        for tid, st, lat in items:
            hits = st.cache_full_hits + st.cache_segment_hits
            rows.append({
                "template_id": tid,
                "datasource": st.datasource,
                "query_type": st.query_type,
                "count": st.count,
                "failures": st.failures,
                "p50_ms": percentile(lat, 0.50),
                "p95_ms": percentile(lat, 0.95),
                "p99_ms": percentile(lat, 0.99),
                "mean_ms": (st.total_ms / st.count) if st.count else None,
                "total_ms": round(st.total_ms, 3),
                "rows_scanned": st.rows_scanned,
                "segments_scanned": st.segments_scanned,
                "cache_hit_rate": (hits / st.count) if st.count else 0.0,
                "cache_full_hits": st.cache_full_hits,
                "cache_segment_hits": st.cache_segment_hits,
                "segments_cached": st.segments_cached,
                "dims": ",".join(st.dims),
                "granularities": json.dumps(st.granularities,
                                            sort_keys=True),
                "paths": json.dumps(st.paths, sort_keys=True),
                "first_seen_ms": st.first_seen_ms,
                "last_seen_ms": st.last_seen_ms,
                "template": st.template,
            })
        rows.sort(key=lambda r: (-r["count"], r["template_id"]))
        return rows[:limit] if limit else rows

    def totals(self) -> dict:
        with self._lock:
            return {"templates": len(self._templates),
                    "observations": self._observations,
                    "max_templates": self.max_templates,
                    "latency_window": self.latency_window,
                    "enabled": self.enabled}

    def clear(self):
        with self._lock:
            self._templates.clear()
        if self._m_templates is not None:
            self._m_templates.set(0)


# ---------------------------------------------------------- cube advisor

# coarse -> fine; a rollup cube must be built at the FINEST granularity
# its templates request to serve all of them by re-aggregation
_GRAIN_ORDER = ("all", "year", "P1Y", "quarter", "P3M", "month", "P1M",
                "week", "P1W", "day", "P1D", "hour", "PT1H",
                "minute", "PT1M", "second", "PT1S")
_GRAIN_RANK = {g: i for i, g in enumerate(_GRAIN_ORDER)}


def _finest_grain(granularities: dict) -> str:
    best, rank = "all", -1
    for g in granularities or {"all": 1}:
        r = _GRAIN_RANK.get(g, len(_GRAIN_ORDER))  # unknown = finest
        if r > rank:
            best, rank = g, r
    return best


def recommend_rollups(rows, top: int = 5) -> list[dict]:
    """Rank (datasource, dim-set, finest grain) groups by total wall
    spent — the demand signal of the cube advisor (cubes.advisor).
    A group's `est_ms_saved` is the aggregate wall its queries burned;
    a covering rollup cube would have served them as lookups."""
    groups: dict = {}
    for r in rows:
        if r.get("query_type") not in ("groupBy", "timeseries", "topN",
                                       "fallback"):
            continue
        ds = str(r.get("datasource") or "")
        if not ds or ds.startswith("__") or ds.startswith("(") \
                or ds.startswith("sys."):
            # rewrite pseudo-tables ("__winagg", "(derived)"): real
            # demand, but not a datasource a rollup cube can be
            # materialized over — excluded from the advisor signal
            continue
        dims = tuple(sorted(d for d in (r.get("dims") or "").split(",")
                            if d))
        grain = _finest_grain(json.loads(r.get("granularities") or "{}"))
        key = (r.get("datasource"), dims, grain)
        g = groups.setdefault(key, {
            "datasource": key[0], "dims": list(dims),
            "granularity": grain, "queries": 0, "est_ms_saved": 0.0,
            "templates": []})
        g["queries"] += r.get("count", 0)
        g["est_ms_saved"] += float(r.get("total_ms") or 0.0)
        g["templates"].append(r.get("template_id"))
    out = sorted(groups.values(),
                 key=lambda g: (-g["est_ms_saved"], g["datasource"]))
    for g in out:
        g["est_ms_saved"] = round(g["est_ms_saved"], 3)
    return out[:top]

"""The observability core of the PyTorch port (obs.trace, obs.metrics,
obs.events, obs.slo, the runner's record() and history ring, the
engine's counters and EXPLAIN ANALYZE) against the JAX package.

The registry, the SLO tracker and the event log are copies of the JAX
package's: the same observations render the same Prometheus lines. The
engines run one fixed statement sequence over the same table (each
package's own ingest of the same frame): `counters()` has the JAX keys and
counts, every route's record the core keys and the JAX `path`, and
EXPLAIN ANALYZE the JAX span names.
"""

import json
import math

import pandas as pd
import pytest

from test_fault_recovery import SQL, _df
from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.executor.runner import \
    CORE_METRIC_DEFAULTS as JAX_CORE_DEFAULTS
from tpu_olap.obs import events as jax_events
from tpu_olap.obs import metrics as jax_metrics
from tpu_olap.obs import slo as jax_slo
from tpu_olap_torch.executor.runner import CORE_METRIC_DEFAULTS
from tpu_olap_torch.obs import events, metrics, slo
from _torch_port import cpu_engine

UNGROUPED = "SELECT sum(v) AS s, count(*) AS n FROM t WHERE v < 50"
TIMESERIES = ("SELECT date_trunc('day', ts) AS d, count(*) AS n FROM t "
              "GROUP BY date_trunc('day', ts)")
WINDOW = ("SELECT g, v, row_number() OVER (PARTITION BY g ORDER BY v "
          "DESC, ts) AS r FROM t WHERE v > 90")
SCAN = "SELECT g, v FROM t WHERE v < 3 LIMIT 5"
ROLLUP = "SELECT g, sum(v) AS s FROM t GROUP BY ROLLUP (g)"
SPARSE = "SELECT g, v, sum(v) AS s FROM t GROUP BY g, v ORDER BY g, v"
SEQUENCE = [SQL, UNGROUPED, SQL, TIMESERIES, WINDOW, SCAN, ROLLUP]
BATCH = [SQL, SQL, UNGROUPED, "SELECT g, max(v) AS m FROM t GROUP BY g"]


def _feed(m):
    """One observation sequence on a registry of either package."""
    c = m.counter("queries_total", "Queries completed.",
                  ("query_type", "path"))
    c.inc(query_type="groupBy", path="dense")
    c.inc(2, query_type="timeseries", path="cache")
    g = m.gauge("inflight_transfers", "Live transfers.")
    g.set(3)
    g.set(1)
    h = m.histogram("dispatch_lock_wait_ms", "Lock wait.",
                    buckets=jax_metrics.QUEUE_WAIT_BUCKETS_MS)
    for v in (0.01, 0.3, 7.0, 42.0, 9000.0, math.nan, math.inf):
        h.observe(v)
    lat = m.histogram("query_latency_ms", "Latency.",
                      ("query_type", "path"))
    for v in (0.2, 3.0, 260.0):
        lat.observe(v, query_type="groupBy", path="fused")
    m.counter("hbm_evictions_total", "Evictions.").set_total(7)


def test_render_is_identical_for_the_same_observations():
    port, jax = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    _feed(port)
    _feed(jax)
    assert port.render() == jax.render()
    assert port.snapshot_rows() == jax.snapshot_rows()
    assert metrics.LATENCY_BUCKETS_MS == jax_metrics.LATENCY_BUCKETS_MS
    assert metrics.QUEUE_WAIT_BUCKETS_MS == \
        jax_metrics.QUEUE_WAIT_BUCKETS_MS
    # the SLO tracker reports into the registry with the same lines
    ps, js = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    trackers = (slo.SloTracker(100.0, 0.9, 60.0, metrics=ps),
                jax_slo.SloTracker(100.0, 0.9, 60.0, metrics=js))
    for t in trackers:
        for ms, failed in ((5.0, False), (150.0, False), (1.0, True)):
            t.observe(ms, failed=failed)
    assert ps.render() == js.render()
    assert trackers[0].snapshot() == trackers[1].snapshot()
    # the event log keeps the same records, bar the wall clock
    logs = (events.EventLog(limit=2), jax_events.EventLog(limit=2))
    for log in logs:
        for i in range(3):
            log.emit("query", query_id=f"q{i}", total_ms=0.1 * i,
                     err=ValueError("x" * 400))
    recs = [[{k: v for k, v in r.items() if k != "ts"}
             for r in log.snapshot()] for log in logs]
    assert recs[0] == recs[1] and len(recs[0]) == 2


@pytest.fixture(scope="module")
def engines():
    """Both packages over the same segments, tier 2 of the result cache
    on, the fallback off in the port; closed after the module."""
    jax = JaxEngine(JaxConfig(result_cache_enabled=True,
                              cube_auto_refresh=False))
    port = cpu_engine(result_cache_enabled=True, cube_auto_refresh=False)
    for eng in (jax, port):
        eng.register_table("t", _df(), time_column="ts", block_rows=512)
    yield jax, port
    jax.close()
    port.close()


def _run_sequence(eng):
    outs = [eng.sql(q) for q in SEQUENCE]
    outs += eng.sql_batch(BATCH)
    return outs


@pytest.fixture(scope="module")
def ran(engines):
    jax, port = engines
    return _run_sequence(jax), _run_sequence(port)


def test_counters_keys_and_counts_match(engines, ran):
    jax, port = engines
    want, got = jax.counters(), port.counters()
    assert sorted(got) == sorted(want)
    for k in ("queries", "rows_scanned", "segments_scanned",
              "segments_pruned", "cache_hits", "by_query_type"):
        assert got[k] == want[k], k
    assert got["total_ms"] > 0
    assert len(port.history) == len(jax.history)
    assert [h["path"] for h in port.history] == \
        [h["path"] for h in jax.history]
    assert [h["query_type"] for h in port.history] == \
        [h["query_type"] for h in jax.history]
    for (a, b) in zip(*ran):
        pd.testing.assert_frame_equal(a.reset_index(drop=True),
                                      b.reset_index(drop=True),
                                      check_dtype=False)


def test_every_record_has_the_core_keys(engines, ran):
    _, port = engines
    assert CORE_METRIC_DEFAULTS == JAX_CORE_DEFAULTS
    core = {k for k, _ in CORE_METRIC_DEFAULTS} | {"query_id", "ts_ms",
                                                   "path"}
    for rec in port.history:
        assert core <= set(rec), sorted(core - set(rec))
        json.dumps(rec)   # sanitized: every value serializes


def test_metrics_series_match_the_statement_sequence(engines, ran):
    """The per-path query counters and the scan totals read the same in
    both registries after the same statements."""
    jax, port = engines
    for name in ("queries_total", "rows_scanned_total",
                 "segments_scanned_total"):
        def lines(eng):
            return sorted(ln for ln in eng.metrics.render().splitlines()
                          if ln.startswith(f"tpu_olap_{name}"))
        assert lines(port) == lines(jax), name
    for eng in engines:
        h = eng.metrics.histogram("query_latency_ms")
        assert sum(s.n for s in h.series.values()) == \
            eng.counters()["queries"]


@pytest.mark.parametrize("route", ["packed", "sparse", "unpacked",
                                   "segment_cache", "cache", "batch",
                                   "mask", "search", "manifest",
                                   "fallback"])
def test_record_keys_and_path_of_each_route(route):
    """Each route ends in one record with the core keys and the JAX
    package's path label."""
    cfg = {"packed": {}, "sparse": {"dense_group_budget": 4},
           "unpacked": {"result_group_cap": 1},
           "segment_cache": {"segment_cache_enabled": True,
                             "segment_cache_min_rows": 1},
           "cache": {"result_cache_enabled": True}, "batch": {},
           "mask": {}, "search": {}, "manifest": {},
           "fallback": {}}[route]
    sql = {"sparse": SPARSE, "mask": SCAN, "fallback": WINDOW}.get(route,
                                                                   SQL)
    ir = {"search": {"queryType": "search", "dataSource": "t",
                     "query": {"type": "contains", "value": "x"}},
          "manifest": {"queryType": "timeBoundary", "dataSource": "t"}}
    recs = []
    for jax in (True, False):
        kw = dict(cfg, cube_auto_refresh=False)
        eng = JaxEngine(JaxConfig(**kw)) if jax else cpu_engine(**kw)
        eng.register_table("t", _df(), time_column="ts", block_rows=512)
        if route == "batch":
            eng.sql_batch([SQL, UNGROUPED])
        elif route in ir:
            eng.execute_ir(ir[route])
        else:
            eng.sql(sql)
            if route == "cache":
                eng.sql(sql)
        recs.append(dict(eng.history[-1]))
        eng.close()
    want, got = recs
    assert got["path"] == want["path"]
    assert got["query_type"] == want["query_type"]
    assert got["route"] == {"search": "mask", "manifest": "manifest",
                            "fallback": "fallback"}.get(route, route)
    core = {k for k, _ in CORE_METRIC_DEFAULTS} | {"query_id", "ts_ms",
                                                   "path"}
    assert core <= set(got) and core <= set(want)


def _span_names(frame, depth):
    return [s.strip() for s in frame["span"]
            if len(s) - len(s.lstrip()) <= 2 * depth]


def test_explain_analyze_gives_the_span_tree(engines, ran):
    """EXPLAIN ANALYZE runs the statement and returns its spans: on the
    device path the root and its children are the JAX package's (parse,
    plan, execute, render), and the children sum to within the root; a
    statement the interpreter serves has the JAX package's whole tree,
    the fallback's own spans included."""
    jax, port = engines
    for sql, depth in ((SQL, 1), (WINDOW, 99)):
        want = jax.sql(f"EXPLAIN ANALYZE {sql}")
        got = port.sql(f"EXPLAIN ANALYZE {sql}")
        assert list(got.columns) == list(want.columns)
        assert _span_names(got, depth) == _span_names(want, depth), sql
        root = got["ms"][0]
        assert sum(ms for s, ms in zip(got["span"], got["ms"])
                   if s.startswith("  ") and not s.startswith("    ")) \
            <= root + 1e-6
        detail = json.loads(got["detail"][0])
        assert detail["rows_returned"] > 0 and detail["query_id"]
    assert {"fallback", "fallback-filter", "fallback-agg"} <= \
        set(_span_names(got, 99))


def test_history_ring_is_bounded_and_counters_stay_exact():
    for jax in (True, False):
        kw = dict(history_limit=3, cube_auto_refresh=False)
        eng = JaxEngine(JaxConfig(**kw)) if jax else cpu_engine(**kw)
        eng.register_table("t", _df(), time_column="ts", block_rows=512)
        for _ in range(5):
            eng.sql(SQL)
        assert len(eng.history) == 3
        assert eng.counters()["queries"] == 5
        assert len({h["query_id"] for h in eng.history}) == 3
        eng.close()

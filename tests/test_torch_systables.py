"""The `sys.*` tables of the PyTorch port (catalog.systables and
Engine._execute_sys_stmt) against the JAX package.

Both engines run the same scripted traffic over the same seeded table
(statements, a cache hit, a batch, an append, a compaction, a cube build),
then every sys table is compared column for column. Left out of the
comparison: byte counts and the device columns (the two packages hold
different buffers on different devices), wall-clock and latency columns,
query ids, and table generations (a per-process counter of each
package). sys.checkpoints is compared over one store directory written by
the JAX engine and recovered by a fresh engine of each package.
"""

import numpy as np
import pandas as pd
import pytest

from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap_torch.catalog import stmt_uses_sys
from tpu_olap_torch.planner.sqlparse import parse_sql
from _torch_port import cpu_engine

SQL = "SELECT g, sum(v) AS s FROM t GROUP BY g ORDER BY g"
CUBE = {"name": "c1", "datasource": "t", "dimensions": ["g"],
        "granularity": "all",
        "aggregations": [{"type": "longSum", "name": "s",
                          "fieldName": "v"}]}
# the compile families: the JAX package compiles on the CPU too, the port
# builds kernels (NVRTC) only on the card
COMPILE = ("tpu_olap_recompiles_total", "tpu_olap_compile_ms_total",
           "tpu_olap_compile_cache_requests_total")
NEVER_COMPARED = {"query_id", "ts_ms", "total_ms", "p50_ms", "p95_ms",
                  "p99_ms", "mean_ms", "first_seen_ms", "last_seen_ms",
                  "generation", "base_generation", "cube_generation",
                  "last_refresh_ms", "build_ms", "fired_at_ms",
                  "last_seen_ms", "cleared_at_ms", "baseline_ms",
                  "threshold_ms", "device_bytes", "bytes", "storage_bytes",
                  "sketch_bytes", "budget_bytes"}


def _df(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "ts": pd.to_datetime("2024-01-01")
        + pd.to_timedelta(rng.integers(0, 86400 * 40, n), unit="s"),
        "g": rng.choice([f"g{i}" for i in range(6)], n),
        "v": rng.integers(0, 500, n).astype(np.int64),
    })


def _make(jax, **kw):
    kw = dict(kw, telemetry_interval_s=0.0, cube_auto_refresh=False,
              ingest_auto_compact=False, ingest_wal_fsync="never")
    return JaxEngine(JaxConfig(use_pallas="never", **kw)) if jax \
        else cpu_engine(**kw)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    d = tmp_path_factory.mktemp("systables")
    out = []
    for i, jax in enumerate((True, False)):
        eng = _make(jax, result_cache_enabled=True,
                    segment_cache_enabled=True, segment_cache_min_rows=1,
                    ingest_wal_dir=str(d / f"wal{i}"))
        eng.register_table("t", _df(), time_column="ts", block_rows=512)
        eng.register_table("dim", pd.DataFrame({"g": ["g0", "g1"],
                                                "label": ["a", "b"]}),
                           accelerate=False)
        eng.sql(SQL)
        eng.sql(SQL)
        eng.sql("SELECT sum(v) AS s FROM t WHERE v < 100")
        eng.sql_batch([SQL, "SELECT g, max(v) AS m FROM t GROUP BY g"])
        eng.append("t", [{"ts": "2024-02-20T00:00:00", "g": "g2",
                          "v": 7}] * 5)
        eng.sql("SELECT g, count(*) AS n FROM t GROUP BY g")
        eng.compact_now("t")
        eng.create_cube(CUBE)
        eng.sql(SQL)
        eng.runner.telemetry.sample_once()
        eng.runner.sentinel.add_probe("wal", lambda: {"t": 10 ** 6})
        eng.runner.sentinel.check()
        out.append(eng)
    yield out
    for eng in out:
        eng.close()


def _comparable(frame: pd.DataFrame) -> pd.DataFrame:
    keep = [c for c in frame.columns if c not in NEVER_COMPARED]
    return frame[keep].reset_index(drop=True)


@pytest.mark.parametrize("name", ["tables", "segments", "queries",
                                  "query_templates", "cubes", "alerts"])
def test_sys_table_matches_the_jax_package(engines, name):
    jax, port = engines
    want = jax.sql(f"SELECT * FROM sys.{name}")
    got = port.sql(f"SELECT * FROM sys.{name}")
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    pd.testing.assert_frame_equal(_comparable(got), _comparable(want),
                                  check_dtype=False)


def test_sys_metrics_and_history_match(engines):
    """Same families, kinds and label sets; the counters the traffic
    fed hold the same values."""
    frames = [(eng.sql("SELECT * FROM sys.metrics"),
               eng.sql("SELECT * FROM sys.metrics_history"))
              for eng in engines]
    for i in (0, 1):
        assert list(frames[0][i].columns) == list(frames[1][i].columns)

    def series(f):
        # the JAX package's "arg" cache (uploaded constants) has no
        # counterpart in the port; SLO outcomes depend on latency (the
        # JAX package's first statements compile past slo_latency_ms)
        f = f[~f["name"].isin(COMPILE + ("tpu_olap_slo_events_total",))
              & (f["labels"] != '{"cache": "arg"}')]
        return set(zip(f["name"], f["kind"], f["labels"]))
    (jm, jh), (pm, ph) = frames
    assert series(pm) == series(jm)
    assert series(ph) == series(jh)
    counted = ["tpu_olap_queries_total", "tpu_olap_rows_scanned_total",
               "tpu_olap_ingest_rows_total", "tpu_olap_cube_builds_total",
               "tpu_olap_result_cache_requests_total",
               "tpu_olap_compactions_total", "tpu_olap_alerts_active"]
    for f in (jm, pm):
        f.sort_values(["name", "labels"], inplace=True)

    def values(f):
        f = f[f["name"].isin(counted)]
        return list(zip(f["name"], f["labels"], f["value"]))
    assert values(pm) == values(jm)


def test_sys_caches_and_devices(engines):
    jax, port = engines
    want = jax.sql("SELECT * FROM sys.caches")
    got = port.sql("SELECT * FROM sys.caches")
    assert list(got.columns) == list(want.columns)
    # the result-cache tiers alike; of the runner caches the port has the
    # plan cache and, as "jit", its NVRTC-compiled kernels (the JAX
    # package's "arg" cache of uploaded constants has no counterpart)
    tiers = [f[f["cache"].isin(["full", "segment"])] for f in (got, want)]
    pd.testing.assert_frame_equal(_comparable(tiers[0]),
                                  _comparable(tiers[1]), check_dtype=False)
    assert list(got["cache"]) == ["full", "segment", "jit", "plan"]
    assert int(got.set_index("cache").loc["plan", "entries"]) == \
        len(port.runner._plan_cache)
    dev = [e.sql("SELECT * FROM sys.devices") for e in engines]
    assert list(dev[1].columns) == list(dev[0].columns)
    assert len(dev[1]) == len(dev[0]) == 1
    row = dev[1].iloc[0]
    assert (row["device"], row["platform"], row["chips"]) == \
        ("cpu", "cpu", 1)
    assert int(row["hbm_bytes"]) == port.runner._ledger.bytes_in_use
    assert int(row["segments"]) == sum(
        len(ds.table.segments) for ds in port.runner._datasets.values())


def test_sys_statements_leave_no_trace_in_the_engine(engines):
    """No history record, counter, metric, SLO observation, workload
    template, result-cache entry or trace — through sql and sql_batch."""
    _, port = engines
    r = port.runner

    def state():
        return (len(port.history), port.counters(), r.slo.snapshot(),
                r.workload.totals(), r.result_cache.snapshot(),
                len(port.tracer.recent_traces()),
                [ln for ln in r.metrics.render().splitlines()
                 if ln.startswith("tpu_olap_queries_total")])
    before = state()
    got = port.sql("SELECT q.path, count(*) AS n FROM sys.queries q "
                   "GROUP BY q.path ORDER BY q.path")
    assert int(got["n"].sum()) == before[0]
    port.sql("SELECT * FROM sys.metrics_history")
    assert state() == before
    outs, qids = port.sql_batch_ids([
        "SELECT count(*) AS n FROM sys.tables", SQL,
        "SELECT name FROM sys.metrics WHERE kind = 'counter' LIMIT 3"])
    assert qids[0] == "-" and qids[2] == "-" and qids[1] != "-"
    assert int(outs[0]["n"].iloc[0]) == 3   # t, dim and the cube's table
    after = state()
    # the batch's one user statement, and only it
    assert after[0] == before[0] + 1
    assert port.history[-1]["query_id"] == qids[1]
    assert after[1]["queries"] == before[1]["queries"] + 1
    assert after[5] == before[5] + 1        # the sql_batch trace


def test_sys_joins_user_tables_and_literals_stay_user_queries(engines):
    jax, port = engines
    q = ("SELECT d.label, count(*) AS n FROM sys.segments s JOIN dim d "
         "ON s.table = d.g GROUP BY d.label")
    pd.testing.assert_frame_equal(port.sql(q), jax.sql(q),
                                  check_dtype=False)
    lit = "SELECT g, count(*) AS n FROM t WHERE g <> 'sys.queries' " \
          "GROUP BY g ORDER BY g"
    assert not stmt_uses_sys(parse_sql(lit), port.catalog)
    h = len(port.history)
    pd.testing.assert_frame_equal(port.sql(lit), jax.sql(lit),
                                  check_dtype=False)
    assert len(port.history) == h + 1     # an ordinary, recorded query
    sub = "SELECT g FROM t WHERE g IN (SELECT table FROM sys.tables)"
    assert stmt_uses_sys(parse_sql(sub), port.catalog)
    # a registered table shadows a sys name
    assert port.catalog.is_sys("sys.queries")
    assert not port.catalog.is_sys("t")


def test_sys_checkpoints_over_a_jax_written_store(tmp_path):
    wal, store = str(tmp_path / "wal"), str(tmp_path / "store")
    writer = _make(True, ingest_wal_dir=wal, ingest_store_dir=store)
    writer.register_table("t", _df(), time_column="ts", block_rows=512)
    writer.append("t", [{"ts": "2024-02-20T00:00:00", "g": "g2",
                         "v": 7}] * 5)
    writer.checkpoint_now("t")
    writer.append("t", [{"ts": "2024-02-21T00:00:00", "g": "g3",
                         "v": 9}] * 3)
    writer.close()
    frames = []
    for jax in (True, False):
        eng = _make(jax, ingest_wal_dir=wal, ingest_store_dir=store)
        eng.register_table("t", _df(), time_column="ts", block_rows=512)
        frames.append(eng.sql("SELECT * FROM sys.checkpoints"))
        frames.append(eng.sql("SELECT count(*) AS n, sum(v) AS s FROM t"))
        eng.close()
    want, want_t, got, got_t = frames
    assert list(got.columns) == list(want.columns)
    assert len(got) == 1 and got["last_status"].iloc[0] == "loaded"
    pd.testing.assert_frame_equal(_comparable(got), _comparable(want),
                                  check_dtype=False)
    pd.testing.assert_frame_equal(got_t, want_t, check_dtype=False)

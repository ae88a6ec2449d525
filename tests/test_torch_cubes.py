"""The PyTorch port's materialized rollup cubes (cubes/, the cube rewrite
pass, the advisor and the DDL), on the CPU, against the JAX package.

The cases are those of `tests/test_cubes.py` that need no HTTP server
and no `sys.*` table, over its frame recipe `_df` and its cube DDL
(imported from it). Every statement runs through the port with the
rewrite on and off (equal exactly: sums, counts and the sketch states
behind the HLL and theta estimates fold exactly) and through the JAX
package (`assert_frame_parity`), and both packages must take the same
decision: served from a cube or not. The JAX side runs with
use_pallas="never"; every engine runs with cube_auto_refresh=False but
the maintainer's."""

import json
import threading
import time

import pandas as pd
import pytest

from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap_torch.bench import assert_frame_parity
from tpu_olap_torch.cubes import (CubeSpec, agg_signature,
                                  cube_specs_from_workload, period_contains)
from tpu_olap_torch.resilience.errors import UserError

from test_cubes import FULL_DDL, N_ROWS, _df
from _torch_port import cpu_engine

REG = dict(time_column="ts", block_rows=1 << 11, time_partition="month")
TINY = ("CREATE DRUID CUBE tiny ON t DIMENSIONS (g) GRANULARITY all "
        "AGGREGATES (sum(v))")
G_SUM = "SELECT g, sum(v) AS s FROM t GROUP BY g ORDER BY g"


def _pair(df=None, ddl=(), **kw):
    df = _df() if df is None else df
    jax = JaxEngine(JaxConfig(use_pallas="never", cube_auto_refresh=False,
                              **kw))
    port = cpu_engine(cube_auto_refresh=False, **kw)
    for eng in (jax, port):
        eng.register_table("t", df, **REG)
        for d in ddl:
            eng.sql(d)
    return jax, port


@pytest.fixture(scope="module")
def cubed():
    return _pair(ddl=(FULL_DDL, TINY))


def _compare(pair, sql, expect_cube=True):
    """The statement with the rewrite on, then off, on the port (equal
    exactly), and on the JAX package (parity); both packages serve it
    from a cube, or both do not. Returns the port's metrics."""
    jax, port = pair
    a = port.sql(sql)
    m = dict(port.runner.last_metrics)
    assert (m.get("path") == "cube") == expect_cube, (m.get("path"), sql)
    port.config.cube_rewrite_enabled = False
    try:
        b = port.sql(sql)
        assert port.runner.last_metrics.get("path") != "cube"
    finally:
        port.config.cube_rewrite_enabled = True
    pd.testing.assert_frame_equal(a, b)
    want = jax.sql(sql)
    rec = dict(jax.history[-1])
    assert (rec.get("path") == "cube") == expect_cube, sql
    if expect_cube:
        assert rec["cube"] == m["cube"], sql
    assert_frame_parity(a, want, ordered=True, label=sql)
    return m


# ------------------------------------------------------ rewrite parity


def test_agg_matrix_parity_groupby(cubed):
    m = _compare(cubed, (
        "SELECT g, sum(v) AS s, count(*) AS n, avg(v) AS a, "
        "min(w) AS mn, max(w) AS mx, sum(w) AS sw, "
        "approx_count_distinct(u) AS d, theta_sketch(u) AS th "
        "FROM t GROUP BY g ORDER BY g"))
    assert m["cube"] == "c" and m["route"] == "cube"
    assert m["rows_scanned"] < N_ROWS
    assert m["segments_scanned"] == 0 and m["host_copies"] == 0


@pytest.mark.parametrize("sql", [
    "SELECT g, sum(v) AS s FROM t WHERE r = 'A' GROUP BY g ORDER BY g",
    "SELECT g, sum(v) AS s FROM t WHERE r IN ('A', 'C') AND y = 1997 "
    "GROUP BY g ORDER BY g",
    "SELECT g, sum(v) AS s FROM t WHERE g LIKE 'g%' AND (r = 'A' OR "
    "r = 'B') GROUP BY g ORDER BY g",
    "SELECT substr(g, 1, 1) AS p, sum(v) AS s FROM t WHERE "
    "substr(r, 1, 1) = 'A' GROUP BY substr(g, 1, 1) ORDER BY p",
], ids=["selector", "in-and-long", "like-or", "extraction"])
def test_filters_on_cube_dims_and_extractions(cubed, sql):
    _compare(cubed, sql)


@pytest.mark.parametrize("sql", [
    "SELECT sum(v) AS s, count(*) AS n FROM t",
    "SELECT g, sum(v) AS s FROM t GROUP BY g ORDER BY s DESC LIMIT 3",
    "SELECT g, sum(v) AS s FROM t GROUP BY g HAVING sum(v) > 100000 "
    "ORDER BY g",
], ids=["timeseries", "topn", "having"])
def test_timeseries_topn_and_having(cubed, sql):
    _compare(cubed, sql)


def test_filtered_aggregate_signature_match_and_refusal():
    pair = _pair(ddl=(
        "CREATE DRUID CUBE fc ON t DIMENSIONS (g) GRANULARITY all "
        "AGGREGATES (sum(CASE WHEN r = 'A' THEN v ELSE 0 END), "
        "count(v))",))
    _compare(pair, "SELECT g, sum(CASE WHEN r = 'A' THEN v ELSE 0 END) "
                   "AS s, count(v) AS n FROM t GROUP BY g ORDER BY g")
    _compare(pair, "SELECT g, sum(CASE WHEN r = 'B' THEN v ELSE 0 END) "
                   "AS s FROM t GROUP BY g ORDER BY g", expect_cube=False)


@pytest.mark.parametrize("sql", [
    *(f"SELECT date_trunc('{u}', ts) AS b, sum(v) AS s, avg(v) AS a "
      f"FROM t GROUP BY date_trunc('{u}', ts) ORDER BY b"
      for u in ("month", "quarter", "year")),
    "SELECT year(ts) AS yy, g, sum(v) AS s FROM t GROUP BY year(ts), g "
    "ORDER BY yy, g",
    "SELECT month(ts) AS mm, sum(v) AS s FROM t GROUP BY month(ts) "
    "ORDER BY mm",
], ids=["month", "quarter", "year", "year-dim", "month-dim"])
def test_coarser_grain_re_rollup(cubed, sql):
    """A month-grain cube serves month, quarter and year grains and the
    year(ts) / month(ts) timeFormat dims by re-bucketing its partials."""
    _compare(cubed, sql)


def test_interval_containment(cubed):
    m = _compare(cubed, "SELECT g, sum(v) AS s FROM t "
                        "WHERE ts >= TIMESTAMP '1997-03-01' AND "
                        "ts < TIMESTAMP '1997-06-01' GROUP BY g ORDER BY g")
    assert m["cube"] == "c"
    _compare(cubed, "SELECT g, sum(v) AS s FROM t "
                    "WHERE ts >= TIMESTAMP '1997-03-15' "
                    "GROUP BY g ORDER BY g", expect_cube=False)
    _compare(cubed, "SELECT g, sum(v) AS s FROM t WHERE year(ts) = 1997 "
                    "GROUP BY g ORDER BY g")


def test_smallest_covering_cube_wins(cubed):
    assert _compare(cubed, G_SUM)["cube"] == "tiny"
    assert _compare(cubed, "SELECT g, sum(v) AS s FROM t WHERE r = 'A' "
                           "GROUP BY g ORDER BY g")["cube"] == "c"


# ------------------------------------------------------------ refusals


def test_rewrite_refusals_fall_back_to_base(cubed):
    port = cubed[1]
    n0 = port.cubes.rewrites.get("refused", 0)
    for sql in (
            "SELECT g, sum(v) AS s FROM t WHERE u > 10 GROUP BY g "
            "ORDER BY g",
            "SELECT g, min(v) AS m FROM t GROUP BY g ORDER BY g",
            "SELECT u, sum(v) AS s FROM t GROUP BY u ORDER BY u LIMIT 5",
            "SELECT date_trunc('day', ts) AS d, sum(v) AS s FROM t "
            "GROUP BY date_trunc('day', ts) ORDER BY d LIMIT 5"):
        _compare(cubed, sql, expect_cube=False)
    assert port.cubes.rewrites["refused"] >= n0 + 4


def test_scan_and_select_never_touch_cubes(cubed):
    jax, port = cubed
    out = port.sql("SELECT g, v FROM t LIMIT 5")
    assert len(out) == 5 and port.runner.last_metrics.get("path") != "cube"
    pd.testing.assert_frame_equal(out, jax.sql("SELECT g, v FROM t LIMIT 5"))


def test_batch_path_serves_from_cube(cubed):
    jax, port = cubed
    sqls = [G_SUM, "SELECT r, count(*) AS n FROM t GROUP BY r ORDER BY r"]
    outs = port.sql_batch(sqls)
    legs = port.runner.last_metrics["statements"]
    assert all(m.get("path") == "cube" for m in legs)
    port.config.cube_rewrite_enabled = False
    try:
        base = [port.sql(q) for q in sqls]
    finally:
        port.config.cube_rewrite_enabled = True
    for sql, a, b in zip(sqls, outs, base):
        pd.testing.assert_frame_equal(a, b)
        assert_frame_parity(a, jax.sql(sql), ordered=True, label=sql)


def test_workload_attribution_path_cube(cubed):
    jax, port = cubed
    sql = "SELECT r, sum(v) AS s FROM t GROUP BY r ORDER BY r"
    for _ in range(3):
        port.sql(sql)
    tid = port.runner.last_metrics["template_id"]
    row = {r["template_id"]: r for r in port.runner.workload.snapshot()}[tid]
    assert json.loads(row["paths"]).get("cube") == 3
    jax.sql(sql)
    assert dict(jax.history[-1])["template_id"] == tid


# --------------------------------------------------- invalidation/stale


def test_stale_generation_never_served_and_refresh_recovers():
    pair = _pair(ddl=(FULL_DDL,))
    jax, port = pair
    assert _compare(pair, G_SUM)["path"] == "cube"
    for eng in pair:
        eng.register_table("t", _df(seed=99), **REG)
    a = port.sql(G_SUM)
    assert port.runner.last_metrics.get("path") != "cube", "stale serve!"
    expect = _df(seed=99).groupby("g", as_index=False)["v"].sum() \
        .rename(columns={"v": "s"})
    pd.testing.assert_frame_equal(
        a, expect.sort_values("g").reset_index(drop=True))
    assert_frame_parity(a, jax.sql(G_SUM), ordered=True, label="stale")
    row = port.cubes.get("c").snapshot_row(port)
    assert row["stale"] and row["status"] == "ready"
    for eng in pair:
        assert list(eng.sql("REFRESH DRUID CUBES")["status"]) == ["ok"]
    assert _compare(pair, G_SUM)["path"] == "cube"
    assert port.cubes.rewrites["stale"] >= 1
    assert port.cubes.builds == {"ok": 1, "refresh": 1}


def test_drop_table_cascades_to_cubes():
    for eng in _pair(ddl=(FULL_DDL,)):
        assert eng.catalog.maybe("__cube_c") is not None
        eng.drop_table("t")
        assert eng.cubes.names() == []
        assert eng.catalog.maybe("__cube_c") is None


def test_auto_refresh_maintainer_rebuilds():
    jax = JaxEngine(JaxConfig(use_pallas="never"))
    jax.register_table("t", _df(seed=3), **REG)
    port = cpu_engine(cube_auto_refresh=True,
                  cube_refresh_interval_s=0.05)
    port.register_table("t", _df(), **REG)
    port.sql(FULL_DDL)
    port.register_table("t", _df(seed=3), **REG)
    deadline = time.time() + 30
    while time.time() < deadline:
        e = port.cubes.get("c")
        if e.ready and not e.snapshot_row(port)["stale"]:
            break
        time.sleep(0.05)
    else:
        pytest.fail("maintainer did not rebuild the stale cube")
    a = port.sql(G_SUM)
    assert port.runner.last_metrics["path"] == "cube"
    port.cubes.stop(join=True)
    # the maintainer is a background graph of the stage scheduler
    assert port.cubes._handle.cancelled and not port.cubes._handle.running
    port.close()
    port.config.cube_rewrite_enabled = False
    pd.testing.assert_frame_equal(a, port.sql(G_SUM))
    assert_frame_parity(a, jax.sql(G_SUM), ordered=True, label="refreshed")


# ------------------------------------------------------- DDL + surfaces


def test_ddl_create_snapshot_contract_and_drop():
    ddl = ("CREATE DRUID CUBE c ON t DIMENSIONS (g, r) GRANULARITY month "
           "AGGREGATES (sum(v), count(*))")
    jax, port = _pair()
    outs = [eng.sql(ddl) for eng in (jax, port)]
    assert list(outs[1]["status"]) == ["ready"]
    assert list(outs[0]["status"]) == ["ready"]
    rows = [eng.cubes.get("c").snapshot_row(eng) for eng in (jax, port)]
    for k in ("name", "base_table", "table", "dims", "granularity", "rows",
              "status", "stale", "serve_count", "refreshes", "error"):
        assert rows[0][k] == rows[1][k], k
    row = rows[1]
    assert row["dims"] == "g,r" and row["rows"] > 0
    assert row["base_generation"] == row["cube_generation"]
    assert row["storage_bytes"] == rows[0]["storage_bytes"] > 0
    stored = port.sql("SELECT count(*) AS n FROM __cube_c")
    assert int(stored["n"][0]) == int(row["rows"])
    pd.testing.assert_frame_equal(
        port.sql("SELECT g, r, sum(__rows) AS n FROM __cube_c GROUP BY g, r "
                 "ORDER BY g, r"),
        jax.sql("SELECT g, r, sum(__rows) AS n FROM __cube_c GROUP BY g, r "
                "ORDER BY g, r"))
    port.sql("SELECT g, sum(v) AS s FROM t GROUP BY g")
    assert port.cubes.get("c").snapshot_row(port)["serve_count"] == 1
    for eng in (jax, port):
        assert list(eng.sql("DROP DRUID CUBE c")["status"]) == ["dropped"]
        assert eng.cubes.names() == []
        assert eng.catalog.maybe("__cube_c") is None
        assert list(eng.sql("DROP DRUID CUBE c")["status"]) == ["absent"]


@pytest.mark.parametrize("ddl", [
    "CREATE DRUID CUBE c ON t DIMENSIONS (nope) AGGREGATES (sum(v))",
    "CREATE DRUID CUBE c ON t AGGREGATES (median(v))",
    "CREATE DRUID CUBE c ON missing AGGREGATES (sum(v))",
    "CREATE DRUID CUBE c ON t DIMENSIONS g AGGREGATES (sum(v))",
    "CREATE DRUID CUBE c ON t DIMENSIONS (ts) AGGREGATES (sum(v))",
], ids=["unknown-dim", "no-device-agg", "unknown-table", "bare-list",
        "time-dim"])
def test_ddl_errors_are_user_errors(ddl):
    jax = JaxEngine(JaxConfig(use_pallas="never", cube_auto_refresh=False))
    port = cpu_engine(cube_auto_refresh=False)
    for eng in (jax, port):
        eng.register_table("t", _df(n=2000), **REG)
    from tpu_olap.resilience.errors import UserError as JaxUserError
    with pytest.raises(JaxUserError) as want:
        jax.sql(ddl)
    with pytest.raises(UserError) as got:
        port.sql(ddl)
    assert str(got.value) == str(want.value)
    assert not any(port.cubes.get(n).ready for n in port.cubes.names())


def test_create_cubes_from_file_and_spec_roundtrip(tmp_path):
    spec = CubeSpec(name="f1", datasource="t", dimensions=("g",),
                    granularity="month", aggregations=("sum(v)",))
    assert CubeSpec.from_json(spec.to_json()) == spec
    path = tmp_path / "cubes.json"
    path.write_text(json.dumps(
        {"cubes": [spec.to_json(),
                   {"name": "bad", "datasource": "missing",
                    "aggregations": ["sum(v)"]}]}))
    pair = _pair()
    for eng in pair:
        out = eng.sql(f"CREATE DRUID CUBES FROM '{path}'")
        by_name = {r["cube"]: r["status"] for r in out.to_dict("records")}
        assert by_name == {"f1": "ready", "bad": "error"}
    assert _compare(pair, G_SUM)["cube"] == "f1"


def test_ddl_quoted_literals_with_parens_and_commas():
    ddl = ("CREATE DRUID CUBE q ON t DIMENSIONS (g) GRANULARITY all "
           "AGGREGATES (sum(CASE WHEN r = 'A)' THEN v ELSE 0 END), "
           "sum(CASE WHEN g = 'x,(y' THEN v ELSE 0 END), count(*))")
    pair = _pair(ddl=(ddl,))
    for eng in pair:
        assert eng.cubes.get("q").status == "ready"
    _compare(pair, "SELECT g, sum(CASE WHEN r = 'A)' THEN v ELSE 0 END) AS s,"
                   " count(*) AS n FROM t GROUP BY g ORDER BY g")


def test_failed_build_not_retried_until_generation_moves():
    """A failing spec is recorded as failed and attempted once per base
    generation; nothing builds it on the host instead."""
    port = cpu_engine(cube_auto_refresh=False)
    port.register_table("t", _df(n=4000), **REG)
    with pytest.raises(UserError):
        port.sql("CREATE DRUID CUBE doomed ON t DIMENSIONS (g) "
                 "GRANULARITY all AGGREGATES (median(v))")
    entry = port.cubes.get("doomed")
    assert entry.status == "error" and not entry.ready
    assert "not device-rewritable" in entry.error
    assert port.catalog.maybe("__cube_doomed") is None
    assert port.cubes.builds == {"error": 1}
    assert entry not in port.cubes.stale_cubes()
    assert port.cubes.refresh_now() == {}
    assert port.cubes.builds == {"error": 1}
    port.register_table("t", _df(n=3000, seed=1), **REG)
    assert any(e.spec.name == "doomed" for e in port.cubes.stale_cubes())
    jax = JaxEngine(JaxConfig(use_pallas="never", cube_auto_refresh=False))
    jax.register_table("t", _df(n=4000), **REG)
    with pytest.raises(Exception):
        jax.sql("CREATE DRUID CUBE doomed ON t DIMENSIONS (g) "
                "GRANULARITY all AGGREGATES (median(v))")
    assert jax.cubes.get("doomed").error == entry.error


def test_failed_device_build_is_recorded_not_served(monkeypatch):
    """A build whose device pass raises is recorded as failed and raises:
    the registry never serves, nor builds elsewhere, in its place."""
    port = cpu_engine(cube_auto_refresh=False)
    port.register_table("t", _df(n=4000), **REG)

    def boom(query, table):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(port.runner, "compute_partials", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        port.sql(TINY)
    assert port.cubes.get("tiny").status == "error"
    assert port.catalog.maybe("__cube_tiny") is None
    port.sql(G_SUM)
    assert port.runner.last_metrics["path"] != "cube"


def test_drop_during_inflight_build_leaves_no_orphan_storage():
    port = cpu_engine(cube_auto_refresh=False)
    port.register_table("t", _df(n=4000), **REG)
    port.sql(TINY)
    gate = threading.Event()
    orig = port.runner.compute_partials

    def slow(query, table):
        out = orig(query, table)
        gate.wait(10)
        return out

    port.runner.compute_partials = slow
    port.register_table("t", _df(n=4000, seed=5), **REG)
    t = threading.Thread(target=port.cubes.refresh_now, daemon=True)
    t.start()
    time.sleep(0.2)
    assert port.drop_cube("tiny")
    gate.set()
    t.join(30)
    port.runner.compute_partials = orig
    assert port.catalog.maybe("__cube_tiny") is None
    assert port.cubes.names() == []


# --------------------------------------------------- advisor loop


def test_advisor_specs_close_the_loop():
    sqls = ["SELECT g, sum(v) AS s FROM t WHERE r = 'A' GROUP BY g",
            "SELECT g, sum(v) AS s FROM t WHERE r = 'B' GROUP BY g",
            "SELECT year(ts) AS yy, avg(v) AS a FROM t GROUP BY year(ts) "
            "ORDER BY yy"]
    pair = _pair()
    jax, port = pair
    for eng in pair:
        for q in sqls:
            eng.sql(q)
    specs, _ = cube_specs_from_workload(port.runner.workload.snapshot(),
                                        port)
    from tpu_olap.cubes import cube_specs_from_workload as jax_specs
    want, _ = jax_specs(jax.runner.workload.snapshot(), jax)
    # the advisor ranks by wall time spent, so compare the sets
    assert specs and sorted(json.dumps(s.to_json(), sort_keys=True)
                            for s in specs) == \
        sorted(json.dumps(s.to_json(), sort_keys=True) for s in want)
    for eng, ss in ((port, specs), (jax, want)):
        for s in ss:
            eng.create_cube(s)
    for q in sqls:
        _compare(pair, q)


# -------------------------------------------------------- unit helpers


def test_period_containment_ladder():
    from tpu_olap.cubes import period_contains as jax_contains
    grains = ("PT1S", "PT1M", "PT1H", "P1D", "P1W", "P1M", "P3M", "P1Y")
    for a in grains:
        for b in grains:
            assert period_contains(a, b) == jax_contains(a, b), (a, b)
    assert period_contains("P1Y", "P1M") and not period_contains("P1M",
                                                                 "P1W")


def test_agg_signature_resolves_virtual_columns(cubed):
    port = cubed[1]

    def sig(sql):
        q = port.planner.plan(sql).query
        vex = {v.name: v.expression for v in q.virtual_columns}
        return agg_signature(q.aggregations[0], vex)

    a = sig("SELECT sum(v * 2) AS a FROM t")
    assert a == sig("SELECT sum(v * 2) AS b FROM t")
    assert a != sig("SELECT sum(v * 3) AS a FROM t")
    from tpu_olap.cubes import agg_signature as jax_sig
    q = cubed[0].planner.plan("SELECT sum(v * 2) AS a FROM t").query
    assert a == jax_sig(q.aggregations[0],
                        {v.name: v.expression for v in q.virtual_columns})

"""COUNT(DISTINCT), theta sketches and the sparse group-by through the
port's Engine.sql (tpu_olap_torch on the CPU) against the JAX engine.

The distinct-count SSB queries x1–x4 (ssb.DISTINCT_QUERIES) take the
port's three routes: packed (x1 HLL, x2 theta), unpacked (x3, a theta
set operation over raw tables) and sparse (x4). Their HLL registers,
theta tables and sparse partials must equal the JAX package's exactly,
and their frames must agree: integers and strings exact, estimates at
rtol 1e-12. Then the single-device SQL of the JAX package's
tests/test_sparse_groupby.py and tests/test_theta_setops.py, read from
those files, the adaptive sparse cap and the sketch-state budget.
"""

import numpy as np
import pandas as pd
import pytest

import test_sparse_groupby as jax_sparse_tests
import test_theta_setops as jax_theta_tests
from tpu_olap import Engine as JaxEngine
from tpu_olap.bench import ssb as jax_ssb
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.planner.fallback import FallbackError
from tpu_olap_torch.bench import assert_frame_parity, ssb
from tpu_olap_torch.kernels.sparse_groupby import SENTINEL
from tpu_olap_torch.planner.fallback import FallbackError as PortFallbackError

from _torch_port import cpu_engine, sql_literals as sql_of
from test_theta_setops import _setop, _theta
from test_theta_setops import setup as theta_setup  # noqa: F401 (fixture)

EST_RTOL = 1e-12
ROUTES = {"x1": "packed", "x2": "packed", "x3": "unpacked", "x4": "sparse"}


@pytest.fixture(scope="module")
def ssb_pair():
    tables = jax_ssb.generate_tables(60_000, 0)
    jeng = JaxEngine(JaxConfig())
    jax_ssb.register_ssb(jeng, tables=tables, block_rows=8192)
    peng = cpu_engine()
    _, denorm = ssb.register_ssb(peng, tables=tables, block_rows=8192)
    return jeng, peng, denorm, {}


def _frames(pair, name):
    jeng, peng, _, cache = pair
    if name not in cache:
        sql = ssb.DISTINCT_QUERIES[name]
        cache[name] = (jeng.sql(sql), peng.sql(sql),
                       dict(peng.runner.last_metrics))
    return cache[name]


@pytest.mark.parametrize("name", list(ssb.DISTINCT_QUERIES))
def test_distinct_queries_match_jax(ssb_pair, name):
    want, got, metrics = _frames(ssb_pair, name)
    assert metrics["route"] == ROUTES[name]
    assert metrics["host_copies"] == 1
    assert len(got) > 0
    assert_frame_parity(got, want, float_rtol=EST_RTOL, label=name)


def _lowered(eng, sql):
    q = eng.planner.plan(sql)
    return eng.runner._lower_cached(q.query, q.entry.segments)


@pytest.mark.parametrize("name", ["x1", "x2", "x3"])
def test_sketch_state_matches_jax(ssb_pair, name):
    """The dense partials, HLL registers and theta tables included, as
    the unpacked route fetches them."""
    jeng, peng, _, _ = ssb_pair
    sql = ssb.DISTINCT_QUERIES[name]
    want = jeng.runner._run_partials(_lowered(jeng, sql), {})
    plan = _lowered(peng, sql)
    got = peng.runner._run_partials(plan, {})
    sketches = [p.name for p in plan.agg_plans if p.kind in ("hll", "theta")]
    assert sketches
    for n in ["_rows"] + [p.name for p in plan.agg_plans]:
        np.testing.assert_array_equal(got[n], np.asarray(want[n]),
                                      err_msg=n)


def test_sparse_partials_match_jax(ssb_pair):
    jeng, peng, _, _ = ssb_pair
    sql = ssb.DISTINCT_QUERIES["x4"]
    want, count = jeng.runner._run_sparse(_lowered(jeng, sql), {})
    plan = _lowered(peng, sql)
    assert plan.sparse and plan.total_groups > peng.config.dense_group_budget
    got = peng.runner._run_sparse(plan, {})
    assert int(got["_count"]) == count > 0
    for n in ["_keys", "_rows"] + [p.name for p in plan.agg_plans]:
        np.testing.assert_array_equal(got[n], np.asarray(want[n]),
                                      err_msg=n)


def test_distinct_queries_match_pandas(ssb_pair):
    """x3 is exact (every sketch is below k) and x4 is exact; x1 and x2
    are estimates within the harness's approximate band."""
    _, _, d, _ = ssb_pair
    got = _frames(ssb_pair, "x3")[1]
    for _, r in got.iterrows():
        sub = d[d.c_region == r["c_region"]]
        want = len(set(sub[sub.d_year == 1997].lo_custkey)
                   & set(sub[sub.d_year == 1998].lo_custkey))
        assert int(r["retained"]) == want
    m = (d.c_region == "AMERICA") & (d.s_region == "AMERICA")
    ref = (d[m].groupby(["d_year", "c_city", "s_city", "p_brand1"])
           .agg(revenue=("lo_revenue", "sum"), orders=("lo_revenue", "size"))
           .reset_index().sort_values("revenue", ascending=False).head(100))
    got = _frames(ssb_pair, "x4")[1]
    assert_frame_parity(got.astype({"d_year": np.int64}),
                        ref.astype({"d_year": np.int64}), ordered=True,
                        label="x4/pandas")
    for name, keys, col, src in (
            ("x1", ["d_yearmonth", "s_nation"], "customers", "lo_custkey"),
            ("x2", ["c_region", "d_year"], "parts", "lo_partkey")):
        ref = d.groupby(keys)[src].nunique().reset_index(name=col)
        got = _frames(ssb_pair, name)[1][keys + [col]]
        assert_frame_parity(got.astype({k: ref[k].dtype for k in keys}),
                            ref, approx_cols=(col,), label=f"{name}/pandas")


def test_adaptive_sparse_cap(ssb_pair):
    """x4's groups overflow a 64-slot first table: one re-run at the next
    power of two, then the same answer."""
    jeng, _, _, _ = ssb_pair
    peng = cpu_engine(sparse_group_cap=64)
    _, _, denorm, _ = ssb_pair
    peng.register_table("lineorder", denorm, time_column=ssb.TIME_COL,
                        star_schema=ssb.star_schema(), block_rows=8192)
    got = peng.sql(ssb.DISTINCT_QUERIES["x4"])
    m = peng.runner.last_metrics
    assert m["sparse_reruns"] == [64]
    assert m["result_cap"] >= m["result_groups"] > 64
    assert m["host_copies"] == 2
    assert_frame_parity(got, _frames(ssb_pair, "x4")[0], label="x4 cap 64")
    # the hint sizes the next run: no re-run
    peng.sql(ssb.DISTINCT_QUERIES["x4"])
    assert peng.runner.last_metrics["sparse_reruns"] == []


def test_packed_overflow_reruns_unpacked(ssb_pair):
    """Past result_group_cap present groups the packed buffer overflows
    and the query re-runs unpacked: same answer, a second copy."""
    _, _, denorm, _ = ssb_pair
    peng = cpu_engine(result_group_cap=64)
    peng.register_table("lineorder", denorm, time_column=ssb.TIME_COL,
                        star_schema=ssb.star_schema(), block_rows=8192)
    got = peng.sql(ssb.DISTINCT_QUERIES["x1"])
    m = peng.runner.last_metrics
    assert m["route"] == "unpacked" and m["host_copies"] == 2
    assert m["result_groups"] > 64
    assert_frame_parity(got, _frames(ssb_pair, "x1")[0], float_rtol=EST_RTOL,
                        label="x1 cap 64")


# --------------------------------------------------------------------------
# The JAX package's own sparse and theta set-op SQL


@pytest.fixture(scope="module")
def sparse_pair():
    jeng = jax_sparse_tests._engine()
    peng = cpu_engine(dense_group_budget=64)
    peng.register_table("t", jax_sparse_tests._df(), time_column="ts",
                        block_rows=512)
    return jeng, peng


def _same_answer(jeng, peng, sql):
    try:
        want = jeng.sql(sql)
    except FallbackError:  # refused by the JAX planner and its fallback
        want = None
    if want is None:
        # the JAX fallback refuses it: so does the port's
        with pytest.raises(PortFallbackError):
            peng.sql(sql)
        return
    got = peng.sql(sql)
    assert peng.last_plan.rewritten == jeng.last_plan.rewritten
    ordered = "ORDER BY" in sql.upper()
    assert_frame_parity(got, want, float_rtol=EST_RTOL, ordered=ordered,
                        label=sql)


# the SQL over the module's table `t` (test_sparse_groupby._df); the
# capacity test's `t` is another table (a key per row)
SPARSE_SQL = [jax_sparse_tests.SQL] + [
    s for name, s in sql_of(jax_sparse_tests) if " FROM t " in s
    and name != "test_exchange_scales_past_per_chip_budget"]


@pytest.mark.parametrize("sql", SPARSE_SQL)
def test_jax_sparse_sql(sparse_pair, sql):
    jeng, peng = sparse_pair
    _same_answer(jeng, peng, sql)
    assert peng.runner.last_metrics["route"] == "sparse"


def test_sparse_budget_raises(sparse_pair):
    """Past sparse_group_budget the sparse route raises
    UnsupportedAggregation, and the engine serves the query from the
    fallback interpreter with the JAX package's reason and answer
    (integers exact)."""
    jeng = jax_sparse_tests._engine(sparse_group_budget=64)
    peng = cpu_engine(dense_group_budget=64,
                  sparse_group_budget=64)
    peng.register_table("t", jax_sparse_tests._df(), time_column="ts",
                        block_rows=512)
    got = peng.sql(jax_sparse_tests.SQL)
    want = jeng.sql(jax_sparse_tests.SQL)
    assert peng.runner.last_metrics["route"] == "fallback"
    assert "sparse budget" in peng.last_plan.fallback_reason
    assert peng.last_plan.fallback_reason == jeng.last_plan.fallback_reason
    assert_frame_parity(got, want)


THETA_SQL = [s for _, s in sql_of(jax_theta_tests) if "FROM events" in s] \
    + [f"SELECT {e} AS x FROM events" for _, e in
       sql_of(jax_theta_tests, starts=("theta_sketch",)) if "(" in e]


@pytest.fixture(scope="module")
def theta_pair(theta_setup):
    jeng, df = theta_setup
    peng = cpu_engine()
    peng.register_table("events", df, time_column="ts")
    return jeng, peng


@pytest.mark.parametrize("sql", THETA_SQL)
def test_jax_theta_setop_sql(theta_pair, sql):
    jeng, peng = theta_pair
    _same_answer(jeng, peng, sql)


SETOPS = [
    [_setop("both", "INTERSECT", "buyers", "viewers")],
    [_setop("any", "UNION", "buyers", "sharers"),
     _setop("only", "NOT", "buyers", "viewers"),
     {"type": "arithmetic", "name": "ratio", "fn": "/",
      "fields": [{"type": "fieldAccess", "fieldName": "any"},
                 {"type": "fieldAccess", "fieldName": "only"}]}],
]


@pytest.mark.parametrize("dims", [(), ("device",)])
@pytest.mark.parametrize("post", SETOPS)
def test_theta_setop_ir_matches_jax(theta_pair, post, dims):
    """Druid-JSON set-op queries built with the JAX tests' helpers, as a
    timeseries and grouped: the rows agree exactly (every sketch is below
    its k, so the estimates are exact counts)."""
    jeng, peng = theta_pair
    q = {"queryType": "groupBy" if dims else "timeseries",
         "dataSource": "events", "granularity": "all",
         "intervals": ["2024-01-01/2025-01-01"],
         "aggregations": [_theta("buyers", "buy"), _theta("viewers", "view"),
                          _theta("sharers", "share")],
         "postAggregations": post}
    if dims:
        q["dimensions"] = list(dims)
    want, got = jeng.execute_ir(q).rows, peng.execute_ir(q).rows
    assert peng.runner.last_metrics["route"] == "unpacked"
    assert got == want and len(got) == (2 if dims else 1)


def test_sketch_state_budget_routes_to_sparse(sparse_pair):
    """A grouped theta query whose [groups x k] state passes
    dense_sketch_state_budget takes the sparse path, its sketch width
    clamped to sparse_theta_k_cap, on both engines."""
    sql = "SELECT a, theta_sketch(v) AS d, count(*) AS n FROM t GROUP BY a"
    kw = dict(dense_sketch_state_budget=1 << 16)
    jeng = JaxEngine(JaxConfig(**kw))
    peng = cpu_engine(**kw)
    df = jax_sparse_tests._df()
    for e in (jeng, peng):
        e.register_table("t", df, time_column="ts", block_rows=512)
    plan = _lowered(peng, sql)
    assert plan.sparse and plan.total_groups <= peng.config.dense_group_budget
    assert [p.theta_k for p in plan.agg_plans if p.kind == "theta"] == \
        [peng.config.sparse_theta_k_cap]
    got = peng.sql(sql)
    assert peng.runner.last_metrics["route"] == "sparse"
    assert_frame_parity(got, jeng.sql(sql), float_rtol=EST_RTOL)
    ref = df.groupby("a").v.nunique()
    assert [int(x) for x in got.sort_values("a")["d"]] == \
        [int(ref[a]) for a in sorted(ref.index)]


def test_sparse_keys_are_sorted_and_compact(ssb_pair):
    """Slot i holds the i-th smallest present key; SENTINEL fills the
    tail."""
    _, peng, _, _ = ssb_pair
    out = peng.runner._run_sparse(
        _lowered(peng, ssb.DISTINCT_QUERIES["x4"]), {})
    keys = out["_keys"]
    n = int(out["_count"])
    assert (np.diff(keys[:n]) > 0).all() and (keys[n:] == SENTINEL).all()
    assert pd.Series(out["_rows"][:n]).gt(0).all()

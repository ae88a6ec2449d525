"""The PyTorch port's fallback interpreter and its routing
(tpu_olap_torch, on the CPU) against the JAX package.

Every SQL statement of tests/test_tpch.py (read from that file) runs
through the port's Engine on the CPU (`_torch_port.cpu_engine`) on
the test's own `_olps` data (12,000 rows): the port's `rewritten` flag
must equal the JAX planner's for the same SQL, and its frame must equal
the JAX package's answer. The JAX side is its pandas fallback, as the JAX test's
own `_check` takes it (its planner's subquery hook runs the inner
statements in that fallback too, so no jit is needed). Tolerances: the
parity harness — integers and strings exact, floats at rtol 1e-9, and
the columns the JAX test marks approximate (Q8's share, Q16's HLL
count) in its approximate band (rtol 0.12). Then ROLLUP, CUBE and
GROUPING SETS through the union of device legs, a GroupBy past
`sparse_group_budget`, a plain table, and the rule that a failure on
the device path propagates instead of rerouting to the fallback.
"""

import re

import pandas as pd
import pytest

import test_sql_margins as jax_margins_tests
import test_tpch as jax_tpch_tests
from tpu_olap import Engine as JaxEngine
from tpu_olap.bench.parity import pure_config as jax_pure_config
from tpu_olap.catalog.star import StarDimension as JaxStarDimension
from tpu_olap.catalog.star import StarSchema as JaxStarSchema
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.planner.fallback import execute_fallback as jax_fallback
from tpu_olap.planner.fallback import \
    grouping_set_legs as jax_grouping_set_legs
from tpu_olap_torch.bench import assert_frame_parity
from tpu_olap_torch.bench import tpch as port_tpch
from tpu_olap_torch.planner import fallback as port_fallback

from _torch_port import cpu_engine, sql_literals

TPCH_SQL = sql_literals(jax_tpch_tests, starts=("SELECT", "WITH"))
APPROX = ("share", "supplier_cnt")
GROUPING_SQL = [s for _, s in sql_literals(jax_margins_tests)
                if re.search(r"GROUP BY (ROLLUP|CUBE|GROUPING SETS)", s)]


def _jax_star():
    return JaxStarSchema(fact="olps", dimensions=tuple(
        JaxStarDimension(f"{side}_nat", fact_key=f"{side}_nation",
                         dim_key="n_name",
                         column_map={"n_name": f"{side}_nation",
                                     "n_region": f"{side}_region"})
        for side in ("s", "c")))


def _register_jax_olps(engine):
    engine.register_table("olps", jax_tpch_tests._olps(),
                          time_column="o_orderdate", star_schema=_jax_star(),
                          block_rows=2048)
    engine.register_table("s_nat", jax_tpch_tests._nation_dim(),
                          accelerate=False)
    engine.register_table("c_nat", jax_tpch_tests._nation_dim(),
                          accelerate=False)
    return engine


def _jax_fallback_only(engine):
    """The JAX planner with its subquery hook on the pure pandas
    fallback: its rewrite decisions, with no device execution."""
    cfg = jax_pure_config(engine.config)
    engine.planner.run_subquery = \
        lambda stmt: jax_fallback(stmt, engine.catalog, cfg)
    return engine


@pytest.fixture(scope="module")
def tpch():
    jeng = _jax_fallback_only(_register_jax_olps(
        JaxEngine(JaxConfig())))
    peng = cpu_engine()
    port_tpch.register_olps(peng, port_tpch.olps_frame(), block_rows=2048)
    return jeng, peng


def test_port_workload_is_the_jax_tests():
    """bench.tpch copies the JAX test suite's data recipe and its 25
    statements (whitespace aside), in order."""
    pd.testing.assert_frame_equal(port_tpch.olps_frame(),
                                  jax_tpch_tests._olps())
    pd.testing.assert_frame_equal(port_tpch.nation_dim(),
                                  jax_tpch_tests._nation_dim())
    assert [" ".join(sql.split()) for _, sql in port_tpch.QUERIES.values()] \
        == [" ".join(sql.split()) for _, sql in TPCH_SQL]


def _jax_answer(jeng, sql):
    plan = jeng.planner.plan(sql)
    return plan.rewritten, jax_fallback(plan.stmt, jeng.catalog,
                                        jax_pure_config(jeng.config))


@pytest.mark.parametrize("name, sql", TPCH_SQL,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(TPCH_SQL)])
def test_tpch_shape_matches_jax(tpch, name, sql):
    jeng, peng = tpch
    rewritten, want = _jax_answer(jeng, sql)
    got = peng.sql(sql)
    plan, metrics = peng.last_plan, peng.runner.last_metrics
    assert plan.rewritten == rewritten, plan.fallback_reason
    # the path bench.tpch (and the chip smoke) expects for the shape
    expected = {" ".join(q.split()): rw
                for rw, q in port_tpch.QUERIES.values()}
    assert expected[" ".join(sql.split())] == rewritten
    if name in ("test_q11_having_scalar_subquery",
                "test_q18_in_aggregating_subquery"):
        # the uncorrelated subquery ran first through the engine, on the
        # device path, and its result inlined
        assert [n["route"] for n in metrics["nested"]] == ["packed"]
    if rewritten:
        assert metrics["route"] == "packed"
    else:
        assert metrics["route"] == "fallback"
        assert metrics["fallback_reason"] == plan.fallback_reason
        assert plan.fallback_reason
    assert_frame_parity(got, want, approx_cols=APPROX, label=name)


@pytest.mark.parametrize("name", ["q11 scaled", "q18 scaled"])
def test_scaled_subqueries_match_jax(tpch, name):
    """Q11 and Q18 with their subqueries' literals set from the data
    (bench.tpch.scaled_subqueries, as the chip smoke runs them at
    6,001,215 rows): the inner statement runs on the device path and
    inlines, the outer one keeps some brands and not all, and the frame
    equals the JAX package's answer (parity harness: exact)."""
    jeng, peng = tpch
    df = port_tpch.olps_frame()
    by = df.groupby("p_brand")
    sql = port_tpch.scaled_subqueries(by.l_extendedprice.sum(),
                                      by.l_quantity.sum())[name][1]
    rewritten, want = _jax_answer(jeng, sql)
    got = peng.sql(sql)
    assert rewritten and peng.last_plan.rewritten
    assert [n["route"] for n in peng.runner.last_metrics["nested"]] == \
        ["packed"]
    assert 0 < len(got) < df.p_brand.nunique()
    assert_frame_parity(got, want, label=name)


@pytest.fixture(scope="module")
def margins():
    """tests/test_sql_margins.py's `eng` fact (seed 17, 500 rows) in the
    port, and a JAX engine over the same frame for its fallback."""
    jeng, fact, _ = jax_margins_tests.eng.__wrapped__()
    peng = cpu_engine()
    peng.register_table("fact", fact, time_column="ts")
    return jeng, peng


@pytest.mark.parametrize("sql", GROUPING_SQL)
def test_grouping_sets_union_matches_jax(margins, sql):
    """Each leg takes the route the JAX planner gives it (a global
    aggregate with HAVING is a fallback leg there too); the union equals
    the JAX package's whole-statement fallback."""
    jeng, peng = margins
    got = peng.sql(sql)
    m = peng.runner.last_metrics
    assert m["route"] == "grouping_sets"
    stmt = jeng.planner.plan(sql).stmt
    rewritten = [jeng.planner.plan_stmt(leg).rewritten
                 for leg, _ in jax_grouping_set_legs(stmt)[1]]
    assert [leg["route"] for leg in m["legs"]] == \
        ["packed" if rw else "fallback" for rw in rewritten]
    assert (peng.last_plan.fallback_reason is None) == all(rewritten)
    want = jax_fallback(stmt, jeng.catalog, jeng.config)
    assert_frame_parity(got, want, ordered="ORDER BY" in sql, label=sql)


def test_sparse_budget_served_by_fallback(tpch):
    """A GroupBy past sparse_group_budget: the sparse route raises
    UnsupportedAggregation and the fallback serves the query, with the
    JAX package's reason and answer."""
    sql = ("SELECT p_brand, s_nation, c_nation, sum(l_quantity) AS q "
           "FROM olps GROUP BY p_brand, s_nation, c_nation")
    budgets = dict(dense_group_budget=64, sparse_group_budget=64)
    jeng = _register_jax_olps(JaxEngine(JaxConfig(**budgets)))
    peng = cpu_engine(**budgets)
    port_tpch.register_olps(peng, port_tpch.olps_frame(), block_rows=2048)
    want = jeng.sql(sql)
    got = peng.sql(sql)
    assert peng.runner.last_metrics["route"] == "fallback"
    assert "sparse budget" in peng.last_plan.fallback_reason
    assert peng.last_plan.fallback_reason == jeng.last_plan.fallback_reason
    assert_frame_parity(got, want)


def test_plain_table_served_by_fallback(tpch):
    jeng, peng = tpch
    sql = ("SELECT n_region, count(*) AS n FROM s_nat GROUP BY n_region "
           "ORDER BY n_region")
    rewritten, want = _jax_answer(jeng, sql)
    got = peng.sql(sql)
    assert not rewritten and not peng.last_plan.rewritten
    assert "not druid-backed" in peng.last_plan.fallback_reason
    assert peng.runner.last_metrics["route"] == "fallback"
    assert_frame_parity(got, want, ordered=True)


@pytest.mark.parametrize("name", ["test_q1_pricing_summary",
                                  "test_q11_having_scalar_subquery",
                                  "test_q13_count_distribution"])
def test_device_failure_propagates(tpch, monkeypatch, name):
    """With fallback_on_device_failure off, a failure in runner.execute
    (here a RuntimeError standing for a launch or NVRTC error that
    outlived the retries) reaches the caller of Engine.sql — for a
    rewritten statement, an inlined subquery and a derived table alike —
    and the fallback interpreter never runs the whole statement. With it
    on (the default, as in the JAX package), the interpreter serves the
    statement and the metrics say why."""
    _, peng = tpch
    sql = dict(TPCH_SQL)[name]
    want = peng.sql(sql)
    monkeypatch.setattr(peng.config, "fallback_on_device_failure", False)

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: launch failed")

    served = []
    real = port_fallback.execute_fallback

    def spy(stmt, *a, **kw):
        served.append(stmt)
        return real(stmt, *a, **kw)

    monkeypatch.setattr(peng.runner, "execute", broken)
    monkeypatch.setattr("tpu_olap_torch.api.engine.execute_fallback", spy)
    with pytest.raises(RuntimeError, match="launch failed"):
        peng.sql(sql)
    # Q13's outer statement is not rewritten, so the fallback runs it by
    # its shape; the failure of its derived body on the device path
    # propagates out of it
    assert len(served) == (name == "test_q13_count_distribution")
    monkeypatch.setattr(peng.config, "fallback_on_device_failure", True)
    got = peng.sql(sql)
    assert_frame_parity(got, want, ordered=True)
    if name != "test_q13_count_distribution":
        m = peng.runner.last_metrics
        assert m["route"] == "fallback" and m["path"] == "fallback"
        assert peng.last_plan.fallback_reason.startswith(
            "device failure: RuntimeError")

"""Search, TimeBoundary, SegmentMetadata, EXPLAIN, select_page and the
statement verbs of the PyTorch port (tpu_olap_torch, on the CPU) against
the JAX package, and `kernels.topk.top_k_groups` against the JAX
function.

Both packages serve the same segments (the JAX ingest carried into the
port), so results compare exactly: `QueryResult.rows` and `.druid`, or
the verbs' frames. The cases mirror the JAX package's own
(tests/test_executor.py, tests/test_sql_extended.py,
tests/test_planner.py, tests/test_api_surface.py, tests/test_kernels.py)
and add each search sort, the case-sensitive and fragment matchers, and
a numeric search dimension. A numeric dimension is where the two
packages part: the JAX runner hands the raw number to the matcher,
which raises; the port matches and reports its string form
(Druid's), held here against pandas.
"""

import json

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.executor import QueryRunner as JaxRunner
from tpu_olap.ir import serde as jax_serde
from tpu_olap.kernels.topk import top_k_groups as jax_top_k_groups
from tpu_olap_torch.executor import EngineConfig, QueryRunner
from tpu_olap_torch.ir.serde import query_from_json
from tpu_olap_torch.kernels.topk import top_k_groups
from tpu_olap_torch.segments.carry import carry_table

from _torch_port import carry_into, cpu_engine, export_segments
from test_executor import DF, TABLE
from test_sql_extended import _df as sql_extended_df


@pytest.fixture(scope="module")
def runners():
    """JAX and port runners over test_executor's table, carried across."""
    return (JaxRunner(JaxConfig(platform="cpu")),
            QueryRunner(EngineConfig(device="cpu")),
            carry_table(**export_segments(TABLE)))


def _both(spec):
    spec = dict(spec, dataSource="t")
    return jax_serde.query_from_json(spec), query_from_json(spec)


def _search(value, dims=("city", "kind"), sort="lexicographic", **kw):
    q = {"type": "contains" if kw.pop("case", False)
         else "insensitive_contains", "value": value}
    if "fragments" in kw:
        q = {"type": "fragment", "values": kw.pop("fragments"),
             "caseSensitive": kw.pop("fragment_case", False)}
    return {"queryType": "search", "searchDimensions": list(dims),
            "query": q, "sort": {"type": sort}, **kw}


SEARCHES = {
    # test_executor.py::test_search
    "contains": _search("am", limit=10),
    "all_dims": _search("A", dims=()),
    "case_sensitive": _search("A", case=True),
    "case_sensitive_lower": _search("a", case=True),
    "fragment": _search("", fragments=["b", "a"]),
    "fragment_case": _search("", fragments=["B"], fragment_case=True),
    "strlen": _search("", sort="strlen"),
    "alphanumeric": _search("", sort="alphanumeric"),
    "limit": _search("", limit=2),
    "filter_interval": _search(
        "a", filter={"type": "bound", "dimension": "qty", "upper": "20",
                     "ordering": "numeric"},
        intervals=["1993-04-01/1993-09-01"]),
}
METADATA = {
    # test_executor.py::test_time_boundary, and its bounds in an interval
    "time_boundary": {"queryType": "timeBoundary"},
    "min_time": {"queryType": "timeBoundary", "bound": "minTime",
                 "intervals": ["1993-06-01/1994-02-01"]},
    "max_time": {"queryType": "timeBoundary", "bound": "maxTime",
                 "intervals": ["1993-06-01/1994-02-01"]},
    # test_executor.py::test_segment_metadata, and a toInclude list
    "segment_metadata": {"queryType": "segmentMetadata"},
    "segment_metadata_some": {"queryType": "segmentMetadata",
                              "toInclude": {"type": "list",
                                            "columns": ["city", "qty"]}},
}


@pytest.mark.parametrize("case", list(SEARCHES) + list(METADATA))
def test_query_matches_jax(runners, case):
    jax_runner, runner, table = runners
    jq, q = _both({**SEARCHES, **METADATA}[case])
    want = jax_runner.execute(jq, TABLE)
    got = runner.execute(q, table)
    assert got.rows == want.rows
    assert got.druid == want.druid
    m = runner.last_metrics
    if case in SEARCHES:
        # the table's values are lower case: an upper-case needle finds
        # nothing when case matters
        assert (len(got.rows) > 0) == (case not in ("case_sensitive",
                                                    "fragment_case"))
        assert m["route"] == "mask" and m["host_copies"] == 1
        assert m["mask_kernel"]
    else:
        assert m["host_copies"] == 0


def test_search_counts_match_pandas(runners):
    """test_executor.py's pandas check, on the port."""
    _, runner, table = runners
    res = runner.execute(_both(SEARCHES["contains"])[1], table)
    counts = {h["value"]: h["count"] for h in res.rows}
    assert counts["amsterdam"] == (DF.city == "amsterdam").sum()
    assert all("am" in h["value"] for h in res.rows)


def test_metadata_matches_table(runners):
    """test_executor.py's time-boundary and segment-metadata checks."""
    from tpu_olap_torch.utils import timeutil as tu
    _, runner, table = runners
    rec = runner.execute(_both(METADATA["segment_metadata"])[1],
                         table).rows[0]
    assert rec["numRows"] == len(DF)
    assert rec["columns"]["city"]["cardinality"] == 3
    tb = runner.execute(_both(METADATA["time_boundary"])[1], table).rows[0]
    t0, t1 = TABLE.time_boundary
    assert tb == {"minTime": tu.millis_to_iso(t0),
                  "maxTime": tu.millis_to_iso(t1)}


def test_numeric_search_dimension_matches_pandas(runners):
    """A numeric dimension runs a GroupBy of its own (the fused reduce's
    route on a card): its values match as strings and count like
    pandas, next to a coded dimension's."""
    _, runner, table = runners
    q = query_from_json(dict(_search("199", dims=("year_col", "city")),
                             dataSource="t"))
    res = runner.execute(q, table)
    want = [{"dimension": "year_col", "value": str(y), "count": int(n)}
            for y, n in sorted(DF.year_col.value_counts().items())]
    assert res.rows == want
    m = runner.last_metrics
    assert m["host_copies"] == 1 + 1     # the coded half, the GroupBy
    assert m["numeric_dims"]["year_col"]["route"] == "packed"
    # the JAX runner raises on the same query (TypeError, or
    # AttributeError from the case-insensitive matcher's lower())
    jq = jax_serde.query_from_json(dict(_search("199", dims=("year_col",)),
                                        dataSource="t"))
    with pytest.raises((TypeError, AttributeError)):
        JaxRunner(JaxConfig(platform="cpu")).execute(jq, TABLE)


def test_search_padded_shard_mask(runners):
    """test_executor.py::test_search_padded_shard_mask: the JAX runner
    pads its mask to 8 shards; the port's mask covers the 5 segments."""
    _, runner, table = runners
    spec = {"queryType": "search", "searchDimensions": ["city"],
            "query": {"type": "insensitive_contains", "value": "am"}}
    jq, q = _both(spec)
    want = JaxRunner(JaxConfig(platform="device", num_shards=8)) \
        .execute(jq, TABLE)
    got = runner.execute(q, table)
    assert got.rows == want.rows and got.druid == want.druid
    counts = {h["value"]: h["count"] for h in got.rows}
    assert counts["amsterdam"] == (DF.city == "amsterdam").sum()


# ------------------------------------------------- engine: verbs and API


@pytest.fixture(scope="module")
def engines():
    """test_sql_extended.py's engine (table t plus a plain dim table) in
    both packages, the port's t carried across."""
    df = sql_extended_df()
    dim = pd.DataFrame({"d_city": [f"c{i}" for i in range(6)],
                        "d_zone": ["west" if i < 3 else "east"
                                   for i in range(6)]})
    jax = JaxEngine()
    jax.register_table("t", df, time_column="ts")
    jax.register_table("dim", dim, accelerate=False)
    port = cpu_engine()
    carry_into(port, jax, "t")
    port.register_table("dim", dim, accelerate=False)
    return jax, port, df


VERBS = {
    # test_sql_extended.py::test_search_verb
    "search_verb": "SEARCH DRUID DATASOURCE t FOR 'c1' IN city, g LIMIT 10",
    "search_verb_all": "SEARCH DRUID DATASOURCE t FOR 'C'",
    "search_verb_quote": "SEARCH DRUID DATASOURCE t FOR 'c''x'",
    "passthrough_scan": "ON DRUID DATASOURCE t EXECUTE QUERY '" + json.dumps(
        {"queryType": "scan", "columns": ["g", "v"], "limit": 12,
         "filter": {"type": "selector", "dimension": "city",
                    "value": "c3"}}) + "'",
    # test_api_surface.py::test_passthrough_verb's shape
    "passthrough_timeseries": "ON DRUID DATASOURCE t EXECUTE QUERY '"
    + json.dumps({"queryType": "timeseries", "granularity": "all",
                  "aggregations": [{"type": "longSum", "name": "s",
                                    "fieldName": "v"}]}) + "'",
    "passthrough_time_boundary": "on druid datasource t execute query "
                                 "'{\"queryType\": \"timeBoundary\"}';",
    "explain_scan": "EXPLAIN DRUID REWRITE SELECT g, v FROM t "
                    "WHERE city = 'c2' LIMIT 4",
    "explain_fallback": "EXPLAIN DRUID REWRITE SELECT count(*) AS n "
                        "FROM dim",
    "clear_table": "CLEAR DRUID CACHE t",
    "clear_all": "clear druid cache;",
}


@pytest.mark.parametrize("name", list(VERBS))
def test_verb_matches_jax(engines, name):
    jax, port, _ = engines
    want = jax.sql(VERBS[name])
    got = port.sql(VERBS[name])
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    if name.startswith("search_verb"):
        assert list(got.columns) == ["dimension", "value", "count"] or \
            len(got) == 0


def test_search_verb_counts_like_pandas(engines):
    """test_sql_extended.py::test_search_verb's checks, on the port."""
    _, port, df = engines
    got = port.sql(VERBS["search_verb"])
    assert list(got.columns) == ["dimension", "value", "count"]
    assert set(got["value"]) == {"c1"}
    assert int(got["count"][0]) == int((df.city == "c1").sum())


def test_clear_cache_drops_resident_columns(engines):
    """test_api_surface.py::test_clear_cache_verb on the port, and the
    query after a clear re-uploads and answers the same."""
    _, port, _ = engines
    sql = "SELECT g, v FROM t WHERE city = 'c4' LIMIT 25"
    before = port.sql(sql)
    assert port.runner._datasets and port.runner._plan_cache
    assert port.sql("CLEAR DRUID CACHE").status[0] == "cleared cache"
    assert not port.runner._datasets and not port.runner._plan_cache
    pd.testing.assert_frame_equal(port.sql(sql), before, check_exact=True)
    assert "t" in port.sql("CLEAR DRUID CACHE t").status[0]
    assert not port.runner._datasets


def test_explain_matches_jax(engines):
    """test_planner.py::test_explain_shapes and test_scan_plan on the
    port: EXPLAIN equals the JAX package's, the cost model's decision
    ("cost", on aggregate plans) included but for its time estimates,
    which each package takes from its own device's constants."""
    jax, port, _ = engines
    for sql, kind in (("SELECT count(*) AS n FROM t", "timeseries"),
                      ("SELECT g, sum(v) AS s FROM t GROUP BY g",
                       "groupBy"),
                      ("SELECT city, v FROM t WHERE g = 'a' LIMIT 7",
                       "scan"),
                      ("SELECT count(*) AS n FROM dim", None)):
        got = port.explain(sql)
        want = jax.explain(sql)
        got_cost, want_cost = got.pop("cost", None), want.pop("cost", None)
        assert (got_cost is None) == (want_cost is None) \
            == (kind not in ("timeseries", "groupBy"))
        if got_cost is not None:
            for k in ("scanUs", "mergeUs"):
                got_cost.pop(k)
                want_cost.pop(k)
            assert got_cost == want_cost
        assert got == want
        if kind is None:
            assert not got["rewritten"] and "reason" in got
        else:
            assert got["rewritten"] and got["query"]["queryType"] == kind
    assert port.explain("SELECT city, v FROM t LIMIT 7")["query"]["limit"] \
        == 7


def test_select_page_matches_jax(engines):
    """test_sql_extended.py::test_select_page_api, against the JAX
    engine's pages."""
    jax, port, _ = engines
    off = 0
    for _ in range(3):
        want = jax.select_page("t", columns=("city",), page_size=7,
                               offset=off)
        got = port.select_page("t", columns=("city",), page_size=7,
                               offset=off)
        assert got == want and got[1] == off + 7
        off = got[1]
    want = jax.select_page("t", page_size=5, descending=True)
    assert port.select_page("t", page_size=5, descending=True) == want


def test_sql_scan_with_nothing_ported_missing(engines):
    """The non-aggregate statement that raised before this slice."""
    jax, port, _ = engines
    sql = "SELECT g, v FROM t WHERE v < 40 LIMIT 5"
    pd.testing.assert_frame_equal(port.sql(sql), jax.sql(sql),
                                  check_exact=True)


@pytest.mark.parametrize("sql, item", [
    ("INSERT INTO t (g, v) VALUES ('a', 1)", "item 12"),
    ("COMPACT DRUID TABLE t", "item 12"),
    ("CHECKPOINT DRUID TABLE t", "item 12"),
    ("EXPLAIN ANALYZE SELECT count(*) AS n FROM t", "item 14"),
])
def test_unported_verbs_raise(engines, sql, item):
    """The verbs the port once refused answer as the JAX package
    does. EXPLAIN ANALYZE (item 14's tracer) runs the statement in both
    packages and returns its span tree: the same columns, the same root
    and the same spans under it. The ingest verbs of item 12: on fresh
    engines over the same table they answer (or refuse) as the JAX
    package does."""
    jax, port, df = engines
    if item != "item 12":
        want, got = jax.sql(sql), port.sql(sql)
        assert list(got.columns) == list(want.columns) == \
            ["span", "ms", "detail"]

        def top(frame):   # the root and its children (depth <= 1)
            return [s for s in frame["span"] if not s.startswith("    ")]
        assert top(got) == top(want) == \
            ["sql", "  parse", "  plan", "  execute", "  render"]
        assert json.loads(got["detail"][0])["rows_returned"] == 1
        return
    jax = JaxEngine(JaxConfig(ingest_auto_compact=False))
    fresh = cpu_engine(ingest_auto_compact=False)
    answers = []
    for eng in (jax, fresh):
        eng.register_table("t", df, time_column="ts")
        try:
            answers.append(eng.sql(sql))
        except Exception as e:  # noqa: BLE001 — compared below
            answers.append(e)
        eng.close()
    want, got = answers
    if isinstance(want, Exception):
        assert type(got).__name__ == type(want).__name__
        assert str(got) == str(want)
        return
    skip = {"generation", "ms"}
    assert list(got.columns) == list(want.columns)
    cols = [c for c in want.columns if c not in skip]
    pd.testing.assert_frame_equal(got[cols], want[cols])


@pytest.mark.parametrize("sql, status", [
    ("CREATE DRUID CUBE c1 ON t DIMENSIONS (g) AGGREGATES (sum(v))",
     ["ready"]),
    ("REFRESH DRUID CUBES", []),
    ("DROP DRUID CUBE c1", ["dropped"]),
])
def test_cube_verbs_are_ported(engines, sql, status):
    """The cube DDL, which raised NotYetPorted before the caches and
    cubes slice, answers as the JAX package's does."""
    jax, port, _ = engines
    got = port.sql(sql)
    assert list(got["status"]) == status
    pd.testing.assert_frame_equal(got.drop(columns="detail"),
                                  jax.sql(sql).drop(columns="detail"))


# --------------------------------------------------------------- top-k


@pytest.mark.parametrize("inverted", [False, True])
@pytest.mark.parametrize("threshold", [0, 1, 3, 5, 40])
@pytest.mark.parametrize("seed", [0, 1])
def test_top_k_groups_matches_jax(seed, threshold, inverted):
    """Ties (a small value range) and absent groups included: the same
    group ids in the same order as the JAX function, and the same
    validity."""
    rng = np.random.default_rng(seed)
    metric = rng.integers(-4, 5, 29).astype(np.float64)
    present = rng.random(29) < 0.7
    want = jax_top_k_groups(jnp.asarray(metric), jnp.asarray(present),
                            threshold, inverted, jnp)
    got = top_k_groups(torch.from_numpy(metric), torch.from_numpy(present),
                       threshold, inverted)
    assert got[0].tolist() == np.asarray(want[0]).tolist()
    assert got[1].tolist() == np.asarray(want[1]).tolist()


def test_top_k_groups_jax_case():
    """tests/test_kernels.py::test_top_k on the port."""
    metric = torch.tensor([5.0, 1.0, 9.0, 7.0, 3.0])
    present = torch.tensor([True, True, True, False, True])
    assert top_k_groups(metric, present, 3, False)[0].tolist() == [2, 0, 4]
    assert top_k_groups(metric, present, 3, True)[0].tolist() == [1, 4, 0]
    assert int(top_k_groups(metric, present, 5, False)[1].sum()) == 4

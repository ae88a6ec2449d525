"""The PyTorch port's engine (tpu_olap_torch, on the CPU) against the JAX
package, end to end through Engine.sql and Engine.execute_ir.

Inputs are made once from a seed and handed to both packages. The JAX
side runs B1 in Pallas interpret mode (use_pallas="force") and the XLA
generic reduce ("never"); the port runs its generic torch reduce (the
default on the CPU) and its fused reduce's plain version ("force").
Frames compare with the parity harness: integers and strings exact,
floats at the harness's rtol 1e-9 (summation order differs).
"""

import numpy as np
import pytest
import torch

from tpu_olap import Engine as JaxEngine
from tpu_olap.bench import ssb as jax_ssb
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap_torch import Engine
from tpu_olap_torch.bench import assert_frame_parity, ssb

from _torch_port import carry_into, cpu_engine
from test_pallas_reduce import (COLCMP_QUERIES, MINMAX_QUERIES,
                                PRECOMPUTED_DIM_QUERIES, WIDENED_QUERIES)
from test_pallas_reduce import QUERIES as PALLAS_QUERIES
from test_pallas_reduce import _table as pallas_table


@pytest.fixture(scope="module")
def ssb_engines():
    tables = jax_ssb.generate_tables(60_000, 0)
    out = {}
    for mode in ("force", "never"):
        e = JaxEngine(JaxConfig(use_pallas=mode))
        jax_ssb.register_ssb(e, tables=tables, block_rows=8192)
        out[("jax", mode)] = e
    for mode in ("auto", "force"):
        e = cpu_engine(use_fused_reduce=mode)
        ssb.register_ssb(e, tables=tables, block_rows=8192)
        out[("port", mode)] = e
    carried = cpu_engine()
    carry_into(carried, out[("jax", "never")], "lineorder",
               ssb.star_schema())
    out["carried"] = carried
    out["frames"] = {}  # JAX results, computed once per (mode, query)
    return out


@pytest.fixture(scope="module")
def t_engines():
    df = pallas_table()
    out = {}
    for mode in ("force", "never"):
        e = JaxEngine(JaxConfig(use_pallas=mode))
        e.register_table("t", df, time_column="ts", block_rows=512)
        out[("jax", mode)] = e
    for mode in ("auto", "force"):
        e = cpu_engine(use_fused_reduce=mode)
        e.register_table("t", df, time_column="ts", block_rows=512)
        out[("port", mode)] = e
    return out


@pytest.mark.parametrize("port_mode", ["auto", "force"])
@pytest.mark.parametrize("jax_mode", ["force", "never"])
@pytest.mark.parametrize("name", list(ssb.QUERIES))
def test_ssb_matches_jax(ssb_engines, name, jax_mode, port_mode):
    sql = ssb.QUERIES[name]
    port = ssb_engines[("port", port_mode)]
    got = port.sql(sql)
    assert port.runner.last_metrics["fused"] == (port_mode == "force")
    frames = ssb_engines["frames"]
    if (jax_mode, name) not in frames:
        frames[(jax_mode, name)] = ssb_engines[("jax", jax_mode)].sql(sql)
    want = frames[(jax_mode, name)]
    assert len(got) > 0
    assert_frame_parity(got, want, label=name)


@pytest.mark.parametrize("name", list(ssb.QUERIES))
def test_carried_segments_answer_like_own_ingest(ssb_engines, name):
    """The JAX ingest carried across serves every query exactly like the
    port's own ingest of the same data."""
    sql = ssb.QUERIES[name]
    got = ssb_engines["carried"].sql(sql)
    want = ssb_engines[("port", "auto")].sql(sql)
    assert_frame_parity(got, want, ordered=True, label=name)


@pytest.mark.parametrize("jax_mode", ["force", "never"])
@pytest.mark.parametrize("sql", PALLAS_QUERIES + MINMAX_QUERIES)
def test_nullable_table_matches_jax(t_engines, sql, jax_mode):
    want = t_engines[("jax", jax_mode)].sql(sql)
    for port_mode in ("auto", "force"):
        got = t_engines[("port", port_mode)].sql(sql)
        assert_frame_parity(got, want)


@pytest.mark.parametrize(
    "sql", WIDENED_QUERIES + PRECOMPUTED_DIM_QUERIES + COLCMP_QUERIES)
def test_time_dims_and_colcmp_match_jax(t_engines, sql):
    """Buckets, interval masks, remap/timeformat dims and columnComparison
    (the port's timebucket, dimplan and filter-stream paths) against the
    JAX package's generic reduce."""
    want = t_engines[("jax", "never")].sql(sql)
    for port_mode in ("auto", "force"):
        assert_frame_parity(t_engines[("port", port_mode)].sql(sql), want)


def _timeseries(granularity, interval):
    return {
        "queryType": "timeseries", "dataSource": "t",
        "granularity": granularity, "intervals": [interval],
        "filter": {"type": "in", "dimension": "region",
                   "values": ["r1", "r2", "r7"]},
        "aggregations": [
            {"type": "longSum", "name": "s", "fieldName": "price"},
            {"type": "count", "name": "n"},
            {"type": "longMax", "name": "mx", "fieldName": "qty"}],
    }


@pytest.mark.parametrize("granularity,interval", [
    ("day", "2020-01-03T06:00:00/2020-02-11"),
    ("month", "2020-01-01/2020-07-01"),
])
def test_execute_ir_timeseries_matches_jax(t_engines, granularity,
                                           interval):
    q = _timeseries(granularity, interval)
    want = t_engines[("jax", "never")].execute_ir(q).rows
    for port_mode in ("auto", "force"):
        got = t_engines[("port", port_mode)].execute_ir(q).rows
        assert len(got) == len(want) > 1
        assert got == want


def test_unrewritten_statement_raises(t_engines):
    """A statement the planner does not rewrite (a UNION) is served by
    the fallback interpreter, equal to the JAX package's answer."""
    sql = "SELECT color FROM t UNION SELECT region FROM t"
    port = t_engines[("port", "auto")]
    got = port.sql(sql)
    assert not port.last_plan.rewritten
    assert port.runner.last_metrics["route"] == "fallback"
    want = t_engines[("jax", "never")].sql(sql)
    assert_frame_parity(got, want)


def test_cuda_engine_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine()


def test_port_results_are_exact_integers(ssb_engines):
    """q4.x sums go negative-capable (revenue - supplycost): the port's
    result is an exact integer, not a float approximation."""
    got = ssb_engines[("port", "force")].sql(ssb.QUERIES["q4.1"])
    assert np.issubdtype(got["profit"].dtype, np.integer)

"""Parquet streaming ingest and the chunked fallback of the PyTorch port
(tpu_olap_torch, on the CPU) against the JAX package.

One seeded multi-file parquet dataset (tests/test_chunked_fallback.py's
`_write_dataset`: three files of 512-row row groups, a time column,
dictionary strings with nulls, a nullable integer column) is ingested by
both packages. Tolerances: segments (block boundaries, codes,
dictionaries, null masks, the manifest) equal exactly, dtypes included;
query frames by the parity harness, integers and strings exact and
floats at its rtol 1e-9; the chunked fallback against the whole-frame
fallback with `pd.testing.assert_frame_equal` (values exact, dtypes not
checked), as the JAX package's own test holds them.
"""

import numpy as np
import pandas as pd
import pytest

import test_chunked_fallback as jax_chunked_tests
from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap_torch.bench import assert_frame_parity
from tpu_olap_torch.planner import fallback as port_fallback
from tpu_olap_torch.planner.exprutil import contains_agg

from _torch_port import cpu_engine, export_segments

BLOCK_ROWS = 1024
PRUNE = dict(columns=["ts", "category", "city", "amount"],
             column_map={"cat": "category", "qty": "amount"})
DIM = pd.DataFrame({"d_city": [f"c{i}" for i in range(7)],
                    "d_zone": ["west" if i < 4 else "east"
                               for i in range(7)]})


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return jax_chunked_tests._write_dataset(
        str(tmp_path_factory.mktemp("parquet")))


def _register(engine, paths, **kw):
    engine.register_table("t", paths, time_column="ts",
                          block_rows=BLOCK_ROWS, **kw)
    engine.register_table("d", DIM, accelerate=False)
    return engine


@pytest.fixture(scope="module")
def pair(paths):
    return (_register(JaxEngine(JaxConfig()), paths),
            _register(cpu_engine(), paths))


def _assert_same_segments(a, b):
    """Two export_segments dicts equal exactly, arrays by dtype and
    value."""
    assert a["schema"] == b["schema"]
    assert a["dictionaries"] == b["dictionaries"]
    assert (a["block_rows"], a["time_partition"]) == \
        (b["block_rows"], b["time_partition"])
    assert len(a["segments"]) == len(b["segments"]) > 1
    for sa, sb in zip(a["segments"], b["segments"]):
        assert sa["meta"] == sb["meta"]
        for part in ("columns", "null_masks"):
            assert sorted(sa[part]) == sorted(sb[part])
            for c, x in sa[part].items():
                y = sb[part][c]
                assert x.dtype == y.dtype, (part, c)
                np.testing.assert_array_equal(x, y, err_msg=f"{part} {c}")


@pytest.mark.parametrize("prune", [False, True], ids=["all", "pruned"])
def test_parquet_segments_equal_jax(paths, prune):
    kw = PRUNE if prune else {}
    jeng = _register(JaxEngine(JaxConfig()), paths, **kw)
    peng = _register(cpu_engine(), paths, **kw)
    jentry, pentry = jeng.catalog.get("t"), peng.catalog.get("t")
    _assert_same_segments(export_segments(jentry.segments),
                          export_segments(pentry.segments))
    if prune:
        assert set(pentry.segments.schema) == {"__time", "category",
                                               "city", "amount"}
    for f in ("parquet_paths", "parquet_read_cols", "parquet_column_map",
              "parquet_rows"):
        assert getattr(pentry, f) == getattr(jentry, f), f
    # the fallback frame loads lazily, with the same pruning and renames
    assert pentry._frame is None
    pd.testing.assert_frame_equal(pentry.frame, jentry.frame)


PARQUET_QUERIES = [
    # device path over the parquet-ingested segments
    "SELECT cat, city, sum(price) AS s, count(qty) AS nq, min(qty) AS lo "
    "FROM t GROUP BY cat, city ORDER BY cat, city",
    "SELECT date_trunc('month', ts) AS m, sum(qty) AS s FROM t "
    "WHERE ts >= '2021-02-01' AND ts < '2021-05-01' "
    "GROUP BY date_trunc('month', ts) ORDER BY m",
    # a join to a plain table: the fallback interpreter
    "SELECT d_zone, sum(price) AS s FROM t JOIN d ON city = d_city "
    "GROUP BY d_zone ORDER BY d_zone",
]


@pytest.mark.parametrize("sql", PARQUET_QUERIES)
def test_parquet_query_matches_jax(pair, sql):
    jeng, peng = pair
    want = jeng.sql(sql)
    got = peng.sql(sql)
    assert peng.last_plan.rewritten == jeng.last_plan.rewritten
    assert_frame_parity(got, want, ordered=True)


@pytest.fixture(scope="module")
def chunk_engines(paths):
    """Whole-frame, chunked and parallel-chunked port engines over the
    dataset, as tests/test_chunked_fallback.py builds the JAX ones."""
    def make(**kw):
        return _register(cpu_engine(**kw), paths)
    return {"whole": make(fallback_chunk_rows=10**9),
            "chunked": make(fallback_chunk_rows=100,
                            fallback_chunk_batch_rows=1024,
                            fallback_parallel_workers=1),
            "parallel": make(fallback_chunk_rows=100,
                             fallback_chunk_batch_rows=1024,
                             fallback_parallel_workers=2)}


def _fallback(engine, sql):
    return port_fallback.execute_fallback(
        engine.planner.plan(sql).stmt, engine.catalog, engine.config)


@pytest.mark.parametrize("mode", ["chunked", "parallel"])
@pytest.mark.parametrize("sql", jax_chunked_tests.QUERIES)
def test_chunked_matches_whole(chunk_engines, monkeypatch, sql, mode):
    """The port's chunked fallback over the parquet table equals its
    whole-frame fallback, serial and with two fork workers; with two the
    parallel path must really serve every aggregate query (not its
    sequential retry)."""
    served = []
    real = port_fallback._parallel_chunk_partials

    def spy(*a, **kw):
        out = real(*a, **kw)
        served.append(out is not None)
        return out

    monkeypatch.setattr(port_fallback, "_parallel_chunk_partials", spy)
    a = _fallback(chunk_engines["whole"], sql)
    b = _fallback(chunk_engines[mode], sql)
    assert chunk_engines[mode].catalog.get("t")._frame is None
    if mode == "parallel":
        stmt = chunk_engines[mode].planner.plan(sql).stmt
        aggregates = bool(stmt.group_by) or stmt.distinct or any(
            contains_agg(e) for e, _ in stmt.projections)
        assert served == ([True] if aggregates else [])
    pd.testing.assert_frame_equal(
        a.reset_index(drop=True), b.reset_index(drop=True),
        check_dtype=False)


def test_write_ssb_parquet_matches_jax(tmp_path):
    """The port's SSB parquet writer, on spawned processes (one per
    chunk here, as the host's cores allow), writes the JAX package's
    files: same names, row groups and tables, exactly; the dimension
    tables equal too."""
    import pyarrow.parquet as pq
    from tpu_olap.bench import ssb as jax_ssb
    from tpu_olap_torch.bench import ssb
    kw = dict(seed=3, chunk_rows=8_000, row_group_rows=4096)
    want, want_dims = jax_ssb.write_ssb_parquet(str(tmp_path / "jax"),
                                                30_000, **kw)
    got, dims = ssb.write_ssb_parquet(str(tmp_path / "port"), 30_000,
                                      **kw)
    assert [p.rsplit("/", 1)[1] for p in got] == \
        [p.rsplit("/", 1)[1] for p in want]
    for g, w in zip(got, want):
        assert pq.ParquetFile(g).metadata.num_row_groups == \
            pq.ParquetFile(w).metadata.num_row_groups
        assert pq.read_table(g).equals(pq.read_table(w))
    assert sorted(dims) == sorted(want_dims)
    for name, frame in want_dims.items():
        pd.testing.assert_frame_equal(dims[name], frame)

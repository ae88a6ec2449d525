"""The PyTorch port's Engine.register_lookup and Engine.drop_table, on the
CPU, against the JAX package.

The lookup statements are those of `tests/test_sql_extended.py`'s three
lookup tests, over the same seeded frame (its `_df`). Frames compare with
the parity harness (integers and strings exact)."""

import numpy as np
import pandas as pd
import pytest

from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap_torch import Engine
from tpu_olap_torch.bench import assert_frame_parity
from tpu_olap_torch.planner.fallback import FallbackError, execute_fallback

from test_sql_extended import _df
from _torch_port import cpu_engine

ZONE = {f"c{i}": ("west" if i < 3 else "east") for i in range(6)}
GROUPED = ("SELECT lookup(city, 'zone') AS z, sum(v) AS s FROM t "
           "GROUP BY lookup(city, 'zone') ORDER BY z")
PARTIAL = ("SELECT lookup(city, 'partial') AS z, count(*) AS n "
           "FROM t GROUP BY lookup(city, 'partial') ORDER BY z")
UNKNOWN = "SELECT lookup(city, 'nope') AS z FROM t LIMIT 1"


def _register(eng, df):
    eng.register_table("t", df, time_column="ts")
    eng.register_table("dim", pd.DataFrame(
        {"d_city": [f"c{i}" for i in range(6)],
         "d_zone": ["west" if i < 3 else "east" for i in range(6)]}),
        accelerate=False)
    eng.register_lookup("zone", ZONE)
    eng.register_lookup("partial", {"c0": "zero"})
    return eng


@pytest.fixture(scope="module")
def engines():
    df = _df()
    return (_register(JaxEngine(JaxConfig(use_pallas="never")), df),
            _register(cpu_engine(), df), df)


@pytest.mark.parametrize("sql", [GROUPED, PARTIAL], ids=["zone", "partial"])
def test_lookup_matches_jax_on_both_paths(engines, sql):
    jax_eng, port, _ = engines
    want = jax_eng.sql(sql)
    got = port.sql(sql)
    assert port.last_plan.rewritten, port.last_plan.fallback_reason
    assert port.runner.last_metrics["route"] == "packed"
    assert_frame_parity(got, want, ordered=True, label="device path")
    fb = execute_fallback(port.planner.plan(sql).stmt, port.catalog,
                          port.config)
    assert_frame_parity(fb, want, ordered=True, label="fallback")


def test_lookup_values_and_null_group(engines):
    _, port, df = engines
    got = port.sql(GROUPED)
    expect = df.assign(z=df.city.map(ZONE)).groupby("z").v.sum()
    assert dict(zip(got["z"], got["s"])) == expect.to_dict()
    zs = list(port.sql(PARTIAL)["z"])
    assert "zero" in zs and len(zs) == 2
    assert any(pd.isna(z) for z in zs)  # unmapped values: the null group


def test_unknown_lookup_is_a_clear_error(engines):
    _, port, _ = engines
    with pytest.raises(FallbackError, match="unknown lookup"):
        port.sql(UNKNOWN)
    assert not port.last_plan.rewritten  # the planner declined first


def test_drop_table_as_in_jax():
    df = _df()
    sql = "SELECT g, sum(v) AS s FROM t GROUP BY g ORDER BY g"
    errors = []
    for eng in (JaxEngine(JaxConfig(use_pallas="never")),
                cpu_engine()):
        eng.register_table("t", df, time_column="ts")
        eng.sql(sql)
        eng.drop_table("t")
        with pytest.raises(KeyError, match="unknown table") as exc:
            eng.sql(sql)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]

    port = eng
    assert port.runner.device_bytes() == 0
    assert "t" not in port.runner._datasets
    # a new registration under the same name answers from the new data
    df2 = df.assign(v=df.v * 2 + 1)
    port.register_table("t", df2, time_column="ts")
    got = port.sql(sql)
    want = df2.groupby("g", as_index=False).v.sum().rename(
        columns={"v": "s"})
    assert got["s"].tolist() == want["s"].astype(np.int64).tolist()
    assert port.runner.device_bytes() > 0


def test_engine_surface_left_to_later_items():
    """The port's Engine lacks no method of the JAX package's Engine:
    ROADMAP queue A item 14 ported the last two (the sys tables'
    `_execute_sys_stmt` and the sentinel's `_wal_lag_probe`); the mesh
    (item 13) adds no Engine method."""
    def names(cls):
        return {n for n in dir(cls) if not n.startswith("__")}
    assert names(JaxEngine) - names(Engine) == set()


def test_config_surface_left_out_by_design():
    """The JAX package's EngineConfig fields the port lacks are exactly
    the ones left out by design (executor/config.py's docstring): the
    numpy-platform batch knobs, the Pallas knobs, the JAX backend
    switches, a knob nothing reads and the free-form dict. The mesh's
    knobs (num_shards, degrade_shards_on_retry, sparse_merge,
    force_strategy, the cost model's) are all ported."""
    import dataclasses
    from tpu_olap_torch.executor.config import EngineConfig

    def fields(cls):
        return {f.name for f in dataclasses.fields(cls)}
    missing = fields(JaxConfig) - fields(EngineConfig)
    assert missing == {
        "batch_chunk_segments", "batch_cpu_threads", "use_pallas",
        "platform", "enable_x64", "max_segments_per_dispatch", "extra",
    } | {n for n in fields(JaxConfig) if n.startswith("pallas_")}
    assert fields(EngineConfig) - fields(JaxConfig) == \
        {"device", "use_fused_reduce"}

"""The port's mesh (tpu_olap_torch.executor.sharding) on the CPU against
the JAX package.

The mesh's functions are held against their JAX counterparts on the same
inputs: placement, padding and the per-device window exactly, and the
broker merge on the same D partial tables (the port's per-device dicts,
stacked into the JAX [D·K] layout for its broker_merge): integers exact,
doubles at rtol 1e-12. Then the port's engine at D = 8 (eight entries of
the CPU device) against the JAX engine on one device, on the cases of
tests/test_sharding.py: the 13 SSB queries under both merge strategies
and both use_fused_reduce settings, a shared-scan batch, sketches,
scans, pruning, the per-device window, tier-1 cache shards, an append
and a compaction, sys.devices and a handful of fuzz seeds. Frames
compare with the parity harness.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import test_fuzz_parity as jax_fuzz
from test_sharding import QUERIES, WINDOW_SQL, _month_build, build
from tpu_olap import Engine as JaxEngine
from tpu_olap.bench import ssb as jax_ssb
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.executor import sharding as jax_sh
from tpu_olap_torch.bench import assert_frame_parity, ssb
from tpu_olap_torch.executor import sharding as sh
from tpu_olap_torch.executor.config import EngineConfig
from tpu_olap_torch.utils import platform

from _torch_port import cpu_engine

D = 8


def _close_all(request, engines):
    request.addfinalizer(lambda: [e.close() for e in engines])


# ------------------------------------------------- functions against JAX

@pytest.mark.parametrize("n, d", [(16, 8), (8, 8), (100, 4), (98, 4),
                                  (37, 8), (1, 2), (5, 1)])
def test_placement_padding_match_jax(n, d):
    assert sh.pad_segments(n, d) == jax_sh.pad_segments(n, d)
    s = sh.pad_segments(n, d)
    for got, want in zip(sh.placement(s, d), jax_sh.placement(s, d)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert [sh.chip_of(i, d) for i in range(s)] == \
        [jax_sh.chip_of(i, d) for i in range(s)]


def test_local_window_matches_jax():
    rng = np.random.default_rng(5)
    cases = 0
    for _ in range(300):
        d = int(rng.choice([1, 2, 4, 8]))
        s = sh.pad_segments(int(rng.integers(1, 200)), d)
        lo = int(rng.integers(0, s))
        hi = int(rng.integers(lo, s)) + 1
        ids = list(range(lo, hi)) if rng.random() < 0.7 else \
            sorted(rng.choice(s, int(rng.integers(0, s)) + 1,
                              replace=False).tolist())
        got = sh.local_window(ids, d, s // d)
        assert got == jax_sh.local_window(ids, d, s // d)
        cases += got is not None
    assert cases > 50  # the window cut often enough to count
    assert sh.local_window([], 4, 8) is None


BROKER_SQL = ("SELECT brand, sum(qty) AS s, min(price) AS mn, max(qty) AS mx,"
              " count(*) AS n, count(DISTINCT uid) AS u,"
              " theta_sketch_estimate(theta_sketch(uid)) AS t"
              " FROM f GROUP BY brand")


def test_broker_merge_matches_jax(request):
    """The D per-device partial tables of a real dispatch (sum, min,
    max, count, HLL registers, theta tables), merged by the port's
    broker and by the JAX package's over the same tables stacked
    [D·K]."""
    _, df = _sharding_frames()
    eng = cpu_engine(num_shards=4)
    _close_all(request, [eng])
    eng.register_table("f", df, time_column="ts", block_rows=1 << 11)
    plan = eng.planner.plan(BROKER_SQL)
    runner = eng.runner
    phys = runner._lower_cached(plan.query, plan.entry.segments)
    env, valid, seg_mask, consts = runner._prepare(phys, {})
    parts = [{n: t.numpy() for n, t in out.items()}
             for out in sh.launch_per_device(
                 runner.mesh, phys.kernel,
                 sh.device_args(env, valid, seg_mask, consts))]
    kinds = {p.kind for p in phys.agg_plans}
    assert {"sum", "min", "max", "hll", "theta"} <= kinds
    got = sh.broker_merge(parts, phys.agg_plans)
    stacked = {n: np.concatenate([p[n] for p in parts]) for n in parts[0]}
    want = jax_sh.broker_merge(stacked, phys.agg_plans, 4)
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n].numpy()
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12)
        else:
            np.testing.assert_array_equal(g, np.asarray(w))


def test_make_mesh_devices(monkeypatch):
    cpu = sh.make_mesh(3, "cpu")
    assert cpu.size == 3 and all(d.type == "cpu" for d in cpu.devices)
    assert not sh.is_multihost(cpu)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert sh.make_mesh(2, "cuda").devices == (torch.device("cuda", 0),
                                               torch.device("cuda", 1))
    with pytest.raises(ValueError, match="exceeds 2 devices"):
        sh.make_mesh(4, "cuda")
    try:
        platform.force_virtual_devices(4)
        assert sh.make_mesh(4, "cuda").devices == tuple(
            torch.device("cuda", c % 2) for c in range(4))
        with pytest.raises(ValueError):
            sh.make_mesh(5, "cuda")
    finally:
        platform.force_virtual_devices(0)
    with pytest.raises(ValueError):
        sh.make_mesh(4, "cuda")


def test_mesh_fields_take_the_jax_names_and_defaults():
    names = ("num_shards", "degrade_shards_on_retry", "sparse_merge",
             "force_strategy", "cost_model_enabled", "shard_merge_factor",
             "cost_scan_ns_per_row_col", "cost_merge_ns_per_byte",
             "cost_collective_lat_us", "cost_gspmd_overhead")
    port, jax = EngineConfig(), JaxConfig()
    assert {n: getattr(port, n) for n in names} == \
        {n: getattr(jax, n) for n in names}
    cfg = EngineConfig(num_shards=8, degrade_shards_on_retry=True,
                       sparse_merge="gather", force_strategy="broker",
                       cost_model_enabled=False, cost_scan_ns_per_row_col=1.0,
                       cost_merge_ns_per_byte=2.0, cost_collective_lat_us=3.0,
                       cost_gspmd_overhead=4.0)
    assert cfg.num_shards == 8 and cfg.sparse_merge == "gather"


# ------------------------------------------------------- SSB at D = 8

@pytest.fixture(scope="module")
def ssb_engines(request):
    tables = jax_ssb.generate_tables(60_000, 0)
    jax = JaxEngine(JaxConfig(use_pallas="never"))
    jax_ssb.register_ssb(jax, tables=tables, block_rows=4096)
    out = {"jax": jax, "frames": {}}
    for strategy in ("historicals", "broker"):
        for mode in ("force", "never"):
            e = cpu_engine(num_shards=D, use_fused_reduce=mode,
                           force_strategy=strategy)
            ssb.register_ssb(e, tables=tables, block_rows=4096)
            out[(strategy, mode)] = e
    _close_all(request, [v for k, v in out.items() if isinstance(k, tuple)])
    return out


def _jax_frame(engines, sql):
    frames = engines["frames"]
    if sql not in frames:
        frames[sql] = engines["jax"].sql(sql)
    return frames[sql]


@pytest.mark.parametrize("mode", ["force", "never"])
@pytest.mark.parametrize("strategy", ["historicals", "broker"])
@pytest.mark.parametrize("name", list(ssb.QUERIES))
def test_ssb_mesh_matches_jax(ssb_engines, name, strategy, mode):
    eng = ssb_engines[(strategy, mode)]
    got = eng.sql(ssb.QUERIES[name])
    m = eng.runner.last_metrics
    assert m["num_shards"] == D and m["strategy"] == strategy
    assert m["cost"]["strategy"] == strategy
    assert m["merge"] == ("broker" if strategy == "historicals"
                          else "device")
    # D copies to the host broker, or one after the fold on device 0
    assert m["host_copies"] == (D if strategy == "historicals" else 1)
    assert m["fused"] == (mode == "force")
    assert m["route"] == "unpacked"  # unfinalized partials: no packing
    assert_frame_parity(got, _jax_frame(ssb_engines, ssb.QUERIES[name]),
                        label=name)


def test_ssb_batch_mesh_matches_jax(ssb_engines):
    """The 13 as one shared-scan batch at D = 8: every fused group runs
    per device and the broker merges each leg."""
    eng = ssb_engines[("historicals", "force")]
    got = eng.sql_batch(list(ssb.QUERIES.values()))
    stmts = eng.runner.last_metrics["statements"]
    assert any(s.get("route") == "batch" and s["host_copies"] == D
               for s in stmts)
    for (name, sql), g in zip(ssb.QUERIES.items(), got):
        assert_frame_parity(g, _jax_frame(ssb_engines, sql), label=name)


# ------------------------------- tests/test_sharding.py's cases at D = 8

_FRAMES = {}


def _sharding_frames():
    """The JAX engine of tests/test_sharding.py's build() on one device,
    and its frame (built once)."""
    if "build" not in _FRAMES:
        _FRAMES["build"] = build(num_shards=None)
    return _FRAMES["build"]


@pytest.fixture(scope="module")
def sharded(request):
    jax, df = _sharding_frames()
    port = cpu_engine(num_shards=D)
    port.register_table("f", df, time_column="ts", block_rows=1 << 11)
    _close_all(request, [port])
    return jax, port, df


@pytest.mark.parametrize("idx", range(len(QUERIES)))
def test_sharded_matches_jax(sharded, idx):
    jax, port, _ = sharded
    got = port.sql(QUERIES[idx])
    assert port.last_plan.rewritten, port.last_plan.fallback_reason
    assert port.runner.last_metrics["num_shards"] == D
    assert_frame_parity(got, jax.sql(QUERIES[idx]), ordered=True)


def test_sharded_theta_matches_jax(sharded):
    from tpu_olap.ir import (DefaultDimensionSpec as JDim,
                             GroupByQuerySpec as JGroupBy,
                             ThetaSketchAggregation as JTheta)
    from tpu_olap_torch.ir import (DefaultDimensionSpec, GroupByQuerySpec,
                                   ThetaSketchAggregation)
    jax, port, df = sharded
    want = jax.execute_ir(JGroupBy(
        data_source="f", dimensions=(JDim("region"),),
        aggregations=(JTheta("u", "uid", 1 << 12),)))
    got = port.execute_ir(GroupByQuerySpec(
        data_source="f", dimensions=(DefaultDimensionSpec("region"),),
        aggregations=(ThetaSketchAggregation("u", "uid", 1 << 12),)))
    assert port.runner.last_metrics["num_shards"] == D
    assert got.rows == want.rows
    truth = df.groupby("region").uid.nunique()
    for r in got.rows:
        assert abs(r["u"] - truth[r["region"]]) / truth[r["region"]] < 0.1


def test_sharded_hll_and_scan(sharded):
    jax, port, _ = sharded
    for sql in ("SELECT count(DISTINCT uid) AS u FROM f",
                "SELECT brand, qty FROM f WHERE qty = 49 LIMIT 12",
                "SELECT ts, brand FROM f WHERE region = 'ASIA' "
                "ORDER BY ts DESC LIMIT 9"):
        got = port.sql(sql)
        m = port.runner.last_metrics
        assert m["num_shards"] == D, sql
        if "LIMIT" in sql:  # the row mask per device, one copy each
            assert m["route"] == "mask" and m["host_copies"] == D
        assert_frame_parity(got, jax.sql(sql), ordered=True, label=sql)


def test_sharded_search_matches_jax(sharded):
    """Search counts per device under each device's row mask, summed
    at the host: the padding segments count nothing."""
    jax, port, df = sharded
    sql = "SEARCH DRUID DATASOURCE f FOR 'b1' IN brand, region LIMIT 40"
    got = port.sql(sql)
    assert port.runner.last_metrics["num_shards"] == D
    assert port.runner.last_metrics["host_copies"] == D
    pd.testing.assert_frame_equal(got, jax.sql(sql), check_exact=True)
    counts = dict(zip(got["value"], got["count"]))
    assert counts["B10"] == int((df.brand == "B10").sum())


def test_sharded_pruning_still_correct(sharded):
    jax, port, df = sharded
    sql = "SELECT count() AS n FROM f WHERE year(ts) = 1994"
    got = port.sql(sql)
    years = pd.to_datetime(df.ts).dt.year
    assert got.n[0] == int((years == 1994).sum())
    m = port.runner.last_metrics
    assert m["segments_scanned"] < m["segments_total"]
    assert_frame_parity(got, jax.sql(sql))


@pytest.fixture(scope="module")
def months(request):
    jax, df = _month_build()
    out = {"jax": jax, "df": df}
    made = []
    for name, kw in (("plain", {}), ("tier1", {"segment_cache_enabled": True}),
                     ("compact", {"segment_cache_enabled": True,
                                  "ingest_auto_compact": False})):
        e = cpu_engine(num_shards=D, cube_auto_refresh=False, **kw)
        e.register_table("m", df, time_column="ts", block_rows=512,
                         time_partition="month")
        out[name] = e
        made.append(e)
    _close_all(request, made)
    return out


def test_per_chip_window_prunes_working_set(months):
    port = months["plain"]
    got = port.sql(WINDOW_SQL)
    m = port.runner.last_metrics
    n_seg = len(port.catalog.get("m").segments.segments)
    per_chip = -(-n_seg // D)
    w = m["segments_window_per_chip"]
    assert 0 < w < per_chip, (w, per_chip)
    assert m["num_shards"] == D
    assert m["cost"]["strategy"] in ("historicals", "broker")
    assert_frame_parity(got, months["jax"].sql(WINDOW_SQL), ordered=True)


def test_mesh_tier1_cache_shards_merge_at_broker(months):
    """Per-(device, segment) tier-1 entries: the first run fills them
    from one segment-extended launch per device, the repeat serves them
    from the broker fold, and sys.devices counts them per device."""
    port = months["tier1"]
    a = port.sql(WINDOW_SQL)
    m1 = port.runner.last_metrics
    assert "segment_cache" not in m1  # served by the tier, not bypassed
    assert m1["num_shards"] == D and m1["host_copies"] == D
    b = port.sql(WINDOW_SQL)
    m2 = port.runner.last_metrics
    assert m2["cache_hit"] and m2["cache_tier"] == "segment"
    assert m2["segments_cached"] > 0 and m2["segments_computed"] == 0
    dev = port.sql("SELECT sum(cache_shard_entries) AS n, count(*) AS d "
                   "FROM sys.devices")
    assert int(dev.d[0]) == D
    assert int(dev.n[0]) == m2["segments_cached"]
    want = months["jax"].sql(WINDOW_SQL)
    assert_frame_parity(a, want, ordered=True)
    assert_frame_parity(b, want, ordered=True)


def test_sys_devices_census(months):
    port = months["plain"]
    port.sql(WINDOW_SQL)
    out = port.sql("SELECT * FROM sys.devices")
    assert len(out) == D and (out.chips == D).all()
    assert list(out["index"]) == list(range(D))
    n_seg = len(port.catalog.get("m").segments.segments)
    assert int(out.segments.sum()) == n_seg
    assert int(out.dispatches.min()) > 0
    ledger = port.runner._ledger
    assert int(out.hbm_bytes.sum()) == ledger.bytes_in_use
    assert int(out.resident_bytes.sum()) == port.runner.device_bytes()


def test_incremental_replace_on_append(request):
    """An append rebases the resident shards on their devices (only the
    touched segments' rows upload) and the mesh's answers stay the JAX
    engine's."""
    jax, df = _month_build()
    port = cpu_engine(num_shards=D, cube_auto_refresh=False)
    _close_all(request, [port])
    port.register_table("m", df, time_column="ts", block_rows=512,
                        time_partition="month")
    base = port.sql(WINDOW_SQL)
    row = {"ts": "1994-12-30T00:00:00", "g": "g1", "v": 7}
    jax.append("m", [row])
    port.append("m", [row])
    got = port.sql("SELECT count() AS n FROM m")
    assert int(got.n[0]) == 60_001
    ds = port.runner._datasets["m"]
    assert ds.rebased_cols > 0 and ds.mesh is not None
    n_seg = len(port.catalog.get("m").segments.segments)
    assert ds.rebase_rows_uploaded < n_seg * 512 // 2
    assert_frame_parity(port.sql(WINDOW_SQL), jax.sql(WINDOW_SQL),
                        ordered=True)
    assert_frame_parity(port.sql(WINDOW_SQL), base, ordered=True)
    total = "SELECT g, sum(v) AS s, count(*) AS n FROM m GROUP BY g"
    assert_frame_parity(port.sql(total), jax.sql(total))


def test_compaction_keeps_untouched_cache_shards(months):
    port = months["compact"]
    port.sql(WINDOW_SQL)
    warm = port.sql(WINDOW_SQL)
    assert port.runner.last_metrics["cache_hit"]
    port.append("m", [{"ts": "1994-12-30T00:00:00", "g": "g1", "v": 7}])
    res = port.compact_now("m")
    assert res.get("mode") == "incremental", res
    again = port.sql(WINDOW_SQL)
    m = port.runner.last_metrics
    assert m["cache_hit"], m.get("segment_cache")
    assert m["segments_cached"] > 0 and m["segments_computed"] == 0, m
    assert_frame_parity(again, warm, ordered=True)


# ------------------------------------------------------------ fuzz seeds

@pytest.mark.parametrize("seed", [0, 5, 10, 15, 20, 25])
def test_fuzz_seeds_at_d8_match_jax(request, seed):
    """tests/test_fuzz_parity.py's generated statements at D = 8 against
    the JAX engine on one device (its D = 8 seeds, seed % 5 == 0)."""
    rng = np.random.default_rng(1000 + seed)
    frame = jax_fuzz._make_table(rng, int(rng.integers(500, 6000)))
    block_rows = int(2 ** rng.integers(8, 11))
    sql = jax_fuzz._gen_query(rng)
    jax = JaxEngine(JaxConfig(use_pallas="never"))
    port = cpu_engine(num_shards=D, use_fused_reduce="force")
    _close_all(request, [port])
    from tpu_olap_torch.catalog.star import StarDimension, StarSchema
    star = StarSchema(fact="t", dimensions=(StarDimension(
        "citydim", fact_key="城市", dim_key="d_city",
        column_map={"d_city": "城市", "d_region": "region"}),))
    jax.register_table("t", frame, time_column="ts", block_rows=block_rows,
                       star_schema=jax_fuzz._star())
    port.register_table("t", frame, time_column="ts", block_rows=block_rows,
                        star_schema=star)
    for e in (jax, port):
        e.register_table("citydim", jax_fuzz._city_dim(), accelerate=False)
    want = jax.sql(sql)
    got = port.sql(sql)
    assert port.last_plan.rewritten == jax.last_plan.rewritten
    if port.last_plan.rewritten:
        assert port.runner.last_metrics.get("num_shards") == D, sql
    assert_frame_parity(got, want, label=f"seed={seed} sql={sql!r}")

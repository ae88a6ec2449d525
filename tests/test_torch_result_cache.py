"""The PyTorch port's two-tier result cache, on the CPU, against the JAX
package.

The scenarios are those of `tests/test_result_cache.py` (its frame recipe
`_df` and statements imported from it): the full-result tier, the
generational invalidation, CLEAR DRUID CACHE, DROP, the byte-budget LRU,
the per-segment tier over a moving window, the bucket rebase, straddling
segments, the exact sketch merge, the state-budget bypass and batch legs
sharing the tiers. Every answer is held against the JAX package's
(`assert_frame_parity`) and against the port's own run with the caches
off (`pd.testing.assert_frame_equal`, exact); `segments_cached` and
`segments_computed` equal the JAX package's on every step. The
segment-extended plain version of the fused reduce is held exactly,
segment by segment, against the JAX package's `_seg_partials_kernel`.
The JAX side runs with use_pallas="never"."""

import numpy as np
import pandas as pd
import pytest
import torch

from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap_torch.bench import assert_frame_parity
from tpu_olap_torch.kernels import fused_reduce

from _torch_port import carry_into, cpu_engine
from test_result_cache import AGG_SQL, GROUP_SQL, _df, _win_sql

CACHES = dict(result_cache_enabled=True, segment_cache_enabled=True,
              segment_cache_min_rows=0)
REG = dict(time_column="ts", block_rows=1 << 11, time_partition="day")
DAY_SQL = ("SELECT DATE_TRUNC('day', ts) AS d, sum(v) AS s, min(v) AS mn, "
           "max(v) AS mx FROM t WHERE {} GROUP BY d ORDER BY d")
HLL_SQL = "SELECT count(DISTINCT g) AS n, sum(v) AS s FROM t WHERE {}"
STRADDLE = ("ts >= TIMESTAMP '2023-01-03 12:00:00' AND "
            "ts < TIMESTAMP '2023-01-20 06:30:00'")


def _span(lo, hi=None):
    cond = f"ts >= TIMESTAMP '{lo}'" if lo else ""
    if hi:
        cond += (" AND " if cond else "") + f"ts < TIMESTAMP '{hi}'"
    return cond


@pytest.fixture(scope="module")
def df():
    return _df()


def _jax(df, **kw):
    eng = JaxEngine(JaxConfig(use_pallas="never", **{**CACHES, **kw}))
    eng.register_table("t", df, **REG)
    return eng


def _port(jax_eng, **kw):
    eng = cpu_engine(use_fused_reduce="force",
                 **{**CACHES, **kw})
    carry_into(eng, jax_eng, "t")
    return eng


@pytest.fixture(scope="module")
def engines(df):
    """(JAX engine with tier 1 only, port engine with tier 1 only, port
    engine with both tiers off) over the same segments."""
    jax = _jax(df, result_cache_enabled=False)
    port = _port(jax, result_cache_enabled=False)
    plain = _port(jax, result_cache_enabled=False,
                  segment_cache_enabled=False)
    return jax, port, plain


def _step(jax, port, plain, sql, label, approx=()):
    """One statement through the three engines: the port's answer equals
    the JAX package's and the port's cache-off answer; returns (port
    metrics, JAX record)."""
    got = port.sql(sql)
    m = dict(port.runner.last_metrics)
    want = jax.sql(sql)
    rec = dict(jax.history[-1])
    assert_frame_parity(got, want, ordered=True, approx_cols=approx,
                        label=label)
    pd.testing.assert_frame_equal(got, plain.sql(sql))
    return m, rec


def _same_counts(m, rec):
    for k in ("segments_cached", "segments_computed"):
        assert m.get(k) == rec.get(k), (k, m.get(k), rec.get(k))


# ------------------------------------------------------- tier 2 (full)


def test_full_cache_serves_repeat_with_real_cache_hit(df):
    jax = _jax(df)
    port = _port(jax)
    a = port.sql(GROUP_SQL)
    first = dict(port.runner.last_metrics)
    b = port.sql(GROUP_SQL)
    hit = dict(port.runner.last_metrics)
    pd.testing.assert_frame_equal(a, b)
    assert first["cache_hit"] is False
    assert hit["cache_hit"] is True and hit["cache_tier"] == "full"
    assert hit["path"] == "cache" and hit["route"] == "cache"
    assert hit["rows_scanned"] == 0 and hit["segments_scanned"] == 0
    assert hit["host_copies"] == 0
    stats = port.runner.result_cache.stats["full"]
    assert stats["hit"] >= 1 and stats["miss"] >= 1
    jax.sql(GROUP_SQL)
    assert_frame_parity(b, jax.sql(GROUP_SQL), ordered=True, label="hit")
    assert dict(jax.history[-1])["cache_tier"] == "full"


def test_ingest_bumps_generation_and_invalidates_both_tiers(df):
    jax, port = _jax(df), cpu_engine(**CACHES)
    port.register_table("t", df, **REG)
    win = _win_sql("2023-01-01", "2023-02-01")
    gen0 = port.catalog.get("t").segments.generation
    a = port.sql(GROUP_SQL)
    port.sql(GROUP_SQL)
    port.sql(win)
    for eng in (jax, port):
        eng.register_table("t", df.iloc[: len(df) // 2], **REG)
    assert port.catalog.get("t").segments.generation > gen0
    w = port.sql(win)
    assert not port.runner.last_metrics.get("segments_cached")
    jw = jax.sql(win)
    assert not dict(jax.history[-1]).get("segments_cached")
    assert_frame_parity(w, jw, ordered=True, label="post-ingest window")
    b = port.sql(GROUP_SQL)
    assert port.runner.last_metrics.get("cache_tier") != "full"
    assert not b.equals(a)
    assert_frame_parity(b, jax.sql(GROUP_SQL), ordered=True,
                        label="post-ingest")
    plain = cpu_engine()
    plain.register_table("t", df.iloc[: len(df) // 2], **REG)
    pd.testing.assert_frame_equal(b, plain.sql(GROUP_SQL))
    assert port.runner.result_cache.snapshot()["full"]["entries"] <= 2


def test_clear_druid_cache_clears_both_tiers(df):
    port = cpu_engine(**CACHES)
    port.register_table("t", df, **REG)
    port.sql(GROUP_SQL)
    port.sql(_win_sql("2023-01-01", "2023-02-01"))
    snap = port.runner.result_cache.snapshot()
    assert snap["full"]["entries"] >= 1 and snap["segment"]["entries"] >= 1
    port.sql("CLEAR DRUID CACHE t")
    snap = port.runner.result_cache.snapshot()
    assert snap["full"]["entries"] == 0 and snap["segment"]["entries"] == 0
    port.sql(GROUP_SQL)
    assert port.runner.last_metrics["cache_hit"] is False
    port.sql("CLEAR DRUID CACHE")
    assert port.runner.result_cache.snapshot()["full"]["entries"] == 0


def test_drop_table_purges_cache_entries(df):
    port = cpu_engine(**CACHES)
    port.register_table("t", df, **REG)
    port.sql(GROUP_SQL)
    port.drop_table("t")
    assert port.runner.result_cache.snapshot()["full"]["entries"] == 0
    with pytest.raises(Exception):
        port.sql(GROUP_SQL)


def test_byte_budget_lru_eviction(df, engines):
    jax, _, plain = engines
    port = _port(jax, result_cache_max_bytes=20_000)
    for lo in range(1, 20, 6):
        sql = _win_sql(f"2023-01-{lo:02d}", "2023-02-01")
        got = port.sql(sql)
        assert_frame_parity(got, jax.sql(sql), ordered=True, label=sql)
        pd.testing.assert_frame_equal(got, plain.sql(sql))
    for lo in range(1, 20):
        port.sql(_win_sql(f"2023-01-{lo:02d}", "2023-02-01"))
    snap = port.runner.result_cache.snapshot()
    assert snap["full"]["bytes"] <= 20_000
    assert snap["full"]["evict"] >= 1


# ---------------------------------------------------- tier 1 (segment)


def test_moving_window_recomputes_only_uncached_segments(engines):
    jax, port, plain = engines
    port.sql("CLEAR DRUID CACHE")
    jax.sql("CLEAR DRUID CACHE")
    cold, rec = _step(jax, port, plain, _win_sql("2023-01-01", "2023-02-01"),
                      "cold")
    _same_counts(cold, rec)
    assert cold["cache_hit"] is False and cold["segments_computed"] >= 28
    warm, rec = _step(jax, port, plain, _win_sql("2023-01-08", "2023-02-15"),
                      "warm")
    _same_counts(warm, rec)
    assert warm["cache_tier"] == "segment" and warm["route"] == \
        "segment_cache"
    assert warm["segments_cached"] >= 20 and warm["segments_computed"] <= 18
    assert warm["rows_scanned"] < cold["rows_scanned"]
    full, rec = _step(jax, port, plain, _win_sql("2023-01-08", "2023-02-15"),
                      "repeat")
    _same_counts(full, rec)
    assert full["segments_computed"] == 0 and full["rows_scanned"] == 0
    assert full["host_copies"] == 0


def test_bucketed_layout_rebases_across_shifted_windows(engines):
    """A day-granularity timeseries whose interval slides: the shifted
    window's bucket grid differs, and the cached per-segment rows
    re-anchor by bucket start (resultcache._rebase)."""
    jax, port, plain = engines
    steps = [(None, "2023-02-01"), ("2023-01-05", "2023-02-20"),
             ("2023-01-09", "2023-02-24")]
    for i, (lo, hi) in enumerate(steps):
        m, rec = _step(jax, port, plain, DAY_SQL.format(_span(lo, hi)),
                       f"rebase {i}")
        _same_counts(m, rec)
        if i:
            assert m["cache_tier"] == "segment"
            assert m["segments_cached"] >= 20


def test_straddling_interval_segments_always_recompute(engines):
    jax, port, plain = engines
    sql = GROUP_SQL.replace("FROM t ", f"FROM t WHERE {STRADDLE} ")
    for i in range(2):
        m, rec = _step(jax, port, plain, sql, f"straddle {i}")
        _same_counts(m, rec)
    assert m["segments_computed"] >= 1


def test_sketches_merge_exactly_through_segment_cache(engines):
    jax, port, plain = engines
    for i, (lo, hi) in enumerate([(None, "2023-02-01"),
                                  ("2023-01-10", "2023-02-20")]):
        m, rec = _step(jax, port, plain, HLL_SQL.format(_span(lo, hi)),
                       f"hll {i}", approx=("n",))
        _same_counts(m, rec)
    assert m["segments_cached"] >= 1
    assert m["fused"] is False  # HLL takes the generic reduce
    # the merged sketch state equals the plain path's, register for
    # register
    plan = port.runner._lower_cached(
        port.planner.plan(HLL_SQL.format(_span("2023-01-10",
                                               "2023-02-20"))).query,
        port.catalog.get("t").segments)
    seg = port.runner._run_seg_partials(plan, {}, list(plan.pruned_ids))
    merged = None
    from tpu_olap_torch.kernels.groupby import merge_partials
    for sid in sorted(seg):
        merged = seg[sid] if merged is None else \
            merge_partials(merged, seg[sid], plan.agg_plans)
    whole = port.runner._run_partials(plan, {})
    for name, arr in whole.items():
        assert np.array_equal(np.asarray(merged[name]), arr), name


def test_state_budget_bypass_falls_through_to_plain_path(engines):
    jax, _, plain = engines
    port = _port(jax, result_cache_enabled=False,
                 segment_cache_state_budget=1)
    out = port.sql(GROUP_SQL)
    m = port.runner.last_metrics
    assert str(m.get("segment_cache", "")).startswith("bypass")
    assert "segments_cached" not in m and m["route"] == "packed"
    assert len(out) == 10
    pd.testing.assert_frame_equal(out, plain.sql(GROUP_SQL))
    assert port.runner.result_cache.stats["segment"]["bypass"] >= 1


# ----------------------------------------------------- batch executor


def test_batch_legs_share_tiers_with_single_query_dispatch(df):
    jax = _jax(df)
    port = _port(jax)
    port.sql(GROUP_SQL)
    outs = port.sql_batch([GROUP_SQL, AGG_SQL])
    legs = port.runner.last_metrics["statements"]
    assert legs[0]["cache_tier"] == "full" and legs[0]["host_copies"] == 0
    pd.testing.assert_frame_equal(outs[0], port.sql(GROUP_SQL))
    port.sql(AGG_SQL)
    assert port.runner.last_metrics["cache_hit"] is True
    for sql, got in zip((GROUP_SQL, AGG_SQL), outs):
        assert_frame_parity(got, jax.sql(sql), ordered=True, label=sql)


def test_fused_batch_leg_fills_the_full_cache(df):
    jax = _jax(df)
    port = _port(jax)
    sqls = [_win_sql("2023-01-01", "2023-02-01"),
            _win_sql("2023-01-02", "2023-02-01")]
    port.config.segment_cache_enabled = False
    outs = port.sql_batch(sqls)
    legs = port.runner.last_metrics["statements"]
    assert all(m["route"] == "batch" for m in legs)
    for sql, got in zip(sqls, outs):
        assert_frame_parity(got, jax.sql(sql), ordered=True, label=sql)
        pd.testing.assert_frame_equal(port.sql(sql), got)
        assert port.runner.last_metrics["cache_tier"] == "full"


# ------------------------------------- the segment-extended plain version


@pytest.mark.parametrize("sql, fused", [
    ("SELECT g, sum(v) AS s, min(v) AS mn, max(v) AS mx, count(*) AS n "
     f"FROM t WHERE {STRADDLE} GROUP BY g", True),
    (HLL_SQL.format(STRADDLE), False),
], ids=["dense", "sketch"])
def test_segment_partials_equal_jax_seg_partials_kernel(engines, sql,
                                                        fused):
    """Per segment, the port's per-segment pass (the segment-extended
    fused reduce's plain version for the dense plan, the generic reduce
    with the extended key for the HLL plan) equals what the JAX
    package's `_seg_partials_kernel` gives, exactly, over a window of
    segments that is not a power of two (min/max where the group has
    rows: an empty group holds the fold identity, whose width differs
    between the reduces)."""
    jax, port, _ = engines
    jt = jax.catalog.get("t").segments
    pt = port.catalog.get("t").segments
    jplan = jax.runner._lower_cached(jax.planner.plan(sql).query, jt)
    pplan = port.runner._lower_cached(port.planner.plan(sql).query, pt)
    assert (pplan.fused_reason is None) == fused, pplan.fused_reason
    ids = list(pplan.pruned_ids)
    assert ids == list(jplan.pruned_ids) and len(ids) not in (8, 16, 32)
    want = jax.runner._run_seg_partials(jplan, {}, ids)
    n0 = fused_reduce.seg_launches
    got = port.runner._run_seg_partials(pplan, {}, ids)
    assert fused_reduce.seg_launches == n0  # the CPU runs the plain version
    assert sorted(got) == sorted(want) == ids
    kinds = {p.name: p.kind for p in pplan.agg_plans}
    for sid in ids:
        assert "_rows" in got[sid]
        for name, a in got[sid].items():
            if name not in want[sid]:
                continue
            a, w = a.numpy(), np.asarray(want[sid][name])
            if kinds.get(name) in ("min", "max"):
                # an empty group's min/max is the fold identity, int32's
                # in the fused reduce and int64's in the JAX generic
                # reduce: finalize reads neither (its _nn_ count is 0)
                nn = np.asarray(want[sid][f"_nn_{name}"]) > 0
                assert np.array_equal(got[sid][f"_nn_{name}"].numpy() > 0,
                                      nn), (sid, name)
                a, w = a[nn], w[nn]
            assert np.array_equal(a, w), (sid, name)
        for p in pplan.agg_plans:
            assert p.name in got[sid]


def test_segment_extended_ref_matches_per_segment_runs():
    """fused_reduce_seg's plain version over a window equals, segment by
    segment, the plain fused reduce run on that segment alone; rows keyed
    outside [0, K) and segments outside the window count nowhere."""
    from tpu_olap_torch.kernels import rowprog
    torch.manual_seed(0)
    S, R, K = 6, 64, 5
    slots = (("k", "col", torch.int32), ("x", "col", torch.int32),
             ("", "base", torch.bool))

    def row_fn(streams):
        k, x, base = streams
        return base & (x > 2), k, [(None, None), (x, None)], [(x, None)]

    prog = rowprog.trace(row_fn, slots)
    k = torch.randint(-1, K + 1, (S, R), dtype=torch.int32)
    x = torch.randint(0, 9, (S, R), dtype=torch.int32)
    valid = torch.rand(S, R) < 0.9
    seg_mask = torch.tensor([True, True, False, True, True, True])
    lo, W = 1, 4
    sums, mins = fused_reduce.fused_reduce_seg(
        prog, [k, x, None], valid, seg_mask, K, lo, W)
    assert sums.shape == (W * K, prog.n_sum)
    for j in range(W):
        only = torch.zeros(S, dtype=torch.bool)
        only[lo + j] = seg_mask[lo + j]
        s1, m1 = fused_reduce.fused_reduce(prog, [k, x, None], valid, only,
                                           K)
        assert torch.equal(sums[j * K:(j + 1) * K], s1), j
        assert torch.equal(mins[j * K:(j + 1) * K], m1), j
    with pytest.raises(ValueError):
        fused_reduce.fused_reduce_seg(prog, [k, x, None], valid, seg_mask,
                                      K, 4, 4)


def test_segment_kernel_source_and_variants(monkeypatch, tmp_path):
    """The segment-extended kernel is B1's template with W * K groups and
    the per-segment K as constants: its source parses as C++17 with
    CUDA's keywords stubbed (NVRTC compiles it on the card), one variant
    compiles per (K, W) and a window that slides at the same W compiles
    nothing (its start is a launch parameter)."""
    import re
    import shutil
    import subprocess

    from tpu_olap_torch.kernels import cuda_build, rowgen, rowprog
    from test_torch_batch import _CUDA_STUBS

    slots = (("k", "col", torch.int32), ("x", "col", torch.int16),
             ("", "base", torch.bool))

    def row_fn(streams):
        k, x, base = streams
        return base & (x > 2), k, [(None, None), (x, None)], [(x, None)]

    prog = rowprog.trace(row_fn, slots)
    plain, seg = rowgen.kernel_source(prog, 5), \
        rowgen.kernel_source(prog, 5, 4)
    assert "constexpr long long kSegGroups = 0;" in plain
    assert "constexpr long long kSegGroups = 5;" in seg
    assert "constexpr long long kGroups = 20;" in seg
    assert seg.replace("kGroups = 20;", "kGroups = 5;").replace(
        "kSegGroups = 5;", "kSegGroups = 0;") == plain
    built = []
    monkeypatch.setattr(cuda_build, "nvrtc_kernel",
                        lambda src, *a: built.append(src) or object())
    for W in (4, 4, 8, 4):
        fused_reduce.compiled_seg(prog, 5, W, "cuda:0")
    assert built == [seg, rowgen.kernel_source(prog, 5, 8)]
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    for name, src in (("plain", plain), ("seg", seg)):
        src = re.sub(r"asm volatile\([^;]*\);", "v = *(const V16*)p;", src)
        path = tmp_path / f"{name}.cpp"
        path.write_text(_CUDA_STUBS + src)
        out = subprocess.run([cxx, "-std=c++17", "-fsyntax-only", str(path)],
                             capture_output=True, text=True)
        assert out.returncode == 0, out.stderr[:3000]


def test_mesh_cache_shards_equal_one_device_entries(df):
    """Tier 1 over a mesh of 8 CPU devices: one segment-extended pass
    per device, and every cached per-segment partial (the cache shard of
    its segment's device, segment i on device i mod 8) equal, exactly,
    to the one-device engine's entry for that segment; the repeat is
    served from the shards, as the JAX engine serves it."""
    jax = _jax(df, result_cache_enabled=False)
    one = _port(jax, result_cache_enabled=False)
    mesh = cpu_engine(use_fused_reduce="force", num_shards=8,
                      **{**CACHES, "result_cache_enabled": False})
    carry_into(mesh, jax, "t")
    sql = _win_sql("2023-01-01", "2023-02-01")
    for step in ("cold", "warm"):
        got = mesh.sql(sql)
        m = mesh.runner.last_metrics
        if step == "cold":  # one copy per device
            assert m["num_shards"] == 8 and m["host_copies"] == 8
            assert m["segments_window_per_chip"] == 4
        assert_frame_parity(got, jax.sql(sql), ordered=True, label=step)
        _same_counts(m, dict(jax.history[-1]))
        pd.testing.assert_frame_equal(got, one.sql(sql))
    assert m["segments_computed"] == 0 and m["cache_tier"] == "segment"
    # keyed by (template, segment id): the two engines' segments are
    # separate carries of the same blocks, with uids of their own
    a = {(k[0], k[2]): e for k, e in one.runner.result_cache._seg.items()}
    b = {(k[0], k[2]): e
         for k, e in mesh.runner.result_cache._seg.items()}
    assert set(a) == set(b) and len(b) >= 28
    for key, entry in b.items():
        for name, t in entry.partials.items():
            assert torch.equal(t, a[key].partials[name]), (key, name)
    per_device = mesh.runner.result_cache.shard_entries(8)
    assert sum(per_device.values()) == len(b) and len(per_device) == 8
    for e in (one, mesh):
        e.close()

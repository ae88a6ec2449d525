"""The port's sort-based sparse group-by (tpu_olap_torch.kernels.
sparse_groupby) against the JAX package's on the same seeded rows. Keys,
group counts, row counts, integer sums, min/max, non-null counts, HLL
registers and theta tables must be equal exactly — also when the groups
overflow the compact table (`_count` > cap). The float sums add exact
quarters, so they are exact too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_olap.kernels import groupby as jgroupby
from tpu_olap.kernels import sparse_groupby as jsparse
from tpu_olap_torch.kernels import groupby as tgroupby
from tpu_olap_torch.kernels import sparse_groupby as tsparse

SIZES = (7, 300, 1000, 40)  # a 84 M group space: past any dense budget


@pytest.fixture(autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)


def _rows(seed, n=6000):
    rng = np.random.default_rng(seed)
    ids = [rng.integers(0, s, n).astype(np.int32) for s in SIZES]
    # a few hot keys so groups hold several rows
    hot = rng.random(n) < 0.5
    for i in ids:
        i[hot] = i[hot] % 3
    cols = {
        "v": rng.integers(-10**12, 10**12, n).astype(np.int64),
        "w": rng.integers(-400, 400, n) / 4.0,
        "x": rng.integers(-30000, 30000, n).astype(np.int16),
        "u": rng.integers(0, 500, n).astype(np.int32),
    }
    nulls = {"x": rng.random(n) < 0.2}
    return ids, rng.random(n) < 0.8, cols, nulls


def _plans(mod):
    def flt(env, consts):
        return env["cols"]["u"] < 250

    P = mod.AggPlan
    return [P("n", "count", (), np.int64),
            P("nf", "count", (), np.int64, flt),
            P("sv", "sum", ("v",), np.int64),
            P("sw", "sum", ("w",), np.float64, flt),
            P("lo", "min", ("x",), np.int64),
            P("hi", "max", ("v",), np.int64, flt),
            P("d", "hll", ("u",), np.int32, is_string_input=(False,),
              hash_tables=(None,)),
            P("t", "theta", ("u",), np.float64, theta_k=16,
              is_string_input=(False,), hash_tables=(None,))]


def _jax(ids, mask, cols, nulls, cap):
    key, total = jsparse.build_group_key64(
        [jnp.asarray(i) for i in ids], SIZES, jnp)
    env = {"cols": {c: jnp.asarray(a) for c, a in cols.items()},
           "nulls": {c: jnp.asarray(a) for c, a in nulls.items()}}
    out = jsparse.sparse_group_reduce(key, jnp.asarray(mask), env,
                                      _plans(jgroupby), cap, {}, jnp)
    return np.asarray(key), {k: np.asarray(v) for k, v in out.items()}


def _port(ids, mask, cols, nulls, cap):
    key, total = tsparse.build_group_key64(
        [torch.from_numpy(i) for i in ids], SIZES)
    env = {"cols": {c: torch.from_numpy(a) for c, a in cols.items()},
           "nulls": {c: torch.from_numpy(a) for c, a in nulls.items()}}
    out = tsparse.sparse_group_reduce(key, torch.from_numpy(mask), env,
                                      _plans(tgroupby), cap, {})
    return key.numpy(), {k: v.numpy() for k, v in out.items()}


def test_build_group_key64_matches_jax():
    ids, *_ = _rows(0)
    want, _ = jsparse.build_group_key64(
        [jnp.asarray(i) for i in ids], SIZES, jnp)
    got, total = tsparse.build_group_key64(
        [torch.from_numpy(i) for i in ids], SIZES)
    assert total == int(np.prod(SIZES))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(tgroupby.UnsupportedAggregation, match="int64"):
        tsparse.build_group_key64([torch.zeros(3, dtype=torch.int32)] * 2,
                                  (1 << 31, 1 << 31))


@pytest.mark.parametrize("cap", [4096, 256])
def test_sparse_group_reduce_matches_jax(cap):
    ids, mask, cols, nulls = _rows(1)
    _, want = _jax(ids, mask, cols, nulls, cap)
    _, got = _port(ids, mask, cols, nulls, cap)
    assert set(got) == set(want)
    n_groups = int(want["_count"])
    assert int(got["_count"]) == n_groups
    assert (n_groups > cap) == (cap == 256)  # the overflow case
    assert (want["_keys"] != jsparse.SENTINEL).sum() == min(cap, n_groups)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_sparse_group_reduce_no_rows():
    ids, mask, cols, nulls = _rows(2, 500)
    mask[:] = False
    _, want = _jax(ids, mask, cols, nulls, 64)
    _, got = _port(ids, mask, cols, nulls, 64)
    assert int(got["_count"]) == 0
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ---------------------------------------------------------------------------
# The mesh's merge: merge_sparse, the theta union and the exchange


_PARTS: dict = {}


def _parts(seed, d, cap):
    """d devices' compact tables of one row set (its rows dealt round
    robin), from the port's sparse_group_reduce (which equals the JAX
    package's, above); made once per (seed, d, cap)."""
    if (seed, d, cap) in _PARTS:
        return _PARTS[(seed, d, cap)]
    ids, mask, cols, nulls = _rows(seed)
    parts = []
    for c in range(d):
        sl = slice(c, None, d)
        _, out = _port([i[sl] for i in ids], mask[sl],
                       {k: v[sl] for k, v in cols.items()},
                       {k: v[sl] for k, v in nulls.items()}, cap)
        parts.append(out)
    _PARTS[(seed, d, cap)] = parts
    return parts


@pytest.mark.parametrize("d, cap", [(8, 4096), (3, 4096), (8, 512)])
def test_merge_sparse_matches_jax(d, cap):
    """The broker's merge of D compact tables equals the JAX package's
    merge_sparse (xp=np) exactly; at cap 512 the merged groups overflow
    and _count still tells the true number."""
    parts = _parts(3, d, 4096)
    want = jsparse.merge_sparse(parts, _plans(jgroupby), cap, np)
    got = tsparse.merge_sparse(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in parts],
        _plans(tgroupby), cap)
    assert set(got) == set(want)
    assert (int(want["_count"]) > cap) == (cap == 512)
    for name in want:
        g = got[name].numpy()
        assert g.shape == np.asarray(want[name]).shape, name
        np.testing.assert_array_equal(g, np.asarray(want[name]),
                                      err_msg=name)


def test_seg_theta_union_matches_jax():
    rng = np.random.default_rng(9)
    n, k, cap, n_parts = 400, 16, 150, 5
    gid = np.sort(rng.integers(0, cap + 1, n)).astype(np.int32)
    rows = np.sort(np.where(rng.random((n, k)) < 0.8,
                            rng.integers(0, 60, (n, k)) / 64.0, 1.0), axis=1)
    # a part contributes at most one row per group: cap the group sizes
    gid = np.minimum(gid, cap)
    _, first = np.unique(gid, return_index=True)
    rank = np.arange(n) - np.repeat(first, np.diff(np.append(first, n)))
    keep = rank < n_parts
    gid, rows = gid[keep], rows[keep]
    want = jsparse._seg_theta_union(rows, gid, cap, n_parts, np)
    got = tsparse._seg_theta_union(torch.from_numpy(rows),
                                   torch.from_numpy(gid).to(torch.int64),
                                   cap, n_parts)
    np.testing.assert_array_equal(got.numpy(), want)


def test_owner_of_is_the_fibonacci_hash():
    from test_sparse_groupby import _fib_owner
    keys = np.random.default_rng(4).integers(-2**62, 2**62, 5000)
    for d in (1, 2, 3, 8):
        np.testing.assert_array_equal(
            tsparse.owner_of(torch.from_numpy(keys), d).numpy(),
            _fib_owner(keys, d))


@pytest.mark.parametrize("d", [8, 2])
def test_exchange_equals_one_merge(d):
    """The exchange (each device's entries to their owners, merged per
    owner) holds exactly the groups one merge of every table holds."""
    parts = _parts(3, d, 4096)
    tparts = [{k: torch.from_numpy(v) for k, v in p.items()} for p in parts]
    counts = [int(p["_count"]) for p in parts]
    merged, caps = tsparse.exchange(tparts, counts,
                                    [torch.device("cpu")] * d,
                                    _plans(tgroupby), 1 << 20)
    owned = [int(m["_count"]) for m in merged]
    assert all(c <= cap for c, cap in zip(owned, caps))
    keys = torch.cat([m["_keys"][:c] for m, c in zip(merged, owned)])
    order = torch.argsort(keys)
    want = jsparse.merge_sparse(parts, _plans(jgroupby), 4096, np)
    n = int(want["_count"])
    assert sum(owned) == n
    for name in want:
        if name == "_count":
            continue
        got = torch.cat([m[name][:c] for m, c in zip(merged, owned)])[order]
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want[name])[:n],
                                      err_msg=name)
    # every key sits with its owner
    for o, (m, c) in enumerate(zip(merged, owned)):
        assert (tsparse.owner_of(m["_keys"][:c], d) == o).all()


# ---------------------------------------------------------------------------
# The sparse group-by on the engine at D = 8: tests/test_sparse_groupby.py's
# multi-chip, exchange and skew cases, against the JAX engine on one device

import pandas as pd  # noqa: E402

import test_sparse_groupby as jax_sparse_tests  # noqa: E402
from tpu_olap import Engine as JaxEngine  # noqa: E402
from tpu_olap.executor import EngineConfig as JaxConfig  # noqa: E402
from tpu_olap_torch.bench import assert_frame_parity  # noqa: E402

from _torch_port import cpu_engine, sql_literals  # noqa: E402

MESH_WORDS = ("multichip", "exchange", "skew")
# the SQL those JAX tests run over their table `t` (the same frame as
# test_sparse_groupby._df; the k-keyed table of the capacity test is
# held below at a smaller size)
MESH_SQL = [jax_sparse_tests.SQL] + [
    s for name, s in sql_literals(jax_sparse_tests)
    if any(w in name for w in MESH_WORDS) and " FROM t " in s
    and name != "test_exchange_scales_past_per_chip_budget"]


@pytest.fixture(scope="module")
def mesh_sparse(request):
    jax = jax_sparse_tests._engine()
    out = {"jax": jax, "frames": {}}
    for merge in ("exchange", "gather"):
        e = cpu_engine(dense_group_budget=64, num_shards=8,
                       sparse_merge=merge)
        e.register_table("t", jax_sparse_tests._df(), time_column="ts",
                         block_rows=512)
        out[merge] = e
    request.addfinalizer(lambda: [out[m].close()
                                  for m in ("exchange", "gather")])
    return out


@pytest.mark.parametrize("merge", ["exchange", "gather"])
@pytest.mark.parametrize("sql", MESH_SQL)
def test_mesh_sparse_matches_jax(mesh_sparse, sql, merge):
    eng = mesh_sparse[merge]
    got = eng.sql(sql)
    m = eng.runner.last_metrics
    assert m["route"] == "sparse" and m["num_shards"] == 8
    assert m.get("sparse_merge") == ("exchange" if merge == "exchange"
                                     else None)
    frames = mesh_sparse["frames"]
    if sql not in frames:
        frames[sql] = mesh_sparse["jax"].sql(sql)
    assert_frame_parity(got, frames[sql], float_rtol=1e-12,
                        ordered="ORDER BY" in sql, label=sql)


def _skew_df(values, rows_per_group=3):
    """test_sparse_groupby._skewed_engine's frame."""
    vals = np.repeat(values, rows_per_group)
    return pd.DataFrame({
        "ts": pd.to_datetime("2022-01-01")
        + pd.to_timedelta(np.arange(len(vals)) % 9973, unit="s"),
        "k": vals,
        "v": np.ones(len(vals), dtype=np.int64),
    })


def _skew_pair(request, n_groups, **kw):
    df = _skew_df(jax_sparse_tests._skewed_values(n_groups))
    jax = JaxEngine(JaxConfig(dense_group_budget=64, **kw))
    port = cpu_engine(dense_group_budget=64, num_shards=8,
                      sparse_merge="exchange", **kw)
    request.addfinalizer(port.close)
    for e in (jax, port):
        e.register_table("t", df, time_column="ts", block_rows=512)
    return jax, port


def test_exchange_skewed_single_owner_parity(request):
    """Every key hashes to one owner device: that owner's table takes
    every group, and the answers stay the JAX engine's."""
    jax, port = _skew_pair(request, 1500)
    sql = jax_sparse_tests.SKEW_SQL
    got = port.sql(sql)
    m = port.runner.last_metrics
    assert m["sparse_merge"] == "exchange" and m["result_groups"] == 1500
    assert m["result_cap_owner"] >= 1500  # one owner holds them all
    assert_frame_parity(got, jax.sql(sql))


def test_exchange_skew_absorbed_past_the_device_budget(request):
    jax, port = _skew_pair(request, 1200, sparse_group_budget=512)
    sql = jax_sparse_tests.SKEW_SQL
    got = port.sql(sql)
    m = port.runner.last_metrics
    assert port.last_plan.fallback_reason is None
    assert m["sparse_merge"] == "exchange" and m["result_groups"] == 1200
    assert_frame_parity(got, jax.sql(sql))


def test_exchange_overflow_falls_back_cleanly(request):
    jax, port = _skew_pair(request, 1200, sparse_group_budget=64)
    port.config.fallback_on_device_failure = True
    sql = jax_sparse_tests.SKEW_SQL
    got = port.sql(sql)
    assert "sparse budget" in (port.last_plan.fallback_reason or "")
    assert_frame_parity(got, jax.sql(sql))


def test_exchange_scales_past_per_chip_budget(request):
    """One group per row, 8,000 groups on 8 devices under a budget of
    2^11 per device: "gather" (one device's budget) refuses and the
    fallback answers, "exchange" (8 x the budget) answers on the
    devices."""
    n = 8_000
    df = pd.DataFrame({
        "ts": pd.to_datetime("2022-01-01")
        + pd.to_timedelta(np.arange(n) // 20, unit="min"),
        "k": np.arange(n, dtype=np.int64),
        "v": np.ones(n, dtype=np.int64),
    })
    engines = {}
    for merge in ("exchange", "gather"):
        e = engines[merge] = cpu_engine(
            dense_group_budget=64, num_shards=8, sparse_merge=merge,
            sparse_group_budget=1 << 11, fallback_on_device_failure=True)
        request.addfinalizer(e.close)
        e.register_table("t", df, time_column="ts", block_rows=1 << 10)
    ex = engines["exchange"]
    got = ex.sql("SELECT k, sum(v) AS s FROM t GROUP BY k LIMIT 7")
    m = ex.runner.last_metrics
    assert m["sparse_merge"] == "exchange" and m["result_groups"] == n
    assert len(got) == 7 and (got.s == 1).all()
    sub = ex.sql("SELECT k, sum(v) AS s FROM t WHERE k < 1000 "
                 "GROUP BY k ORDER BY k")
    assert list(sub.k) == list(range(1000)) and (sub.s == 1).all()
    ga = engines["gather"]
    ga.sql("SELECT k, sum(v) AS s FROM t GROUP BY k LIMIT 7")
    assert "sparse budget" in (ga.last_plan.fallback_reason or "")

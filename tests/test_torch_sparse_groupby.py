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

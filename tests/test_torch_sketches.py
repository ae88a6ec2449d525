"""The port's sketch kernels (tpu_olap_torch.kernels.hashing / hll / theta)
against the JAX package's, on the same seeded inputs. Hashes, HLL
registers and theta tables must be equal exactly; estimates are exact
too, except the HLL estimate, at rtol 1e-12 (it takes a log; see
test_hll_estimate_matches_jax)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_olap.kernels import hashing as jhash
from tpu_olap.kernels import hll as jhll
from tpu_olap.kernels import theta as jtheta
from tpu_olap_torch.kernels import groupby as tgroupby
from tpu_olap_torch.kernels import hashing as thash
from tpu_olap_torch.kernels import hll as thll
from tpu_olap_torch.kernels import theta as ttheta

EDGES = np.array([0, -1, np.iinfo(np.int32).min, np.iinfo(np.int32).max, 1,
                  -2, 1 << 30], np.int32)


@pytest.fixture(autouse=True)
def x64():
    # the JAX package enables x64 whenever an engine starts; its sketch
    # index math needs int64 lanes
    jax.config.update("jax_enable_x64", True)


def _ints(seed, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, n,
                     dtype=np.int64).astype(np.int32)
    return np.concatenate([x, EDGES])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_hash32_int_bit_exact():
    x = _ints(0)
    want = np.asarray(jhash.hash32_int(jnp.asarray(x), jnp))
    got = thash.hash32_int(_t(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the JAX package's numpy branch agrees as well
    np.testing.assert_array_equal(got, jhash.hash32_int(x, np))


def test_hash_combine_bit_exact():
    a, b = _ints(1), _ints(2)
    want = np.asarray(jhash.hash_combine(jnp.asarray(a), jnp.asarray(b),
                                         jnp))
    np.testing.assert_array_equal(thash.hash_combine(_t(a), _t(b)).numpy(),
                                  want)


def test_to_unit_float_exact():
    x = _ints(3)
    want = np.asarray(jhash.to_unit_float(jnp.asarray(x), jnp))
    np.testing.assert_array_equal(thash.to_unit_float(_t(x)).numpy(), want)


def test_wide_fold_and_float_bits_match_jax():
    """The int64 fold and the float32 bit view of _hash_fields, against
    numpy's astype/view (the JAX package's own rules)."""
    rng = np.random.default_rng(4)
    x = rng.integers(-(1 << 62), 1 << 62, 2000, dtype=np.int64)
    want = (x ^ (x >> 32)).astype(np.int32)
    got = thash.wrap_int32(_t(x) ^ (_t(x) >> 32)).numpy()
    np.testing.assert_array_equal(got, want)
    f = rng.normal(0, 1e6, 2000)
    np.testing.assert_array_equal(tgroupby._float_bits(_t(f)).numpy(),
                                  f.astype(np.float32).view(np.int32))


def _hll_case(seed, n, K):
    rng = np.random.default_rng(seed)
    h = _ints(seed, n)
    valid = rng.random(h.size) < 0.8
    key = rng.integers(0, K, h.size).astype(np.int32)
    return h, valid, key


@pytest.mark.parametrize("K", [1, 37])
def test_hll_update_registers_exact(K):
    h, valid, key = _hll_case(5 + K, 20000, K)
    want = np.asarray(jhll.hll_update(
        jnp.asarray(h), jnp.asarray(valid),
        jnp.asarray(np.where(valid, key, 0)), K, jnp))
    got = thll.hll_update(_t(h), _t(valid), _t(key), K)
    assert got.dtype == torch.int32 and tuple(got.shape) == (K, 2048)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hll_estimate_matches_jax():
    """Large groups (harmonic mean) and small ones (linear counting).
    The harmonic sum of 2^-rho is exact in float64, so the large-group
    estimates are bit-equal; linear counting takes a log, where XLA's
    differs from the correctly rounded one (numpy's and torch's) by one
    ulp on a few of the 2048 possible inputs — hence rtol 1e-12 against
    the jitted function, and exact against the JAX package's host
    (numpy) estimate."""
    rows = []
    for seed, n, K in ((6, 200000, 3), (7, 3000, 9), (8, 40, 5)):
        h, valid, key = _hll_case(seed, n, K)
        rows.append(thll.hll_update(_t(h), _t(valid), _t(key), K).numpy())
    regs = np.concatenate(rows)
    got = thll.hll_estimate(_t(regs)).numpy()
    want = np.asarray(jax.jit(lambda r: jhll.hll_estimate(
        r, jnp, np.float64))(jnp.asarray(regs)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got, jhll.hll_estimate(regs))
    big = regs.min(axis=1) > 0
    assert big.any() and (~big).any()
    np.testing.assert_array_equal(got[big], want[big])


def _theta_case(seed, n, K, dup_pool):
    """Hashes drawn from a small pool, so (group, hash) pairs repeat; the
    groups hold from a few to many more distinct hashes than k."""
    rng = np.random.default_rng(seed)
    pool = _ints(seed, dup_pool)
    h = pool[rng.integers(0, pool.size, n)]
    key = np.minimum(rng.geometric(0.6, n) - 1, K - 1).astype(np.int32)
    valid = rng.random(n) < 0.9
    return h, valid, key


def _jax_theta(h, valid, key, K, k):
    return np.asarray(jtheta.theta_update(
        jnp.asarray(h), jnp.asarray(valid), jnp.asarray(key), K, k, jnp))


@pytest.mark.parametrize("k", [16, 64])
def test_theta_update_and_merge_exact(k):
    K = 9
    h1, v1, g1 = _theta_case(10 + k, 3000, K, 700)
    h2, v2, g2 = _theta_case(20 + k, 2500, K, 700)
    want1 = _jax_theta(h1, v1, g1, K, k)
    want2 = _jax_theta(h2, v2, g2, K, k)
    got1 = ttheta.theta_update(_t(h1), _t(v1), _t(g1), K, k)
    got2 = ttheta.theta_update(_t(h2), _t(v2), _t(g2), K, k)
    np.testing.assert_array_equal(got1.numpy(), want1)
    np.testing.assert_array_equal(got2.numpy(), want2)
    filled = (want1 < 1.0).sum(axis=1)
    assert (filled == k).any() and (filled < k).any()  # above and below k
    np.testing.assert_array_equal(
        ttheta.theta_merge(got1, got2).numpy(),
        np.asarray(jtheta.theta_merge(jnp.asarray(want1),
                                      jnp.asarray(want2), jnp)))
    for t in (want1, np.asarray(jtheta.theta_merge(
            jnp.asarray(want1), jnp.asarray(want2), jnp))):
        np.testing.assert_array_equal(
            ttheta.theta_estimate(_t(t)).numpy(),
            np.asarray(jtheta.theta_estimate(jnp.asarray(t), jnp,
                                             np.float64)))


def test_theta_no_valid_rows_is_empty():
    h, _, g = _theta_case(30, 100, 4, 50)
    v = np.zeros(h.size, bool)
    np.testing.assert_array_equal(
        ttheta.theta_update(_t(h), _t(v), _t(g), 4, 16).numpy(),
        _jax_theta(h, v, g, 4, 16))


def test_merge_partials_and_radix_match_jax():
    from tpu_olap.kernels import groupby as jgroupby
    K, k = 6, 16
    plans_t = [tgroupby.AggPlan("n", "count", (), np.int64),
               tgroupby.AggPlan("lo", "min", ("x",), np.int64),
               tgroupby.AggPlan("u", "hll", ("x",), np.int32),
               tgroupby.AggPlan("th", "theta", ("x",), np.float64,
                                theta_k=k)]
    plans_j = [jgroupby.AggPlan(p.name, p.kind, p.fields, p.acc_dtype,
                                theta_k=p.theta_k) for p in plans_t]
    assert tgroupby.partials_radix(plans_t) == \
        jgroupby.partials_radix(plans_j)
    rng = np.random.default_rng(40)
    parts = []
    for s in (41, 42):
        h, v, g = _theta_case(s, 800, K, 300)
        parts.append({
            "_rows": rng.integers(0, 9, K).astype(np.int32),
            "n": rng.integers(0, 99, K).astype(np.int64),
            "lo": rng.integers(-50, 50, K).astype(np.int64),
            "_nn_lo": rng.integers(0, 9, K).astype(np.int32),
            "u": thll.hll_update(_t(h), _t(v), _t(g), K).numpy(),
            "th": _jax_theta(h, v, g, K, k)})
    want = jgroupby.merge_partials(
        *[{n: jnp.asarray(a) for n, a in p.items()} for p in parts],
        plans_j)
    got = tgroupby.merge_partials(
        *[{n: _t(a) for n, a in p.items()} for p in parts], plans_t)
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))

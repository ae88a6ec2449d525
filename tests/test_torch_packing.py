"""The port's packed single-fetch path (tpu_olap_torch.executor.packing)
against the JAX package's build_packer (jitted, on the CPU) over the same
partials: count, sum, min, max, HLL and theta, with the cap below and
above the number of present groups. The buffers must agree word for
word; the HLL slab's linear-counting estimates take a log, where XLA's
differs from the correctly rounded one by an ulp on a few inputs, so that
slab is held exactly against the JAX package's host (numpy) estimate and
at rtol 1e-12 against the jitted one. Then unpack/densify round trips."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_olap.executor import packing as jpacking
from tpu_olap.kernels import groupby as jgroupby
from tpu_olap.kernels import hll as jhll
from tpu_olap_torch.executor import packing as tpacking
from tpu_olap_torch.kernels import groupby as tgroupby
from tpu_olap_torch.kernels import hll as thll
from tpu_olap_torch.kernels import theta as ttheta

K, THETA_K = 300, 32
KINDS = (("n", "count", np.int64), ("s", "sum", np.int64),
         ("f", "sum", np.float64), ("lo", "min", np.int64),
         ("hi", "max", np.float64), ("d", "hll", np.int32),
         ("t", "theta", np.float64))


@pytest.fixture(autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)


def _plan(mod):
    plans = [mod.AggPlan(n, kind, () if kind == "count" else ("c",), dt,
                         theta_k=THETA_K if kind == "theta" else 0)
             for n, kind, dt in KINDS]
    return SimpleNamespace(agg_plans=plans, total_groups=K)


def _partials(seed=0):
    """Dense partial tables as a reduce leaves them: empty groups hold
    zeros, identities, empty registers and empty theta slots."""
    rng = np.random.default_rng(seed)
    rows = np.where(rng.random(K) < 0.6, rng.integers(1, 5000, K), 0)
    live = rows > 0
    nn = np.where(live & (rng.random(K) < 0.9), rows, 0).astype(np.int32)
    h = rng.integers(-(1 << 31), 1 << 31, 200_000).astype(np.int32)
    key = rng.choice(np.nonzero(live)[0], h.size).astype(np.int32)
    # groups of very different sizes: both HLL regimes
    key = np.where(rng.random(h.size) < 0.7, key[0], key)
    th = torch.from_numpy(h)
    return {
        "_rows": rows.astype(np.int64),
        "n": rows.astype(np.int64),
        "s": np.where(live, rng.integers(-10**15, 10**15, K), 0),
        "f": np.where(live, rng.normal(0, 1e9, K), 0.0),
        "lo": np.where(nn > 0, rng.integers(-10**9, 10**9, K),
                       np.iinfo(np.int64).max),
        "_nn_lo": nn,
        "hi": np.where(nn > 0, rng.normal(0, 1e3, K), -np.inf),
        "_nn_hi": nn,
        "d": thll.hll_update(th, torch.ones(h.size, dtype=torch.bool),
                             torch.from_numpy(key), K).numpy(),
        "t": ttheta.theta_update(th[:4000], torch.ones(4000, dtype=torch.bool),
                                 torch.from_numpy(key[:4000]), K,
                                 THETA_K).numpy(),
    }


def _buffers(partials, cap):
    jplan, tplan = _plan(jgroupby), _plan(tgroupby)
    cfg = SimpleNamespace(result_group_cap=cap, enable_x64=True)
    jl = jpacking.make_layout(jplan, cfg)
    tl = tpacking.make_layout(tplan, cfg)
    assert (tl.cap, tl.total, tl.fields) == (jl.cap, jl.total, jl.fields)
    jfn = jax.jit(jpacking.build_packer(
        lambda *a: {n: jnp.asarray(v) for n, v in partials.items()},
        jplan, jl))
    jbuf = np.asarray(jfn(None, None, None, None))
    tbuf = tpacking.build_packer(
        lambda *a: {n: torch.from_numpy(v) for n, v in partials.items()},
        tplan, tl)(None, None, None, None).numpy()
    return jbuf, tbuf, tl


@pytest.mark.parametrize("cap", [64, 1024])
def test_packed_buffer_matches_jax(cap):
    partials = _partials()
    jbuf, tbuf, layout = _buffers(partials, cap)
    assert tbuf.dtype == np.int32 and tbuf.shape == jbuf.shape
    n_present = int((partials["_rows"] > 0).sum())
    assert (n_present > layout.cap) == (cap == 64)
    jc, jidx, jarr = jpacking.unpack(jbuf, layout)
    tc, tidx, tarr = tpacking.unpack(tbuf, layout)
    assert tc == jc == n_present
    # header, indices and every slab but the HLL one: word for word
    hll_at = 1 + layout.cap
    for name, dt in layout.fields:
        if name == "d":
            break
        hll_at += layout.cap * dt.itemsize // 4
    hll_end = hll_at + 2 * layout.cap
    np.testing.assert_array_equal(tbuf[:hll_at], jbuf[:hll_at])
    np.testing.assert_array_equal(tbuf[hll_end:], jbuf[hll_end:])
    np.testing.assert_array_equal(tidx, jidx)
    n = min(tc, layout.cap)
    regs = partials["d"][tidx]
    np.testing.assert_array_equal(tarr["d"], jhll.hll_estimate(regs)[:n])
    np.testing.assert_allclose(tarr["d"], jarr["d"], rtol=1e-12, atol=0)
    assert (regs.min(axis=1) == 0).any() and (regs.min(axis=1) > 0).any()


@pytest.mark.parametrize("cap", [64, 1024])
def test_unpack_densify_round_trip(cap):
    partials = _partials(1)
    _, tbuf, layout = _buffers(partials, cap)
    count, idx, compact = tpacking.unpack(tbuf, layout)
    plans = _plan(tgroupby).agg_plans
    dense = tpacking.densify(idx, compact, layout, plans)
    fin = tpacking.device_finalize(
        {n: torch.from_numpy(v) for n, v in partials.items()}, plans)
    present = np.nonzero(partials["_rows"] > 0)[0]
    assert count == present.size and list(idx) == list(present[:cap])
    kinds = {p.name: p.kind for p in plans}
    for name, dt in layout.fields:
        want = fin[name].numpy().astype(dt)
        got = dense[name]
        assert got.dtype == dt and got.shape == (K,)
        np.testing.assert_array_equal(got[idx], want[idx], err_msg=name)
        rest = np.setdiff1d(np.arange(K), idx)
        fill = np.nan if kinds.get(name) in ("min", "max") else 0
        np.testing.assert_array_equal(got[rest], np.full(rest.size, fill, dt))

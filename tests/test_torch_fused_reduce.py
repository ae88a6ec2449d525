"""The port's fused reduce (tpu_olap_torch.kernels.fused_reduce) against
the JAX package's Pallas kernel B1 (kernels/pallas_reduce.py).

Both packages lower the same SQL over identical segments (the JAX ingest
carried into the port, segments/carry.py); B1 runs in Pallas interpret
mode on the CPU backend, the port's kernel through its plain version
(CPU tensors: the traced row program run by torch ops, then the
reduce). The partial dicts must be equal exactly — integer sums and
counts, so the tolerance is 0. The plain version is also held against
the port's generic group_reduce, and the CUDA kernel against the plain
version on a card (skipped without one).
"""

import numpy as np
import pytest
import torch

from tpu_olap import Engine as JaxEngine
from tpu_olap.bench import ssb as jax_ssb
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.executor.lowering import lower as jax_lower
from tpu_olap_torch.bench import assert_frame_parity, ssb
from tpu_olap_torch.executor.lowering import lower
from tpu_olap_torch.kernels import fused_reduce as fr
from tpu_olap_torch.kernels import rowprog
from tpu_olap_torch.kernels.groupby import AggPlan, group_reduce

from _torch_port import carry_into, cpu_engine
from test_pallas_reduce import (COLCMP_QUERIES, MINMAX_QUERIES,
                                PRECOMPUTED_DIM_QUERIES, WIDENED_QUERIES)
from test_pallas_reduce import QUERIES as PALLAS_QUERIES
from test_pallas_reduce import _table as pallas_table


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) pairs per table, both forcing the fused
    kernel; the port serves the JAX ingest carried across."""
    out = {}
    jax_ssb_eng = JaxEngine(JaxConfig(use_pallas="force"))
    tables = jax_ssb.generate_tables(60_000, 0)
    jax_ssb.register_ssb(jax_ssb_eng, tables=tables, block_rows=8192)
    port = cpu_engine(use_fused_reduce="force")
    carry_into(port, jax_ssb_eng, "lineorder", ssb.star_schema())
    out["ssb"] = (jax_ssb_eng, port)
    jax_t = JaxEngine(JaxConfig(use_pallas="force"))
    jax_t.register_table("t", pallas_table(), time_column="ts",
                         block_rows=512)
    port_t = cpu_engine(use_fused_reduce="force")
    carry_into(port_t, jax_t, "t")
    out["t"] = (jax_t, port_t)
    return out


def _partials(jax_eng, port, sql):
    jplan = jax_eng.planner.plan(sql)
    tplan = port.planner.plan(sql)
    assert jplan.rewritten and tplan.rewritten
    jphys = jax_lower(jplan.query, jplan.entry.segments, jax_eng.config)
    tphys = lower(tplan.query, tplan.entry.segments, port.config)
    assert jphys.pallas_reason is None, jphys.pallas_reason
    assert tphys.fused_reason is None, tphys.fused_reason
    return (jax_eng.runner._run_partials(jphys, {}),
            port.runner._run_partials(tphys, {}))


# the 13 SSB queries, then every B1-eligible query of test_pallas_reduce:
# buckets and interval masks, remap/timeformat dims, columnComparison
T_QUERIES = (PALLAS_QUERIES + MINMAX_QUERIES + WIDENED_QUERIES
             + PRECOMPUTED_DIM_QUERIES + COLCMP_QUERIES)
CASES = ([("ssb", q) for q in ssb.QUERIES.values()]
         + [("t", q) for q in T_QUERIES])
IDS = list(ssb.QUERIES) + [f"t{i}" for i in range(len(T_QUERIES))]


@pytest.mark.parametrize("table,sql", CASES, ids=IDS)
def test_partials_equal_pallas_interpret(engines, table, sql):
    want, got = _partials(*engines[table], sql)
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


SLOTS = (("k", "col", torch.int32), ("a", "col", torch.int32),
         ("b", "col", torch.int16), ("c", "col", torch.int32),
         ("f", "col", torch.bool), ("nb", "null", torch.bool),
         ("", "base", torch.bool))


def _row_fn(s):
    """mask = base ∧ a % 3 != 0; key = k; columns: _rows, sum(a), a
    count filtered by f, the non-null count of b, then min(b) and a
    negated max(c) over b's non-null rows."""
    k, a, b, c, f, nb, base = s
    nn = ~nb
    mask = base & (torch.remainder(a, 3) != 0)
    sums = [(None, None), (a, None), (None, f), (None, nn)]
    mins = [(b, nn), (-c, nn)]
    return mask, k, sums, mins


def _random_case(n, K, seed, device="cpu"):
    """Program inputs with negatives, a filtered count, a min and a
    (negated) max over nullable input; some groups stay empty. Rows lie
    in [S, R] blocks with some invalid rows and one pruned segment."""
    rng = np.random.default_rng(seed)
    R = 1000
    S = n // R
    hi = max(1, K - 2) if K > 2 else K
    cols = {"k": rng.integers(0, hi, n).astype(np.int32),
            "a": rng.integers(-(2 ** 31) + 1, 2 ** 31 - 1, n)
            .astype(np.int32),
            "b": rng.integers(-30000, 30000, n).astype(np.int16),
            "c": rng.integers(-(2 ** 31) + 1, 2 ** 31 - 1, n)
            .astype(np.int32),
            "f": rng.random(n) < 0.5, "nb": rng.random(n) < 0.3}
    valid = rng.random((S, R)) < 0.9
    seg = np.ones(S, bool)
    seg[S // 2] = False
    t = {k: torch.from_numpy(v.reshape(S, R)).to(device)
         for k, v in cols.items()}
    return (t, torch.from_numpy(valid).to(device),
            torch.from_numpy(seg).to(device))


def _inputs(prog, t):
    return [None if kind == "base" else t[name]
            for name, kind, _ in prog.slots]


@pytest.mark.parametrize("K", [1, 7, 300])
@pytest.mark.parametrize("seed", [0, 1])
def test_ref_matches_group_reduce(K, seed):
    """The wrapper's plain version vs the generic group_reduce on the
    same rows: _rows, a sum, a filtered count, a min and a max over
    nullable input."""
    prog = rowprog.trace(_row_fn, SLOTS)
    t, valid, seg = _random_case(5000, K, seed)
    sums, mins = fr.fused_reduce(prog, _inputs(prog, t), valid, seg, K)

    flat = {k: v.reshape(-1) for k, v in t.items()}
    base = (valid & seg[:, None]).reshape(-1)
    mask = base & (torch.remainder(flat["a"], 3) != 0)
    env = {"cols": {"a": flat["a"], "b": flat["b"], "c": flat["c"]},
           "nulls": {"b": flat["nb"], "c": flat["nb"]}}
    plans = [AggPlan("s", "sum", ("a",), np.int64),
             AggPlan("n", "count", (), np.int64,
                     filter_fn=lambda e, c: flat["f"]),
             AggPlan("mn", "min", ("b",), np.int64),
             AggPlan("mx", "max", ("c",), np.int64)]
    want = group_reduce(flat["k"], mask, env, plans, K, {})
    assert torch.equal(sums[:, 0], want["_rows"])
    assert torch.equal(sums[:, 1], want["s"])
    assert torch.equal(sums[:, 2], want["n"])
    assert torch.equal(sums[:, 3].int(), want["_nn_mn"])
    present = want["_nn_mn"] > 0
    assert torch.equal(mins[:, 0][present], want["mn"][present].int())
    assert torch.equal((-mins[:, 1])[present], want["mx"][present].int())
    # empty groups carry the identity
    assert (mins[:, 0][~present] == fr.MAX_VALUE).all()


def test_ref_all_counts_and_empty_rows():
    prog = rowprog.trace(lambda s: (s[0], torch.zeros_like(s[0], dtype=
                                                           torch.int32),
                                    [(None, None)], []),
                         (("", "base", torch.bool),))
    valid = torch.zeros((0, 16), dtype=torch.bool)
    seg = torch.zeros(0, dtype=torch.bool)
    sums, mins = fr.fused_reduce(prog, [None], valid, seg, 4)
    assert sums.shape == (4, 1) and mins.shape == (4, 0)
    assert int(sums.sum()) == 0


@pytest.mark.parametrize("bad", ["key_dtype", "mask_shape", "vals_rows",
                                 "count_in_min", "sel_missing"])
def test_wrapper_rejects_bad_inputs(bad):
    prog = rowprog.trace(_row_fn, SLOTS)
    t, valid, seg = _random_case(2000, 8, 0)
    inputs = _inputs(prog, t)
    K = 8
    if bad == "key_dtype":      # a stream of another dtype than traced
        inputs[0] = inputs[0].long()
    elif bad == "mask_shape":   # validity must be [S, R]
        valid = valid.reshape(-1)
    elif bad == "vals_rows":    # a stream of another row count
        inputs[1] = inputs[1][:1]
    elif bad == "count_in_min":  # a count among the minimums
        with pytest.raises(ValueError):
            rowprog.trace(lambda s: (s[-1], s[0], [], [(None, None)]),
                          SLOTS)
        return
    else:                       # a missing stream
        inputs = inputs[:-2] + inputs[-1:]
    with pytest.raises(ValueError):
        fr.fused_reduce(prog, inputs, valid, seg, K)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 264, 6952, 65536])
def test_cuda_kernel_matches_plain_version(K):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    prog = rowprog.trace(_row_fn, SLOTS)
    t, valid, seg = _random_case(1 << 20, K, 3, device="cuda")
    args = (prog, _inputs(prog, t), valid, seg, K)
    before = fr.launches
    got = fr.fused_reduce(*args)
    torch.cuda.synchronize()
    assert fr.launches == before + 1
    want = fr.fused_reduce_ref(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_group_space_past_cap_takes_generic_reduce(engines):
    """Past the cap (65,536 groups) the plan keeps the generic reduce and
    still answers like the JAX package's generic reduce."""
    jax_eng, port = engines["t"]
    sql = ("SELECT region, price, count(*) AS n FROM t "
           "GROUP BY region, price ORDER BY region, price")
    plan = port.planner.plan(sql)
    phys = lower(plan.query, plan.entry.segments, port.config)
    assert phys.total_groups > fr.GROUP_CAP
    assert "exceeds fused cap" in phys.fused_reason
    want = JaxEngine(JaxConfig(use_pallas="never"))
    want.register_table("t", pallas_table(), time_column="ts",
                        block_rows=512)
    assert_frame_parity(port.sql(sql), want.sql(sql))

"""The PyTorch port's shared-scan batch executor (tpu_olap_torch.executor.
batch), on the CPU, against the JAX package's and against its own single
statements.

One JAX engine (use_pallas="never") and port engines (device="cpu") hold
the same frame, made from a seed with `tests/test_batch_executor.py`'s
recipe; the statements are that file's `BATCH` list. Frames compare with
the parity harness across the packages (floats at rtol 1e-9: summation
order differs) and exactly (`pd.testing.assert_frame_equal`) within the
port, where a batch leg reads the same rows in the same order as the
single statement. On the CPU the multi-leg kernel's wrapper runs its
plain version; its generated source is checked here by a host C++
compiler for syntax only, and on the card by `chip_smoke.py` phase 11.
"""

import re
import shutil
import subprocess
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.kernels import filtereval as jax_fe
from tpu_olap.kernels import groupby as jax_gb
from tpu_olap.ir.filters import filter_from_json as jax_filter
from tpu_olap_torch.bench import assert_frame_parity
from tpu_olap_torch.executor import batch
from tpu_olap_torch.ir.filters import filter_from_json
from tpu_olap_torch.kernels import filtereval as fe
from tpu_olap_torch.kernels import fused_reduce as fr
from tpu_olap_torch.kernels import groupby as gb
from tpu_olap_torch.kernels import rowgen, rowprog

from test_batch_executor import BATCH
from test_torch_fused_reduce import SLOTS, _inputs, _random_case, _row_fn
from _torch_port import cpu_engine


def _frame():
    """tests/test_batch_executor.py::frame's recipe."""
    rng = np.random.default_rng(19)
    rows = 30_000
    return pd.DataFrame({
        "ts": pd.to_datetime("2024-01-01")
        + pd.to_timedelta(rng.integers(0, 86400 * 120, rows), unit="s"),
        "g": rng.choice([f"g{i}" for i in range(16)], rows),
        "h": rng.choice(["a", "b", "c"], rows),
        "v": rng.integers(0, 1000, rows).astype(np.int64),
        "w": rng.normal(size=rows),
    })


@pytest.fixture(scope="module")
def engines():
    df = _frame()
    jax_eng = JaxEngine(JaxConfig(use_pallas="never"))
    jax_eng.register_table("t", df, time_column="ts", block_rows=1 << 12)
    out = {"jax": jax_eng}
    for mode in ("force", "never"):
        e = cpu_engine(use_fused_reduce=mode)
        e.register_table("t", df, time_column="ts", block_rows=1 << 12)
        out[mode] = e
    return out


@pytest.fixture(scope="module")
def singles(engines):
    """The port's own Engine.sql of every BATCH statement, per mode."""
    return {mode: [engines[mode].sql(q) for q in BATCH]
            for mode in ("force", "never")}


@pytest.mark.parametrize("mode", ["force", "never"])
def test_sql_batch_matches_jax_and_own_singles(engines, singles, mode):
    eng = engines[mode]
    got = eng.sql_batch(BATCH)
    stmts = eng.runner.last_metrics["statements"]
    assert any(m.get("route") == "batch" for m in stmts)
    want = engines["jax"].sql_batch(BATCH)
    for i, (g, w, s) in enumerate(zip(got, want, singles[mode])):
        assert_frame_parity(g, w, label=f"leg {i} vs the JAX package")
        pd.testing.assert_frame_equal(g, s, obj=f"leg {i} vs Engine.sql")


def test_fused_group_metrics_and_dedupe(engines):
    eng = engines["force"]
    table = eng.catalog.get("t").segments
    queries = [eng.planner.plan(q).query for q in BATCH]
    res = eng.runner.execute_batch(queries, table)
    legs = [r.metrics for r in res]
    fused = [m for m in legs if m.get("route") == "batch"]
    assert fused
    by_id = {}
    for m in fused:
        by_id.setdefault(m["batch_id"], []).append(m)
    for recs in by_id.values():
        computed = [m for m in recs if not m.get("batch_dedup")]
        assert len(computed) == recs[0]["batch_legs"]
        assert {m["host_copies"] for m in recs} == {1}
        assert len({m["scan_ms_shared"] for m in recs}) == 1
        assert recs[0]["batch_size"] == len(recs)
        # the float sum (avg(w)) is no B1 leg: group_reduce_batch serves it
        assert recs[0]["fused_batch"] == sum(m["fused"] for m in computed)
    # the duplicates of BATCH share their leg's rows
    for a, b in ((0, 8), (2, 9)):
        assert legs[b]["batch_dedup"] and res[b].rows is res[a].rows

    sql = "SELECT g, sum(v) AS s FROM t GROUP BY g ORDER BY g"
    frames = eng.sql_batch([sql] * 4)
    stmts = eng.runner.last_metrics["statements"]
    assert all(f.equals(eng.sql(sql)) for f in frames)
    assert [m.get("batch_dedup", False) for m in stmts] == \
        [False, True, True, True]
    assert stmts[0]["batch_size"] == 4 and stmts[0]["batch_legs"] == 1


def test_fused_groups_fit_the_parameter_block(engines, singles,
                                             monkeypatch):
    """A cluster whose kernel legs' arguments pass one launch's parameter
    block splits into groups that fit it, each one launch, each answer
    unchanged."""
    eng = engines["force"]
    table = eng.catalog.get("t").segments
    plans = [eng.runner._lower_cached(eng.planner.plan(q).query, table)
             for q in BATCH]
    words = [rowgen.multi_layout([fr.program(p, table)])[1]
             for p in plans if p.fused_reason is None]
    limit = sum(words) - 1           # the kernel legs cannot share one
    monkeypatch.setattr(rowgen, "MAX_MULTI_WORDS", limit)
    calls = []
    real = fr.fused_reduce_multi
    monkeypatch.setattr(fr, "fused_reduce_multi",
                        lambda *a: calls.append(a) or real(*a))
    got = eng.sql_batch(BATCH)
    for i, (g, s) in enumerate(zip(got, singles["force"])):
        pd.testing.assert_frame_equal(g, s, obj=f"leg {i} vs Engine.sql")
    assert calls and all(rowgen.multi_layout(c[0])[1] <= limit
                         for c in calls)
    assert max(len(c[0]) for c in calls) < len(words)


def test_sql_batch_mixes_verbs_fallback_and_grouping_sets(engines):
    eng = engines["force"]
    stmts = [
        "SELECT g, sum(v) AS s FROM t GROUP BY g ORDER BY g",
        "EXPLAIN DRUID REWRITE SELECT count(*) AS n FROM t",
        "SELECT g, h, sum(v) AS s FROM t GROUP BY ROLLUP(g, h)",
        # a derived table: the fallback interpreter serves it
        "SELECT count(*) AS n FROM (SELECT g FROM t WHERE v > 990) x",
        "SELECT h, count(*) AS n FROM t GROUP BY h ORDER BY h",
    ]
    got, qids = eng.sql_batch_ids(stmts)
    assert qids[1] == "-" and len(set(qids)) == len(stmts)
    for q, f in zip(stmts, got):
        pd.testing.assert_frame_equal(f, eng.sql(q))


def test_multi_leg_failure_raises(engines, monkeypatch):
    """With fallback_on_device_failure off, a failure of the multi-leg
    kernel on the batch path raises after its retries: no statement
    comes back from the single path in its place. With it on (the
    default, as in the JAX package), each leg is served by the single
    path, its metrics naming the batch's error."""
    eng = engines["force"]
    monkeypatch.setattr(eng.config, "fallback_on_device_failure", False)

    def boom(*a):
        raise RuntimeError("multi-leg launch failed")
    monkeypatch.setattr(fr, "fused_reduce_multi", boom)
    singles = []
    real = eng.runner._execute
    monkeypatch.setattr(eng.runner, "_execute",
                        lambda q, t: singles.append(q) or real(q, t))
    with pytest.raises(RuntimeError, match="multi-leg launch failed"):
        eng.sql_batch(BATCH)
    # only the legs that are single by shape ran alone
    assert len(singles) <= 2
    monkeypatch.setattr(eng.config, "fallback_on_device_failure", True)
    outs = eng.sql_batch(BATCH)
    stmts = eng.runner.last_metrics["statements"]
    assert any("multi-leg launch failed" in m.get("batch_error", "")
               for m in stmts)
    monkeypatch.undo()
    for q, f in zip(BATCH, outs):
        pd.testing.assert_frame_equal(f, eng.sql(q))


def test_coalescer_gives_each_caller_its_answer(engines, singles):
    eng = engines["force"]
    picks = list(range(8))
    got, sizes, errors = {}, {}, []
    gate = threading.Barrier(len(picks))

    def caller(i):
        try:
            gate.wait(timeout=30)
            got[i] = eng.sql(BATCH[i])
            sizes[i] = eng.runner.last_metrics.get("batch_size", 1)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)
    eng.runner.set_batch_window(20)
    try:
        threads = [threading.Thread(target=caller, args=(i,))
                   for i in picks]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        eng.runner.set_batch_window(0)
    assert not errors and not any(t.is_alive() for t in threads)
    for i in picks:
        pd.testing.assert_frame_equal(got[i], singles["force"][i])
    assert max(sizes.values()) > 1


def test_coalescer_leader_interrupt_does_not_strand_followers():
    """An async exception in the leader (KeyboardInterrupt mid-window)
    must still reset the collecting flag, drain the queue and wake every
    follower (tests/test_batch_executor.py's case, on the port)."""
    class StubRunner:
        dispatch_lock = threading.RLock()

    co = batch.Coalescer(StubRunner(), 0.25)
    real_sleep = time.sleep
    out = {}

    def boom(s):
        if s == 0.25:        # the leader's window sleep
            real_sleep(0.1)  # let the follower enqueue first
            raise KeyboardInterrupt
        real_sleep(s)

    def leader():
        try:
            co.submit("q1", "t")
        except BaseException as e:  # noqa: BLE001 — inspected below
            out["leader"] = e

    def follower():
        try:
            out["follower"] = co.submit("q2", "t")
        except BaseException as e:  # noqa: BLE001 — inspected below
            out["follower"] = e

    time.sleep = boom
    try:
        tl = threading.Thread(target=leader)
        tl.start()
        real_sleep(0.02)
        tf = threading.Thread(target=follower)
        tf.start()
        tl.join(timeout=10)
        tf.join(timeout=10)
    finally:
        time.sleep = real_sleep
    assert not tf.is_alive(), "follower stranded by the dead leader"
    assert isinstance(out["leader"], KeyboardInterrupt)
    assert isinstance(out["follower"], RuntimeError)
    assert co._collecting is False and co._queue == []


# ------------------------------------------------------------- the kernel

KS = (1, 7, 8000)   # 8000 groups x 28 B overflow the 200 KB shared budget


def _legs(seed=0):
    prog = rowprog.trace(_row_fn, SLOTS)
    legs = []
    for i, K in enumerate(KS):
        t, valid, seg = _random_case(5000, K, seed)
        seg = seg.clone()
        seg[i % len(seg)] = False        # each leg keeps its own segments
        legs.append((prog, _inputs(prog, t), seg, K))
    # one shared validity: the batch's legs read one table
    return legs, valid


def test_multi_ref_matches_single_legs():
    legs, valid = _legs()
    progs, inputs, segs, Ks = map(list, zip(*legs))
    got = fr.fused_reduce_multi(progs, inputs, valid, segs, Ks)
    for (prog, ins, seg, K), (sums, mins) in zip(legs, got):
        want = fr.fused_reduce_ref(prog, ins, valid, seg, K)
        assert torch.equal(sums, want[0]) and torch.equal(mins, want[1])
        assert sums.shape == (K, prog.n_sum)
    with pytest.raises(ValueError):
        fr.fused_reduce_multi(progs, inputs[:2], valid, segs, Ks)


def test_multi_smem_is_the_largest_fitting_table():
    """A block serves one leg at a time: the launch reserves the largest
    table that fits the shared budget alone, and a leg past it (K =
    8000) updates its global outputs, as B1 does."""
    prog = rowprog.trace(_row_fn, SLOTS)
    assert rowgen.layout(prog).table_bytes(KS[-1]) > rowgen.SMEM_TABLE_BYTES
    assert rowgen.multi_smem([prog] * 3, KS) == \
        rowgen.table_bytes(prog, KS[1]) == rowgen.layout(prog).table_bytes(7)
    src = rowgen.multi_kernel_source([prog] * 3, KS)
    for i, shared in enumerate((True, True, False)):
        ns = rowgen.leg_namespace(i)
        body = src[src.index(f"namespace {ns} {{\nconstexpr long long "):]
        assert f"constexpr bool kShared = {str(shared).lower()};" in \
            body[:body.index("struct Cone")]


_CUDA_STUBS = """
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__
#define __align__(x) __attribute__((aligned(x)))
#define __CUDACC_RTC__ 1
struct Dim3 { unsigned x, y, z; };
static Dim3 threadIdx, blockIdx, gridDim;
inline void __syncthreads() {}
template <class T> T __shfl_down_sync(unsigned, T v, int) { return v; }
inline unsigned long long atomicAdd(unsigned long long* a,
                                    unsigned long long v) { return *a += v; }
inline unsigned atomicAdd(unsigned* a, unsigned v) { return *a += v; }
inline int atomicMin(int* a, int v) { return *a = *a < v ? *a : v; }
template <class T> T __ldg(const T* p) { return *p; }
"""


def test_multi_source_is_valid_cpp(tmp_path):
    """The generated multi-leg source parses as C++17 with CUDA's
    keywords and builtins stubbed (syntax and names only: NVRTC compiles
    it on the card)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    legs, _ = _legs()
    progs = [p for p, _, _, _ in legs]
    src = rowgen.multi_kernel_source(progs, KS)
    assert "//@@" not in src
    for i in range(len(KS)):
        assert f"namespace {rowgen.leg_namespace(i)} {{" in src
    # the 16-byte load is inline PTX
    src = re.sub(r"asm volatile\([^;]*\);", "v = *(const V16*)p;", src)
    path = tmp_path / "multi.cpp"
    path.write_text(_CUDA_STUBS + src)
    out = subprocess.run([cxx, "-std=c++17", "-fsyntax-only", str(path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]


def test_multi_key_ignores_literals(engines):
    """Two batches that differ only in literals share one multi-leg
    source (and so one compiled kernel)."""
    eng = engines["force"]
    table = eng.catalog.get("t").segments

    def progs(lit):
        out = []
        for q in (f"SELECT g, sum(v) AS s FROM t WHERE v > {lit} GROUP BY g",
                  f"SELECT sum(v) AS s FROM t WHERE h = '{'ab'[lit % 2]}'"):
            plan = eng.runner._lower_cached(eng.planner.plan(q).query, table)
            out.append(fr.program(plan, table))
        return out
    a, b = progs(500), progs(7)
    assert a[0] is not b[0]
    assert rowgen.multi_kernel_source(a, (16, 1)) == \
        rowgen.multi_kernel_source(b, (16, 1))


def test_multi_kernel_keyed_by_cone_widths(monkeypatch):
    """Two compositions whose legs differ only in one mask-cone column's
    width (int8 against int16) compile two kernels: the compiled kernel
    is keyed by the whole generated source, which reads the cone at its
    width."""
    from tpu_olap_torch.kernels import cuda_build
    seen = []
    monkeypatch.setattr(cuda_build, "nvrtc_kernel",
                        lambda src, *a: seen.append(
                            (cuda_build.source_hash(src), src)) or a)

    def progs(width):
        slots = tuple((n, k, width if n == "a" else t) for n, k, t in SLOTS)
        prog = rowprog.trace(_row_fn, slots)
        assert slots.index(next(s for s in slots if s[0] == "a")) \
            in rowgen.cone_slots(prog)
        return [rowprog.trace(_row_fn, SLOTS), prog]
    for width in (torch.int8, torch.int16, torch.int8):
        fr.compiled_multi(progs(width), (7, 7), "cuda:0")
    (h8, src8), (h16, src16), (h8b, _) = seen
    assert h8 != h16 and h8 == h8b
    assert "rowgen::lane_i8(c.s" in src8
    assert "rowgen::lane_i8(c.s" not in src16


@pytest.mark.gpu
def test_cuda_multi_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    prog = rowprog.trace(_row_fn, SLOTS)
    legs = []
    for i, K in enumerate(KS):
        t, valid, seg = _random_case(1 << 20, K, 3, device="cuda")
        legs.append((_inputs(prog, t), seg, K))
    args = ([prog] * 3, [x for x, _, _ in legs], valid,
            [s for _, s, _ in legs], list(KS))
    before = fr.multi_launches
    got = fr.fused_reduce_multi(*args)
    torch.cuda.synchronize()
    assert fr.multi_launches == before + 1
    for g, w in zip(got, fr.fused_reduce_multi_ref(*args)):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])


# ------------------------------------------- the batch functions vs JAX


def test_group_reduce_batch_matches_jax():
    rng = np.random.default_rng(5)
    n, legs_np = 4000, []
    for K in (1, 9, 40):
        legs_np.append((rng.integers(0, K, n).astype(np.int32),
                        rng.random(n) < 0.7, K))
    cols = {"v": rng.integers(-500, 500, n).astype(np.int64),
            "w": rng.normal(size=n)}
    nulls = {"v": rng.random(n) < 0.1}
    spec = [("n", "count", ()), ("s", "sum", ("v",)),
            ("mn", "min", ("v",)), ("mx", "max", ("w",))]

    def plans(mod):
        return [mod.AggPlan(name, kind, f,
                            np.float64 if f == ("w",) else np.int64)
                for name, kind, f in spec]
    jax_out = jax_gb.group_reduce_batch(
        [(k, m, {"cols": cols, "nulls": nulls}, plans(jax_gb), K)
         for k, m, K in legs_np], [{}] * 3)
    tenv = {"cols": {c: torch.from_numpy(a) for c, a in cols.items()},
            "nulls": {c: torch.from_numpy(a) for c, a in nulls.items()}}
    port_out = gb.group_reduce_batch(
        [(torch.from_numpy(k), torch.from_numpy(m), tenv, plans(gb), K)
         for k, m, K in legs_np], [{}] * 3)
    for j, p in zip(jax_out, port_out):
        assert set(j) == set(p)
        for name in j:
            np.testing.assert_array_equal(p[name].numpy(), np.asarray(j[name]),
                                          err_msg=name)


FILTERS = [
    {"type": "selector", "dimension": "g", "value": "g3"},
    None,
    {"type": "bound", "dimension": "v", "lower": "100", "upper": "700",
     "ordering": "numeric"},
    {"type": "and", "fields": [
        {"type": "in", "dimension": "h", "values": ["a", "c"]},
        {"type": "not", "field": {"type": "selector", "dimension": "g",
                                  "value": "g0"}}]},
]


def test_compile_and_eval_predicates_match_jax(engines):
    jt = engines["jax"].catalog.get("t").segments
    pt = engines["force"].catalog.get("t").segments
    jpool, ppool = jax_fe.ConstPool(), fe.ConstPool()
    jfns = jax_fe.compile_predicates(
        [None if f is None else jax_filter(f) for f in FILTERS], jt, jpool)
    pfns = fe.compile_predicates(
        [None if f is None else filter_from_json(f) for f in FILTERS], pt,
        ppool)
    for js, ps in zip(jt.segments[:3], pt.segments[:3]):
        jenv = {"cols": dict(js.columns), "nulls": dict(js.null_masks)}
        penv = {"cols": {c: torch.from_numpy(a)
                         for c, a in ps.columns.items()},
                "nulls": {c: torch.from_numpy(a)
                          for c, a in ps.null_masks.items()}}
        jm = jax_fe.eval_predicates(jfns, jenv, jpool.consts)
        pm = fe.eval_predicates(
            pfns, penv, {k: torch.as_tensor(np.atleast_1d(v))
                         for k, v in ppool.consts.items()})
        for a, b in zip(jm, pm):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))

"""The PyTorch port's HbmLedger (executor.dataset), on the CPU, against
the JAX package's.

The same sequences of add / touch / pin_inflight / unpin_inflight /
remove / remove_table on both ledgers give the same bytes_in_use,
evictions, high watermark and eviction order. A port engine whose
`hbm_budget_bytes` is below its working set answers the statements of
`tests/test_derived_dims.py` (its frame recipe `_table` and statements
imported from it) as the JAX package does and as an unbudgeted port
engine does, exactly, while evicting."""

import numpy as np
import pandas as pd
import pytest

from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.executor.dataset import HbmLedger as JaxLedger
from tpu_olap_torch.bench import assert_frame_parity
from tpu_olap_torch.executor.dataset import HbmLedger

from test_derived_dims import Q_REMAP, Q_TIMEFORMAT, _table
from _torch_port import cpu_engine

Q_MONTH = ("SELECT date_trunc('month', ts) AS m, sum(v) AS s FROM t "
           "GROUP BY date_trunc('month', ts) ORDER BY m")
SEQUENCE = [Q_REMAP, Q_TIMEFORMAT, Q_REMAP.replace("'c3'", "'c4'"),
            Q_MONTH, Q_REMAP, "SELECT count(*) AS n, sum(v) AS s FROM t",
            Q_TIMEFORMAT]


def _ops(seed, n=60):
    """A seeded sequence of ledger operations over 12 keys of 3 tables."""
    rng = np.random.default_rng(seed)
    keys = [(f"t{t}", kind, f"c{c}") for t in range(3)
            for kind in ("col", "derived") for c in range(2)]
    ops = []
    for _ in range(n):
        r = rng.random()
        k = keys[rng.integers(len(keys))]
        if r < 0.5:
            pins = frozenset(keys[i] for i in rng.integers(
                len(keys), size=rng.integers(0, 4)))
            ops.append(("add", k, int(rng.integers(1, 400)), pins))
        elif r < 0.7:
            ops.append(("touch", k))
        elif r < 0.8:
            ops.append(("pin", ("__inflight__", int(rng.integers(3))),
                        int(rng.integers(1, 200))))
        elif r < 0.87:
            ops.append(("unpin", ("__inflight__", int(rng.integers(3)))))
        elif r < 0.95:
            ops.append(("remove", k))
        else:
            ops.append(("remove_table", k[0]))
    return ops


def _replay(ledger, ops):
    evicted = []
    trace = []
    for op in ops:
        if op[0] == "add":
            _, k, n, pins = op
            ledger.add(k, n, lambda k=k: evicted.append(k), pins)
        elif op[0] == "touch":
            ledger.touch(op[1])
        elif op[0] == "pin":
            ledger.pin_inflight(op[1], op[2])
        elif op[0] == "unpin":
            ledger.unpin_inflight(op[1])
        elif op[0] == "remove":
            ledger.remove(op[1])
        else:
            ledger.remove_table(op[1])
        trace.append((ledger.bytes_in_use, ledger.evictions,
                      ledger.high_watermark))
    return evicted, trace


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("budget", [None, 600, 1500])
def test_ledger_sequences_match_jax(seed, budget):
    ops = _ops(seed)
    mine, want = HbmLedger(budget), JaxLedger(budget)
    got = _replay(mine, ops)
    assert got == _replay(want, ops)
    assert mine.inflight_bytes == want.inflight_bytes
    assert list(mine._entries) == list(want._entries)
    if budget is not None and seed < 3:
        assert mine.evictions > 0


def _distinct(ops):
    """`ops` less the adds and pins of a key already held: both ledgers
    keep a re-added key's earlier bytes in their totals, which a
    re-attribution over a new device count (rightly) drops."""
    held, out = set(), []
    for op in ops:
        if op[0] in ("add", "pin"):
            if op[1] in held:
                continue
            held.add(op[1])
        elif op[0] in ("remove", "unpin"):
            held.discard(op[1])
        elif op[0] == "remove_table":
            held = {k for k in held if k[0] != op[1]}
        out.append(op)
    return out


@pytest.mark.parametrize("late", [False, True])
@pytest.mark.parametrize("chips", [3, 8])
def test_per_chip_split_matches_jax(chips, late):
    """The per-(chip, owner) split over a mesh equals the JAX ledger's
    (which takes the device count at construction), whether the port's
    learns the count before any entry (with evictions under a budget)
    or after half of them (set_num_chips re-attributes the live
    entries; its watermarks then restart from the current bytes, so
    they are compared only when the count came first)."""
    budget = None if late else 1500
    ops = _distinct(_ops(1)) if late else _ops(1)
    mine, want = HbmLedger(budget), JaxLedger(budget, num_chips=chips)
    if not late:
        mine.set_num_chips(chips)
    _replay(mine, ops[:len(ops) // 2])
    if late:
        assert mine.breakdown() and mine.num_chips == 1
        mine.set_num_chips(chips)
    _replay(mine, ops[len(ops) // 2:])
    _replay(want, ops)
    assert mine.breakdown() == want.breakdown()
    if late:
        assert sum(mine.breakdown().values()) == mine.bytes_in_use
    else:
        assert mine.watermarks() == want.watermarks()


def test_single_over_budget_entry_still_admitted():
    for ledger in (HbmLedger(100), JaxLedger(100)):
        ledger.add(("t", "col", "a"), 60, lambda: None)
        ledger.add(("t", "col", "b"), 500, lambda: None)
        assert ledger.bytes_in_use == 500 and ledger.evictions == 1


@pytest.fixture(scope="module")
def frames():
    df = _table()
    jax = JaxEngine(JaxConfig(use_pallas="never",
                              hbm_budget_bytes=64 * 2**20))
    jax.register_table("t", df, time_column="ts")
    free = cpu_engine()
    free.register_table("t", df, time_column="ts")
    free_fused = cpu_engine(use_fused_reduce="force")
    free_fused.register_table("t", df, time_column="ts")
    want = {sql: jax.sql(sql) for sql in SEQUENCE}
    plain = {sql: free.sql(sql) for sql in SEQUENCE}
    for sql in SEQUENCE:
        free_fused.sql(sql)
    resident = max(free.runner.device_bytes(),
                   free_fused.runner.device_bytes())
    return df, want, plain, resident


@pytest.mark.parametrize("fused", ["never", "force"])
def test_budgeted_engine_answers_equal_while_evicting(frames, fused):
    df, want, plain, resident = frames
    budget = int(resident * 0.4)
    eng = cpu_engine(hbm_budget_bytes=budget,
                 use_fused_reduce=fused)
    eng.register_table("t", df, time_column="ts")
    before = eng.runner._ledger.bytes_in_use
    largest = 0
    for sql in SEQUENCE * 2:
        got = eng.sql(sql)
        m = eng.runner.last_metrics
        assert "hbm_bytes" in m and "hbm_evictions" in m
        pd.testing.assert_frame_equal(got, plain[sql])
        assert_frame_parity(got, want[sql], ordered=True, label=sql)
        plan = eng.runner._lower_cached(eng.planner.plan(sql).query,
                                        eng.catalog.get("t").segments)
        ds = eng.runner._dataset(plan.table)
        # a column without nulls has no null stack to pin
        pins = {k for k in eng.runner.pins([plan])
                if k[1] != "null" or ds._nulls.get(k[2]) is not None}
        largest = max(largest, sum(
            n for k, (n, _) in eng.runner._ledger._entries.items()
            if k in pins))
        # every stack the statement read is still resident and counted
        assert pins <= set(eng.runner._ledger._entries)
        assert eng.runner.device_bytes() == eng.runner._ledger.bytes_in_use
        assert ds.resident_bytes() == eng.runner._ledger.bytes_in_use
    ledger = eng.runner._ledger
    assert ledger.bytes_in_use > before  # derived streams are accounted
    assert ledger.evictions > 0
    assert eng.runner.last_metrics["hbm_evictions"] == ledger.evictions
    assert ledger.high_watermark <= budget + largest


def test_batch_pins_the_union_of_its_legs(frames):
    """A fused batch pins every leg's working set while the envs build:
    under a budget below the union, the stacks of earlier statements
    evict but none of the batch's own, the answers equal the unbudgeted
    engine's, and the ledger stays exact."""
    df, want, plain, resident = frames
    eng = cpu_engine(hbm_budget_bytes=int(resident * 0.2),
                 use_fused_reduce="force")
    eng.register_table("t", df, time_column="ts")
    for sql in (Q_MONTH, Q_TIMEFORMAT):
        eng.sql(sql)
    legs = [Q_REMAP, Q_REMAP.replace("'c3'", "'c4'"),
            "SELECT count(*) AS n, sum(v) AS s FROM t"]
    n0 = eng.runner._ledger.evictions
    outs = eng.sql_batch(legs)
    assert all(m["route"] == "batch"
               for m in eng.runner.last_metrics["statements"])
    for sql, got in zip(legs, outs):
        pd.testing.assert_frame_equal(got, plain[sql])
        assert_frame_parity(got, want[sql], ordered=True, label=sql)
    table = eng.catalog.get("t").segments
    plans = [eng.runner._lower_cached(eng.planner.plan(q).query, table)
             for q in legs]
    ds = eng.runner._dataset(table)
    pins = {k for k in eng.runner.pins(plans)
            if k[1] != "null" or ds._nulls.get(k[2]) is not None}
    assert eng.runner._ledger.evictions > n0
    assert pins <= set(eng.runner._ledger._entries)
    assert eng.runner.device_bytes() == eng.runner._ledger.bytes_in_use


def test_drop_and_clear_release_the_ledger(frames):
    df = frames[0]
    eng = cpu_engine(hbm_budget_bytes=1 << 30)
    eng.register_table("t", df, time_column="ts")
    eng.register_table("u", df, time_column="ts")
    eng.sql(Q_REMAP)
    eng.sql(Q_REMAP.replace("FROM t", "FROM u"))
    n_t = sum(n for k, (n, _) in eng.runner._ledger._entries.items()
              if k[0] == "t")
    total = eng.runner._ledger.bytes_in_use
    eng.drop_table("t")
    assert eng.runner._ledger.bytes_in_use == total - n_t
    eng.clear_cache()
    assert eng.runner._ledger.bytes_in_use == 0
    pd.testing.assert_frame_equal(
        eng.sql(Q_REMAP.replace("FROM t", "FROM u")), frames[2][Q_REMAP])

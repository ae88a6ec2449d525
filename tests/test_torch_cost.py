"""The port's cost model (tpu_olap_torch.planner.cost) against the JAX
package's planner/cost.py: for every case of tests/test_cost.py, the same
plan (each package lowering the same statement over the same frame), the
same mesh size and the same explicit cost_* constants give the same
CostDecision.to_json(). Then the model's wiring in the port: constant
resolution, EXPLAIN's "cost", both merges at D = 8 against the JAX
engine, and the fitted "cuda" entry of cost_calibration.json."""

import json
import math
import os

import numpy as np
import pandas as pd
import pytest

from test_cost import _plan_for as jax_plan_for
from test_cost import _table
from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.planner import cost as jax_cost
from tpu_olap_torch.bench import assert_frame_parity
from tpu_olap_torch.executor.config import EngineConfig
from tpu_olap_torch.executor.lowering import lower
from tpu_olap_torch.planner import cost as cost_mod

from _torch_port import cpu_engine

# explicit constants, pinned in both packages (each would otherwise read
# its own device's fit)
PINS = dict(cost_scan_ns_per_row_col=0.05, cost_merge_ns_per_byte=0.05,
            cost_collective_lat_us=25.0, cost_gspmd_overhead=1.35)
GROUP_SQL = "SELECT dim, sum(val) AS s FROM t GROUP BY dim"
SKETCH_SQL = ("SELECT dim, val, count(DISTINCT dim) AS u "
              "FROM t GROUP BY dim, val")


def _pair(frame=None, **kw):
    frame = _table() if frame is None else frame
    jax = JaxEngine(JaxConfig(**PINS, **kw))
    port = cpu_engine(**PINS, **kw)
    for e in (jax, port):
        e.register_table("t", frame, time_column="ts", block_rows=512)
    return jax, port


def _port_plan(eng, sql):
    plan = eng.planner.plan(sql)
    assert plan.rewritten, plan.fallback_reason
    return lower(plan.query, plan.entry.segments, eng.config)


def _both(jax, port, sql, shards):
    want = jax_cost.decide(jax_plan_for(jax, sql), jax.config, shards)
    got = cost_mod.decide(_port_plan(port, sql), port.config, shards)
    assert got.to_json() == want.to_json()
    return got


@pytest.mark.parametrize("sql, shards, kw, strategy, reason", [
    (GROUP_SQL, 8, {}, "historicals", "explicit partials cheaper"),
    (SKETCH_SQL, 8, {}, "broker",
     "merge dominates scan; defer to partitioner"),
    (SKETCH_SQL, 8, {"cost_model_enabled": False}, "historicals",
     "cost model disabled"),
    ("SELECT sum(val) AS s FROM t", 1, {}, "historicals", "single device"),
    (GROUP_SQL, 8, {"force_strategy": "broker"}, "broker",
     "forced by config"),
    (GROUP_SQL, 4, {"shard_merge_factor": 40.0}, None, None),
])
def test_decide_matches_jax(sql, shards, kw, strategy, reason):
    """test_cost.py's small group-by, sketch-heavy table, disabled
    model, single device and forced strategy (and a merge factor)."""
    jax, port = _pair(**kw)
    d = _both(jax, port, sql, shards)
    if strategy is not None:
        assert (d.strategy, d.reason) == (strategy, reason)
    if shards == 1:
        assert d.merge_us == 0.0
    if sql == SKETCH_SQL and strategy == "broker":
        assert d.table_bytes > 100 * d.rows_scanned


def test_table_width_and_groups_match_jax():
    jax, port = _pair()
    for sql in (GROUP_SQL, SKETCH_SQL,
                "SELECT dim, min(val) AS a, max(val) AS b, count(*) AS n,"
                " theta_sketch_estimate(theta_sketch(dim)) AS t FROM t"
                " GROUP BY dim"):
        jp, pp = jax_plan_for(jax, sql), _port_plan(port, sql)
        assert cost_mod.table_width_bytes(pp) == \
            jax_cost.table_width_bytes(jp)
        assert cost_mod.estimate_groups(pp) == jax_cost.estimate_groups(jp)


def test_decision_flips_at_modeled_crossover():
    """test_cost.py's sweep: the strategy flips exactly where
    merge_us crosses overhead x (scan_us + lat x hops), and every
    decision on the way equals the JAX package's."""
    shards = 8
    hops = math.ceil(math.log2(shards))
    c = cost_mod.constants(EngineConfig(**PINS))
    n = 4096

    def decision_for(k):
        rng = np.random.default_rng(5)
        df = pd.DataFrame({
            "ts": pd.to_datetime("2024-01-01")
            + pd.to_timedelta(np.arange(n) % 9999, unit="s"),
            "g": np.concatenate(
                [np.array([0, k - 1]),
                 rng.integers(0, k, n - 2)]).astype(np.int64),
            "v": rng.integers(0, 100, n).astype(np.int64),
        })
        jax, port = _pair(df)
        d = _both(jax, port, "SELECT g, sum(v) AS s FROM t GROUP BY g",
                  shards)
        assert d.groups in (k, k + 1)
        return d

    probe = decision_for(8)
    width = probe.table_bytes // probe.groups
    bytes_star = ((c["gspmd_overhead"]
                   * (probe.scan_us + c["collective_lat_us"] * hops) / hops
                   - c["collective_lat_us"])
                  * 1000.0 / c["merge_ns_per_byte"])
    k_star = int(bytes_star / width)
    assert k_star > 4
    assert decision_for(max(2, int(k_star * 0.5))).strategy == "historicals"
    assert decision_for(int(k_star * 2.0)).strategy == "broker"


def test_constants_resolve_pin_then_fit_then_datasheet(monkeypatch):
    monkeypatch.setattr(cost_mod, "_calibration_cache",
                        {"cpu": {"scan_ns_per_row_col": 7.0}})
    c = cost_mod.constants(EngineConfig(device="cpu",
                                        cost_gspmd_overhead=2.5))
    assert c["scan_ns_per_row_col"] == 7.0          # the device's fit
    assert c["gspmd_overhead"] == 2.5               # the pin
    assert c["merge_ns_per_byte"] == \
        cost_mod.DATASHEET["merge_ns_per_byte"]     # neither
    c = cost_mod.constants(EngineConfig(device="cuda"))
    assert c["scan_ns_per_row_col"] == \
        cost_mod.DATASHEET["scan_ns_per_row_col"]   # no "cuda" fit here


def test_calibration_holds_no_jax_constant():
    """The port's calibration is its own: no entry keyed by a JAX
    backend, and no value of the JAX package's fits or fallbacks."""
    path = os.path.join(os.path.dirname(cost_mod.__file__),
                        "cost_calibration.json")
    with open(path) as f:
        ours = json.load(f)
    assert set(ours) <= {"cuda", "cpu"}
    with open(os.path.join(os.path.dirname(jax_cost.__file__),
                           "cost_calibration.json")) as f:
        theirs = json.load(f)
    jax_values = {v for entry in theirs.values() for v in entry.values()
                  if isinstance(v, float)} | set(jax_cost._FALLBACKS.values())
    for entry in ours.values():
        for k in cost_mod.DATASHEET:
            assert entry.get(k) not in jax_values, k


def test_explain_includes_cost():
    jax, port = _pair()
    got = port.explain(GROUP_SQL)
    assert got["rewritten"]
    assert got["cost"] == jax.explain(GROUP_SQL)["cost"]
    assert got["cost"]["strategy"] == "historicals"
    assert got["cost"]["rowsScanned"] > 0
    assert "cost" not in port.explain("SELECT dim, val FROM t LIMIT 3")


@pytest.mark.parametrize("strategy", ["historicals", "broker"])
def test_both_strategies_agree_with_jax(request, strategy):
    """test_cost.py's both-strategies case at D = 8: the forced merge
    serves, and the answer is the JAX engine's."""
    jax, _ = _pair()
    port = cpu_engine(num_shards=8, force_strategy=strategy)
    request.addfinalizer(port.close)
    port.register_table("t", _table(), time_column="ts", block_rows=512)
    sql = ("SELECT dim, sum(val) AS s, count() AS n, min(val) AS lo "
           "FROM t GROUP BY dim ORDER BY dim")
    got = port.sql(sql)
    m = port.runner.last_metrics
    assert m["cost"]["strategy"] == strategy and m["num_shards"] == 8
    assert_frame_parity(got, jax.sql(sql), ordered=True, label=strategy)


def test_cuda_fit_carries_every_term_and_decides_by_them():
    """The "cuda" entry (chip_smoke.py phase 16 on the card) carries all
    four terms, names the card and says the merge's bytes term is the
    datasheet's, not measured; with its terms pinned, every decision
    follows the documented inequality, and at SSB SF1's scan on 4
    devices it picks the device fold ("broker"), as the card's p50s
    did."""
    path = os.path.join(os.path.dirname(cost_mod.__file__),
                        "cost_calibration.json")
    with open(path) as f:
        cuda = json.load(f)["cuda"]
    for term in cost_mod.DATASHEET:
        assert term in cuda, f"cuda entry missing {term}"
    assert "H100" in cuda["note"] and "not measured" in cuda["note"]
    assert cuda["merge_ns_per_byte"] == round(1e9 / 450e9, 6)
    pins = {f"cost_{t}": cuda[t] for t in cost_mod.DATASHEET}
    jax, port = _pair()
    port.config = EngineConfig(device="cpu", **pins)
    c = cost_mod.constants(port.config)
    for sql in (GROUP_SQL, SKETCH_SQL):
        phys = _port_plan(port, sql)
        for shards in (2, 4, 8):
            d = cost_mod.decide(phys, port.config, shards)
            hops = max(1, math.ceil(math.log2(shards)))
            broker = d.merge_us > c["gspmd_overhead"] * (
                d.scan_us + c["collective_lat_us"] * hops)
            assert d.strategy == ("broker" if broker else "historicals")
    # SF1's q2.1: 6,000,000 rows x 3 columns over 4 devices
    scan_us = 6_000_000 * 3 * c["scan_ns_per_row_col"] / 1000 / 4
    merge_us = 2 * (c["collective_lat_us"]
                    + 328 * 24 * c["merge_ns_per_byte"] / 1000)
    assert merge_us > c["gspmd_overhead"] * (
        scan_us + c["collective_lat_us"] * 2)

"""The telemetry plane of the PyTorch port (obs.timeseries, obs.sentinel,
the runner's compile, memory and ledger gauges, the metrics and events of
caches, cubes and ingest) against the JAX package.

Both engines run one scripted traffic over the same seeded table: plain
statements, a repeat served by the result cache, a shared-scan batch, an
append, a compaction, a checkpoint, a cube build and a cache clear. The
metric families (name, kind, label names) and the event kinds, in order,
must then be the JAX package's exactly. The sentinel's stage attribution
is held on both packages with the same injected `stage-transfer` latency.
"""

import gc
import time
import weakref

import numpy as np
import pandas as pd
import pytest

from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.obs.sentinel import _Baseline as JaxBaseline
from tpu_olap.resilience.faults import FaultInjector as JaxInjector
from tpu_olap_torch.kernels import cuda_build
from tpu_olap_torch.obs.sentinel import _Baseline
from tpu_olap_torch.resilience.faults import FaultInjector
from _torch_port import cpu_engine

SQL = "SELECT g, sum(v) AS s FROM t GROUP BY g ORDER BY g"
CUBE = {"name": "c1", "datasource": "t", "dimensions": ["g"],
        "granularity": "all",
        "aggregations": [{"type": "longSum", "name": "s",
                          "fieldName": "v"}]}


def _df(n=4000, seed=3):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "ts": pd.to_datetime("2024-01-01")
        + pd.to_timedelta(rng.integers(0, 86400 * 60, n), unit="s"),
        "g": rng.choice([f"g{i}" for i in range(8)], n),
        "v": rng.integers(0, 1000, n).astype(np.int64),
    })


def _engines(**kw):
    """(JAX engine, port engine) over the same frame; manual telemetry
    ticks unless `kw` says otherwise."""
    kw.setdefault("telemetry_interval_s", 0.0)
    kw.setdefault("cube_auto_refresh", False)
    out = (JaxEngine(JaxConfig(use_pallas="never", **kw)),
           cpu_engine(**kw))
    for eng in out:
        eng.register_table("t", _df(), time_column="ts",
                           block_rows=1 << 10)
    return out


def _traffic(eng):
    eng.sql(SQL)
    eng.sql(SQL)
    eng.sql("SELECT sum(v) AS s FROM t")
    eng.sql_batch([SQL, "SELECT g, max(v) AS m FROM t GROUP BY g",
                   "SELECT sum(v) AS s2 FROM t"])
    eng.append("t", [{"ts": "2024-03-05T00:00:00", "g": "g1", "v": 5}] * 10)
    eng.sql(SQL)
    eng.compact_now("t")
    eng.checkpoint_now("t")
    eng.create_cube(CUBE)
    eng.sql(SQL)
    eng.sql("CLEAR DRUID CACHE t")
    eng.runner.refresh_resource_gauges()


@pytest.fixture(scope="module")
def scripted(tmp_path_factory):
    d = tmp_path_factory.mktemp("telemetry")
    engines = []
    for i, make in enumerate((
            lambda **kw: JaxEngine(JaxConfig(use_pallas="never", **kw)),
            cpu_engine)):
        eng = make(result_cache_enabled=True, ingest_auto_compact=False,
                   ingest_wal_dir=str(d / f"wal{i}"),
                   ingest_store_dir=str(d / f"store{i}"),
                   ingest_wal_fsync="never", telemetry_interval_s=0.0,
                   cube_auto_refresh=False)
        eng.register_table("t", _df(), time_column="ts",
                           block_rows=1 << 10)
        _traffic(eng)
        engines.append(eng)
    yield engines
    for eng in engines:
        eng.close()


def _families(eng) -> dict:
    return {m.name: (m.kind, tuple(m.labelnames))
            for m in eng.metrics._metrics.values()}


def test_metric_families_match_the_jax_package(scripted):
    jax, port = scripted
    assert _families(port) == _families(jax)
    # the cube, cache and ingest series the traffic fed
    text = port.metrics.render()
    for line in ('tpu_olap_cube_builds_total{result="ok"} 1',
                 "tpu_olap_cubes_registered 1",
                 'tpu_olap_ingest_rows_total{table="t"} 10',
                 'tpu_olap_compactions_total{table="t"} 1',
                 'tpu_olap_cache_clears_total{scope="table"} 1'):
        assert line in text, line
    for name in ("cube_builds_total", "ingest_rows_total",
                 "compactions_total", "cache_clears_total",
                 "cube_rewrite_total", "delta_rows",
                 "result_cache_requests_total", "checkpoints_total"):
        def lines(eng):
            return sorted(ln for ln in eng.metrics.render().splitlines()
                          if ln.startswith(f"tpu_olap_{name}"))
        assert lines(port) == lines(jax), name


def test_event_kinds_match_in_order(scripted):
    jax, port = scripted

    def kinds(eng):
        return [e["event"] for e in reversed(eng.runner.events.snapshot())]
    assert kinds(port) == kinds(jax)
    assert {"ingest", "compact", "checkpoint", "cube_build",
            "cache_invalidate", "cache_clear"} <= set(kinds(port))


def test_sampler_history_matches_the_registry(scripted):
    """A sampler tick records every live series; its newest point equals
    the registry's value, in both packages alike."""
    for eng in scripted:
        tel = eng.runner.telemetry
        tel.sample_once()
        tel.sample_once()
        rows = pd.DataFrame(tel.rows())
        q = rows[rows["name"] == "tpu_olap_queries_total"]
        live = sum(s.value for s in
                   eng.metrics.counter("queries_total").series.values())
        newest = q.groupby("labels")["value"].last()
        assert float(newest.sum()) == live
    (js, ps) = (eng.runner.telemetry.snapshot() for eng in scripted)
    assert ps["samples"] == js["samples"] == 2
    assert ps["retention"] == js["retention"]
    # the same series but the compile families: the JAX package compiles
    # on the CPU too, the port builds a kernel (NVRTC) only on the card
    compile_fams = {"tpu_olap_recompiles_total", "tpu_olap_compile_ms_total",
                    "tpu_olap_compile_cache_requests_total"}
    names = [{s["name"] for s in snap["timeseries"]} - compile_fams
             for snap in (js, ps)]
    assert names[0] == names[1]


def test_sampler_rings_are_bounded():
    eng = cpu_engine(telemetry_interval_s=0.0, telemetry_retention=3)
    try:
        eng.register_table("t", _df(), time_column="ts")
        eng.sql(SQL)
        for _ in range(7):
            eng.runner.telemetry.sample_once()
        snap = eng.runner.telemetry.snapshot()
        assert snap["samples"] == 7
        assert all(len(s["points"]) <= 3 for s in snap["timeseries"])
        assert all(len(s["points"]) <= 1 for s in eng.runner.telemetry
                   .snapshot(limit_per_series=1)["timeseries"])
    finally:
        eng.close()


def test_background_graph_ticks_and_stops_on_close():
    eng = cpu_engine(telemetry_interval_s=0.05)
    deadline = time.time() + 10
    while time.time() < deadline and eng.runner.telemetry.samples < 2:
        time.sleep(0.02)
    assert eng.runner.telemetry.samples >= 2
    assert eng.runner.sentinel.checks >= 1
    eng.close()
    assert eng.runner._telemetry_handle.cancelled
    n = eng.runner.telemetry.samples
    time.sleep(0.15)
    assert eng.runner.telemetry.samples == n


def test_unclosed_engine_does_not_live_on_in_its_ticker():
    """The telemetry graph holds the runner weakly: an engine dropped
    without close() is collected, and its ticker thread ends."""
    eng = cpu_engine(telemetry_interval_s=0.02)
    runner = weakref.ref(eng.runner)
    sched = eng.runner.stages
    deadline = time.time() + 10
    while time.time() < deadline and eng.runner.telemetry.samples < 1:
        time.sleep(0.02)
    del eng
    deadline = time.time() + 10
    while time.time() < deadline and runner() is not None:
        gc.collect()      # a tick in progress holds it for a moment
        time.sleep(0.01)
    assert runner() is None
    deadline = time.time() + 10
    while time.time() < deadline and sched._ticker is not None:
        time.sleep(0.02)
    assert sched._ticker is None


def test_ledger_owner_classes_sum_to_bytes_in_use(scripted):
    """One device: every class sits on chip 0, the ledger-managed ones
    sum exactly to bytes_in_use, and sys.devices' row says the same."""
    _, port = scripted
    port.sql("SELECT g, min(v) AS lo FROM t GROUP BY g")
    port.sql("SELECT * FROM __cube_c1")
    led = port.runner._ledger
    bd = led.breakdown()
    assert {c for c, _ in bd} == {0}
    assert {o for _, o in bd} >= {"table_columns", "cube_tables"}
    assert sum(b for (_, o), b in bd.items() if o != "cache_pins") \
        == led.bytes_in_use
    assert led.total_bytes() == sum(bd.values())
    row = port.runner.device_snapshot()[0]
    assert row["hbm_bytes"] == led.bytes_in_use == (
        row["table_column_bytes"] + row["cube_table_bytes"]
        + row["inflight_bytes"])
    assert row["hbm_high_watermark_bytes"] >= row["hbm_bytes"]
    assert (row["device"], row["platform"], row["chips"]) == \
        ("cpu", "cpu", 1)
    out = port.sql("SELECT hbm_bytes, cube_table_bytes FROM sys.devices")
    assert int(out["hbm_bytes"].iloc[0]) == led.bytes_in_use
    text = port.metrics.render()
    port.runner.refresh_resource_gauges()
    text = port.metrics.render()
    assert 'hbm_chip_bytes{chip="0",owner="table_columns"}' in text
    assert 'hbm_chip_high_watermark_bytes{chip="0"}' in text
    assert 'cache_entries{cache="plan"}' in text


def test_compile_observer_counts_nvrtc_builds(monkeypatch):
    """An NVRTC build reported during a statement (on the card: a
    cubin-cache miss in kernels.cuda_build) counts once in
    recompiles_total{kind} with its milliseconds, and stamps the
    statement's record; a statement with no build counts nothing."""
    import tpu_olap_torch.executor.runner as runner_mod
    eng = cpu_engine(telemetry_interval_s=0.0)
    real = runner_mod.lower

    def lower(*a, **kw):
        cuda_build._compile_observer.get()("fused_reduce", 12.5)
        return real(*a, **kw)
    try:
        eng.register_table("t", _df(), time_column="ts")
        monkeypatch.setattr(runner_mod, "lower", lower)
        eng.sql(SQL)
        rec = eng.history[-1]
        assert (rec["recompiles"], rec["compile_ms"]) == (1, 12.5)
        eng.sql(SQL)                 # the plan cache: no lowering
        assert "recompiles" not in eng.history[-1]
        m = eng.metrics
        assert m.counter("recompiles_total").value(kind="fused_reduce") == 1
        assert m.counter("compile_ms_total").value() == 12.5
        assert cuda_build.template_kind("fused_reduce_multi_gen") == \
            "fused_reduce_multi"
        assert cuda_build.template_kind("row_mask_gen") == "row_mask"
    finally:
        eng.close()


# ------------------------------------------------------------ sentinel


def _drift(eng, injector_cls):
    """Warm baseline (15 statements: the first one's compile and upload
    decays out of the EWMA), then two statements behind an injected
    transfer latency: the active alerts, sys.alerts and the alert
    events."""
    for i in range(15):
        eng.sql(f"SELECT g, sum(v) FROM t WHERE v < {900 + i} GROUP BY g")
    inj = injector_cls(rate=1.0, stages={"stage-transfer"}, latency_s=0.4)
    eng.config.fault_injector = inj
    for i in range(2):
        eng.sql(f"SELECT g, sum(v) FROM t WHERE v < {100 + i} GROUP BY g")
    eng.config.fault_injector = None
    active = eng.runner.sentinel.active()
    alerts = eng.sql("SELECT kind, stage, status FROM sys.alerts")
    health = eng.runner.sentinel.health()
    time.sleep(0.35)
    eng.runner.sentinel.check()
    kinds = [e["event"] for e in reversed(eng.runner.events.snapshot())
             if e["event"].startswith("alert")]
    return inj, active, alerts, health, kinds


def test_sentinel_attributes_transfer_drift_like_the_jax_package():
    kw = dict(telemetry_interval_s=0.0, sentinel_min_samples=3,
              sentinel_latency_factor=2.0, sentinel_latency_floor_ms=1.0,
              sentinel_clear_after_s=0.3)
    jax, port = _engines(**kw)
    try:
        got = [_drift(jax, JaxInjector), _drift(port, FaultInjector)]
    finally:
        jax.close()
        port.close()
    for inj, active, alerts, health, kinds in got:
        assert inj.faults >= 2
        a = active[0]
        assert (a["kind"], a["stage"]) == ("latency_drift", "transfer")
        assert a["total_ms"] > a["threshold_ms"] > a["baseline_ms"]
        assert not health["ok"]
        assert kinds == ["alert", "alert_clear"]
    (_, ja, jal, _, _), (_, pa, pal, _, _) = got
    assert [(a["kind"], a["stage"]) for a in pa] == \
        [(a["kind"], a["stage"]) for a in ja]
    pd.testing.assert_frame_equal(pal, jal)
    b = port.runner.sentinel.baseline(pa[0]["subject"])
    assert b["anomalies"] >= 1 and b["ewma_ms"] < pa[0]["total_ms"] / 2
    assert b["moments"][0] == b["n"] + b["anomalies"]
    assert port.runner.sentinel.health()["ok"]
    assert 'alerts_active{kind="latency_drift"} 0' in port.metrics.render()


def test_sentinel_moments_and_resource_probes_match():
    xs = [10.0, 12.0, 11.0, 50.0, 55.0]
    for cls in (_Baseline, JaxBaseline):
        a, b, both = cls(), cls(), cls()
        for i, x in enumerate(xs):
            (a if i < 3 else b).update(x, [], 0.2, False)
            both.update(x, [], 0.2, False)
        assert [a.moments[i] + b.moments[i] for i in range(3)] == \
            pytest.approx(both.moments)
    fired = []
    for eng in _engines(sentinel_wal_lag_records=4,
                        sentinel_eviction_thrash=2):
        s = eng.runner.sentinel
        s.add_probe("wal", lambda: {"t": 10})
        s.check()
        s.add_probe("hbm", lambda: {"bytes_in_use": 99, "budget": 100,
                                    "evictions": 9})
        s.check()
        fired.append(sorted((a["kind"], a["subject"])
                            for a in s.active()))
        eng.close()
    assert fired[0] == fired[1]
    assert ("wal_lag", "t") in fired[1] and ("hbm_pressure", "hbm") \
        in fired[1] and ("eviction_thrash", "hbm") in fired[1]


def test_wal_lag_probe_reads_the_ingest_snapshot(tmp_path):
    eng = cpu_engine(telemetry_interval_s=0.0,
                     ingest_wal_dir=str(tmp_path), ingest_wal_fsync="never")
    try:
        eng.register_table("t", _df(), time_column="ts")
        assert eng._wal_lag_probe() == {}
        eng.append("t", [{"ts": "2024-03-05T00:00:00", "g": "g1", "v": 5}])
        lag = eng._wal_lag_probe()
        assert set(lag) == {"t"} and lag["t"] >= 0
    finally:
        eng.close()

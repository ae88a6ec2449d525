"""Resilience in the PyTorch port against the JAX package.

From tests/test_resilience.py: the error taxonomy, admission, the
breaker, the
host-transfer, ingest, reprobe and batch-leg fault sites and the legacy
injector. From tests/test_fault_recovery.py: dispatch retries, the
device-failure fallback and quiescence. From tests/test_pipeline.py: the
ledger's in-flight pin, the stage pools' bounds, reclaim and
reentrancy, and the background graphs' runs, wakes, rearms and recorded
faults. Each scenario runs the same way in both packages where the JAX
package can run it on the CPU (numpy platform, use_pallas="never"), and
the answers are compared with assert_frame_parity. Deadlines and the
pipelined mode are held in test_torch_deadline.py and
test_torch_pipeline.py. Shard degradation runs on the port's mesh of 8
CPU devices (test_fault_recovery.py::test_shard_degradation) against the
JAX engine on one device. The card-only cases skip without CUDA.
"""

import threading
import time

import pytest
import torch

from test_fault_recovery import SQL, FlakyInjector
from test_resilience import _df
from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.executor.stages import StageScheduler as JaxScheduler
from tpu_olap.resilience import AdmissionController as JaxAdmission
from tpu_olap.resilience import CircuitBreaker as JaxBreaker
from tpu_olap.resilience import errors as jax_errors
from tpu_olap_torch import Engine
from tpu_olap_torch.bench.parity import assert_frame_parity
from tpu_olap_torch.executor.config import EngineConfig
from tpu_olap_torch.executor.dataset import DeviceDataset, HbmLedger
from tpu_olap_torch.executor.runner import QueryDeadlineExceeded
from tpu_olap_torch.executor.stages import StageScheduler
from tpu_olap_torch.resilience import (AdmissionController, BreakerOpen,
                                       CircuitBreaker, FaultInjector,
                                       QueryShed, errors)
from tpu_olap_torch.resilience.breaker import STATE_VALUES
from tpu_olap_torch.resilience.faults import maybe_inject
from _torch_port import cpu_engine

BATCH_SQL = [SQL, "SELECT sum(v) AS s, count(*) AS n FROM t WHERE v < 50"]


def _register(eng):
    eng.register_table("t", _df(), time_column="ts", block_rows=512)
    return eng


@pytest.fixture
def mk(request):
    """mk(jax=False, **config): a registered engine, closed (and its
    breaker closed, stopping a healer) when the test ends."""
    made = []

    def done():
        for e in made:
            e.runner.breaker.close()
            e.close()
    request.addfinalizer(done)

    def make(jax=False, register=True, **kw):
        kw.setdefault("cube_auto_refresh", False)
        # this module's subject is the device-failure fallback: on, as
        # the JAX package's default has it, unless a test turns it off
        kw.setdefault("fallback_on_device_failure", True)
        eng = JaxEngine(JaxConfig(platform="cpu", use_pallas="never",
                                  **kw)) if jax else \
            cpu_engine(use_fused_reduce="force", **kw)
        made.append(eng)
        return _register(eng) if register else eng
    return make


@pytest.fixture(scope="module")
def want():
    """The JAX package's answers on a healthy engine."""
    eng = _register(JaxEngine(JaxConfig(platform="cpu", use_pallas="never",
                                        cube_auto_refresh=False)))
    return {q: eng.sql(q) for q in BATCH_SQL}


def _wait_until(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and not pred():
        time.sleep(0.02)
    return pred()


# ------------------------------------------------------- error taxonomy

@pytest.mark.parametrize("name, args", [
    ("QueryShed", ("full",)), ("BreakerOpen", ("open",)),
    ("IngestBackpressure", ("wait",)), ("DeviceFailure", ("lost",)),
    ("InternalError", ("bug",)), ("UserError", ("bad",)),
    ("QueryError", ("x",))])
def test_error_taxonomy_matches_jax(name, args):
    j, p = getattr(jax_errors, name)(*args), getattr(errors, name)(*args)
    for k in ("code", "retriable", "http_status"):
        assert getattr(p, k) == getattr(j, k), k
    assert p.to_json() == j.to_json()
    for attr in ("reason", "retry_after_s"):
        assert getattr(p, attr, None) == getattr(j, attr, None)
    assert isinstance(errors.UserError("x"), ValueError)
    assert isinstance(errors.InternalError("x"), RuntimeError)


# ---------------------------------------------------- admission control

def _occupy(ac):
    entered, release = threading.Event(), threading.Event()

    def hold():
        with ac.slot():
            entered.set()
            release.wait(timeout=30)

    t = threading.Thread(target=hold, daemon=True)
    t.start()
    assert entered.wait(5)
    return release, t


@pytest.mark.parametrize("queue_limit, budget, reason", [
    (0, None, "queue_full"), (8, 1e-6, "deadline_budget")])
def test_admission_sheds_like_jax(queue_limit, budget, reason):
    got = []
    for cls in (JaxAdmission, AdmissionController):
        ac = cls(max_inflight=1, queue_limit=queue_limit)
        release, t = _occupy(ac)
        try:
            with pytest.raises(Exception) as ei:
                with ac.slot(budget_s=budget):
                    pass
            got.append((type(ei.value).__name__, ei.value.reason,
                        ei.value.http_status))
        finally:
            release.set()
            t.join(timeout=10)
        with ac.slot():
            pass
        assert ac.snapshot()["inflight"] == 0
    assert got[0] == got[1] == ("QueryShed", reason, 429)


def test_admission_waits_reentrant_and_disabled():
    ac = AdmissionController(max_inflight=1, queue_limit=8)
    release, t = _occupy(ac)
    threading.Timer(0.1, release.set).start()
    t0 = time.perf_counter()
    with ac.slot(budget_s=30.0):
        assert time.perf_counter() - t0 > 0.03
    t.join(timeout=10)
    with ac.slot():
        with ac.slot():
            assert ac.snapshot()["inflight"] == 1
    off = AdmissionController(max_inflight=0, queue_limit=0)
    with off.slot():
        assert off.snapshot()["inflight"] == 0


def test_engine_sheds_with_queryshed(mk):
    eng = mk(max_inflight_dispatches=1, admission_queue_limit=0)
    release, t = _occupy(eng.runner.admission)
    try:
        with pytest.raises(QueryShed):
            eng.sql(SQL)
        with pytest.raises(QueryShed):
            eng.sql_batch(BATCH_SQL)
    finally:
        release.set()
        t.join(timeout=10)
    assert len(eng.sql(SQL)) == 3


# ----------------------------------------------------- circuit breaker

def test_breaker_trips_heals_and_resets_like_jax():
    for cls in (JaxBreaker, CircuitBreaker):
        ok = {"v": False}
        br = cls(failure_threshold=2, cooldown_s=0.1,
                 probe=lambda: ok["v"])
        br.record_failure()
        assert br.state == "closed"
        br.record_failure()
        assert br.state == "open" and br.trips_total == 1
        with pytest.raises(Exception) as ei:
            br.check()
        assert type(ei.value).__name__ == "BreakerOpen"
        assert ei.value.http_status == 503 and ei.value.retry_after_s >= 0
        time.sleep(0.3)
        assert br.state in ("open", "half_open")
        ok["v"] = True
        assert _wait_until(lambda: br.state == "closed", 5.0)
        br.check()
        br2 = cls(failure_threshold=2, cooldown_s=5.0)
        br2.record_failure()
        br2.record_success()
        br2.record_failure()
        assert br2.state == "closed"
        off = cls(failure_threshold=0, cooldown_s=1.0)
        for _ in range(5):
            off.record_failure()
        off.check()
    assert STATE_VALUES == {"closed": 0, "half_open": 1, "open": 2}


def test_breaker_open_serves_fallback_with_path(mk, want):
    def always_fail(stage, attempt):
        raise RuntimeError("injected device loss")

    eng = mk(dispatch_retries=0, breaker_failure_threshold=2,
             breaker_open_cooldown_s=30.0, fault_injector=always_fail)
    for _ in range(2):
        assert_frame_parity(eng.sql(SQL), want[SQL], ordered=True)
        assert eng.runner.last_metrics["path"] == "fallback"
    assert eng.runner.breaker.state == "open"
    got = eng.sql(SQL)
    m = eng.runner.last_metrics
    assert m["path"] == "fallback_breaker" and m["route"] == "fallback"
    assert m["fallback_reason"].startswith("breaker open")
    assert_frame_parity(got, want[SQL], ordered=True)
    # the raw IR passthrough has no interpreter equivalent: refused
    with pytest.raises(BreakerOpen):
        eng.execute_ir({"queryType": "timeseries", "dataSource": "t",
                        "granularity": "all",
                        "aggregations": [{"type": "longSum", "name": "s",
                                          "fieldName": "v"}]})
    # sql_batch legs go to the single path, and so to the interpreter
    outs = eng.sql_batch(BATCH_SQL)
    for q, f in zip(BATCH_SQL, outs):
        assert_frame_parity(f, want[q], ordered=True)
    eng.config.fallback_on_device_failure = False
    with pytest.raises(BreakerOpen):
        eng.sql(SQL)


def test_healer_probe_closes_the_breaker(mk, want):
    inj = FaultInjector(stages={"dispatch"}, fail_calls={1, 2})
    eng = mk(dispatch_retries=1, breaker_failure_threshold=1,
             breaker_open_cooldown_s=0.1, fault_injector=inj)
    eng.sql(SQL)  # both attempts fail: one terminal failure trips it
    assert eng.runner.breaker.state == "open"
    assert eng.runner.last_metrics["retries"] == 1
    assert len(eng.runner.last_metrics["retry_errors"]) == 2
    assert _wait_until(lambda: eng.runner.breaker.state == "closed")
    assert not eng.runner._datasets  # the recovery purge ran
    assert_frame_parity(eng.sql(SQL), want[SQL], ordered=True)
    assert eng.runner.last_metrics["route"] == "packed"


# ----------------------------------------------- retries and fallback

def test_retry_recovers(mk, want):
    inj = FlakyInjector(1)
    eng = mk(dispatch_retries=1, fault_injector=inj)
    got = eng.sql(SQL)
    m = eng.runner.last_metrics
    assert m["retries"] == 1 and m["route"] == "packed"
    assert m["retry_errors"] == ["RuntimeError: injected fault #1 at "
                                 "dispatch"]
    assert_frame_parity(got, want[SQL], ordered=True)


@pytest.mark.parametrize("fallback", [True, False])
def test_retry_exhaustion(mk, want, fallback):
    jax = mk(jax=True, dispatch_retries=1, fault_injector=FlakyInjector(10),
             fallback_on_device_failure=fallback)
    port = mk(dispatch_retries=1, fault_injector=FlakyInjector(10),
              fallback_on_device_failure=fallback)
    if not fallback:
        for eng in (jax, port):
            with pytest.raises(RuntimeError, match="injected fault"):
                eng.sql(SQL)
        return
    got = port.sql(SQL)
    assert_frame_parity(got, jax.sql(SQL), ordered=True)
    assert port.last_plan.fallback_reason.startswith("device failure")
    assert jax.last_plan.fallback_reason.startswith("device failure")
    m = port.runner.last_metrics
    assert m["path"] == "fallback" and m["retries"] == 1
    assert len(m["retry_errors"]) == 2
    failed = [h for h in jax.runner.history if h.get("failed")]
    assert failed[-1]["retry_errors"] == m["retry_errors"]


@pytest.mark.parametrize("failures, retries, shards",
                         [(1, 1, 4), (2, 2, 2)])
def test_shard_degradation(mk, want, failures, retries, shards):
    """The device-loss analog: the 8-device mesh's dispatch fails
    `failures` times and every retry halves the mesh (8 -> 4 -> 2);
    the statement answers on the smaller mesh, as the JAX package's."""
    eng = mk(num_shards=8, dispatch_retries=retries,
             degrade_shards_on_retry=True,
             fault_injector=FlakyInjector(failures))
    assert eng.runner.mesh.size == 8
    got = eng.sql(SQL)
    m = eng.runner.last_metrics
    assert m["retries"] == failures and m["degraded_shards"] == shards
    assert m["num_shards"] == shards and m["path"] != "fallback"
    assert eng.runner.mesh.size == shards
    assert eng.runner._ledger.num_chips == shards
    assert len(eng.sql("SELECT * FROM sys.devices")) == shards
    assert_frame_parity(got, want[SQL], ordered=True)


def test_injector_quiescent_by_default(mk):
    eng = mk(dispatch_retries=3)
    eng.sql(SQL)
    assert "retries" not in eng.runner.last_metrics


# ------------------------------------------- generalized fault sites

def test_host_transfer_fault_rides_dispatch_retry(mk, want):
    inj = FaultInjector(stages={"host-transfer"}, fail_calls={1})
    eng = mk(dispatch_retries=1, fault_injector=inj)
    got = eng.sql(SQL)
    assert eng.runner.last_metrics["retries"] == 1
    assert inj.by_stage == {"host-transfer": 1}
    assert_frame_parity(got, want[SQL], ordered=True)


def test_ingest_fault_site_aborts_registration(mk):
    inj = FaultInjector(stages={"ingest"}, fail_calls={1})
    eng = mk(register=False, fault_injector=inj)
    with pytest.raises(RuntimeError, match="injected fault"):
        _register(eng)
    assert eng.catalog.maybe("t") is None
    _register(eng)
    assert len(eng.sql(SQL)) == 3


def test_reprobe_fault_site_fails_probe(mk):
    eng = mk(register=False,
             fault_injector=FaultInjector(stages={"reprobe"}, rate=1.0))
    assert eng.runner._probe_device(0.5) is False
    eng.config.fault_injector = None
    assert eng.runner._probe_device(10.0) is True


def test_batch_leg_fault_falls_back_per_query(mk, want):
    inj = FaultInjector(stages={"batch-leg"}, fail_calls={1})
    eng = mk(fault_injector=inj)
    outs = eng.sql_batch(BATCH_SQL)
    assert inj.by_stage.get("batch-leg") == 1
    stmts = eng.runner.last_metrics["statements"]
    assert sum("batch_leg_error" in m for m in stmts) == 1
    assert sum(m.get("route") == "batch" for m in stmts) == 1
    for q, f in zip(BATCH_SQL, outs):
        assert_frame_parity(f, want[q], ordered=True)


def test_legacy_injector_fires_only_at_dispatch(mk):
    seen = []
    eng = mk(fault_injector=lambda stage, attempt: seen.append(stage))
    eng.sql(SQL)
    eng.sql_batch(BATCH_SQL)
    eng.append("t", [{"ts": "2021-01-05", "g": "x", "v": 1}])
    eng.compact_now("t")
    assert seen and set(seen) == {"dispatch"}


def test_compute_partials_runs_under_admission_and_breaker(mk):
    eng = mk()
    for _ in range(eng.config.breaker_failure_threshold):
        eng.runner.breaker.record_failure()
    with pytest.raises(BreakerOpen):
        eng.sql("CREATE DRUID CUBE c ON t DIMENSIONS (g) "
                "GRANULARITY all AGGREGATES (sum(v))")
    assert eng.cubes.get("c").status == "error"


# ------------------------------------------- ledger and stage pools

def test_ledger_pin_inflight_counts_and_never_evicts():
    led = HbmLedger(budget_bytes=1000)
    evicted = []
    led.add(("t", "col", "a"), 400, lambda: evicted.append("a"))
    led.add(("t", "col", "b"), 400, lambda: evicted.append("b"))
    led.pin_inflight(("__inflight__", 1), 500)
    assert led.bytes_in_use == 1300 and led.inflight_bytes == 500
    led.add(("t", "col", "c"), 400, lambda: evicted.append("c"))
    assert "a" in evicted and led.inflight_bytes == 500
    led.unpin_inflight(("__inflight__", 1))
    assert led.inflight_bytes == 0
    assert led.bytes_in_use == sum(n for n, _ in led._entries.values())


def test_stage_pool_bounds_reclaims_and_reenters():
    sched = StageScheduler(EngineConfig(device="cpu"))
    pool = sched.pools["enqueue"]
    assert pool.max_workers == 1 == \
        JaxScheduler(JaxConfig()).pools["enqueue"].max_workers
    entered, release = threading.Event(), threading.Event()

    def strand():
        with pool.section():
            entered.set()
            release.wait(timeout=30)

    t = threading.Thread(target=strand, daemon=True)
    t.start()
    assert entered.wait(5)
    # a budget that runs out raises the deadline's own error, as the
    # JAX package's pool does
    with pytest.raises(QueryDeadlineExceeded):
        with pool.section(budget_s=0.05):
            pass
    time.sleep(0.25)
    assert sched.reclaim_stranded(0.2) >= 1
    with pool.section(budget_s=5.0) as waited_ms:
        assert waited_ms >= 0.0
    release.set()
    t.join(timeout=10)
    tot = pool.totals()
    assert tot["active"] == 0 and tot["stranded"] >= 1
    with pool.section():
        with pool.section():
            assert pool.totals()["active"] == 1
    assert pool.totals()["active"] == 0
    sched.stop()


def test_background_graph_runs_wakes_rearms_and_records_faults():
    sched = StageScheduler(EngineConfig(device="cpu"))
    runs = []
    h = sched.register_periodic("probe", lambda: 30.0,
                                lambda: runs.append(1))
    h.wake()
    assert _wait_until(lambda: runs) and h.runs >= 1
    sched.stop()
    assert h.cancelled
    runs2 = []
    h2 = sched.register_periodic("probe2", lambda: 0.05,
                                 lambda: runs2.append(1))
    assert not h2.cancelled and _wait_until(lambda: runs2)
    sched.stop()
    cfg = EngineConfig(device="cpu", fault_injector=FaultInjector(
        stages={"stage-background"}, fail_calls=(1,)))
    sched = StageScheduler(cfg, inject=lambda s: maybe_inject(cfg, s))
    runs3 = []
    h3 = sched.register_periodic("flaky", lambda: 30.0,
                                 lambda: runs3.append(1))
    h3.wake()
    assert _wait_until(lambda: h3.errors >= 1)
    assert not runs3 and "injected fault" in (h3.last_error or "")
    h3.wake()
    assert _wait_until(lambda: runs3)
    sched.stop()


def test_close_joins_every_background_graph(mk):
    eng = mk(ingest_auto_compact=True, ingest_compact_interval_s=0.05,
             ingest_compact_rows=1, cube_auto_refresh=True,
             cube_refresh_interval_s=0.05)
    eng.sql("CREATE DRUID CUBE c ON t DIMENSIONS (g) "
            "GRANULARITY all AGGREGATES (sum(v))")
    eng.append("t", [{"ts": "2021-01-05", "g": "x", "v": 1}])
    assert _wait_until(
        lambda: eng.catalog.get("t").segments.delta_rows == 0)
    ticker = eng.runner.stages._ticker
    handles = [eng.ingest._compact_handle, eng.cubes._handle]
    assert ticker.is_alive() and all(handles)
    eng.close()
    assert not ticker.is_alive() and eng.runner.stages._ticker is None
    assert all(h.cancelled and not h.running for h in handles)


# ------------------------------------------------------- on the card

@pytest.mark.gpu
def test_cuda_probe_and_rebase_match_full_restack():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the probe syncs a CUDA stream)")
    eng = Engine(device="cuda", ingest_auto_compact=False,
                 cube_auto_refresh=False)
    try:
        _register(eng)
        assert eng.runner._probe_device(10.0) is True
        eng.sql(SQL)
        for k in range(3):
            eng.append("t", [{"ts": "2021-01-20", "g": "y", "v": k}] * 300)
            eng.sql(SQL)
            ds = eng.runner._datasets["t"]
            assert ds.rebased_cols >= 1
            fresh = DeviceDataset(ds.table, ds.device)
            for c in ("g", "v"):
                assert torch.equal(ds.col(c), fresh.col(c)), c
            assert torch.equal(ds.valid(), fresh.valid())
    finally:
        eng.close()

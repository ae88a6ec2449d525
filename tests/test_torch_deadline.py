"""The per-query deadline and its wedge recovery in the PyTorch port
against the JAX package (tests/test_fault_recovery.py's deadline cases,
the batch's shared pass under the deadline, and the serialized retry's
purge).

A statement's device work runs on a watchdog thread; past
`query_deadline_s` the caller raises QueryDeadlineExceeded (served by the
fallback when `fallback_on_device_failure` is set), the device is marked
wedged, and the next statement re-probes it before trusting it. Each case
runs the same injector and config in a port engine (`device="cpu"`) and
a JAX engine (its default platform, on the CPU backend) over the same
table and compares frames (assert_frame_parity), the `fallback_reason`
class and the record keys. Injector sleeps stay under a second.
"""

import threading
import time

import pytest

from test_fault_recovery import SQL, FlakyInjector, _df
from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.executor.runner import \
    QueryDeadlineExceeded as JaxDeadlineExceeded
from tpu_olap_torch.bench.parity import assert_frame_parity
from tpu_olap_torch.resilience import QueryDeadlineExceeded
from _torch_port import cpu_engine

UNGROUPED = "SELECT sum(v) AS s, count(*) AS n FROM t WHERE v < 50"
BATCH = [SQL, UNGROUPED, "SELECT g, max(v) AS m FROM t GROUP BY g"]
STALL_S = 0.6
DEADLINE_S = 0.2


def _register(eng):
    eng.register_table("t", _df(), time_column="ts", block_rows=512)
    return eng


@pytest.fixture
def mk(request):
    """mk(jax=False, **config): a registered engine of either package,
    closed when the test ends; the port's falls back on device failure
    unless the test says otherwise, as the JAX package's default."""
    made = []

    def done():
        for e in made:
            e.runner.breaker.close()
            e.close()
        # let abandoned watchdog threads finish their stalls
        time.sleep(STALL_S)
    request.addfinalizer(done)

    def make(jax=False, **kw):
        kw.setdefault("cube_auto_refresh", False)
        if jax:
            eng = JaxEngine(JaxConfig(**kw))
        else:
            kw.setdefault("fallback_on_device_failure", True)
            eng = cpu_engine(**kw)
        made.append(eng)
        return _register(eng)
    return make


@pytest.fixture(scope="module")
def want():
    eng = _register(JaxEngine(JaxConfig(cube_auto_refresh=False)))
    out = {q: eng.sql(q) for q in BATCH}
    eng.close()
    return out


class _StallOnce:
    """Injector that sleeps at the dispatch site the first time it is
    armed (a plain callable: the dispatch site only)."""

    def __init__(self):
        self.armed = False
        self.fired = 0

    def __call__(self, stage, attempt):
        if self.armed:
            self.armed = False
            self.fired += 1
            time.sleep(STALL_S)


def _reason_class(plan):
    r = plan.fallback_reason
    return None if r is None else ": ".join(r.split(": ")[:2])


def test_deadline_falls_back(mk, want):
    """A dispatch that outlives the deadline is abandoned and the engine
    still answers through the fallback: a deadline record first, then the
    fallback's own record, with the JAX package's keys."""
    got = {}
    for jax in (True, False):
        inj = _StallOnce()
        eng = mk(jax=jax, query_deadline_s=DEADLINE_S, dispatch_retries=0,
                 fault_injector=inj)
        inj.armed = True
        t0 = time.perf_counter()
        out = eng.sql(SQL)
        assert time.perf_counter() - t0 < STALL_S + 1.0
        assert inj.fired == 1
        dl = [h for h in eng.runner.history if h.get("deadline_exceeded")]
        fb = eng.runner.history[-1]
        assert len(dl) == 1 and fb["query_type"] == "fallback"
        assert fb["device_attempt_ms"] >= DEADLINE_S * 1000
        got[jax] = (out, _reason_class(eng.last_plan), sorted(dl[0]),
                    set(fb), dl[0]["path"], fb["path"])
    assert got[False][1] == got[True][1] == \
        "device failure: QueryDeadlineExceeded"
    assert got[False][2] == got[True][2]
    # the port's fallback record adds its route and copy count
    assert got[False][3] - got[True][3] == {"route", "host_copies"}
    assert got[False][4:] == got[True][4:]
    assert_frame_parity(got[False][0], got[True][0], ordered=True)
    assert_frame_parity(got[False][0], want[SQL], ordered=True)


def test_deadline_recovery_reaches_device_again(mk, want):
    """After a statement timed out, the next re-probes the device,
    clears the wedge and runs on the device path again."""
    for jax in (True, False):
        inj = _StallOnce()
        eng = mk(jax=jax, dispatch_retries=0, fault_injector=inj)
        eng.sql(SQL)  # warm outside the deadline regime
        eng.config.query_deadline_s = DEADLINE_S
        inj.armed = True
        got1 = eng.sql(SQL)
        assert "QueryDeadlineExceeded" in eng.last_plan.fallback_reason
        assert eng.runner._wedged
        eng.config.query_deadline_s = 30.0
        got2 = eng.sql(SQL)
        assert eng.last_plan.fallback_reason is None
        assert not eng.runner._wedged
        rec = [h for h in eng.runner.history
               if h.get("device_probe_recovered")]
        assert len(rec) == 1 and rec[0]["path"] == "dense"
        assert eng.runner.history[-1]["query_type"] == "groupBy"
        assert not eng.runner.history[-1].get("deadline_exceeded")
        assert_frame_parity(got1, want[SQL], ordered=True)
        assert_frame_parity(got2, want[SQL], ordered=True)


def test_deadline_raises_without_fallback(mk):
    """With the fallback off, the deadline's error reaches the caller,
    with the JAX package's taxonomy, and counts once against the SLO."""
    assert (QueryDeadlineExceeded.code, QueryDeadlineExceeded.retriable,
            QueryDeadlineExceeded.http_status) == \
        (JaxDeadlineExceeded.code, JaxDeadlineExceeded.retriable,
         JaxDeadlineExceeded.http_status) == ("deadline_exceeded", True, 504)
    slo = {}
    for jax, err in ((True, JaxDeadlineExceeded),
                     (False, QueryDeadlineExceeded)):
        inj = _StallOnce()
        eng = mk(jax=jax, query_deadline_s=DEADLINE_S, dispatch_retries=0,
                 fault_injector=inj, fallback_on_device_failure=False)
        inj.armed = True
        with pytest.raises(err, match="exceeded deadline"):
            eng.sql(SQL)
        slo[jax] = eng.runner.slo.snapshot()
        # the interim record logs `query_error`; no served `query`
        assert [e["event"] for e in eng.runner.events.snapshot()
                if e["event"].startswith("query")] == ["query_error"]
    assert slo[False] == slo[True] and slo[False]["bad_total"] == 1


def test_reprobe_failure_fails_fast(mk, want):
    """While the device does not answer the probe, a wedged engine fails
    the next statement at once (device_probe_failed) instead of stacking
    another deadline wait; the fallback serves it."""
    class ProbeFails:
        stages = {"reprobe"}

        def __call__(self, stage, attempt):
            raise RuntimeError("injected probe failure")

    notes = {}
    for jax in (True, False):
        eng = mk(jax=jax, query_deadline_s=DEADLINE_S,
                 fault_injector=ProbeFails())
        eng.runner._wedged = True
        t0 = time.perf_counter()
        out = eng.sql(SQL)
        assert time.perf_counter() - t0 < 5
        assert _reason_class(eng.last_plan) == \
            "device failure: QueryDeadlineExceeded"
        assert "still unresponsive" in eng.last_plan.fallback_reason
        note = [h for h in eng.runner.history
                if h.get("device_probe_failed")]
        assert len(note) == 1 and eng.runner._wedged
        notes[jax] = sorted(note[0])
        assert_frame_parity(out, want[SQL], ordered=True)
    assert notes[False] == notes[True]


def test_batch_shared_pass_under_the_deadline(mk, want):
    """The batch's shared pass runs under the same deadline: a stall
    boxes every leg of the fused group with QueryDeadlineExceeded and
    leaves one batch deadline record; the engine's sql_batch then serves
    every leg through the single path (the wedge re-probed), equal to
    the JAX package's answers."""
    records = {}
    for jax in (True, False):
        inj = _StallOnce()
        eng = mk(jax=jax, dispatch_retries=0, fault_injector=inj)
        eng.sql_batch(BATCH)   # warm: compiles outside the deadline
        eng.config.query_deadline_s = DEADLINE_S
        table = eng.catalog.get("t").segments
        queries = [eng.planner.plan(q).query for q in BATCH]
        inj.armed = True
        t0 = time.perf_counter()
        boxed = eng.runner._execute_batch_boxed(queries, table)
        assert time.perf_counter() - t0 < DEADLINE_S + 1.0
        assert all(isinstance(b, (JaxDeadlineExceeded if jax else
                                  QueryDeadlineExceeded)) for b in boxed)
        dl = [h for h in eng.runner.history if h.get("batch_dispatch")]
        assert len(dl) == 1 and dl[0]["deadline_exceeded"]
        records[jax] = sorted(dl[0])
        time.sleep(STALL_S)   # the abandoned pass ends
        inj.armed = True
        outs = eng.sql_batch(BATCH)
        for q, out in zip(BATCH, outs):
            assert_frame_parity(out, want[q], ordered=True, label=q)
    assert records[False] == records[True]


def test_serialized_retry_under_a_deadline_does_not_wait_on_the_lock(mk,
                                                                     want):
    """Serialized mode with a deadline: the caller holds dispatch_lock
    while the watchdog thread dispatches, so the retry's purge must not
    take the lock — it would wait out the deadline (a deadline record
    and the fallback). One failed attempt then retries at once, on the
    device path, in both packages."""
    for jax in (True, False):
        eng = mk(jax=jax, pipeline_depth=0, dispatch_retries=1)
        eng.sql(SQL)   # warm outside the deadline and the fault
        eng.config.query_deadline_s = 5.0
        eng.config.fault_injector = FlakyInjector(1)
        out = eng.sql(SQL)
        rec = eng.runner.history[-1]
        assert rec["retries"] == 1 and rec["path"] == "dense"
        assert eng.last_plan.fallback_reason is None
        assert not any(h.get("deadline_exceeded")
                       for h in eng.runner.history)
        assert_frame_parity(out, want[SQL], ordered=True)


def test_deadline_bounds_the_pipelined_lock_acquire(mk):
    """Pipelined mode: a statement whose stage 1 cannot get dispatch_lock
    within the deadline (a stranded holder) gives up with the deadline's
    error rather than hang."""
    for jax in (True, False):
        eng = mk(jax=jax, fallback_on_device_failure=False)
        eng.sql(SQL)
        eng.config.query_deadline_s = DEADLINE_S
        held, release = threading.Event(), threading.Event()

        def strand(eng=eng):
            with eng.runner.dispatch_lock:
                held.set()
                release.wait(timeout=30)

        t = threading.Thread(target=strand, daemon=True)
        t.start()
        assert held.wait(5)
        try:
            with pytest.raises(JaxDeadlineExceeded if jax
                               else QueryDeadlineExceeded):
                eng.sql(SQL)
        finally:
            release.set()
            t.join(timeout=10)

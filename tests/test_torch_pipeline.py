"""The pipelined two-stage mode of the PyTorch port against the JAX
package (tests/test_pipeline.py's cases).

Stage 1 (enqueue, under dispatch_lock) launches the route's kernels and
queues its one copy, pinning the output's bytes in the HBM ledger;
stage 2 (transfer, finalize, assemble) reads the copy without the lock.
Each case runs the same statements, injector and config through a port
engine (`device="cpu"`) and a JAX engine (its default platform, on the
CPU backend, so that its transfer stage runs too) over the same table,
and compares the frames (assert_frame_parity), the `fallback_reason`
class and the records. Injector sleeps stay under a second.
"""

import threading
import time

import pytest

from test_pipeline import SQL, _df
from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.resilience import FaultInjector as JaxFaultInjector
from tpu_olap_torch.bench.parity import assert_frame_parity
from tpu_olap_torch.executor.config import EngineConfig
from tpu_olap_torch.resilience import FaultInjector
from _torch_port import cpu_engine

FOREGROUND = ("plan", "enqueue", "transfer", "finalize", "assemble")
UNGROUPED = "SELECT sum(v) AS s, count(*) AS n FROM t WHERE v < 50"
WINDOW = ("SELECT g, v, row_number() OVER (PARTITION BY g ORDER BY v "
          "DESC, ts) AS r FROM t WHERE v > 90")
SPARSE = "SELECT g, v, sum(v) AS s FROM t GROUP BY g, v ORDER BY g, v"


def _register(eng):
    eng.register_table("t", _df(), time_column="ts", block_rows=512)
    return eng


@pytest.fixture
def mk(request):
    """mk(jax=False, **config): a registered engine of either package,
    closed (breaker healer stopped) when the test ends. The port's has
    the device-failure fallback on, as the JAX package's default."""
    made = []

    def done():
        for e in made:
            e.runner.breaker.close()
            e.close()
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
    """The JAX package's answers, serialized mode."""
    eng = _register(JaxEngine(JaxConfig(pipeline_depth=0,
                                        cube_auto_refresh=False)))
    out = {q: eng.sql(q) for q in (SQL, UNGROUPED, WINDOW, SPARSE)}
    eng.close()
    return out


def _reason_class(plan):
    """The fallback_reason up to its exception's name."""
    r = plan.fallback_reason
    return None if r is None else ": ".join(r.split(": ")[:2])


def test_pipelined_is_default_and_matches_serialized(mk, want):
    assert EngineConfig().pipeline_depth == JaxConfig().pipeline_depth == 4
    assert EngineConfig().device == "cuda"
    for depth in (4, 0):
        eng = mk(pipeline_depth=depth)
        assert_frame_parity(eng.sql(SQL), want[SQL], ordered=True,
                            label=f"depth {depth}")
        rec = eng.history[-1]
        assert rec["pipelined"] is (depth > 0)
        assert ("lock_wait_ms" in rec) is (depth > 0)
        assert rec["host_copies"] == 1 and rec["route"] == "packed"
        text = eng.metrics.render()
        for series in ("tpu_olap_dispatch_lock_wait_ms_count",
                       "tpu_olap_pipeline_inflight",
                       "tpu_olap_inflight_transfers"):
            assert series in text, series
        hist = eng.metrics.histogram("dispatch_lock_wait_ms")
        assert next(iter(hist.series.values())).n >= 1


def test_ledger_pins_the_output_until_stage2(mk, want):
    """Stage 1 pins the copy's bytes in the ledger; the host-transfer
    site fires in stage 2, before the unpin, as in the JAX package."""
    seen = []
    port = mk()

    class Probe:
        stages = {"host-transfer"}

        def __call__(self, stage, attempt):
            seen.append(port.runner._ledger.inflight_bytes)

    port.config.fault_injector = Probe()
    assert_frame_parity(port.sql(SQL), want[SQL], ordered=True)
    assert seen == [port.history[-1]["host_bytes"]] and seen[0] > 0
    assert port.runner._ledger.inflight_bytes == 0


def test_concurrent_queries_under_tight_budget_stay_correct(mk, want):
    """Pipelined statements against a 1-byte HBM budget (every add evicts
    what is not pinned) while results are in flight: every thread still
    gets the exact answer, and no pin outlives its statement."""
    port = mk(hbm_budget_bytes=1, pipeline_depth=2)
    errs = []

    def worker():
        try:
            for _ in range(3):
                assert_frame_parity(port.sql(SQL), want[SQL], ordered=True)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs, errs
    assert port.runner._ledger.inflight_bytes == 0


@pytest.mark.parametrize("site", [f"stage-{s}" for s in FOREGROUND])
def test_fault_at_each_stage_boundary_still_answers(mk, want, site):
    """A fault at any stage boundary never surfaces: the retry layer
    (enqueue, transfer) or the fallback (plan, finalize, assemble)
    answers with the frame, the fallback_reason class and the records of
    the JAX package; then both heal."""
    got = {}
    for jax in (True, False):
        eng = mk(jax=jax, breaker_failure_threshold=100)
        eng.sql(SQL)  # warm before arming
        inj = (JaxFaultInjector if jax else FaultInjector)(
            stages={site}, fail_calls=(1,))
        eng.config.fault_injector = inj
        try:
            out = eng.sql(SQL)
        finally:
            eng.config.fault_injector = None
        assert inj.faults == 1, f"{site} never fired"
        got[jax] = (out, _reason_class(eng.last_plan),
                    eng.history[-1]["path"],
                    sum(1 for h in eng.history if h.get("failed")))
        assert_frame_parity(eng.sql(SQL), want[SQL], ordered=True)
        assert eng.last_plan.fallback_reason is None
        snap = eng.runner.stages.snapshot()["pools"]
        assert all(p["active"] == 0 for p in snap.values()), snap
    assert_frame_parity(got[False][0], got[True][0], ordered=True,
                        label=site)
    assert got[False][1:] == got[True][1:], (got[False][1:],
                                            got[True][1:])


class _Stall:
    """Injector that stalls its sites once, when armed."""

    def __init__(self, stages, stall_s=0.5):
        self.stages = stages
        self.stall_s = stall_s
        self.armed = False
        self.fired = 0

    def __call__(self, stage, attempt):
        if self.armed:
            self.fired += 1
            self.armed = False
            time.sleep(self.stall_s)


@pytest.mark.parametrize("site", ["stage-enqueue", "stage-transfer",
                                  "host-transfer"])
def test_deadline_expiry_at_a_stage_boundary(mk, want, site):
    """A stall between or inside the stages — the enqueue section, the
    transfer boundary, the copy itself (after the lock was released) —
    trips the watchdog: deadline -> wedge -> fallback answers -> the
    reprobe clears the wedge and the device path serves again. Same
    fallback_reason class and the same deadline record keys as the JAX
    package."""
    got = {}
    for jax in (True, False):
        inj = _Stall({site})
        eng = mk(jax=jax, dispatch_retries=0, fault_injector=inj)
        eng.sql(SQL)  # warm outside the deadline regime
        eng.config.query_deadline_s = 0.2
        inj.armed = True
        out = eng.sql(SQL)
        assert inj.fired == 1
        dl = [h for h in eng.runner.history if h.get("deadline_exceeded")]
        assert len(dl) == 1 and eng.runner._wedged
        got[jax] = (out, _reason_class(eng.last_plan), sorted(dl[0]),
                    eng.history[-1]["query_type"])
        eng.config.query_deadline_s = 30.0
        assert_frame_parity(eng.sql(SQL), want[SQL], ordered=True)
        assert eng.last_plan.fallback_reason is None
        assert not eng.runner._wedged
    assert got[False][1] == got[True][1] == \
        "device failure: QueryDeadlineExceeded"
    assert got[False][2:] == got[True][2:]
    assert_frame_parity(got[False][0], got[True][0], ordered=True)
    time.sleep(0.4)   # let the abandoned threads drain


def test_breaker_trips_between_enqueue_and_complete(mk, want):
    """A copy lost in stage 2 is a terminal device failure: two open the
    breaker and the engine serves degraded (path fallback_breaker)."""
    class FailTransfer:
        stages = {"host-transfer"}

        def __call__(self, stage, attempt):
            raise RuntimeError("injected transfer loss")

    for jax in (True, False):
        eng = mk(jax=jax, dispatch_retries=0, breaker_failure_threshold=2,
                 breaker_open_cooldown_s=30.0,
                 fault_injector=FailTransfer())
        for _ in range(2):
            assert_frame_parity(eng.sql(SQL), want[SQL], ordered=True)
        assert eng.runner.breaker.state == "open"
        assert_frame_parity(eng.sql(SQL), want[SQL], ordered=True)
        assert eng.runner.history[-1]["path"] == "fallback_breaker"


def test_result_cache_populates_from_stage2_completion(mk, want):
    for jax in (True, False):
        eng = mk(jax=jax, result_cache_enabled=True, pipeline_depth=2)
        assert_frame_parity(eng.sql(SQL), want[SQL], ordered=True)
        assert eng.runner.history[-1]["pipelined"] is True
        assert_frame_parity(eng.sql(SQL), want[SQL], ordered=True)
        rec = eng.runner.history[-1]
        assert rec["path"] == "cache" and rec["cache_tier"] == "full"


def test_recovery_survives_stranded_dispatch_lock(mk):
    """An abandoned stage 1 holding dispatch_lock must not hang recovery:
    the pipelined acquire is bounded, reports a stranded-lock note, and
    succeeds once the lock drains — in both packages."""
    notes = {}
    for jax in (True, False):
        eng = mk(jax=jax, pipeline_depth=2)
        eng.sql(SQL)
        release, held = threading.Event(), threading.Event()

        def strand(eng=eng):
            eng.runner.dispatch_lock.acquire()
            held.set()
            release.wait(timeout=30)
            eng.runner.dispatch_lock.release()

        t = threading.Thread(target=strand, daemon=True)
        t.start()
        assert held.wait(5)
        t0 = time.perf_counter()
        assert eng.runner._recover_after_probe(lock_timeout_s=1.0) is False
        assert time.perf_counter() - t0 < 5
        notes[jax] = dict(eng.runner.history[-1])
        release.set()
        t.join(timeout=10)
        assert eng.runner._recover_after_probe(lock_timeout_s=1.0) is True
        assert eng.runner.history[-1].get("device_probe_recovered")
    assert notes[False]["device_probe_lock_stranded"] is True
    assert sorted(notes[False]) == sorted(notes[True])
    assert notes[False]["path"] == notes[True]["path"]


def test_sparse_path_leaves_no_inflight_pins(mk, want):
    """The sparse route pins each attempt's output and unpins it, on
    success and on the over-budget raise (the fallback then serves)."""
    for jax in (True, False):
        eng = mk(jax=jax, dense_group_budget=4, pipeline_depth=2)
        got = eng.sql(SPARSE)
        assert eng.runner.history[-1]["path"] == "sparse"
        ledger = eng.runner._hbm_ledger if jax else eng.runner._ledger
        assert ledger.inflight_bytes == 0
        assert_frame_parity(got, want[SPARSE], ordered=True)
        sp = mk(jax=jax, dense_group_budget=1, sparse_group_budget=1,
                pipeline_depth=2)
        assert_frame_parity(sp.sql(SPARSE), want[SPARSE], ordered=True)
        assert sp.runner.history[-1]["query_type"] == "fallback"
        ledger = sp.runner._hbm_ledger if jax else sp.runner._ledger
        assert ledger.inflight_bytes == 0


def test_mixed_classes_from_8_threads_at_depth_4(mk, want):
    """Eight threads in a grouped/ungrouped/fallback/statement mix at the
    default depth: every answer equals the JAX package's, every
    foreground stage saw traffic, no stage slot leaks, enqueue stays one
    wide."""
    port = mk(pipeline_depth=4)
    qs = {"grouped": SQL, "ungrouped": UNGROUPED, "fallback": WINDOW,
          "statement": "EXPLAIN DRUID REWRITE SELECT g, sum(v) AS s "
                       "FROM t GROUP BY g"}

    errs = []
    mix = ["grouped"] * 3 + ["ungrouped"] * 3 + ["fallback", "statement"]

    def worker(label):
        try:
            for _ in range(2):
                out = port.sql(qs[label])
                if label != "statement":
                    assert_frame_parity(out, want[qs[label]], ordered=True,
                                        label=label)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append((label, repr(e)))

    threads = [threading.Thread(target=worker, args=(lb,)) for lb in mix]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs, errs
    snap = port.runner.stages.snapshot()["pools"]
    for s in FOREGROUND:
        assert snap[s]["submitted"] > 0, (s, snap[s])
        assert snap[s]["active"] == 0, (s, snap[s])
    assert snap["enqueue"]["max_workers"] == 1

"""Admission control: a bounded device-dispatch queue.

The chip has one program queue (SURVEY.md §3.5 P1), so device dispatch
serializes on QueryRunner.dispatch_lock — but the HTTP surface runs on
an unbounded ThreadingHTTPServer thread pool, and before this layer
every concurrent query piled onto that lock and waited however long the
backlog took. The admission controller bounds that pile-up the way a
production broker does:

- at most `max_inflight` dispatches hold slots concurrently (the lock
  still serializes the device itself; extra slots overlap the Python
  pre/post work around it);
- at most `queue_limit` callers wait for a slot — the next one is shed
  immediately with QueryShed (HTTP 429), which a load balancer turns
  into "try another replica" instead of a growing queue;
- **deadline-aware shedding**: a query whose `query_deadline_s` budget
  cannot cover the expected queue wait (EWMA of recent slot hold times
  x queue depth) is shed at the door instead of burning its deadline in
  line and timing out anyway — the difference between a 429 in
  microseconds and a 504 after `query_deadline_s`.

Queue depth, queue wait, and shed counts are first-class metrics
(`tpu_olap_admission_queue_depth`, `tpu_olap_admission_queue_wait_ms`,
`tpu_olap_queries_shed_total{reason=...}`).

Slot acquisition is not strictly FIFO (condition wake order, and a
fresh arrival can take a just-freed slot before a woken waiter) — the
bound is on *how many* wait, not their order; all waiters make progress
because every release notifies.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from tpu_olap_torch.resilience.errors import QueryShed

# seed for the service-time EWMA before any dispatch completes; a few
# tens of ms is the observed warm SSB dispatch scale
_EWMA_SEED_S = 0.05
_EWMA_ALPHA = 0.2


class AdmissionController:
    """Bounded, deadline-aware admission to the dispatch section.

    `max_inflight <= 0` disables admission entirely (every slot()
    context is a no-op) — the pre-resilience behavior.
    """

    def __init__(self, max_inflight: int, queue_limit: int,
                 metrics=None, events=None, pipeline_depth: int = 0):
        self.max_inflight = int(max_inflight)
        self.queue_limit = max(0, int(queue_limit))
        self._events = events  # obs.events.EventLog (optional)
        self._cond = threading.Condition()
        self._inflight = 0
        self._queued = 0
        self._service_ewma_s = _EWMA_SEED_S
        self._local = threading.local()  # re-entrancy guard
        # pipelined execution (EngineConfig.pipeline_depth): bounds how
        # many dispatches may sit between stage-1 enqueue and stage-2
        # completion at once, so queued device work and pinned result
        # buffers stay within the HBM budget. Independent of the
        # max_inflight dispatch-slot bound (admission off still bounds
        # the pipeline); 0 disables the gate.
        self.pipeline_depth = max(0, int(pipeline_depth))
        self._p_cond = threading.Condition()
        self._p_inflight = 0
        self._m_shed = self._m_depth = self._m_wait = None
        self._m_pipeline = None
        if metrics is not None:
            from tpu_olap_torch.obs.metrics import QUEUE_WAIT_BUCKETS_MS
            self._m_shed = metrics.counter(
                "queries_shed_total",
                "Queries shed by admission control.", ("reason",))
            self._m_depth = metrics.gauge(
                "admission_queue_depth",
                "Callers currently queued for a dispatch slot.")
            self._m_wait = metrics.histogram(
                "admission_queue_wait_ms",
                "Wait for a dispatch slot (admitted queries only).",
                buckets=QUEUE_WAIT_BUCKETS_MS)
            self._m_pipeline = metrics.gauge(
                "pipeline_inflight",
                "Dispatches between stage-1 enqueue and stage-2 "
                "completion (pipelined execution occupancy).")
            self._m_depth.set(0)
            self._m_pipeline.set(0)

    # ------------------------------------------------------------ stats

    def snapshot(self) -> dict:
        with self._cond:
            out = {"inflight": self._inflight, "queued": self._queued,
                   "max_inflight": self.max_inflight,
                   "queue_limit": self.queue_limit,
                   "service_ewma_ms": round(
                       self._service_ewma_s * 1000, 3)}
        with self._p_cond:
            out["pipeline_depth"] = self.pipeline_depth
            out["pipeline_inflight"] = self._p_inflight
        return out

    def _expected_wait_s(self) -> float:
        """Coarse queue-wait estimate under the lock: everyone ahead of
        a new arrival (current queue, plus the backlog implied by full
        slots) costs ~one EWMA'd service time per max_inflight slots."""
        if self._inflight < self.max_inflight:
            return 0.0
        ahead = self._queued + 1
        return ahead * self._service_ewma_s / max(1, self.max_inflight)

    def _shed(self, reason: str, msg: str):
        # metric inc only (a few dict ops): _shed fires while the caller
        # holds self._cond, so the event emission — which may write to
        # the JSONL file sink — happens in slot(), outside the lock
        if self._m_shed is not None:
            self._m_shed.inc(reason=reason)
        raise QueryShed(msg, reason=reason)

    def _emit_shed(self, e: QueryShed):
        """Shed event, emitted OUTSIDE self._cond: a slow event-log file
        sink must not stall every other thread's admission. A shed query
        never reaches QueryRunner.record(), so this event IS its entry
        in the structured log."""
        if self._events is not None:
            from tpu_olap_torch.obs.trace import current_query_id
            self._events.emit("shed", reason=e.reason, detail=str(e),
                              query_id=current_query_id())

    # ------------------------------------------------------------- slot

    @contextmanager
    def slot(self, budget_s: float | None = None):
        """Hold one dispatch slot for the body. May raise QueryShed
        before the body runs; never after. `budget_s` is the query's
        remaining deadline budget (None = no deadline): used both for
        the at-the-door expected-wait shed and as the cap on actual
        queue wait. Re-entrant per thread (nested holds are free), so
        a batch path that re-enters the runner never deadlocks on its
        own slot."""
        if self.max_inflight <= 0 or getattr(self._local, "held", 0):
            yield
            return
        try:
            waited_ms = self._admit(budget_s)
        except QueryShed as e:
            self._emit_shed(e)
            raise
        if self._m_wait is not None:
            self._m_wait.observe(waited_ms)
        self._local.held = 1
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._local.held = 0
            held_s = time.perf_counter() - t0
            with self._cond:
                self._inflight -= 1
                self._service_ewma_s += _EWMA_ALPHA * (
                    held_s - self._service_ewma_s)
                self._cond.notify()

    def _admit(self, budget_s: float | None) -> float:
        """Block until a slot frees (bounded by queue_limit and the
        deadline budget); returns the wait in ms."""
        with self._cond:
            if self._inflight < self.max_inflight:
                self._inflight += 1
                return 0.0
            if self._queued >= self.queue_limit:
                self._shed(
                    "queue_full",
                    f"dispatch queue full ({self._queued} queued, "
                    f"limit {self.queue_limit})")
            exp = self._expected_wait_s()
            if budget_s is not None and exp > budget_s:
                self._shed(
                    "deadline_budget",
                    f"expected queue wait {exp * 1000:.0f} ms exceeds "
                    f"the query's deadline budget "
                    f"{budget_s * 1000:.0f} ms")
            self._queued += 1
            if self._m_depth is not None:
                self._m_depth.set(self._queued)
            t0 = time.perf_counter()
            deadline = None if budget_s is None else t0 + budget_s
            try:
                while self._inflight >= self.max_inflight:
                    timeout = None
                    if deadline is not None:
                        timeout = deadline - time.perf_counter()
                        if timeout <= 0:
                            self._shed(
                                "deadline_budget",
                                "deadline budget exhausted while "
                                "queued for a dispatch slot")
                    self._cond.wait(timeout)
            finally:
                self._queued -= 1
                if self._m_depth is not None:
                    self._m_depth.set(self._queued)
            self._inflight += 1
            return (time.perf_counter() - t0) * 1000

    # --------------------------------------------------------- pipeline

    @contextmanager
    def pipeline_slot(self, budget_s: float | None = None):
        """Hold one in-flight pipeline slot for the body (stage-1
        enqueue through stage-2 completion of one device dispatch).
        Bounds queued device work + pinned result buffers at
        pipeline_depth; a waiter whose deadline budget expires before a
        slot frees is shed (the dispatch was doomed anyway). Re-entrant
        per thread, like slot(): a path that re-enters the runner never
        deadlocks on its own pipeline slot. Disabled (depth 0) -> no-op.
        """
        if self.pipeline_depth <= 0 or getattr(self._local, "p_held", 0):
            yield
            return
        try:
            self._p_admit(budget_s)
        except QueryShed as e:
            self._emit_shed(e)  # outside the cond, like slot()
            raise
        self._local.p_held = 1
        try:
            yield
        finally:
            self._local.p_held = 0
            with self._p_cond:
                # clamp: reset_pipeline may have reclaimed this slot
                # while its (abandoned) holder was still running
                self._p_inflight = max(0, self._p_inflight - 1)
                if self._m_pipeline is not None:
                    self._m_pipeline.set(self._p_inflight)
                self._p_cond.notify()

    def reset_pipeline(self):
        """Reclaim in-flight pipeline slots stranded by deadline-
        abandoned dispatch threads — called from wedge recovery once
        the device has been probed healthy and its state purged
        (QueryRunner._recover_after_probe). Without this, pipeline_depth
        hung dispatches would permanently zero the engine's device
        capacity even after the device heals. A stranded worker that
        later wakes releases a slot that was already reclaimed; the
        release clamps at zero, so the worst case is a transiently
        over-admitted dispatch, not permanent starvation."""
        with self._p_cond:
            if self._p_inflight:
                self._p_inflight = 0
                if self._m_pipeline is not None:
                    self._m_pipeline.set(0)
                self._p_cond.notify_all()

    def _p_admit(self, budget_s: float | None):
        with self._p_cond:
            deadline = None if budget_s is None \
                else time.perf_counter() + budget_s
            while self._p_inflight >= self.pipeline_depth:
                timeout = None
                if deadline is not None:
                    timeout = deadline - time.perf_counter()
                    if timeout <= 0:
                        self._shed(
                            "pipeline_stall",
                            "deadline budget exhausted waiting for an "
                            "in-flight pipeline slot")
                self._p_cond.wait(timeout)
            self._p_inflight += 1
            if self._m_pipeline is not None:
                self._m_pipeline.set(self._p_inflight)

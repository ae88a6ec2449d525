"""Stage-graph execution scheduler (the JAX package's, copied whole;
docs/EXECUTION.md describes it).

Query execution is an explicit per-query stage graph —

    plan -> enqueue -> transfer -> finalize/post-agg -> assemble

— and this module is the small scheduler that drives it. Each stage
class owns a bounded worker pool (StagePool): a stage section occupies
one pool slot for its duration, waiters queue on the pool, and async
submissions (the per-chip transfer fan-out, background graphs) run on
real pool worker threads. The executor's previous shape — the caller's
thread doing host-transfer AND assembly while the next query waits on
one coarse lock — becomes independent per-stage capacities: transfer
and assembly scale independently of the enqueue section, which stays
width 1 because the chip has one program queue (SURVEY.md §3.5 P1).

Pipeline depth is graph admission: `EngineConfig.pipeline_depth` bounds
how many per-query graphs are in flight at once (StageScheduler.graph
wraps AdmissionController.pipeline_slot, so shed/deadline/metrics
semantics are unchanged), and the per-stage queues absorb bursts inside
an admitted graph.

Background work rides the same machinery instead of bespoke daemon
threads: cube maintenance, delta compaction (checkpointing chained on
it), and WAL interval flush register as periodic background graphs
(register_periodic). One ticker thread schedules all of them onto the
`background` pool; their bodies keep their existing admission slots,
breaker checks, and fault-injection sites, so foreground deadlines and
the breaker govern background device work too.

Observability: every stage section exports `stage_queue_depth{stage}`,
`stage_wait_ms{stage}`, `stage_active_workers{stage}` and
`stage_busy_ms_total{stage}`, opens a `stage:<name>` span (visible in
EXPLAIN ANALYZE and /debug/queries), appends a record to the query's
`stages` metrics block, and fires the `stage-<name>` fault-injection
site (resilience.faults) at entry.

Stranded-worker recovery mirrors AdmissionController.reset_pipeline: a
deadline-abandoned thread wedged inside a stage section holds its slot;
reclaim_stranded() (called from wedge recovery) frees slots held longer
than the deadline so a healed device gets its stage capacity back. A
stranded holder that later wakes releases a reclaimed token, which is
ignored — worst case one transiently over-occupied stage, never
permanent starvation.

In the port the query path's sections are the runner's two stages on
one CUDA stream: stage 1 (`enqueue`, under dispatch_lock) launches the
kernels and the non-blocking copy into pinned host memory and records
an event; stage 2 (`transfer`, `finalize`, `assemble`) waits on that
event and runs without the lock. Under a mesh, stage 2 waits on one
copy per device through `map_stage` (the per-device transfer fan-out):
the D waits overlap on the transfer pool's workers, each in that
worker's own slot.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext

from tpu_olap_torch.obs.trace import span as _span

# foreground stage classes, in graph order
FOREGROUND_STAGES = ("plan", "enqueue", "transfer", "finalize", "assemble")
BACKGROUND_STAGE = "background"

_WORKER_IDLE_S = 5.0     # idle pool worker exits after this long
_TICK_MAX_WAIT_S = 0.5   # ticker re-checks at least this often


class _Future:
    """Minimal result box for StagePool.submit."""

    __slots__ = ("_done", "_res", "_err")

    def __init__(self):
        self._done = threading.Event()
        self._res = None
        self._err = None

    def _finish(self, res=None, err=None):
        self._res, self._err = res, err
        self._done.set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError("stage task did not complete in time")
        if self._err is not None:
            raise self._err
        return self._res


class StagePool:
    """One stage class's bounded worker pool.

    Two execution shapes share the slot accounting:

    - section(): the calling thread occupies one slot for the body
      (synchronous stages on the query's own thread — no handoff cost,
      the pool bounds stage *concurrency* and accounts queue wait);
    - submit(): the task runs on a pool worker thread (asynchronous
      stages: per-chip transfer fan-out, background graph bodies),
      spawned on demand up to max_workers and reaped when idle.

    Slots are re-entrant per thread (a nested section on the same
    thread is free), matching the admission controller's guard, so a
    batch leg that re-enters a stage never deadlocks on its own slot.
    """

    def __init__(self, name: str, max_workers: int, sched):
        self.name = name
        self.max_workers = max(1, int(max_workers))
        self._sched = sched
        self._cond = threading.Condition()
        self._active: dict = {}      # token -> start perf_counter
        self._queued = 0
        self._tasks: deque = deque()
        self._idle = 0
        self._threads = 0
        self._local = threading.local()
        self._stopped = False
        # lifetime totals for occupancy snapshots (under _cond)
        self.submitted = 0
        self.busy_ms = 0.0
        self.wait_ms = 0.0
        self.stranded = 0

    # ------------------------------------------------------------ slots

    def _acquire(self, budget_s):
        """Block until a slot frees; returns (token, waited_ms)."""
        with self._cond:
            if len(self._active) < self.max_workers:
                token = object()
                self._active[token] = time.perf_counter()
                self._gauges()
                return token, 0.0
            self._queued += 1
            self._gauges()
            t0 = time.perf_counter()
            deadline = None if budget_s is None else t0 + budget_s
            try:
                while len(self._active) >= self.max_workers:
                    timeout = None
                    if deadline is not None:
                        timeout = deadline - time.perf_counter()
                        if timeout <= 0:
                            # defined in executor.runner (lazy: the
                            # runner constructs this module's scheduler)
                            from tpu_olap_torch.executor.runner import \
                                QueryDeadlineExceeded
                            raise QueryDeadlineExceeded(
                                f"no {self.name!r} stage slot within the "
                                f"{budget_s}s deadline budget "
                                f"({self.max_workers} occupied)") from None
                    self._cond.wait(timeout)
            finally:
                self._queued -= 1
                self._gauges()
            token = object()
            self._active[token] = time.perf_counter()
            self._gauges()
            return token, (time.perf_counter() - t0) * 1000

    def _release(self, token):
        with self._cond:
            start = self._active.pop(token, None)
            if start is not None:  # None: reclaimed while stranded
                self.busy_ms += (time.perf_counter() - start) * 1000
            self._gauges()
            self._cond.notify()

    def _gauges(self):
        s = self._sched
        if s._m_depth is not None:
            s._m_depth.set(self._queued, stage=self.name)
            s._m_active.set(len(self._active), stage=self.name)

    @contextmanager
    def section(self, budget_s=None):
        """Occupy one slot on the calling thread for the body.
        Re-entrant per thread; yields the queue wait in ms."""
        if getattr(self._local, "held", 0):
            yield 0.0
            return
        token, waited_ms = self._acquire(budget_s)
        with self._cond:
            self.submitted += 1
            self.wait_ms += waited_ms
        self._local.held = 1
        try:
            yield waited_ms
        finally:
            self._local.held = 0
            self._release(token)

    def reclaim_stranded(self, older_than_s: float):
        """Free slots whose holders have been inside the section longer
        than `older_than_s` (deadline-abandoned threads wedged on a sick
        device). The holder's own release becomes a no-op."""
        now = time.perf_counter()
        with self._cond:
            victims = [t for t, s in self._active.items()
                       if now - s > older_than_s]
            for t in victims:
                self._active.pop(t, None)
                self.stranded += 1
            if victims:
                self._gauges()
                self._cond.notify_all()
        return len(victims)

    # ---------------------------------------------------------- workers

    def submit(self, fn) -> _Future:
        """Run `fn` on a pool worker thread inside the caller's
        contextvars snapshot (trace propagation). Tasks queue when all
        workers are busy; an idle worker exits after _WORKER_IDLE_S."""
        fut = _Future()
        ctx = contextvars.copy_context()
        with self._cond:
            if self._stopped:
                raise RuntimeError(f"stage pool {self.name!r} stopped")
            self._tasks.append((fn, ctx, fut, time.perf_counter()))
            self._queued += 1
            self._gauges()
            if self._idle:
                self._cond.notify()
            elif self._threads < self.max_workers:
                self._threads += 1
                threading.Thread(
                    target=self._worker, daemon=True,
                    name=f"tpu-olap-stage-{self.name}").start()
        return fut

    def _worker(self):
        while True:
            with self._cond:
                while not self._tasks:
                    if self._stopped:
                        self._threads -= 1
                        return
                    self._idle += 1
                    signaled = self._cond.wait(_WORKER_IDLE_S)
                    self._idle -= 1
                    if not signaled and not self._tasks:
                        self._threads -= 1
                        return
                fn, ctx, fut, enq_t = self._tasks.popleft()
                self._queued -= 1
                waited_ms = (time.perf_counter() - enq_t) * 1000
                token = object()
                self._active[token] = time.perf_counter()
                self.submitted += 1
                self.wait_ms += waited_ms
                self._gauges()
            if self._sched._m_wait is not None:
                self._sched._m_wait.observe(waited_ms, stage=self.name)
            # the task runs in this worker's slot: a section of the same
            # stage inside it (a mesh's per-device transfer node) is
            # free, so D tasks on a narrower pool cannot all wait for a
            # second slot
            self._local.held = 1
            try:
                fut._finish(res=ctx.run(fn))
            except BaseException as e:  # noqa: BLE001 - relayed via future
                fut._finish(err=e)
            finally:
                self._local.held = 0
                self._release(token)

    def stop(self):
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    def drain(self):
        """Reap idle workers now (shutdown hygiene) but stay usable:
        a worker that misses the wakeup is reclaimed by the idle
        timeout instead — never a stuck submit afterwards."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        with self._cond:
            self._stopped = False

    # ------------------------------------------------------------ stats

    def totals(self) -> dict:
        with self._cond:
            return {"max_workers": self.max_workers,
                    "active": len(self._active),
                    "queued": self._queued,
                    "submitted": self.submitted,
                    "busy_ms": round(self.busy_ms, 3),
                    "wait_ms": round(self.wait_ms, 3),
                    "stranded": self.stranded}


class PeriodicHandle:
    """One registered background graph: `body` runs on the background
    pool every `interval_fn()` seconds (None/0 = wake-driven only), or
    immediately on wake(). Never concurrent with itself; cancel() stops
    future runs and optionally joins an in-progress one."""

    def __init__(self, sched, name: str, interval_fn, body):
        self._sched = sched
        self.name = name
        self.interval_fn = interval_fn
        self.body = body
        self.woken = False
        self.cancelled = False
        self.running = False
        self.runs = 0
        self.errors = 0
        self.last_error: str | None = None
        self.next_due = self._compute_due()

    def _compute_due(self):
        try:
            iv = self.interval_fn()
        except Exception:  # noqa: BLE001 - config probe must not kill ticker
            iv = None
        if iv is None or iv <= 0:
            return None  # wake-driven only
        return time.monotonic() + max(0.05, float(iv))

    def wake(self):
        """Request an immediate run (e.g. ingest backpressure needs the
        compactor NOW, not at the next interval tick)."""
        with self._sched._tick_cond:
            self.woken = True
            self._sched._tick_cond.notify()

    def cancel(self, join_timeout: float | None = None):
        with self._sched._tick_cond:
            self.cancelled = True
            if join_timeout is not None:
                deadline = time.monotonic() + join_timeout
                while self.running:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._sched._tick_cond.wait(left)

    def snapshot(self) -> dict:
        return {"name": self.name, "running": self.running,
                "runs": self.runs, "errors": self.errors,
                "last_error": self.last_error,
                "cancelled": self.cancelled}


class StageScheduler:
    """The per-engine stage scheduler: foreground stage pools, graph
    admission, and the background periodic-graph ticker."""

    def __init__(self, config, metrics=None, admission=None, inject=None,
                 events=None):
        self.config = config
        self.admission = admission
        self._inject = inject          # callable(stage_site) or None
        self._events = events
        self._m_depth = self._m_active = self._m_wait = None
        self._m_busy = self._m_runs = None
        if metrics is not None:
            from tpu_olap_torch.obs.metrics import QUEUE_WAIT_BUCKETS_MS
            self._m_depth = metrics.gauge(
                "stage_queue_depth",
                "Callers queued for a stage-pool slot.", ("stage",))
            self._m_active = metrics.gauge(
                "stage_active_workers",
                "Stage-pool slots currently occupied.", ("stage",))
            self._m_wait = metrics.histogram(
                "stage_wait_ms",
                "Queue wait for a stage-pool slot.", ("stage",),
                buckets=QUEUE_WAIT_BUCKETS_MS)
            self._m_busy = metrics.counter(
                "stage_busy_ms_total",
                "Total milliseconds spent inside each stage.", ("stage",))
            self._m_runs = metrics.counter(
                "stage_runs_total",
                "Stage sections/tasks executed.", ("stage",))
        depth = max(1, int(getattr(config, "pipeline_depth", 0) or 0) or 2)
        self.pools = {
            "plan": StagePool("plan", max(2, depth), self),
            # one chip program queue -> enqueue is width 1 by design
            "enqueue": StagePool("enqueue", 1, self),
            "transfer": StagePool("transfer", max(2, depth), self),
            "finalize": StagePool("finalize", max(2, depth), self),
            "assemble": StagePool("assemble", max(2, depth), self),
            BACKGROUND_STAGE: StagePool(BACKGROUND_STAGE, 2, self),
        }
        self._tick_cond = threading.Condition()
        self._handles: list[PeriodicHandle] = []
        self._ticker: threading.Thread | None = None
        self._stopped = False

    # ----------------------------------------------------- foreground

    @contextmanager
    def graph(self, budget_s=None):
        """Admit one per-query stage graph: pipeline_depth bounds how
        many graphs are in flight engine-wide (the admission
        controller's pipeline slot — same shed reason, same metrics,
        re-entrant per thread, reclaimed by wedge recovery)."""
        if self.admission is None:
            yield
            return
        with self.admission.pipeline_slot(budget_s):
            yield

    @contextmanager
    def stage(self, name: str, metrics: dict | None = None,
              budget_s=None):
        """One stage section of the current query's graph: occupies a
        pool slot (queue wait accounted), opens a `stage:<name>` span,
        fires the `stage-<name>` fault site, and appends to the query
        record's `stages` block."""
        pool = self.pools[name]
        if self._inject is not None:
            # a latency-mode fault (FaultInjector.latency_s) stalls the
            # query BETWEEN stages; count that stall as this stage's
            # wait so the regression sentinel attributes the drift to
            # the stage the slow link sits in front of
            ti = time.perf_counter()
            self._inject(f"stage-{name}")
            inject_ms = (time.perf_counter() - ti) * 1000
        else:
            inject_ms = 0.0
        if budget_s is None:
            budget_s = getattr(self.config, "query_deadline_s", None)
        with pool.section(budget_s) as waited_ms:
            waited_ms += inject_ms
            if self._m_wait is not None:
                self._m_wait.observe(waited_ms, stage=name)
            t0 = time.perf_counter()
            with _span(f"stage:{name}",
                       **({"queue_wait_ms": round(waited_ms, 3)}
                          if waited_ms else {})):
                try:
                    yield
                finally:
                    run_ms = (time.perf_counter() - t0) * 1000
                    if self._m_busy is not None:
                        self._m_busy.inc(run_ms, stage=name)
                        self._m_runs.inc(stage=name)
                    if metrics is not None:
                        metrics.setdefault("stages", []).append(
                            {"stage": name,
                             "wait_ms": round(waited_ms, 3),
                             "run_ms": round(run_ms, 3)})

    def submit(self, name: str, fn) -> _Future:
        """Run `fn` asynchronously on the named stage's pool (the
        per-chip transfer fan-out: enqueue D programs, then overlap D
        fetches on transfer workers)."""
        return self.pools[name].submit(fn)

    def map_stage(self, name: str, fns):
        """Fan a list of thunks across the named stage's pool and
        return results in order; with one thunk (or a stopped pool) run
        inline — a single-device transfer must not pay a thread hop."""
        fns = list(fns)
        if len(fns) <= 1:
            return [fn() for fn in fns]
        try:
            futs = [self.pools[name].submit(fn) for fn in fns[1:]]
        except RuntimeError:  # pool stopped (engine closing): run inline
            return [fn() for fn in fns]
        first = fns[0]()  # caller participates instead of idling
        return [first] + [f.result() for f in futs]

    def reclaim_stranded(self, older_than_s: float | None = None) -> int:
        """Wedge recovery: free stage slots held by abandoned threads
        (see StagePool.reclaim_stranded). Defaults to the deadline."""
        if older_than_s is None:
            older_than_s = getattr(
                self.config, "query_deadline_s", None) or 0.0
        return sum(p.reclaim_stranded(older_than_s)
                   for p in self.pools.values())

    # ----------------------------------------------------- background

    def register_periodic(self, name: str, interval_fn,
                          body) -> PeriodicHandle:
        """Register a background graph: `body()` runs on the background
        pool every `interval_fn()` seconds and on every wake(). The one
        scheduler ticker replaces the per-subsystem daemon loops (cube
        maintainer, compactor, WAL flusher)."""
        h = PeriodicHandle(self, name, interval_fn, body)
        with self._tick_cond:
            if self._stopped:
                h.cancelled = True
                return h
            self._handles.append(h)
            if self._ticker is None or not self._ticker.is_alive():
                self._ticker = threading.Thread(
                    target=self._tick_loop, daemon=True,
                    name="tpu-olap-stage-ticker")
                self._ticker.start()
            self._tick_cond.notify()
        return h

    def _tick_loop(self):
        while True:
            with self._tick_cond:
                if self._stopped:
                    return
                if not any(not h.cancelled for h in self._handles):
                    # every graph cancelled (an engine dropped without
                    # close() cancels its telemetry graph): the ticker
                    # ends, and register_periodic starts a new one
                    self._handles = []
                    self._ticker = None
                    return
                now = time.monotonic()
                due = [h for h in self._handles
                       if not h.cancelled and not h.running
                       and (h.woken or (h.next_due is not None
                                        and now >= h.next_due))]
                for h in due:
                    h.woken = False
                    h.running = True
                if not due:
                    # a running handle's next_due is stale until its
                    # finally-block recomputes it — skip it, or a body
                    # outliving its interval spins the ticker at 100 Hz
                    waits = [h.next_due - now for h in self._handles
                             if not h.cancelled and not h.running
                             and h.next_due is not None]
                    self._tick_cond.wait(
                        min([_TICK_MAX_WAIT_S] + [max(0.01, w)
                                                  for w in waits]))
                    continue
            for h in due:
                self._launch(h)

    def _launch(self, h: PeriodicHandle):
        def run():
            try:
                with self.stage(BACKGROUND_STAGE):
                    with _span(f"background:{h.name}"):
                        h.body()
                h.runs += 1
            except Exception as e:  # noqa: BLE001 - periodic: retry next tick
                h.errors += 1
                h.last_error = f"{type(e).__name__}: {e}"
                if self._events is not None:
                    try:
                        self._events.emit("background_error",
                                          graph=h.name,
                                          error=h.last_error)
                    except Exception:  # noqa: BLE001
                        pass
            finally:
                with self._tick_cond:
                    h.running = False
                    h.next_due = h._compute_due()
                    self._tick_cond.notify_all()

        try:
            self.pools[BACKGROUND_STAGE].submit(run)
        except RuntimeError:  # pool stopped mid-shutdown
            with self._tick_cond:
                h.running = False

    # ----------------------------------------------------------- admin

    def snapshot(self) -> dict:
        """Per-stage occupancy totals + background graph states — the
        bench's per-stage occupancy source and /status's `stages`."""
        with self._tick_cond:
            graphs = [h.snapshot() for h in self._handles]
        return {"pools": {n: p.totals() for n, p in self.pools.items()},
                "background_graphs": graphs}

    def stop(self, join_timeout: float = 5.0):
        """Deterministic shutdown: cancel background graphs (joining
        in-progress bodies briefly), join the ticker, and reap idle
        pool workers. The scheduler then RE-ARMS — Engine.close keeps
        the engine queryable, and a later append must be able to
        re-register the compactor/WAL-flush graphs on demand."""
        with self._tick_cond:
            self._stopped = True
            handles = list(self._handles)
            self._tick_cond.notify_all()
        for h in handles:
            h.cancel(join_timeout=join_timeout)
        t = self._ticker
        if t is not None and t.is_alive():
            t.join(timeout=join_timeout)
        with self._tick_cond:
            self._ticker = None
            self._handles = [h for h in self._handles if not h.cancelled]
            self._stopped = False
        for p in self.pools.values():
            p.drain()

"""QueryRunner: execute a QuerySpec against a registered table.

The analog of the reference's DruidRDD.compute + broker round-trip
(SURVEY.md §4.2) collapsed into an in-process call: lower -> device
dispatch over the resident column stacks -> ONE device-to-host copy ->
host finalize and assembly. Every statement leaves one history record
(`record`), as in the JAX package.

Three routes on one device, as in the JAX package:
  - packed (every dense aggregate query): the kernel, then finalize,
    compaction to the non-empty groups and packing on the device
    (executor.packing), one buffer back; a result past
    `result_group_cap` groups re-runs unpacked;
  - unpacked: every partial table back in one copy — queries whose theta
    set-op post-aggregations need the raw tables, and packed overflows;
  - sparse (a GroupBy past the dense budgets): the sort-based sparse
    group-by (kernels.sparse_groupby), re-run at the next power of two
    while the groups overflow its cap, up to `sparse_group_budget`.
Scan and Select take the mask route: the row-mask kernel
(kernels.row_mask) computes the row mask on the device, one copy brings
it back, and the host gathers the rows from the host segment columns.
Search counts the coded dimensions' values under the same mask on the
device (one copy) and runs a GroupBy per numeric dimension;
TimeBoundary and SegmentMetadata read the table's manifest.
Batches of aggregate queries share one pass (executor.batch):
`execute_batch`, and the coalescer behind EngineConfig.batch_window_ms
that gathers concurrent `execute` callers into one batch.

Two stages on one CUDA stream (EngineConfig.pipeline_depth > 0, the
default). Stage 1 (`enqueue`, under `dispatch_lock`) prepares the
resident stacks, launches the route's kernels, queues the route's one
copy into pinned host memory (`non_blocking=True`), records a CUDA
event and pins the output's bytes in the HBM ledger (`_enqueue_fetch`).
Stage 2 (`transfer`, `finalize`, `assemble`) runs without the lock: it
waits on that event (`wait_event`), unpins, views the pinned bytes as
numpy and finishes the statement (`_complete`), overlapping other
statements' enqueues. Every launch and copy stays on the device's
current stream, so a kernel that hangs holds back everything queued
behind it, the device probe included. On the CPU stage 2 has nothing to
wait for. pipeline_depth=0 holds `dispatch_lock` across the whole
statement (serialized mode).

The semantic result cache (executor.resultcache) sits in front: tier 2
serves a repeated aggregate's whole result before the lock, with no
launch and no copy; tier 1 serves the segments a moving window has seen
and computes the rest in one launch of the segment-extended fused reduce
(`_run_agg_segcached`). Every table's resident stacks are accounted in
one HbmLedger under `hbm_budget_bytes`. `compute_partials` is the cube
materializer's entry point.

Resilience, as in the JAX package: `execute` checks the full-result
cache, then the circuit breaker, the coalescer and an admission slot
(with the deadline as its budget). Every device dispatch runs through
`_dispatch`: the "dispatch" fault site, up to `dispatch_retries + 1`
attempts with the table's resident state purged between them, the
retried errors in the metrics (`retries`, `retry_errors`), and one
breaker failure when the attempts run out. With `query_deadline_s` set,
the statement's work runs on a watchdog thread (`_join_abandoning`):
past the deadline the caller raises QueryDeadlineExceeded, the device
is marked wedged, and the next statement re-probes it (`_probe_device`:
a small reduction and a stream synchronize, queued behind whatever the
stream still runs) before trusting it; an abandoned kernel keeps
running on the stream until it ends. A successful probe evicts the
resident stacks but keeps the compiled kernels. The breaker's healer
probes the same way. `stages`, the StageScheduler, runs the stage
sections and the background graphs (compactor, WAL flush, cube
maintainer).

Observability, as in the JAX package (tpu_olap_torch.obs): `record` is
the one gate every statement's metrics pass through — the history ring,
the incremental counters, the metrics registry, the SLO tracker, the
event log, the workload profiler and the regression sentinel. Spans open
on the active trace. NVRTC builds count in `recompiles_total{kind}` (by
kernel template) and `compile_ms_total` (kernels.cuda_build reports
them to `_note_compile`); `refresh_resource_gauges` fills the memory
and cache gauges at scrape time (`device_bytes{table}`,
`cache_entries{cache}` for the plan cache and, as "jit", the in-process
cache of compiled kernels, the ledger's `hbm_chip_*` gauges), without
dispatch_lock and without a device sync. The telemetry graph (a periodic
graph of the stage scheduler) samples the registry into the sampler's
rings and runs the sentinel's resource checks (`hbm`, `breaker`,
`admission`, and the engine's `wal`). While a torch.profiler capture is
live (obs.profile), each dispatch runs under `annotate_dispatch` with
its query id; `profile_dir` profiles every statement into a trace of
its own. `device_snapshot` (sys.devices) has one row per device.

The mesh (EngineConfig.num_shards = D > 1; executor.sharding): the
segment axis is split over D devices in one process, segment i on device
i mod D, and every device aggregate launches once per device over that
device's stacks inside the per-device local window
(`_run_partials_mesh`). The cost model (planner.cost, under a
`cost-decision` span) picks the merge: "historicals" queues one pinned
copy per device, each behind its own event, and stage 2 waits on all D
(the per-device transfer fan-out on the transfer stage's pool,
`_complete_all`) before the host broker folds the unfinalized tables
(`broker-merge` span); "broker" folds them on the mesh's first device
and copies one table back. Packed results are bypassed under a mesh, as
in the JAX package: the merge needs unfinalized partials. Scans,
selects and searches run the row mask per device and put the rows back
in logical segment order; the sparse group-by merges at the host
("gather") or exchanges its compact entries between devices
("exchange"); tier 1 runs one segment-extended launch per device; a
batch launches the multi-leg kernel per device (executor.batch).
`degrade_shards_on_retry` halves D after repeated device failure. Each
device's dispatches count in `_chip_dispatches` (sys.devices).

Across processes (torch.distributed initialized by the user over more
than one rank, `num_shards` = world x L): the mesh is this rank's L
devices of the global D (sharding.make_multihost_mesh), every rank runs
the same statements in the same order, and each merge across ranks is
a collective (executor.collective) issued in stage 1 under
dispatch_lock, after the rank's own copies are waited on there, so that
pipelining and threads cannot reorder one rank's collectives against
another's. Aggregates fold locally as the cost model says, then
gather_partials folds the ranks' tables in rank order (strategy
"broker", as the JAX package forces it; merge "collective"); masks and
Search counts cross in gather_masks; the sparse group-by gathers its
compact tables (gather_varlen) under the global budget. Tier 1 and
shared-scan fusion are refused, as in the JAX package. A retry keeps
the global D, and a statement that has crossed ranks is not retried.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import weakref
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from tpu_olap_torch.executor import collective
from tpu_olap_torch.executor import sharding as sh
from tpu_olap_torch.executor.config import EngineConfig
from tpu_olap_torch.executor.dataset import DeviceDataset, HbmLedger
from tpu_olap_torch.executor.lowering import PhysicalPlan, lower
from tpu_olap_torch.executor.packing import (build_packer, densify,
                                             make_layout, unpack)
from tpu_olap_torch.executor.resultcache import ResultCache
from tpu_olap_torch.executor.stages import StageScheduler
from tpu_olap_torch.executor.results import (agg_specs_by_name, eval_having,
                                             eval_post_aggs, finalize_aggs,
                                             iso, render_value,
                                             theta_raw_fields)
from tpu_olap_torch.ir.aggregations import CountAggregation
from tpu_olap_torch.ir.dimensions import DefaultDimensionSpec
from tpu_olap_torch.ir.interval import ETERNITY
from tpu_olap_torch.kernels.filtereval import _take
from tpu_olap_torch.kernels import cuda_build, fused_reduce
from tpu_olap_torch.kernels.groupby import (UnsupportedAggregation,
                                            group_reduce, merge_partials)
from tpu_olap_torch.kernels.sparse_groupby import (SENTINEL, exchange,
                                                   merge_sparse)
from tpu_olap_torch.ir.query import (GroupByQuerySpec, ScanQuerySpec,
                                     SearchQuerySpec,
                                     SegmentMetadataQuerySpec,
                                     SelectQuerySpec, TimeBoundaryQuerySpec,
                                     TimeseriesQuerySpec, TopNQuerySpec)
from tpu_olap_torch.obs.events import EventLog
from tpu_olap_torch.obs.metrics import QUEUE_WAIT_BUCKETS_MS, MetricsRegistry
from tpu_olap_torch.obs import profile as profile_mod
from tpu_olap_torch.obs.profile import annotate_dispatch
from tpu_olap_torch.obs.sentinel import RegressionSentinel
from tpu_olap_torch.obs.slo import SloTracker
from tpu_olap_torch.obs.timeseries import TimeseriesSampler
from tpu_olap_torch.obs.trace import (Tracer, current_query_id,
                                      current_traceparent,
                                      in_nested_execution, short_str,
                                      span as _span)
from tpu_olap_torch.obs.workload import (WorkloadProfiler, fingerprint_ir,
                                         in_introspection)
from tpu_olap_torch.planner import cost as cost_mod
from tpu_olap_torch.resilience.admission import AdmissionController
from tpu_olap_torch.resilience.breaker import CircuitBreaker
from tpu_olap_torch.resilience.errors import QueryError
from tpu_olap_torch.resilience.faults import maybe_inject
from tpu_olap_torch.segments.segment import TIME_COLUMN


@dataclass
class QueryResult:
    query: object
    rows: list                 # flat records (dims/aggs/postaggs [+timestamp])
    druid: list                # Druid-wire-shaped result
    metrics: dict = field(default_factory=dict)

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame(self.rows)


class QueryDeadlineExceeded(QueryError):
    """Raised when a statement exceeds EngineConfig.query_deadline_s. The
    in-process analog of the reference's task-kill -> HTTP query abort
    (SURVEY.md §3.5): the caller falls back (or raises); the abandoned
    watchdog thread finishes, and is discarded, in the background, since
    a kernel running on the card cannot be interrupted. Part of the
    resilience error taxonomy: HTTP surfaces map it to 504 when no
    fallback answered."""

    code = "deadline_exceeded"
    retriable = True
    http_status = 504


class HistoryRing(list):
    """Bounded per-statement history (EngineConfig.history_limit): an
    append evicts oldest-first past maxlen. A list subclass on purpose —
    callers slice and len() it freely. Aggregate counters never re-sum
    it; QueryRunner.record keeps them incrementally. Appends are locked:
    pipelined execution completes statements on concurrent stage-2
    threads, and two racing evictions must not each delete a
    survivor."""

    def __init__(self, maxlen: int | None = None):
        super().__init__()
        self.maxlen = maxlen if maxlen is None else max(1, int(maxlen))
        self._mu = threading.Lock()

    def append(self, item):
        with self._mu:
            super().append(item)
            if self.maxlen is not None:
                while len(self) > self.maxlen:
                    del self[0]


# core metric keys every completed statement's record carries, whatever
# route served it — the JAX package's dashboard schema
CORE_METRIC_DEFAULTS = (
    ("total_ms", 0.0), ("rows_scanned", 0), ("segments_scanned", 0),
    ("cache_hit", False), ("query_type", "?"), ("datasource", "?"),
    ("pipelined", False),
)


def sanitize_metric_value(v, _depth=0):
    """Exception-carrying (or otherwise non-JSON) metric values -> short
    strings at record time, so that no consumer of a record meets a raw
    exception object. JSON-native scalars pass through untouched."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return short_str(v) if isinstance(v, str) and len(v) > 300 else v
    if _depth < 4:
        if isinstance(v, (list, tuple)):
            return [sanitize_metric_value(x, _depth + 1) for x in v]
        if isinstance(v, dict):
            return {str(k): sanitize_metric_value(x, _depth + 1)
                    for k, x in v.items()}
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return short_str(v)


_GONE = object()


def _call_alive(ref, method: str, *args):
    """`ref()`'s method called with args, or _GONE once the referent has
    been collected."""
    obj = ref()
    if obj is None:
        return _GONE
    return getattr(obj, method)(*args)


def resolve_device(name: str) -> torch.device:
    """The device the engine runs on; "cuda" without a card raises —
    the engine never carries on on the CPU in its place."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"EngineConfig.device={name!r} but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


@dataclass
class _Transfer:
    """A route's one device-to-host copy between the two stages: the
    host tensor it lands in (pinned on the card), the CUDA event recorded
    after it (None on the CPU), the ledger pin of the output's bytes, and
    the (name, dtype, shape) layout of a dict's concatenated bytes (None
    for a single tensor)."""
    host: torch.Tensor
    event: object = None
    pin: object = None
    layout: list | None = None


class QueryRunner:
    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device)
        # serializes device dispatch and the caches below; the engine's
        # device_lock is this object. Pipelined mode holds it for stage 1
        # only (_enqueue_lock), serialized mode across the statement.
        # Coalesced callers wait outside it.
        self.dispatch_lock = threading.RLock()
        # lowering runs outside dispatch_lock in pipelined mode: the plan
        # cache has its own mutex
        self._cache_lock = threading.Lock()
        self._datasets: dict[str, DeviceDataset] = {}
        self._plan_cache: dict = {}
        # last observed group count per query template and route: sizes
        # the next run's packed / sparse cap
        self._cap_hints: dict = {}
        self._tls = threading.local()   # per-thread last_metrics
        self._inflight_seq = itertools.count(1)  # ledger pin keys
        self._transfer_count = 0        # live stage-2 transfers (gauge)
        self._coalescer = None
        self._batch_seq = 0
        self._profile_seq = 0  # profile_dir trace directories
        self._dispatches = 0   # guarded dispatches (sys.devices)
        self._chip_dispatches: dict = {}  # mesh device -> dispatches
        self._wedged = False   # a deadline expired: re-probe before trusting
        # one ledger over every table's resident stacks, by owner class,
        # split per mesh device once the mesh exists
        self._ledger = HbmLedger(self.config.hbm_budget_bytes)
        # the mesh: built here when num_shards > 1 (a mesh the devices
        # cannot hold raises now, not at the first query), rebuilt
        # smaller after a degradation
        self._mesh = None
        self._active_shards = self.config.num_shards
        _ = self.mesh
        # observability (tpu_olap_torch.obs), all fed through record()
        self.history = HistoryRing(self.config.history_limit)
        self.tracer = Tracer(enabled=self.config.tracing_enabled,
                             ring_limit=self.config.trace_history_limit,
                             slow_ms=self.config.slow_query_ms,
                             slow_limit=self.config.slow_log_limit)
        self.metrics = m = MetricsRegistry()
        self.events = EventLog(limit=self.config.event_log_limit,
                               path=self.config.event_log_path,
                               max_bytes=self.config.event_log_max_bytes,
                               rotate_keep=self.config.event_log_rotate_keep)
        self.slo = SloTracker(self.config.slo_latency_ms,
                              self.config.slo_target,
                              self.config.slo_window_s, metrics=m)
        self._totals_lock = threading.Lock()
        self._totals = {"queries": 0, "rows_scanned": 0,
                        "segments_scanned": 0, "segments_pruned": 0,
                        "cache_hits": 0, "total_ms": 0.0}
        self._by_query_type: dict = {}
        self._m_queries = m.counter(
            "queries_total", "Queries completed, by type and path.",
            ("query_type", "path"))
        self._m_latency = m.histogram(
            "query_latency_ms", "End-to-end query latency (ms).",
            ("query_type", "path"))
        self._m_rows = m.counter(
            "rows_scanned_total", "Rows scanned across all queries.")
        self._m_segments = m.counter(
            "segments_scanned_total",
            "Segments scanned across all queries.")
        self._m_retries = m.counter(
            "dispatch_retries_total", "Device dispatch retries.")
        self._m_deadline = m.counter(
            "deadline_exceeded_total",
            "Queries killed by query_deadline_s.")
        self._m_hbm_bytes = m.gauge(
            "hbm_bytes_in_use", "HBM ledger bytes resident.")
        self._m_hbm_evict = m.counter(
            "hbm_evictions_total", "HBM ledger column evictions.")
        self._m_batch = m.histogram(
            "batch_size", "Logical queries per shared-scan batch.",
            buckets=(1, 2, 4, 8, 16, 32, 64))
        self._m_degraded = m.counter(
            "degraded_queries_total",
            "Queries served by the interpreter while the breaker was "
            "open (path=fallback_breaker).")
        self._m_lock_wait = m.histogram(
            "dispatch_lock_wait_ms",
            "Wait to acquire the dispatch lock (stage-1 enqueue in "
            "pipelined mode; whole-query hold in serialized mode).",
            buckets=QUEUE_WAIT_BUCKETS_MS)
        self._m_transfers = m.gauge(
            "inflight_transfers",
            "Device->host result transfers currently in flight "
            "(stage-2 completions).")
        # memory and compile accounting, with the JAX package's names:
        # the gauges are point-in-time (refresh_resource_gauges, at
        # scrape), the counters update where their event happens
        self._m_compile = m.counter(
            "compile_cache_requests_total",
            "Device statements by kernel-cache outcome (miss: an NVRTC "
            "build ran).", ("result",))
        self._m_device_bytes = m.gauge(
            "device_bytes",
            "Live device bytes resident per table (column, null, "
            "validity and derived stacks).", ("table",))
        self._m_cache_entries = m.gauge(
            "cache_entries", "Entries in the runner caches (plan; jit: "
            "the in-process cache of NVRTC-compiled kernels).",
            ("cache",))
        self._m_cache_evict = m.counter(
            "cache_evictions_total",
            "Capacity evictions from the runner caches.", ("cache",))
        self._m_cache_clears = m.counter(
            "cache_clears_total",
            "Explicit cache clears (CLEAR DRUID CACHE / recovery "
            "purges).", ("scope",))
        self._m_recompile = m.counter(
            "recompiles_total",
            "Kernels built by NVRTC (misses of the in-process and the "
            "on-disk cubin caches), by kernel template.", ("kind",))
        self._m_compile_ms = m.counter(
            "compile_ms_total",
            "Milliseconds of NVRTC compilation of the kernels built.")
        self.result_cache = ResultCache(self.config, metrics=m,
                                        events=self.events)
        self.workload = WorkloadProfiler(
            max_templates=self.config.workload_max_templates,
            latency_window=self.config.workload_latency_window,
            enabled=self.config.workload_profile_enabled, metrics=m)
        # bounded admission in front of dispatch_lock (and the pipeline's
        # graph admission), and the device circuit breaker whose healer
        # probes through _healer_probe
        self.admission = AdmissionController(
            self.config.max_inflight_dispatches,
            self.config.admission_queue_limit, metrics=m,
            events=self.events,
            pipeline_depth=self.config.pipeline_depth)
        self.breaker = CircuitBreaker(
            self.config.breaker_failure_threshold,
            self.config.breaker_open_cooldown_s,
            probe=self._healer_probe, metrics=m, events=self.events)
        self._attempt_local = threading.local()  # the dispatch attempt
        # the stage scheduler: the query path's stage sections and the
        # background periodic graphs (compactor, WAL flush, cube
        # maintainer)
        # its hooks hold the runner weakly, so that an engine dropped
        # without close() does not live on in the scheduler's ticker
        ref = weakref.ref(self)
        self.stages = StageScheduler(
            self.config, metrics=m, admission=self.admission,
            inject=lambda stage: _call_alive(ref, "_inject", stage),
            events=self.events)
        if (self.config.batch_window_ms or 0) > 0:
            self.set_batch_window(self.config.batch_window_ms)
        # the telemetry plane: the sampler snapshots every metric series
        # into bounded rings (sys.metrics_history, GET
        # /debug/timeseries); the sentinel keeps per-template and
        # per-stage drift baselines fed by record() and runs resource
        # checks on the same periodic tick. Observers only: neither runs
        # SQL nor leaves a query record.
        self.telemetry = TimeseriesSampler(
            m, retention=self.config.telemetry_retention)
        self.sentinel = RegressionSentinel(self.config, metrics=m,
                                           events=self.events)
        ledger = self._ledger
        cache = self.result_cache
        ledger.register_external("cache_pins", cache.shard_bytes)
        self.sentinel.add_probe("hbm", lambda: {
            "bytes_in_use": ledger.bytes_in_use,
            "budget": ledger.budget, "evictions": ledger.evictions})
        breaker = self.breaker
        self.sentinel.add_probe("breaker", lambda: {"state": breaker.state})
        shed_counter = m.counter("queries_shed_total",
                                 "Queries shed by admission control.",
                                 ("reason",))
        self.sentinel.add_probe("admission", lambda: {
            "shed_total": sum(s.value for s in
                              list(shed_counter.series.values()))})
        self._telemetry_handle = None
        config = self.config
        if config.telemetry_enabled and \
                (config.telemetry_interval_s or 0) > 0:
            def tick():
                if _call_alive(ref, "_telemetry_tick") is _GONE:
                    handle.cancel()   # the engine was dropped unclosed

            handle = self._telemetry_handle = self.stages.register_periodic(
                "telemetry", lambda: config.telemetry_interval_s, tick)

    def _telemetry_tick(self):
        """One telemetry-graph beat: sample the registry into the history
        rings, then run the sentinel's resource checks and stale-alert
        clearing."""
        self.telemetry.sample_once()
        self.sentinel.check()

    def _inject(self, stage: str):
        """Fire the configured fault injector at `stage` with the current
        dispatch attempt (set by _dispatch), so that a fault at e.g.
        host-transfer rides the same retry accounting as a dispatch
        fault."""
        maybe_inject(self.config, stage,
                     getattr(self._attempt_local, "value", 0))

    @property
    def mesh(self):
        """The mesh over `_active_shards` devices (executor.sharding),
        built on first use; None for one device. With torch.distributed
        initialized over more than one process, the multi-host mesh
        (this rank's share of the global devices). The ledger learns the
        device count the moment the mesh exists, so every later add
        splits per device."""
        if self._mesh is None and (self._active_shards or 1) > 1:
            # one process's mesh unless a process group spans several
            self._mesh = sh.make_multihost_mesh(self._active_shards,
                                                self.config.device)
            # the ledger counts this process's devices only
            self._ledger.set_num_chips(len(self._mesh.devices))
        return self._mesh

    def _note_chip_dispatch(self, chips):
        """Per-device dispatch counts behind sys.devices."""
        with self._totals_lock:
            for c in chips:
                self._chip_dispatches[c] = self._chip_dispatches.get(c, 0) + 1

    @property
    def last_metrics(self) -> dict:
        """The metrics of the last statement this thread ran: pipelined
        execution runs several statements' stages at once, so each
        thread stamps its own."""
        return getattr(self._tls, "metrics", {})

    @last_metrics.setter
    def last_metrics(self, metrics: dict):
        self._tls.metrics = metrics

    def _note_compile(self, kind: str, ms: float):
        """kernels.cuda_build's observer: one NVRTC build of a `kind`
        template, `ms` of compilation. Counted in recompiles_total and
        compile_ms_total, and kept for the statement running on this
        thread (`_execute` stamps its record's "recompiles" and
        "compile_ms")."""
        self._m_recompile.inc(kind=kind)
        self._m_compile_ms.inc(ms)
        pending = getattr(self._tls, "compiles", None)
        if pending is not None:
            pending[0] += 1
            pending[1] += ms

    def _observe_compiles(self):
        return cuda_build.observe_compiles(self._note_compile)

    # --------------------------------------------- pipelined execution

    @property
    def _pipelined(self) -> bool:
        """Pipelined mode: dispatch_lock held only for stage-1 enqueue
        (EngineConfig.pipeline_depth > 0); 0 restores the serialized
        whole-statement hold."""
        return (self.config.pipeline_depth or 0) > 0

    def _pipeline_slot(self):
        """Bound one dispatch's enqueue->complete region (the admission
        controller's pipeline slot). No-op when serialized."""
        if not self._pipelined:
            return nullcontext()
        return self.admission.pipeline_slot(self.config.query_deadline_s)

    @contextmanager
    def _enqueue_lock(self, metrics: dict | None = None):
        """The enqueue stage's critical section (the width-1 stage pool
        and dispatch_lock). Pipelined mode: acquire dispatch_lock, bounded
        by the deadline so that a watchdog thread blocked here behind a
        stranded holder eventually gives up, time the wait into
        dispatch_lock_wait_ms and stamp the record. Serialized mode: the
        caller already holds the lock across the whole statement
        (possibly on the watchdog's parent thread), so only the stage
        accounting runs."""
        with self.stages.stage("enqueue", metrics):
            if not self._pipelined:
                yield
                return
            deadline = self.config.query_deadline_s
            t0 = time.perf_counter()
            ok = self.dispatch_lock.acquire(timeout=deadline) \
                if deadline is not None else self.dispatch_lock.acquire()
            waited = (time.perf_counter() - t0) * 1000
            self._m_lock_wait.observe(waited)
            if metrics is not None:
                metrics["pipelined"] = True
                metrics["lock_wait_ms"] = round(
                    metrics.get("lock_wait_ms", 0.0) + waited, 3)
            if not ok:
                raise QueryDeadlineExceeded(
                    f"dispatch lock unavailable within the {deadline}s "
                    "deadline (a dispatch is wedged holding it)") from None
            try:
                yield
            finally:
                self.dispatch_lock.release()

    @contextmanager
    def _timed_dispatch_lock(self):
        """Serialized mode's whole-statement hold, its wait observed into
        the same dispatch_lock_wait_ms histogram as the pipelined
        sections, so that a comparison reads contention from one
        series."""
        t0 = time.perf_counter()
        with self.dispatch_lock:
            self._m_lock_wait.observe((time.perf_counter() - t0) * 1000)
            yield

    def _note_transfer(self, delta: int):
        with self._totals_lock:
            self._transfer_count += delta
            self._m_transfers.set(self._transfer_count)

    def _pin_inflight(self, nbytes: int):
        """Account a just-enqueued copy's device output in the HBM ledger
        until stage 2 has it (counted in the budget, never evictable).
        Returns the pin key for _complete."""
        key = ("__inflight__", next(self._inflight_seq))
        self._ledger.pin_inflight(key, nbytes)
        return key

    def _enqueue_fetch(self, out, metrics: dict) -> _Transfer:
        """Stage 1's end: queue the route's one device-to-host copy.
        `out` is a tensor (copied flat) or {name: tensor} (every tensor's
        bytes concatenated into one uint8 buffer). The output's bytes are
        pinned in the ledger until stage 2. On the card the copy goes,
        non-blocking, into a pinned host tensor from torch's caching host
        allocator, and a CUDA event is recorded after it on the current
        stream; nothing waits here (on the CPU the buffer is the host
        tensor). Counted in metrics["host_copies"] and ["host_bytes"]."""
        layout = None
        if isinstance(out, dict):
            if not out:
                return _Transfer(torch.empty(0, dtype=torch.uint8),
                                 layout=[])
            names = list(out)
            # fresh dense copies: a column view such as sums[:, 0] keeps
            # its stride even where torch calls it contiguous (size-1
            # dims), and viewing bytes needs stride 1
            ts = [out[n].new_empty(out[n].shape).copy_(out[n])
                  for n in names]
            layout = [(n, t.dtype, tuple(t.shape)) for n, t in
                      zip(names, ts)]
            buf = torch.cat([t.reshape(-1).view(torch.uint8) for t in ts])
        else:
            buf = out.reshape(-1)
        nbytes = buf.numel() * buf.element_size()
        metrics["host_copies"] = metrics.get("host_copies", 0) + 1
        metrics["host_bytes"] = metrics.get("host_bytes", 0) + nbytes
        if buf.device.type != "cuda":
            return _Transfer(buf, None, self._pin_inflight(nbytes), layout)
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        # the copy and its event on the stream of the device that holds
        # the output (a mesh queues one copy per device)
        with torch.cuda.device(buf.device):
            host.copy_(buf, non_blocking=True)
            event = torch.cuda.Event(blocking=True)
            event.record(torch.cuda.current_stream(buf.device))
        return _Transfer(host, event, self._pin_inflight(nbytes), layout)

    def _complete(self, tr: _Transfer, metrics: dict):
        """Stage 2's start, without dispatch_lock: the "transfer" stage
        section and the "host-transfer" fault site, the wait on the
        copy's event (`wait_event`), the ledger unpin, and the pinned
        bytes viewed as numpy (a {name: array} dict for a dict fetch).
        The arrays keep the pinned tensor alive, so that the host
        allocator does not hand its block to another copy while they are
        read."""
        t0 = time.perf_counter()
        self._wait_transfer(tr, metrics)
        metrics["transfer_ms"] = round(
            metrics.get("transfer_ms", 0.0)
            + (time.perf_counter() - t0) * 1000, 3)
        return self._host_view(tr)

    def _wait_transfer(self, tr: _Transfer, metrics: dict):
        """One copy's transfer node: the "transfer" stage section and
        the "host-transfer" fault site, the wait on its event, the
        unpin."""
        self._note_transfer(1)
        try:
            with self.stages.stage("transfer", metrics):
                self._inject("host-transfer")
                if tr.event is not None:
                    wait_event(tr.event)
        finally:
            self._note_transfer(-1)
            if tr.pin is not None:
                self._ledger.unpin_inflight(tr.pin)
                tr.pin = None

    def _complete_all(self, trs: list, metrics: dict) -> list:
        """Stage 2 of a mesh statement: every device's copy waited on its
        own transfer node (stages.map_stage: the D waits overlap one
        another, and the caller's thread takes the first), then viewed
        as numpy. One copy degrades to `_complete`."""
        if len(trs) == 1:
            return [self._complete(trs[0], metrics)]
        t0 = time.perf_counter()
        self.stages.map_stage(
            "transfer", [(lambda tr=tr: self._wait_transfer(tr, metrics))
                         for tr in trs])
        metrics["transfer_ms"] = round(
            metrics.get("transfer_ms", 0.0)
            + (time.perf_counter() - t0) * 1000, 3)
        metrics["transfer_fanout"] = len(trs)
        return [self._host_view(tr) for tr in trs]

    def _host_view(self, tr: _Transfer):
        """A waited copy's pinned bytes as numpy (a {name: array} dict
        for a dict fetch)."""
        host = tr.host.numpy()
        if tr.layout is None:
            return host
        res, off = {}, 0
        for name, dtype, shape in tr.layout:
            nb = int(np.prod(shape, dtype=np.int64)) \
                * torch.empty(0, dtype=dtype).element_size()
            res[name] = host[off:off + nb].view(_np_dtype(dtype)) \
                .reshape(shape)
            off += nb
        return res

    def _staged_fetch(self, launch, metrics: dict, dispatch_span=True):
        """One two-stage round of one output: `_staged_fetch_all` of
        `launch()`'s one output."""
        return self._staged_fetch_all(lambda: [launch()], metrics,
                                      dispatch_span)[0]

    def _staged_fetch_all(self, launch, metrics: dict, dispatch_span=True,
                          merge=None):
        """One two-stage round: stage 1 (`launch()` under the enqueue
        lock, inside a `dispatch` span unless the caller opened one, then
        one queued copy per output it returns: one per mesh device, or
        one) and stage 2 (`_complete_all`, inside a `host-transfer`
        span: every copy's event waited on). Returns the host results in
        order. A failed stage 2 still releases the pins.

        `merge`, under a multi-process mesh, is the statement's merge
        across ranks: it takes the host results and issues the
        collectives (executor.collective). The copies are then waited on
        in stage 1 and `merge` runs there, under the lock, inside a
        `collective` span, so that neither pipelining nor threads can
        reorder one rank's collectives against another's; its value is
        returned."""
        trs = []
        try:
            with self._enqueue_lock(metrics):
                with _span("dispatch") if dispatch_span else nullcontext():
                    for out in launch():
                        trs.append(self._enqueue_fetch(out, metrics))
                if merge is not None:
                    with _span("host-transfer"):
                        hosts = self._complete_all(trs, metrics)
                    with _span("collective"):
                        return merge(hosts)
            with _span("host-transfer"):
                return self._complete_all(trs, metrics)
        finally:
            for tr in trs:
                if tr.pin is not None:
                    self._ledger.unpin_inflight(tr.pin)

    # ------------------------------------------------------ batch, API

    def set_batch_window(self, window_ms: float | None):
        """Turn the shared-scan coalescer on (window_ms > 0) or off:
        with a window, concurrent execute() callers of aggregate queries
        ride one batch (executor.batch.Coalescer)."""
        from tpu_olap_torch.executor.batch import Coalescer
        self.config.batch_window_ms = float(window_ms or 0.0)
        self._coalescer = Coalescer(self, float(window_ms) / 1000.0) \
            if window_ms else None

    def execute_batch(self, queries, table) -> list:
        """Execute N queries against one table as a shared-scan batch
        (executor.batch.run_batch): identical queries scan once,
        compatible dense aggregate legs share one pass, everything else
        runs through the single-query path. Results in input order; the
        first failed leg's exception raises."""
        boxed = self._execute_batch_boxed(list(queries), table)
        for b in boxed:
            if isinstance(b, BaseException):
                raise b
        return boxed

    def _execute_batch_boxed(self, queries, table, query_ids=None) -> list:
        from tpu_olap_torch.executor.batch import run_batch
        # one admission slot per batch submission: the shared pass is one
        # device occupancy however many statements ride it. Pipelined
        # mode: no outer lock, run_batch's device sections take it.
        with self.admission.slot(self.config.query_deadline_s), \
                self._observe_compiles():
            if self._pipelined:
                return run_batch(self, queries, table, query_ids)
            with self._timed_dispatch_lock():
                return run_batch(self, queries, table, query_ids)

    def _next_batch_id(self) -> int:
        self._batch_seq += 1
        return self._batch_seq

    def execute(self, query, table) -> QueryResult:
        # the full-result cache first: a hit takes no slot and no lock,
        # launches nothing and copies nothing, and keeps serving through
        # an open breaker
        res = self._serve_full_cache(query, table)
        if res is None:
            with self._observe_compiles():
                res = self._execute_uncached(query, table)
        self.last_metrics = res.metrics
        return res

    def _execute_uncached(self, query, table) -> QueryResult:
        # the breaker next: while open, fail in microseconds (the engine
        # serves fallback-capable statements from the interpreter)
        # instead of queueing work onto a sick device
        self.breaker.check()
        if self._coalescer is not None and not in_nested_execution():
            from tpu_olap_torch.executor.batch import AGG_QUERY_TYPES
            if isinstance(query, AGG_QUERY_TYPES):
                # waits outside dispatch_lock so that concurrent callers
                # can coalesce; the batch leader dispatches
                with _span("coalesce") as sp:
                    res = self._coalescer.submit(query, table)
                    sp.set(batch_id=res.metrics.get("batch_id"),
                           batch_size=res.metrics.get("batch_size"))
                return res
        with self.admission.slot(self.config.query_deadline_s):
            if self._pipelined:
                return self._execute_guarded(query, table)
            with self._timed_dispatch_lock():
                return self._execute_guarded(query, table)

    def _execute_guarded(self, query, table) -> QueryResult:
        """Breaker and deadline/wedge guard around _execute. Serialized
        mode: the caller holds dispatch_lock across this whole call.
        Pipelined mode: no outer lock; the enqueue sections take it."""
        self.breaker.check()
        deadline = self.config.query_deadline_s
        if deadline is None:
            return self._execute(query, table)
        if self._wedged:
            # a previous statement timed out and was abandoned: before
            # trusting the device again, prove it answers a trivial
            # computation; still stuck -> fail fast, so that the engine
            # keeps falling back without stacking another deadline wait
            self._reprobe_device(deadline)
        abandoned = threading.Event()
        return self._join_abandoning(
            lambda: self._execute(query, table, abandoned), deadline,
            {"query_type": query.query_type, "datasource": table.name},
            on_timeout=abandoned.set)  # its history record is discarded

    def _join_abandoning(self, work, deadline: float, rec: dict,
                         on_timeout=None, name="tpu-olap-dispatch"):
        """Run `work` on a fresh daemon thread, abandoning it on expiry:
        mark the device wedged, record `rec` (stamped with the deadline)
        and raise QueryDeadlineExceeded. The one deadline join shared by
        the single-query path and the batch's shared pass
        (_guarded_dispatch); `on_timeout` runs before the wedge is set.
        The worker runs inside a contextvars snapshot, so the caller's
        trace and nesting reach it; its last_metrics come back to the
        caller's thread."""
        import contextvars
        box: dict = {}
        ctx = contextvars.copy_context()

        def run():
            try:
                box["res"] = ctx.run(work)
            except BaseException as e:  # noqa: BLE001 - relayed to caller
                box["err"] = e
            box["metrics"] = getattr(self._tls, "metrics", None)

        t = threading.Thread(target=run, daemon=True, name=name)
        t.start()
        t.join(deadline)
        if t.is_alive():
            if on_timeout is not None:
                on_timeout()
            self._wedged = True
            self.breaker.record_failure("deadline")
            self.record({**rec, "deadline_exceeded": True,
                         "total_ms": deadline * 1000})
            raise QueryDeadlineExceeded(
                f"query exceeded deadline of {deadline}s") from None
        if box.get("metrics") is not None:
            self.last_metrics = box["metrics"]
        if "err" in box:
            raise box["err"]
        return box["res"]

    def _dispatch(self, call, metrics: dict, table_name: str):
        """Run one device dispatch with retry-based recovery: on failure,
        purge the table's resident state (its stacks could be poisoned
        by a device reset; other tables' stay warm) and re-run, up to
        `dispatch_retries + 1` attempts. Every retried error is kept in
        metrics["retry_errors"]; exhausting the attempts counts one
        breaker failure and re-raises. Structural refusals
        (UnsupportedAggregation) and taxonomy errors (QueryError: a lock
        unavailable within the deadline, a pipeline shed) pass through
        untouched: retrying cannot change them. With a mesh and
        degrade_shards_on_retry, a retry halves the mesh instead (every
        table's stacks purged and re-placed over the smaller mesh): the
        in-process analog of re-sharding the segment manifest after a
        device loss. Across processes a retry keeps the global D, and a
        failure after the statement's first collective is not retried."""
        attempts = max(1, self.config.dispatch_retries + 1)
        for attempt in range(attempts):
            try:
                self._attempt_local.value = attempt
                maybe_inject(self.config, "dispatch", attempt)
                # while a torch.profiler capture is live (obs.profile),
                # the launches run under this statement's query id;
                # otherwise a module-flag probe
                with annotate_dispatch(current_query_id()):
                    out = call()
                with self._totals_lock:
                    self._dispatches += 1
                # a success resets the breaker's consecutive failures
                self.breaker.record_success()
                return out
            except (UnsupportedAggregation, QueryError):
                raise
            except Exception as e:
                metrics.setdefault("retry_errors", []).append(
                    f"{type(e).__name__}: {e}")
                # a statement that already crossed ranks in a
                # collective is not re-run by this rank alone: its
                # re-issued collective would meet a peer's next statement
                if attempt + 1 >= attempts or metrics.get("collectives"):
                    # terminal: one breaker failure (the attempts the
                    # retry layer absorbed are not breaker events)
                    self.breaker.record_failure()
                    raise
                metrics["retries"] = attempt + 1
                # pipelined mode: nothing outer holds dispatch_lock, and
                # the purge must not race another statement's stage 1.
                # Serialized mode: the caller holds it — or, on a
                # deadline's watchdog thread, the caller's thread does,
                # so taking it here would wait out the deadline
                purge_lock = self.dispatch_lock if self._pipelined \
                    else nullcontext()
                with purge_lock:
                    # across processes one rank cannot shrink the mesh
                    # alone: its peers keep the global D, so the ranks'
                    # segments would overlap and leave some out
                    if self.config.degrade_shards_on_retry and \
                            (self._active_shards or 1) > 1 and \
                            _world() == 1:
                        # a mesh shrink re-places every table
                        self.clear_cache()
                        self._mesh = None
                        self._active_shards = max(
                            1, self._active_shards // 2)
                        if self._active_shards == 1:
                            self._ledger.set_num_chips(1)
                        metrics["degraded_shards"] = self._active_shards
                    else:
                        self.clear_cache(table_name)
            finally:
                self._attempt_local.value = 0

    def _guarded_dispatch(self, call, metrics: dict, table_name: str):
        """_dispatch under the single-query path's deadline and wedge
        guard: with query_deadline_s set, the batch's shared pass runs on
        a watchdog thread that is abandoned on expiry
        (QueryDeadlineExceeded for every leg), and a wedged device is
        re-probed before it is trusted again."""
        self.breaker.check()
        deadline = self.config.query_deadline_s
        if deadline is None:
            return self._dispatch(call, metrics, table_name)
        if self._wedged:
            self._reprobe_device(deadline)
        return self._join_abandoning(
            lambda: self._dispatch(call, metrics, table_name), deadline,
            {"datasource": table_name, "batch_dispatch": True,
             "query_type": "batch"},  # a failure record, not a note
            name="tpu-olap-batch-dispatch")

    # ------------------------------------------------ device health

    def _probe_device(self, timeout: float) -> bool:
        """A small reduction on the runner's device, on a watchdog
        thread; True iff it returns the right sum within `timeout`. On the
        card the thread synchronizes the current CUDA stream, so that a
        hung kernel ahead of it, or a failed device, shows. The "reprobe"
        fault site lives here, so a failing probe is testable without a
        sick device."""
        ok = threading.Event()

        def work():
            try:
                maybe_inject(self.config, "reprobe", 0)
                x = torch.arange(8, dtype=torch.int32,
                                 device=self.device).sum()
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
                if int(x) == 28:
                    ok.set()
            except Exception:  # noqa: BLE001 — a failed probe is data
                pass

        t = threading.Thread(target=work, daemon=True,
                             name="tpu-olap-probe")
        t.start()
        t.join(timeout)
        return ok.is_set()

    def _recover_after_probe(self, lock_timeout_s: float | None = None
                             ) -> bool:
        """The probe succeeded: clear the wedge and evict the resident
        datasets (stacks a device reset would poison) and the plans'
        device constants and segment masks, but keep the compiled kernels
        (the plans and the process's cubin cache): recompiling every
        template would stall the first statements after recovery. Takes
        dispatch_lock itself (re-entrant for the serialized path, whose
        caller holds it); in pipelined mode the acquire is bounded, since
        an abandoned stage 1 can strand the lock, and a stranded lock
        returns False (callers treat it as a failed probe). Success also
        reclaims the pipeline and stage slots abandoned threads hold."""
        if self._pipelined:
            t = 5.0 if lock_timeout_s is None \
                else max(1.0, float(lock_timeout_s))
            if not self.dispatch_lock.acquire(timeout=t):
                self.record({"device_probe_lock_stranded": True})
                return False
        else:
            self.dispatch_lock.acquire()
        try:
            self._wedged = False
            for ds in list(self._datasets.values()):
                ds.evict()
            self._datasets.clear()
            with self._cache_lock:
                plans = [plan for _, plan in self._plan_cache.values()]
            for plan in plans:
                for k in ("_device_consts", "_device_seg_mask",
                          "_mesh_consts", "_mesh_seg_mask"):
                    plan.__dict__.pop(k, None)
        finally:
            self.dispatch_lock.release()
        self.admission.reset_pipeline()
        self.stages.reclaim_stranded()
        self.record({"device_probe_recovered": True})
        return True

    def _reprobe_device(self, deadline: float):
        """Post-wedge health check: a probe under the deadline. Success
        clears the wedge and purges the resident state; failure raises
        at once."""
        if not self._probe_device(deadline):
            self.record({"device_probe_failed": True})
            self.breaker.record_failure("probe")
            raise QueryDeadlineExceeded(
                "device still unresponsive after a deadline-expired query")
        if not self._recover_after_probe(deadline):
            self.breaker.record_failure("probe")
            raise QueryDeadlineExceeded(
                "device answered the probe but the dispatch lock is "
                "stranded by an abandoned dispatch")

    def _healer_probe(self) -> bool:
        """The breaker healer's half-open probe: the same round trip,
        then the recovery purge, so that the first statement after
        recovery starts from fresh stacks. A stranded lock keeps the
        breaker open until the healer's next try."""
        timeout = self.config.query_deadline_s or 10.0
        if not self._probe_device(timeout):
            self.record({"device_probe_failed": True})
            return False
        return self._recover_after_probe(timeout)

    # ------------------------------------------------------ the record

    def _metric_path(self, m: dict) -> str:
        """Which execution flavor served a record (the JAX package's path
        label): "fallback" / "fallback_breaker" for the interpreter,
        "cache" for a full-result hit (no dispatch ran), "cube" for a
        cube serve, "batch" for a shared or deduplicated pass, "sparse",
        "fused" (the fused reduce; the JAX package's "pallas") or "dense"
        (the generic reduce); tier-1 partial hits keep their dispatch's
        label."""
        if m.get("query_type") == "fallback" or m.get("fallback"):
            if m.get("fallback_breaker"):
                return "fallback_breaker"
            return "fallback"
        if m.get("cache_tier") == "full":
            return "cache"
        if m.get("cube"):
            return "cube"
        if m.get("batch_dedup") or m.get("batch_legs", 0) > 1:
            return "batch"
        if m.get("route") == "sparse":
            return "sparse"
        if m.get("fused"):
            return "fused"
        return "dense"

    def record(self, m: dict) -> dict:
        """The one gate every statement's record passes through:
        sanitize non-JSON values to short strings (in place, so a
        QueryResult.metrics sharing the dict stays consistent), stamp the
        core keys (query_id from the active trace), fold the record into
        the incremental totals and the metrics registry, the workload
        profiler, the SLO tracker and the event log, then append it to
        the history ring. Runner notes (query_type "?": the probe's
        outcomes) log a `device` event and land in history only."""
        # the transient workload fingerprint rides under `_wl`, popped
        # before sanitizing so that the object never stringifies
        fp = m.pop("_wl", None)
        for k in list(m):
            m[k] = sanitize_metric_value(m[k])
        if in_introspection():
            return m
        m.setdefault("query_id",
                     current_query_id() or self.tracer.new_query_id())
        m.setdefault("ts_ms", int(time.time() * 1000))
        tp = current_traceparent()
        if tp is not None:
            m.setdefault("traceparent", tp)
        if fp is not None:
            m.setdefault("template_id", fp.template_id)
        for k, v in CORE_METRIC_DEFAULTS:
            m.setdefault(k, v)
        qt, path = m["query_type"], self._metric_path(m)
        m["path"] = path
        if qt == "?":
            self.events.emit(
                "device", query_id=m["query_id"],
                **{k: v for k, v in m.items()
                   if k.startswith("device_probe")})
            self.history.append(m)
            return m
        self.workload.observe(m, fp)
        with self._totals_lock:
            t = self._totals
            t["queries"] += 1
            t["rows_scanned"] += m["rows_scanned"] or 0
            t["segments_scanned"] += m["segments_scanned"] or 0
            t["segments_pruned"] += max(
                0, (m.get("segments_total", 0) or 0)
                - (m["segments_scanned"] or 0))
            t["cache_hits"] += 1 if m["cache_hit"] else 0
            t["total_ms"] += m["total_ms"] or 0.0
            self._by_query_type[qt] = self._by_query_type.get(qt, 0) + 1
        self._m_queries.inc(query_type=qt, path=path)
        self._m_latency.observe(m["total_ms"] or 0.0,
                                query_type=qt, path=path)
        self._m_rows.inc(m["rows_scanned"] or 0)
        self._m_segments.inc(m["segments_scanned"] or 0)
        if m.get("retries"):
            self._m_retries.inc(m["retries"])
        if m.get("deadline_exceeded"):
            self._m_deadline.inc()
        if m.get("fallback_breaker"):
            self._m_degraded.inc()
        if "hbm_bytes" in m:
            self._m_hbm_bytes.set(m["hbm_bytes"])
        if "hbm_evictions" in m:
            self._m_hbm_evict.set_total(m["hbm_evictions"])
        if self.device.type == "cuda" and "lower_ms" in m:
            # a statement that lowered on the card: its kernels came from
            # the caches (hit) or an NVRTC build ran (miss)
            self._m_compile.inc(
                result="miss" if m.get("recompiles") else "hit")
        if in_nested_execution():
            # an internal leg of a larger statement (a grouping-sets
            # union, a planner subquery, a fallback derived table): its
            # record and per-path metrics stay, the SLO observation and
            # `query` event belong to the outer statement
            self.history.append(m)
            return m
        # interim device failures (failed or deadline records on a
        # non-fallback path) log as `query_error` and never count against
        # the SLO here: the served outcome is accounted once elsewhere
        # (the compensating fallback record, or the statement boundary
        # when the failure propagates). Everything else is a served
        # response: one `query` event and one SLO observation.
        failed = bool(m.get("failed") or m.get("deadline_exceeded"))
        if failed and qt != "fallback":
            self.events.emit(
                "query_error", query_id=m["query_id"], query_type=qt,
                path=path, datasource=m["datasource"],
                total_ms=round(m["total_ms"] or 0.0, 3),
                **({"deadline_exceeded": True}
                   if m.get("deadline_exceeded") else {}))
        else:
            # the SLO sees the latency the user saw: a compensating
            # fallback adds the wall its statement burned on the failed
            # device attempt. Client-shaped failures never burn budget.
            if not (failed and m.get("client_error")):
                self.slo.observe((m["total_ms"] or 0.0)
                                 + (m.get("device_attempt_ms") or 0.0),
                                 failed=failed)
            self.events.emit(
                "query", query_id=m["query_id"], query_type=qt,
                path=path, datasource=m["datasource"],
                total_ms=round(m["total_ms"] or 0.0, 3),
                cache_hit=bool(m["cache_hit"]),
                **({"cache_tier": m["cache_tier"]}
                   if m.get("cache_tier") else {}),
                **({"failed": True} if failed else {}))
        # the regression sentinel sees served responses only:
        # introspection and nested legs returned above, and it skips
        # failed and deadline records itself
        self.sentinel.observe(m)
        self.history.append(m)
        return m

    def device_bytes_by_table(self) -> dict:
        """Live device bytes per table: each dataset's resident column,
        null, validity and derived stacks. Reads the datasets as they
        stand (no dispatch_lock, no device sync)."""
        return {name: ds.resident_bytes()
                for name, ds in list(self._datasets.items())}

    def cache_populations(self) -> dict:
        """{cache: entries} of the runner's caches: the plan cache and,
        as "jit", the process's cache of NVRTC-compiled kernels
        (kernels.cuda_build; shared by every engine of the process)."""
        return {"jit": len(cuda_build._kernels),
                "plan": len(self._plan_cache)}

    def refresh_resource_gauges(self):
        """Point-in-time memory and cache gauges, refreshed at scrape
        time (GET /metrics, sys.metrics) rather than per statement:
        walking every resident buffer is O(buffers). Takes no
        dispatch_lock and never synchronizes with the device."""
        by_table = self.device_bytes_by_table()
        for t, b in by_table.items():
            self._m_device_bytes.set(b, table=t)
        for key in list(self._m_device_bytes.series):
            if key[0] not in by_table:  # evicted table: zero, not stale
                self._m_device_bytes.set(0.0, table=key[0])
        for cache, n in self.cache_populations().items():
            self._m_cache_entries.set(n, cache=cache)
        self.result_cache._refresh_gauges()
        self._refresh_hbm_chip_gauges()

    def _refresh_hbm_chip_gauges(self):
        """Per-(chip, owner-class) device-memory gauges: the ledger's
        exact attribution plus high-watermark and headroom against each
        device's share of the budget — the /metrics face of
        sys.devices' hbm columns."""
        m = self.metrics
        g_bytes = m.gauge(
            "hbm_chip_bytes",
            "HBM-resident bytes per chip and owner class (exact "
            "HbmLedger attribution; cache_pins via the ResultCache "
            "reporter).", ("chip", "owner"))
        g_hwm = m.gauge(
            "hbm_chip_high_watermark_bytes",
            "Ledger-managed per-chip HBM high-watermark.", ("chip",))
        g_head = m.gauge(
            "hbm_chip_headroom_bytes",
            "Per-chip share of hbm_budget_bytes minus ledger-managed "
            "resident bytes (absent without a budget).", ("chip",))
        ledger = self._ledger
        snap = ledger.breakdown()
        hwm = ledger.watermarks()
        D = ledger.num_chips
        in_ledger = [0] * D
        seen = set()
        for (c, owner), b in snap.items():
            if owner != "cache_pins" and c < D:
                in_ledger[c] += b
            g_bytes.set(b, chip=c, owner=owner)
            seen.add((str(c), owner))
        for key in list(g_bytes.series):
            if tuple(key) not in seen:  # released class: zero, not stale
                g_bytes.set(0.0, chip=key[0], owner=key[1])
        for c in range(D):
            g_hwm.set(hwm["per_chip"][c] if c < len(hwm["per_chip"])
                      else 0, chip=c)
            if ledger.budget:
                g_head.set(ledger.budget / D - in_ledger[c], chip=c)
        m.gauge("hbm_high_watermark_bytes",
                "Ledger-managed total HBM high-watermark.") \
            .set(hwm["total"])

    def device_snapshot(self) -> list:
        """Serving state per device, behind sys.devices and GET
        /debug/devices: one row per mesh device (one row, the runner's
        device, without a mesh) with the logical segments it owns under
        the interleaved placement (segment i on device i mod D), its
        resident bytes, its dispatches, its tier-1 cache entries (the
        device of an entry is its segment's), the rebase counts, and the
        ledger's exact per-owner-class bytes on it (table columns, cube
        tables, in-flight pins; over every row they sum to bytes_in_use)
        beside the tier-1 cache's byte census, the high-watermark and
        the headroom against the device's share of hbm_budget_bytes.
        Across processes every global device has a row, `process` its
        rank, as in the JAX package; another rank's bytes and counts are
        its own to report, and are 0 here."""
        mesh = self.mesh
        if mesh is not None:
            devs, procs = [], []
            for r in range(mesh.world):
                own = mesh if r == mesh.rank else sh.rank_mesh(
                    r, mesh.world, mesh.size, self.config.device)
                devs += own.devices
                procs += [r] * len(own.devices)
            first = mesh.local_ids.start
            L = len(mesh.devices)
        else:
            dev = self.device
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            devs, procs, first, L = [dev], [0], 0, 1
        D = len(devs)
        seg = [0] * D
        res_bytes = [0] * L
        rebased_cols = rebase_rows = 0
        for _name, ds in list(self._datasets.items()):
            n_seg = len(ds.table.segments)
            q, r = divmod(ds.resident_bytes(), L)
            for c in range(D):
                seg[c] += len(range(c, n_seg, D))
            for c in range(L):
                res_bytes[c] += q + (1 if c < r else 0)
            rebased_cols += ds.rebased_cols
            rebase_rows += ds.rebase_rows_uploaded
        cache_by_chip = self.result_cache.shard_entries(D)
        ledger = self._ledger
        hbm = ledger.breakdown()
        hwm = ledger.watermarks()["per_chip"]
        budget = ledger.budget
        with self._totals_lock:
            disp = dict(self._chip_dispatches) if mesh is not None \
                else {0: self._dispatches}
        rows = []
        for g, dev in enumerate(devs):
            c = g - first   # this process's index of the device
            mine = 0 <= c < L
            col_b = hbm.get((c, "table_columns"), 0) if mine else 0
            cube_b = hbm.get((c, "cube_tables"), 0) if mine else 0
            infl_b = hbm.get((c, "inflight"), 0) if mine else 0
            in_ledger = col_b + cube_b + infl_b
            rows.append({
                "index": g,
                "device": str(dev),
                "platform": dev.type,
                "process": procs[g],
                "chips": D,
                "segments": seg[g],
                "resident_bytes": int(res_bytes[c]) if mine else 0,
                "dispatches": disp.get(g, 0),
                "cache_shard_entries": cache_by_chip.get(g, 0),
                "rebased_cols": rebased_cols,
                "rebase_rows_uploaded": rebase_rows,
                "hbm_bytes": int(in_ledger),
                "table_column_bytes": int(col_b),
                "cube_table_bytes": int(cube_b),
                "inflight_bytes": int(infl_b),
                "cache_pin_bytes": int(hbm.get((c, "cache_pins"), 0))
                if mine else 0,
                "hbm_high_watermark_bytes": int(
                    hwm[c] if mine and c < len(hwm) else 0),
                "hbm_headroom_bytes": (int(budget / L - in_ledger)
                                       if budget and mine else None),
            })
        return rows

    def counters(self) -> dict:
        """Aggregate counters, kept incrementally at record time: exact
        over the engine's lifetime, history-ring eviction or not."""
        with self._totals_lock:
            out = dict(self._totals)
            out["by_query_type"] = dict(self._by_query_type)
        return out

    # ------------------------------------------------ the statement

    def _execute(self, query, table, abandoned=None) -> QueryResult:
        """One statement's stage graph, ending in one record(); a failure
        records too (with its retry errors), then propagates. `abandoned`
        is set when a deadline gave up on this thread: its record is
        then discarded (the deadline's own record stands)."""
        t0 = time.perf_counter()
        self.last_metrics = {"host_copies": 0}
        pending = self._tls.compiles = [0, 0.0]
        try:
            with self.stages.graph(self.config.query_deadline_s):
                if self.config.profile_dir is None:
                    res = self._execute_graph(query, table)
                else:
                    res = self._execute_profiled(query, table)
        except Exception:
            m = self.last_metrics
            m["failed"] = True
            m["query_type"] = query.query_type
            m["datasource"] = table.name
            m["total_ms"] = (time.perf_counter() - t0) * 1000
            m["_wl"] = self.fingerprint(query, table.name)
            if abandoned is None or not abandoned.is_set():
                self.record(m)
            raise
        m = res.metrics
        m["total_ms"] = (time.perf_counter() - t0) * 1000
        m["query_type"] = query.query_type
        m["datasource"] = table.name
        if pending[0]:
            m["recompiles"] = pending[0]
            m["compile_ms"] = round(pending[1], 3)
        fp = self.fingerprint(query, table.name)
        m["_wl"] = fp
        if abandoned is None or not abandoned.is_set():
            self.record(m)
            self._store_full_cache(query, table, res, fp)
        self.last_metrics = m
        return res

    def _execute_profiled(self, query, table) -> QueryResult:
        """The statement under its own torch.profiler session
        (EngineConfig.profile_dir): a Chrome trace in a directory of its
        own beneath profile_dir, named in the record's "profile_trace".
        One session runs in the process at a time: a statement that meets
        another (a capture, another profiled statement) raises
        RuntimeError, as the JAX package's jax.profiler.trace does."""
        # monotonic, not len(history): the ring plateaus at history_limit
        # and the directory names would collide
        with self._totals_lock:
            self._profile_seq += 1
            seq = self._profile_seq
        trace_dir = os.path.join(self.config.profile_dir,
                                 f"q{seq:05d}_{query.query_type}")
        with profile_mod.profile_query(trace_dir,
                                       cuda=self.device.type == "cuda"):
            res = self._execute_graph(query, table)
        res.metrics["profile_trace"] = trace_dir
        return res

    def _execute_graph(self, query, table) -> QueryResult:
        if isinstance(query, TimeBoundaryQuerySpec):
            return self._run_time_boundary(query, table)
        if isinstance(query, SegmentMetadataQuerySpec):
            return self._run_segment_metadata(query, table)
        if isinstance(query, SearchQuerySpec):
            return self._run_search(query, table)
        if isinstance(query, (ScanQuerySpec, SelectQuerySpec)):
            return self._run_scan(query, table)
        if isinstance(query, (TimeseriesQuerySpec, GroupByQuerySpec,
                              TopNQuerySpec)):
            return self._run_agg(query, table)
        raise TypeError(f"unknown query type {type(query).__name__}")

    # --------------------------------------------- semantic result cache

    _CACHEABLE_QUERY_TYPES = ("timeseries", "groupBy", "topN")

    def _cacheable(self, query, table) -> bool:
        return (self.result_cache.full_enabled and not in_introspection()
                and getattr(query, "query_type", None)
                in self._CACHEABLE_QUERY_TYPES
                and getattr(table, "generation", None) is not None)

    def _serve_full_cache(self, query, table) -> QueryResult | None:
        """Tier-2 lookup: a hit returns a fresh QueryResult sharing the
        cached rows, with its own record (cache_hit, cache_tier "full",
        path "cache", route "cache", rows_scanned 0, no launch and no
        copy). None = miss or bypass; the caller executes."""
        if not self._cacheable(query, table):
            return None
        t0 = time.perf_counter()
        with _span("result-cache") as sp:
            hit = self.result_cache.get_full(query, table)
            sp.set(tier="full", hit=hit is not None)
        if hit is None:
            return None
        rows, druid, meta = hit
        m = {"query_type": query.query_type, "datasource": table.name,
             "route": "cache", "host_copies": 0, "cache_hit": True,
             "cache_tier": "full", "rows_scanned": 0,
             "segments_scanned": 0,
             "segments_total": meta.get("segments_total", 0),
             "rows_returned": len(rows), "_wl": meta.get("_wl_fp"),
             "total_ms": (time.perf_counter() - t0) * 1000}
        self.record(m)
        return QueryResult(query, rows, druid, m)

    def _store_full_cache(self, query, table, res: QueryResult, fp=None):
        """Fill tier 2 from a served result (the single path, batch
        singles and fused batch legs all come here). `fp` is the
        statement's workload fingerprint, kept on the entry so that a
        hit is attributed without re-normalizing the query."""
        if not self._cacheable(query, table) or res.metrics.get("failed"):
            return
        self.result_cache.put_full(query, table, res.rows, res.druid, {
            "segments_total": res.metrics.get("segments_total", 0),
            "_wl_fp": fp})

    # ----------------------------------------------------------- workload

    def fingerprint(self, query, table_name: str):
        """Workload template of a device-path query (obs.workload), or
        None (profiling off, or an exotic spec): profiling never fails
        a query."""
        if not self.workload.enabled:
            return None
        try:
            return fingerprint_ir(query, table_name)
        except Exception:  # noqa: BLE001 — profiling must never raise
            return None

    def clear_cache(self, table_name: str | None = None):
        """Drop one table's resident columns, memoized plans, cap hints
        and both result-cache tiers, or every table's (None): the next
        query re-uploads. Counted in cache_clears_total{scope} with a
        `cache_clear` event, as in the JAX package (the compiled kernels
        are the process's and stay)."""
        self._m_cache_clears.inc(scope="table" if table_name else "full")
        purged = self.result_cache.clear(table_name)
        self.events.emit(
            "cache_clear", table=table_name or "*",
            jit_entries=len(cuda_build._kernels),
            plan_entries=len(self._plan_cache),
            result_entries=purged["full"],
            segment_entries=purged["segment"])
        self.purge_device_state(table_name)

    def purge_device_state(self, table_name: str | None = None):
        """clear_cache without the result cache, the counter and the
        event: one table's (or every table's) resident stacks, memoized
        plans and cap hints. Snapshots first: an abandoned deadline
        thread may touch these dicts concurrently."""
        if table_name is None:
            for ds in list(self._datasets.values()):
                ds.evict()
            self._datasets.clear()
            self._cap_hints.clear()
            with self._cache_lock:
                self._plan_cache.clear()
            return
        ds = self._datasets.pop(table_name, None)
        if ds is not None:
            ds.evict()
        for k in [k for k in list(self._cap_hints) if k[0] == table_name]:
            self._cap_hints.pop(k, None)
        with self._cache_lock:
            for k in [k for k in self._plan_cache if k[0] == table_name]:
                del self._plan_cache[k]

    def device_bytes(self) -> int:
        """Resident device bytes over every table's dataset."""
        return sum(ds.resident_bytes() for ds in list(
            self._datasets.values()))

    def _dataset(self, table) -> DeviceDataset:
        ds = self._datasets.get(table.name)
        if ds is None or ds.table is not table:
            prev = ds
            # the superseded snapshot rides in as `prev`: its resident
            # stacks rebase on the device (only the changed segments'
            # rows upload). It is evicted after the new dataset has
            # taken its stacks; in-flight queries that hold its tensors
            # keep them alive by reference.
            ds = DeviceDataset(table, self.device, self._ledger, prev=prev,
                               mesh=self.mesh)
            if prev is not None:
                prev.evict()
            self._datasets[table.name] = ds
        return ds

    @staticmethod
    def working_set(plan: PhysicalPlan) -> tuple:
        """(columns, null columns, derived tokens) a plan's dispatch
        reads, the derived streams' source columns included."""
        cols = list(plan.columns)
        tokens = [dp.cache_token for dp in plan.dim_plans
                  if dp.cache_token is not None]
        cols += [dp.source_col if dp.source_col is not None
                 else TIME_COLUMN for dp in plan.dim_plans
                 if dp.cache_token is not None]
        bp = plan.bucket_plan
        if bp is not None and bp.cache_token:
            tokens.append(bp.cache_token)
            cols.append(TIME_COLUMN)
        tokens += [t for t, _, _ in plan.filter_streams]
        cols += [src for _, src, _ in plan.filter_streams]
        return tuple(dict.fromkeys(cols)), tuple(plan.null_cols), \
            tuple(tokens)

    def pins(self, plans) -> frozenset:
        """Ledger keys of the union of the plans' working sets (one
        table): what a dispatch pins while its env builds."""
        out = frozenset()
        for plan in plans:
            out |= self._dataset(plan.table).pins(*self.working_set(plan))
        return out

    def _lower_cached(self, query, table) -> PhysicalPlan:
        """Memoized lower() under the "plan" stage: re-lowering an
        unchanged query costs milliseconds of pure Python per execution.
        Keyed on the full query JSON plus the config; a table identity
        check invalidates on re-registration. Lowering runs outside
        dispatch_lock in pipelined mode; a duplicate concurrent lowering
        is last-write-wins."""
        import json
        with self.stages.stage("plan", self.last_metrics):
            key = (table.name,
                   json.dumps(query.to_json(), sort_keys=True, default=str),
                   repr(self.config))
            with self._cache_lock:
                hit = self._plan_cache.get(key)
            if hit is not None and hit[0] is table:
                return hit[1]
            with self._observe_compiles():
                plan = lower(query, table, self.config)
            with self._cache_lock:
                if len(self._plan_cache) > 512:
                    self._plan_cache.pop(next(iter(self._plan_cache)))
                    self._m_cache_evict.inc(cache="plan")
                self._plan_cache[key] = (table, plan)
            return plan

    def _device_consts(self, plan: PhysicalPlan, mesh=None):
        """The plan's ConstPool on the device, once per plan (under a
        mesh: a list of one copy per device, once per plan and mesh).
        Scalars ride as 1-element tensors: torch lets a 0-d int64 tensor
        take the dtype of an int8 column it meets (and wrap), where numpy
        and JAX promote to int64; a 1-element tensor promotes like
        numpy."""
        if mesh is not None:
            hit = getattr(plan, "_mesh_consts", None)
            if hit is None or hit[0] != mesh:
                host = {k: torch.as_tensor(np.atleast_1d(v))
                        for k, v in plan.pool.consts.items()}
                hit = plan._mesh_consts = (mesh, [
                    {k: t.to(dev) for k, t in host.items()}
                    for dev in mesh.devices])
            return hit[1]
        consts = getattr(plan, "_device_consts", None)
        if consts is None:
            consts = plan._device_consts = {
                k: torch.as_tensor(np.atleast_1d(v)).to(self.device)
                for k, v in plan.pool.consts.items()}
        return consts

    def _prepare(self, plan: PhysicalPlan, metrics: dict, pinned=None):
        """Dataset env + derived streams + validity/segment masks + scan
        metrics, under a `prepare` span. The working set (`pinned`,
        default the plan's own; a fused batch passes its legs' union) is
        pinned in the ledger while it builds, so that nothing it reads is
        evicted before the launch that reads it."""
        with _span("prepare") as sp:
            out = self._prepare_inner(plan, metrics, pinned)
            sp.set(rows_scanned=metrics.get("rows_scanned"),
                   segments_scanned=metrics.get("segments_scanned"))
        return out

    def _prepare_inner(self, plan: PhysicalPlan, metrics: dict, pinned):
        """Under a mesh the stacks are Sharded, the constant pool is one
        dict per device, and every derived stream builds per device from
        that device's shard."""
        table = plan.table
        ds = self._dataset(table)
        mesh = ds.mesh
        if pinned is None:
            pinned = self.pins([plan])
        env = ds.env(plan.columns, plan.null_cols, pinned)
        consts = self._device_consts(plan, mesh)

        def per_device(fn, *stacks):
            # fn(stack..., consts) on the one device, or per mesh device
            if mesh is None:
                return fn(*stacks, consts)
            return sh.map_shards(mesh, fn, *stacks, consts)

        for dp in plan.dim_plans:
            if dp.cache_token is not None:
                src = dp.source_col if dp.source_col is not None \
                    else TIME_COLUMN
                env["cols"][dp.derived_name] = ds.derived(
                    dp.cache_token, lambda dp=dp, src=src: per_device(
                        lambda t, c, dp=dp, src=src:
                            dp.ids({"cols": {src: t}, "nulls": {}}, c)
                            .to(torch.int32),
                        ds.col(src, pinned)), pinned)
        bp = plan.bucket_plan
        if bp is not None and bp.cache_token:
            env["cols"][bp.derived_name] = ds.derived(
                bp.cache_token, lambda: per_device(
                    lambda t, c: bp.build_stream(t, c).to(torch.int32),
                    ds.col(TIME_COLUMN, pinned)), pinned)
        for token, src, cname in plan.filter_streams:
            env["cols"]["\0d:" + token] = ds.derived(
                token, lambda src=src, cname=cname: per_device(
                    lambda t, c, cname=cname:
                        _take(c[cname], t).to(torch.int32),
                    ds.col(src, pinned)), pinned)
        valid = ds.valid(pinned)
        kept = plan.pruned_ids if not plan.empty else []
        # once per plan (and mesh): a host-to-device copy per query
        # would sync
        if mesh is not None:
            hit = getattr(plan, "_mesh_seg_mask", None)
            if hit is None or hit[0] != mesh:
                hit = plan._mesh_seg_mask = (mesh, ds.segment_mask(kept))
            seg_mask = hit[1]
        else:
            seg_mask = getattr(plan, "_device_seg_mask", None)
            if seg_mask is None:
                seg_mask = plan._device_seg_mask = ds.segment_mask(kept)
        metrics["segments_total"] = len(table.segments)
        metrics["segments_scanned"] = len(kept)
        metrics["rows_scanned"] = int(sum(
            table.segments[i].meta.n_valid for i in kept))
        if self._ledger.budget is not None:
            metrics["hbm_bytes"] = self._ledger.bytes_in_use
            metrics["hbm_evictions"] = self._ledger.evictions
        return env, valid, seg_mask, consts

    def _segment_window(self, plan: PhysicalPlan, n_segments: int):
        """(lo, W) covering every pruned segment, or None. Interval and
        bounds pruning is mask-only inside the kernel (pruned segments
        still cost their bytes); with time-partitioned ingest the pruned
        set is contiguous on the segment axis, so the dispatch slices the
        [S, R] working set down to a pow2-quantized window and reads ONLY
        those bytes. Skipped when the window saves <25%, and under a mesh
        (whose aggregates cut the per-device window instead,
        sharding.local_window)."""
        ids = plan.pruned_ids
        if self.mesh is not None or plan.empty or not ids:
            return None
        lo, hi = min(ids), max(ids) + 1
        W = _next_pow2(hi - lo)
        if 4 * W >= 3 * n_segments:
            return None
        return min(lo, n_segments - W), W

    def _dispatch_args(self, plan: PhysicalPlan, metrics: dict):
        """(env, valid, seg_mask, consts) of the plan's kernel, cut to
        the segment window when it saves enough. Stage-1 work: the
        caller holds the enqueue lock."""
        t0 = time.perf_counter()
        env, valid, seg_mask, consts = self._prepare(plan, metrics)
        metrics["prepare_ms"] = (time.perf_counter() - t0) * 1000
        win = self._segment_window(plan, len(seg_mask))
        if win is not None:
            lo, W = win
            metrics["segments_window"] = W
            sl = slice(lo, lo + W)
            env = {"cols": {c: a[sl] for c, a in env["cols"].items()},
                   "nulls": {c: a[sl] for c, a in env["nulls"].items()}}
            valid, seg_mask = valid[sl], seg_mask[sl]
        return env, valid, seg_mask, consts

    def _run_partials(self, plan: PhysicalPlan, metrics: dict) -> dict:
        """Unpacked route: the plan's kernel and every partial table back
        in one copy. Stage 1 launches and queues the copy; stage 2 waits
        for it. Under a mesh: `_run_partials_mesh`."""
        if self.mesh is not None:
            return self._run_partials_mesh(plan, metrics)
        t0 = time.perf_counter()
        with self._pipeline_slot():
            out = self._staged_fetch(
                lambda: plan.kernel(*self._dispatch_args(plan, metrics)),
                metrics)
        metrics["execute_ms"] = (time.perf_counter() - t0) * 1000
        return out

    def _run_partials_mesh(self, plan: PhysicalPlan, metrics: dict):
        """The plan's kernel once per mesh device over that device's
        stacks. An aggregate runs inside the per-device local window
        (sharding.local_window) and merges as the cost model says:
        "historicals" copies the D unfinalized partial tables to the host
        (one pinned copy per device, each behind its own event) and the
        broker folds them there; "broker" folds them on the mesh's first
        device and copies one table back. A mask plan's per-device row
        masks come back, one copy per device, in logical segment order
        ([S, R] over the table's segments), as every assembler indexes
        rows by logical segment id.

        Across processes each rank does the same over its own devices,
        then merges with the other ranks in stage 1 (executor.
        collective): an aggregate's locally folded table crosses in one
        gather_partials, folded in rank order; the strategy is reported as "broker", as the JAX package forces it
        across processes, and the merge as "collective". A mask plan's
        masks cross in one gather_masks."""
        mesh = self.mesh
        D = mesh.size
        is_agg = plan.kind == "agg"
        multi = sh.is_multihost(mesh)
        info = {"strategy": "mask"}

        def launch():
            env, valid, seg_mask, consts = self._prepare(plan, metrics)
            per_chip = valid[0].shape[0]
            win = None
            if is_agg:
                with _span("cost-decision") as sp:
                    decision = cost_mod.decide(plan, self.config, D)
                    strategy = decision.strategy
                    # as in the JAX package, whose historicals key
                    # extends by the chip: past int32, fold on a device
                    if strategy == "historicals" and \
                            D * plan.total_groups >= (1 << 31):
                        strategy = "broker"
                    sp.set(strategy="broker" if multi else strategy)
                info["strategy"] = strategy
                metrics["cost"] = decision.to_json()
                win = sh.local_window(plan.pruned_ids, D, per_chip) \
                    if not plan.empty else None
                if win is not None:
                    metrics["segments_window"] = win[1] * D
                    metrics["segments_window_per_chip"] = win[1]
            else:
                metrics["mask_kernel"] = plan.mask_reason is None
                if plan.mask_reason is not None:
                    metrics["mask_reason"] = plan.mask_reason
            with _span("dispatch", num_shards=D, strategy=info["strategy"]):
                outs = sh.launch_per_device(
                    mesh, plan.kernel,
                    sh.device_args(env, valid, seg_mask, consts, win))
            self._note_chip_dispatch(mesh.local_ids)
            if info["strategy"] == "broker":
                with _span("device-fold", num_shards=len(outs)):
                    outs = [sh.device_fold(outs, plan.agg_plans,
                                           mesh.devices[0])]
            return outs

        def merge(hosts):
            with sh.on_device(mesh.devices[0]):
                if not is_agg:
                    local = np.stack([h.reshape(-1) for h in hosts])
                    return [m.cpu().numpy() for m in collective.gather_masks(
                        local, metrics=metrics)]
                local = hosts[0] if len(hosts) == 1 else \
                    sh.broker_merge(hosts, plan.agg_plans)
                return [{n: t.cpu().numpy() for n, t in
                         collective.gather_partials(
                             local, plan.agg_plans, metrics=metrics).items()}]

        t0 = time.perf_counter()
        with self._pipeline_slot():
            hosts = self._staged_fetch_all(
                launch, metrics, dispatch_span=False,
                merge=merge if multi else None)
        metrics["execute_ms"] = (time.perf_counter() - t0) * 1000
        metrics["num_shards"] = D
        metrics["strategy"] = "broker" if multi and is_agg \
            else info["strategy"]
        if not is_agg:
            # every device's mask in global order (across processes,
            # rank r's rows are devices rL .. rL + L - 1)
            table = plan.table
            per_dev = [m for rank in hosts for m in rank] if multi else hosts
            masks = [m.reshape(-1, table.block_rows) for m in per_dev]
            full = np.empty((D * masks[0].shape[0], table.block_rows), bool)
            for c, m in enumerate(masks):
                full[c::D] = m   # local index l of device c: segment c + lD
            return full[:len(table.segments)]
        if multi:
            metrics["merge"] = "collective"
            return hosts[0]
        if info["strategy"] == "historicals":
            with _span("broker-merge", num_shards=D):
                out = sh.broker_merge(hosts, plan.agg_plans)
            metrics["merge"] = "broker"
            return {n: t.numpy() for n, t in out.items()}
        metrics["merge"] = "device"
        return hosts[0]

    def _cap_hint(self, plan: PhysicalPlan, route: str, first: int,
                  limit: int) -> tuple:
        """(hint key, first cap): the config's cap on a template's first
        run, then twice the group count last seen (a power of two, at
        least 64), never past `limit`."""
        key = (plan.table.name, route, plan.sizes,
               tuple((p.kind, p.name) for p in plan.agg_plans))
        hint = self._cap_hints.get(key)
        cap = min(limit, first) if hint is None else \
            min(limit, max(64, _next_pow2(2 * hint)))
        return key, cap

    def _run_packed(self, plan: PhysicalPlan, metrics: dict):
        """Packed route: the kernel plus device finalize/compact/pack, one
        buffer back. The cap adapts per template, with a sized re-run
        when a run overflows its hint: each attempt is one stage-1
        enqueue (the lock taken anew) and one stage-2 read of the count.
        Returns (idx, compact, layout), or None when the groups exceed
        `result_group_cap` (the caller re-runs unpacked)."""
        cap_limit = min(self.config.result_group_cap, plan.total_groups)
        key, cap = self._cap_hint(plan, "packed", cap_limit, cap_limit)
        args = None
        t0 = time.perf_counter()
        with self._pipeline_slot(), _span("dispatch", packed=True) as dsp:
            while True:
                layout = make_layout(plan, self.config, cap)

                def launch(layout=layout):
                    nonlocal args
                    if args is None:
                        args = self._dispatch_args(plan, metrics)
                    return build_packer(plan.kernel, plan, layout)(*args)
                buf = self._staged_fetch(launch, metrics,
                                         dispatch_span=False)
                count, idx, compact = unpack(buf, layout)
                if count <= layout.cap:
                    break
                if count > cap_limit:
                    metrics["result_groups"] = count
                    dsp.set(overflow=True)
                    return None
                cap = min(cap_limit, _next_pow2(count))
        self._cap_hints[key] = count
        metrics["execute_ms"] = (time.perf_counter() - t0) * 1000
        metrics["result_groups"] = count
        metrics["result_cap"] = layout.cap
        return idx, compact, layout

    def _run_sparse(self, plan: PhysicalPlan, metrics: dict) -> dict:
        """Sparse route: the sort-based group-by with an adaptive compact
        table cap; each attempt is one stage-1 enqueue and one copy back,
        read in stage 2. Past `sparse_group_budget` present groups it
        raises UnsupportedAggregation, and the engine serves the query
        from the fallback interpreter. Under a mesh: `_run_sparse_mesh`."""
        if self.mesh is not None:
            return self._run_sparse_mesh(plan, metrics)
        cap_limit = min(self.config.sparse_group_budget, plan.total_groups)
        key, cap = self._cap_hint(plan, "sparse",
                                  self.config.sparse_group_cap, cap_limit)
        args = None
        t0 = time.perf_counter()
        reruns = []
        with self._pipeline_slot(), _span("dispatch", sparse=True) as sp:
            while True:
                def launch(cap=cap):
                    nonlocal args
                    if args is None:
                        args = self._dispatch_args(plan, metrics)
                    return plan.make_sparse_kernel(cap)(*args)
                out = self._staged_fetch(launch, metrics,
                                         dispatch_span=False)
                count = int(out["_count"])
                if count <= cap:
                    break
                if count > cap_limit:
                    raise UnsupportedAggregation(
                        f"{count} present groups exceed sparse budget "
                        f"{cap_limit}")
                reruns.append(cap)
                cap = min(cap_limit, _next_pow2(count))
            sp.set(result_groups=count)
        self._cap_hints[key] = count
        metrics["execute_ms"] = (time.perf_counter() - t0) * 1000
        metrics["result_groups"] = count
        metrics["result_cap"] = cap
        metrics["sparse_reruns"] = reruns  # the caps that overflowed
        return out

    def _run_sparse_mesh(self, plan: PhysicalPlan, metrics: dict) -> dict:
        """The sparse group-by over the mesh: every device compacts its
        own rows (one launch each), under an adaptive local cap that
        re-runs while a device's groups overflow it, up to
        `sparse_group_budget` per device. Then, per
        EngineConfig.sparse_merge:

        - "gather": every device's compact table comes to the host (one
          copy each) and the broker merges them (merge_sparse); the
          merged groups must fit `sparse_group_budget`;
        - "exchange": only each device's group count comes back first;
          then every device's entries go to their owner devices
          (kernels.sparse_groupby.exchange: hash of the key mod D, copied
          device to device), each owner merges what it received, and the
          D owner tables come to the host, where their disjoint keys are
          put in order. The present groups may reach
          D x sparse_group_budget, and a skewed key set only loads one
          owner (`result_cap_owner`: the largest owner table).

        Across processes, the JAX package's "gather" contract whatever
        sparse_merge says, with the merge in stage 1
        (executor.collective): the ranks agree on the largest local
        count (all re-run while it overflows the cap), each rank merges
        its devices' tables, gather_varlen hands every rank the world's
        tables, and merge_sparse folds them in rank order
        (`sparse_merge` "collective").

        Returns the sparse route's compact table (numpy, sorted by key)."""
        mesh = self.mesh
        D = mesh.size
        multi = sh.is_multihost(mesh)
        use_exchange = not multi and self.config.sparse_merge == "exchange"
        budget = self.config.sparse_group_budget
        cap_limit = min(budget * (D if use_exchange else 1),
                        plan.total_groups)
        local_limit = min(budget, plan.total_groups)
        key, cap = self._cap_hint(plan, "sparse-local",
                                  self.config.sparse_group_cap, local_limit)
        state = {"args": None, "outs": None}
        reruns = []

        def gather(tables, cap=None):
            # the compact tables merged at the host, under `cap` groups
            want = max(64, _next_pow2(
                max(1, sum(int(t["_count"]) for t in tables))))
            return merge_sparse(
                [{n: torch.as_tensor(v) for n, v in t.items()}
                 for t in tables], plan.agg_plans,
                want if cap is None else min(cap, want))

        def merge_ranks(hosts, cap):
            # (the world's largest local count, the merged table or None
            # when that count overflows `cap` and every rank re-runs)
            with sh.on_device(mesh.devices[0]):
                local_max = collective.agree_max(
                    max(int(h["_count"]) for h in hosts), metrics=metrics)
                if local_max > cap:
                    return local_max, None
                local = gather(hosts)
                merged = gather(collective.gather_varlen(
                    local, int(local["_count"]), metrics=metrics), cap_limit)
                return local_max, {n: t.cpu().numpy()
                                   for n, t in merged.items()}

        t0 = time.perf_counter()
        with self._pipeline_slot(), \
                _span("dispatch", sparse=True, num_shards=D) as sp:
            while True:
                def launch(cap=cap):
                    if state["args"] is None:
                        state["args"] = sh.device_args(
                            *self._prepare(plan, metrics))
                    outs = state["outs"] = sh.launch_per_device(
                        mesh, plan.make_sparse_kernel(cap), state["args"])
                    self._note_chip_dispatch(mesh.local_ids)
                    if use_exchange:  # the tables stay on their devices
                        return [o["_count"] for o in outs]
                    return outs
                got = self._staged_fetch_all(
                    launch, metrics, dispatch_span=False,
                    merge=(lambda hosts, cap=cap: merge_ranks(hosts, cap))
                    if multi else None)
                if multi:
                    local_max, out = got
                else:
                    hosts = got
                    counts = [int(h["_count"] if isinstance(h, dict)
                                  else h[0]) for h in hosts]
                    local_max = max(counts)
                if local_max <= cap:
                    break
                if local_max > local_limit:
                    raise UnsupportedAggregation(
                        f"{local_max} per-chip present groups exceed sparse "
                        f"budget {local_limit}")
                reruns.append(cap)
                cap = min(local_limit, _next_pow2(local_max))
            self._cap_hints[key] = local_max
            if multi:
                metrics["sparse_merge"] = "collective"
            elif use_exchange:
                caps = []

                def launch_exchange():
                    merged, c = exchange(state["outs"], counts,
                                         list(mesh.devices), plan.agg_plans,
                                         cap_limit)
                    caps.extend(c)
                    return merged
                with _span("exchange", num_shards=D):
                    owners = self._staged_fetch_all(launch_exchange, metrics,
                                                    dispatch_span=False)
                with _span("broker-merge", num_shards=D):
                    out = _concat_owner_tables(owners)
                metrics["sparse_merge"] = "exchange"
                metrics["result_cap_owner"] = max(caps)
            else:
                with _span("broker-merge", num_shards=D):
                    out = {n: t.numpy()
                           for n, t in gather(hosts, cap_limit).items()}
            state.clear()
            count = int(out["_count"])
            if count > cap_limit:
                raise UnsupportedAggregation(
                    f"{count} present groups exceed sparse budget "
                    f"{cap_limit}")
            sp.set(result_groups=count)
        metrics["num_shards"] = D
        metrics["execute_ms"] = (time.perf_counter() - t0) * 1000
        metrics["result_groups"] = count
        metrics["result_cap"] = cap
        metrics["sparse_reruns"] = reruns  # the local caps that overflowed
        return out

    def _run_agg(self, query, table) -> QueryResult:
        metrics = self.last_metrics = {"host_copies": 0}
        t0 = time.perf_counter()
        with _span("lower"):
            plan = self._lower_cached(query, table)
        metrics["lower_ms"] = (time.perf_counter() - t0) * 1000
        metrics["fused"] = plan.fused_reason is None
        if plan.fused_reason is not None:
            metrics["fused_reason"] = plan.fused_reason
        specs = agg_specs_by_name(query.aggregations)
        # theta set-op post-aggregations read RAW sketch tables on the
        # host; the packed route finalizes sketches on the device
        keep_raw = theta_raw_fields(query.post_aggregations)

        if plan.sparse:
            metrics["route"] = "sparse"
            out = self._dispatch(lambda: self._run_sparse(plan, metrics),
                                 metrics, table.name)
            t0 = time.perf_counter()
            with self.stages.stage("finalize", metrics):
                with _span("finalize"):
                    arrays = finalize_aggs(out, plan.agg_plans, specs,
                                           keep_raw)
                with _span("post-agg"):
                    eval_post_aggs(arrays, query.post_aggregations)
            names = self._out_names(query)
            pm = out["_keys"] != SENTINEL  # empty slots fill the tail
            present = out["_keys"][pm]
            sub = {n: np.asarray(arrays[n])[pm] for n in names}
            with self.stages.stage("assemble", metrics), _span("assemble"):
                res = self._emit_groupby(query, plan, present, sub)
            res.metrics = metrics
            metrics["assemble_ms"] = (time.perf_counter() - t0) * 1000
            return res

        arrays = None
        if self.result_cache.seg_enabled:
            arrays = self._run_agg_segcached(query, plan, metrics, specs,
                                             keep_raw, table)
            t0 = time.perf_counter()
        if arrays is None:
            # a mesh merges unfinalized partials: no packed route
            packed = None if keep_raw or self.mesh is not None \
                else self._dispatch(
                    lambda: self._run_packed(plan, metrics), metrics,
                    table.name)
            if packed is not None:
                metrics["route"] = "packed"
                idx, compact, layout = packed
                t0 = time.perf_counter()
                for p in plan.agg_plans:
                    if p.kind == "hll" and \
                            getattr(specs.get(p.name), "round", True):
                        compact[p.name] = np.round(compact[p.name])
                with self.stages.stage("finalize", metrics), \
                        _span("finalize"):
                    arrays = densify(idx, compact, layout, plan.agg_plans)
            else:
                # theta set ops, a packed overflow past
                # result_group_cap, or a mesh
                metrics["route"] = "unpacked"
                partials = self._dispatch(
                    lambda: self._run_partials(plan, metrics), metrics,
                    table.name)
                t0 = time.perf_counter()
                with self.stages.stage("finalize", metrics), \
                        _span("finalize"):
                    arrays = finalize_aggs(partials, plan.agg_plans, specs,
                                           keep_raw)
        with self.stages.stage("finalize", metrics), _span("post-agg"):
            eval_post_aggs(arrays, query.post_aggregations)
        with self.stages.stage("assemble", metrics), _span("assemble"):
            res = self._assemble_agg(query, plan, arrays)
        res.metrics = metrics
        metrics["assemble_ms"] = (time.perf_counter() - t0) * 1000
        return res

    def _run_agg_segcached(self, query, plan, metrics, specs, keep_raw,
                           table):
        """Tier-1 per-segment partial-aggregate path: serve every cached,
        fully interval-covered segment from the cache, compute the rest
        in ONE launch that keys the group space by (segment, group) so
        that each computed segment's partials come back apart
        (cacheable), then fold everything on the host with the
        aggregators' merge and finalize. Returns finalized arrays, or
        None when the plan bypasses the tier (the caller takes the
        packed or unpacked route); `segment_cache` in the metrics says
        why."""
        import functools

        rc = self.result_cache
        if in_introspection():
            return None
        reason = rc.tier1_bypass_reason(plan, self.mesh)
        if reason is not None:
            metrics["segment_cache"] = f"bypass: {reason}"
            rc.count_bypass()
            return None
        metrics["route"] = "segment_cache"
        intervals = query.intervals or (ETERNITY,)
        tkey = rc.template_key(query, table)
        floor = max(0, int(self.config.segment_cache_min_rows))
        covered, always_compute = [], []
        for sid in plan.pruned_ids:
            sm = table.segments[sid].meta
            # only segments ENTIRELY inside one query interval have
            # interval-independent partials; straddlers and segments
            # under the floor are computed every time and never stored
            if sm.n_valid >= floor and table.segment_sealed(sid) and any(
                    iv.start <= sm.time_min and iv.end > sm.time_max
                    for iv in intervals):
                covered.append(sid)
            else:
                always_compute.append(sid)
        with _span("segment-cache") as sp:
            hits = rc.get_segments(tkey, table, plan, covered)
            to_compute = sorted([s for s in covered if s not in hits]
                                + always_compute)
            sp.set(segments_cached=len(hits),
                   segments_computed=len(to_compute),
                   segments_uncovered=len(always_compute))
            if to_compute:
                fresh = self._dispatch(
                    lambda: self._run_seg_partials(plan, metrics,
                                                   to_compute),
                    metrics, table.name)
                storable = set(covered)
                for sid in to_compute:
                    if sid in storable:
                        rc.put_segment(tkey, table, plan, sid, fresh[sid])
            else:
                fresh = {}
                metrics["segments_total"] = len(table.segments)
                metrics["segments_scanned"] = 0
                metrics["rows_scanned"] = 0
        metrics["cache_hit"] = bool(hits)
        if hits:
            metrics["cache_tier"] = "segment"
        metrics["segments_cached"] = len(hits)
        metrics["segments_computed"] = len(to_compute)
        parts = [hits[s] if s in hits else fresh[s]
                 for s in sorted(set(covered) | set(always_compute))]
        merged = functools.reduce(
            lambda a, b: merge_partials(a, b, plan.agg_plans), parts)
        with self.stages.stage("finalize", metrics), _span("finalize"):
            return finalize_aggs(merged, plan.agg_plans, specs, keep_raw)

    def _run_seg_partials(self, plan: PhysicalPlan, metrics: dict,
                          compute_ids: list) -> dict:
        """One pass computing PER-SEGMENT partials for `compute_ids`:
        {segment id: partials dict of CPU tensors}. The group key is
        extended to (window segment, group) over the window [lo, lo + W)
        of the segments to compute (W a power of two, so that a plan
        compiles at most log2(S) variants and a sliding window of the
        same W compiles nothing), and the segment mask admits only
        `compute_ids`. Under a mesh: `_run_seg_partials_mesh`. Fused plans launch the segment-extended fused
        reduce once (kernels.fused_reduce.fused_reduce_seg); others (HLL,
        theta) run the generic reduce with the same extended key. Either
        way one copy, queued in stage 1 and read in stage 2, brings every
        segment's partials back. A failure raises: nothing serves the
        plain path in its place."""
        if self.mesh is not None:
            return self._run_seg_partials_mesh(plan, metrics, compute_ids)
        table = plan.table
        K = plan.total_groups
        win = []

        def launch():
            env, valid, _, consts = self._prepare(plan, metrics)
            seg_mask = self._dataset(table).segment_mask(compute_ids)
            S = valid.shape[0]
            lo, hi = min(compute_ids), max(compute_ids) + 1
            W = min(_next_pow2(hi - lo), S)
            lo = min(lo, S - W)
            win[:] = [lo, W]
            return _seg_partials(plan, env, valid, seg_mask, consts, lo, W)

        t0 = time.perf_counter()
        with self._pipeline_slot(), self._observe_compiles():
            host = self._staged_fetch(launch, metrics)
        lo, W = win
        # only the computed segments are read
        metrics["segments_scanned"] = len(compute_ids)
        metrics["rows_scanned"] = int(sum(
            table.segments[i].meta.n_valid for i in compute_ids))
        metrics["segments_window"] = W
        metrics["execute_ms"] = (time.perf_counter() - t0) * 1000
        # the cache keeps these: copies in pageable memory, not views of
        # the pinned copy
        shaped = {n: torch.from_numpy(a.copy()).reshape(
                  (W, K) + a.shape[1:]) for n, a in host.items()}
        return {sid: {n: a[sid - lo] for n, a in shaped.items()}
                for sid in compute_ids}

    def _run_seg_partials_mesh(self, plan: PhysicalPlan, metrics: dict,
                               compute_ids: list) -> dict:
        """`_run_seg_partials` over the mesh: one segment-extended launch
        per device over the LOCAL window [lo, lo + W) that covers every
        computed segment's local index (logical segment i is local i // D
        on device i mod D), one copy per device, and one cache shard per
        computed segment cut from its device's [W * K] table. `lo` is a
        launch argument, so a sliding window of the same W compiles
        nothing."""
        mesh = self.mesh
        D = mesh.size
        table = plan.table
        K = plan.total_groups
        win = []

        def launch():
            env, valid, _, consts = self._prepare(plan, metrics)
            seg_mask = self._dataset(table).segment_mask(compute_ids)
            per_chip = valid[0].shape[0]
            lo = min(i // D for i in compute_ids)
            hi = max(i // D for i in compute_ids) + 1
            W = min(_next_pow2(hi - lo), per_chip)
            lo = min(lo, per_chip - W)
            win[:] = [lo, W]
            outs = sh.launch_per_device(
                mesh, lambda e, v, m, c: _seg_partials(plan, e, v, m, c,
                                                       lo, W),
                sh.device_args(env, valid, seg_mask, consts))
            self._note_chip_dispatch(mesh.local_ids)
            return outs

        t0 = time.perf_counter()
        with self._pipeline_slot(), self._observe_compiles():
            hosts = self._staged_fetch_all(launch, metrics)
        lo, W = win
        metrics["segments_scanned"] = len(compute_ids)
        metrics["rows_scanned"] = int(sum(
            table.segments[i].meta.n_valid for i in compute_ids))
        metrics["segments_window"] = W * D
        metrics["segments_window_per_chip"] = W
        metrics["num_shards"] = D
        metrics["execute_ms"] = (time.perf_counter() - t0) * 1000
        shaped = [{n: torch.from_numpy(a.copy()).reshape((W, K) + a.shape[1:])
                   for n, a in host.items()} for host in hosts]
        return {sid: {n: a[sid // D - lo]
                      for n, a in shaped[sid % D].items()}
                for sid in compute_ids}

    def compute_partials(self, query, table):
        """Run an aggregation query and return its RAW mergeable
        partials instead of finalized rows: the cube materializer's
        entry point (tpu_olap_torch.cubes). Returns (plan, present flat
        group ids [G] int64, {name: [G, ...] compact partial arrays},
        metrics). Rides the cached lowering and the dense partials route
        (the fused reduce on the card, one copy) or the sparse route,
        under an admission slot, the breaker check and the retry layer
        (dispatch_lock as the mode says), so that a background cube
        build queues behind (and sheds with) foreground traffic. No
        deadline: a rollup over the whole table is legitimate
        long-running background work."""
        lock = nullcontext() if self._pipelined else \
            self._timed_dispatch_lock()
        with self.admission.slot(self.config.query_deadline_s), lock, \
                self._observe_compiles():
            self.breaker.check()
            metrics = self.last_metrics = {"host_copies": 0}
            with _span("lower"):
                plan = self._lower_cached(query, table)
            if plan.kind != "agg":
                raise UnsupportedAggregation(
                    f"{query.query_type} has no mergeable partials")
            metrics["fused"] = plan.fused_reason is None
            if plan.sparse:
                metrics["route"] = "sparse"
                out = self._dispatch(
                    lambda: self._run_sparse(plan, metrics), metrics,
                    table.name)
                pm = out["_keys"] != SENTINEL
                present = out["_keys"][pm].astype(np.int64)
                compact = {k: np.asarray(v)[pm] for k, v in out.items()
                           if not k.startswith("_") or k == "_rows"
                           or k.startswith("_nn_")}
            else:
                metrics["route"] = "unpacked"
                partials = self._dispatch(
                    lambda: self._run_partials(plan, metrics), metrics,
                    table.name)
                present = np.nonzero(partials["_rows"] > 0)[0] \
                    .astype(np.int64)
                compact = {k: np.asarray(v)[present]
                           for k, v in partials.items()}
        return plan, present, compact, metrics

    def _assemble_agg(self, query, plan, arrays) -> QueryResult:
        """Final-arrays -> QueryResult by query type."""
        if isinstance(query, TimeseriesQuerySpec):
            return self._assemble_timeseries(query, plan, arrays)
        if isinstance(query, GroupByQuerySpec):
            return self._assemble_groupby(query, plan, arrays)
        return self._assemble_topn(query, plan, arrays)

    def _out_names(self, query):
        names = [a.name for a in query.aggregations]
        names += [p.name for p in query.post_aggregations]
        return names

    def _bucket_emit_ids(self, query, plan):
        """Bucket ids to emit, honoring intervals and descending order."""
        if plan.empty:
            return []
        intervals = query.intervals or (ETERNITY,)
        starts = plan.bucket_plan.starts
        ids = [b for b in range(plan.bucket_plan.n_buckets)
               if any(iv.overlaps(int(starts[b]),
                                  int(starts[b + 1])
                                  if b + 1 < len(starts) else plan.t_max + 1)
                      for iv in intervals)]
        return ids

    def _assemble_timeseries(self, query, plan, arrays) -> QueryResult:
        names = self._out_names(query)
        rows, druid = [], []
        skip_empty = bool(dict(query.context).get(
            "skipEmptyBuckets", self.config.skip_empty_buckets))
        bucket_ids = self._bucket_emit_ids(query, plan)
        if query.descending:
            bucket_ids = bucket_ids[::-1]
        present = arrays["_rows"] > 0
        for b in bucket_ids:
            if skip_empty and not present[b]:
                continue
            vals = {n: render_value(arrays[n][b]) for n in names}
            ts = iso(plan.bucket_plan.starts[b])
            rows.append({"timestamp": ts, **vals})
            druid.append({"timestamp": ts, "result": vals})
        return QueryResult(query, rows, druid)

    def _decode_groups(self, plan, idx: np.ndarray):
        """Present flat group ids -> (bucket ids, {dim name -> values})."""
        sizes = plan.sizes
        rem = idx
        radix_vals = []
        for s in sizes[::-1]:
            radix_vals.append(rem % s)
            rem = rem // s
        radix_vals = radix_vals[::-1]  # bucket first, then dims in order
        buckets = radix_vals[0]
        dim_vals = {}
        for dp, ids in zip(plan.dim_plans, radix_vals[1:]):
            dim_vals[dp.name] = dp.labels[ids]
        return buckets, dim_vals

    def _assemble_groupby(self, query, plan, arrays) -> QueryResult:
        names = self._out_names(query)
        present = np.nonzero(arrays["_rows"] > 0)[0]
        sub = {n: np.asarray(arrays[n])[present] for n in names}
        return self._emit_groupby(query, plan, present, sub)

    def _emit_groupby(self, query, plan, present, sub) -> QueryResult:
        """present: flat group ids (any int width); sub: compact per-group
        final values."""
        names = self._out_names(query)
        buckets, dim_vals = self._decode_groups(plan, present)

        if query.having is not None:
            hmask = eval_having(query.having, sub, dim_vals)
            present = present[hmask]
            buckets = buckets[hmask]
            dim_vals = {k: v[hmask] for k, v in dim_vals.items()}
            sub = {k: v[hmask] for k, v in sub.items()}

        order = np.arange(len(present))
        ls = query.limit_spec
        if ls is not None and ls.columns:
            keys = []
            for c in ls.columns[::-1]:
                if c.dimension == "timestamp":
                    k = np.asarray(buckets, np.float64)
                elif c.dimension in dim_vals:
                    v = dim_vals[c.dimension]
                    k = np.asarray([("" if x is None else str(x)) for x in v])
                    if c.dimension_order == "numeric":
                        k = np.asarray([float(x) if x else -np.inf for x in k])
                else:
                    k = np.asarray(sub[c.dimension], np.float64)
                if c.direction == "descending":
                    k = _invert_sort_key(k)
                keys.append(k)
            order = np.lexsort(keys)
        if ls is not None:
            lo = ls.offset
            hi = None if ls.limit is None else lo + ls.limit
            order = order[lo:hi]

        rows, druid = [], []
        starts = plan.bucket_plan.starts
        for i in order:
            ts = iso(starts[buckets[i]])
            ev = {dp.name: render_value(dim_vals[dp.name][i])
                  for dp in plan.dim_plans}
            ev.update({n: render_value(sub[n][i]) for n in names})
            rows.append({"timestamp": ts, **ev})
            druid.append({"version": "v1", "timestamp": ts, "event": ev})
        return QueryResult(query, rows, druid)

    def _assemble_topn(self, query, plan, arrays) -> QueryResult:
        names = self._out_names(query)
        n_b = plan.sizes[0]
        d_size = plan.sizes[1]
        metric = np.asarray(arrays[query.metric], np.float64) \
            .reshape(n_b, d_size)
        present = (arrays["_rows"] > 0).reshape(n_b, d_size)
        dp = plan.dim_plans[0]
        rows, druid = [], []
        for b in self._bucket_emit_ids(query, plan):
            m = np.where(present[b],
                         -metric[b] if query.inverted else metric[b],
                         -np.inf)
            order = np.argsort(-m, kind="stable")
            order = order[m[order] > -np.inf][:query.threshold]
            ts = iso(plan.bucket_plan.starts[b])
            result = []
            for g in order:
                flat = b * d_size + g
                ev = {dp.name: render_value(dp.labels[g])}
                ev.update({n: render_value(np.asarray(arrays[n])[flat])
                           for n in names})
                result.append(ev)
                rows.append({"timestamp": ts, **ev})
            druid.append({"timestamp": ts, "result": result})
        return QueryResult(query, rows, druid)

    # ----------------------------------------------------------- scan paths

    def _run_mask(self, plan: PhysicalPlan, metrics: dict) -> torch.Tensor:
        """The plan's row mask over the dispatched segment window, on the
        device: bool [W, R] (the whole stack when no window is cut)."""
        args = self._dispatch_args(plan, metrics)
        metrics["mask_kernel"] = plan.mask_reason is None
        if plan.mask_reason is not None:
            metrics["mask_reason"] = plan.mask_reason
        return plan.kernel(*args)

    def _run_scan(self, query, table) -> QueryResult:
        metrics = self.last_metrics = {"host_copies": 0, "route": "mask"}
        t0 = time.perf_counter()
        with _span("lower"):
            plan = self._lower_cached(query, table)
        metrics["lower_ms"] = (time.perf_counter() - t0) * 1000
        t0 = time.perf_counter()

        def fetch_mask():
            if self.mesh is not None:
                # per device, back in logical segment order
                return self._run_partials_mesh(plan, metrics)
            with self._pipeline_slot():
                return self._staged_fetch(
                    lambda: self._run_mask(plan, metrics), metrics)
        mask = self._dispatch(fetch_mask, metrics, table.name)
        metrics["execute_ms"] = (time.perf_counter() - t0) * 1000
        mask = _embed_windowed_mask(
            mask, self._segment_window(plan, len(table.segments)),
            len(table.segments))

        t0 = time.perf_counter()
        if isinstance(query, ScanQuerySpec):
            cols = list(query.columns) if query.columns else \
                [c for c in table.schema]
            offset, limit = query.offset, query.limit
            descending = query.order == "descending"
        else:
            dims = list(query.dimensions) or [
                c for c, t in table.schema.items() if t.is_dim]
            mets = list(query.metrics) or [
                c for c, t in table.schema.items()
                if not t.is_dim and c != TIME_COLUMN]
            cols = [TIME_COLUMN] + dims + mets
            offset, limit = query.paging_offset, query.page_size
            descending = query.descending
        with self.stages.stage("assemble", metrics), _span("assemble"):
            events = _gather_rows(table, mask, cols, offset, limit,
                                  descending)
        metrics["assemble_ms"] = (time.perf_counter() - t0) * 1000

        if isinstance(query, ScanQuerySpec):
            druid = [{"columns": cols, "events": events}]
        else:
            druid = [{
                "timestamp": iso(plan.t_min),
                "result": {
                    "pagingIdentifiers": {"offset": offset + len(events)},
                    "events": [{"offset": offset + i, "event": e}
                               for i, e in enumerate(events)],
                },
            }]
        return QueryResult(query, events, druid, metrics)

    # ------------------------------------------------------------- metadata

    def _run_search(self, query, table) -> QueryResult:
        """One row-mask launch (filter + interval) shared by every coded
        dimension, whose value counts under the mask are taken on the
        device and packed into one vector: one copy back. A numeric
        dimension (no dictionary) runs a GroupBy of its own."""
        metrics = {"host_copies": 0, "route": "mask"}
        dims = list(query.search_dimensions) or [
            c for c, t in table.schema.items() if t.is_dim]
        matcher = _search_matcher(query.query)
        hits = []

        coded = [d for d in dims if d in table.dictionaries]
        if coded:
            mask_query = ScanQuerySpec(
                data_source=query.data_source,
                intervals=query.intervals,
                filter=query.filter,
                virtual_columns=query.virtual_columns,
            )
            t0 = time.perf_counter()
            plan = self._lower_cached(mask_query, table)
            metrics["lower_ms"] = (time.perf_counter() - t0) * 1000
            t0 = time.perf_counter()
            win = self._segment_window(plan, len(table.segments))
            sl = slice(None) if win is None else slice(win[0],
                                                       win[0] + win[1])
            cards = [table.dictionaries[d].cardinality for d in coded]

            def counts():
                mask = self._run_mask(plan, metrics).reshape(-1)
                ds = self._dataset(table)
                return search_counts(
                    mask, [ds.col(d)[sl].reshape(-1) for d in coded],
                    cards)

            def fetch_counts():
                if self.mesh is not None:
                    return self._search_counts_mesh(plan, table, coded,
                                                    cards, metrics)
                with self._pipeline_slot():
                    return self._staged_fetch(counts, metrics)
            packed = self._dispatch(fetch_counts, metrics, table.name)
            metrics["execute_ms"] = (time.perf_counter() - t0) * 1000
            off = 0
            for dim, card in zip(coded, cards):
                d = table.dictionaries[dim]
                counts = packed[off:off + card + 1]
                off += card + 1
                for code in np.nonzero(counts[1:])[0]:
                    v = d.values[code]
                    if matcher(v):
                        hits.append({"dimension": dim, "value": v,
                                     "count": int(counts[code + 1])})

        numeric = [d for d in dims if d not in table.dictionaries]
        if numeric:
            metrics["numeric_dims"] = {}
        for dim in numeric:
            inner = GroupByQuerySpec(
                data_source=query.data_source,
                intervals=query.intervals,
                filter=query.filter,
                virtual_columns=query.virtual_columns,
                dimensions=(DefaultDimensionSpec(dim),),
                aggregations=(CountAggregation("count"),),
            )
            res = self._run_agg(inner, table)
            metrics["host_copies"] += res.metrics["host_copies"]
            metrics["numeric_dims"][dim] = {
                k: res.metrics.get(k) for k in ("route", "fused",
                                                "fused_reason")}
            for r in res.rows:
                # a search matches and reports a value's string form
                # (Druid's); the JAX package hands the raw number to the
                # matcher, which raises
                v = None if r[dim] is None else str(r[dim])
                if v is not None and matcher(v):
                    hits.append({"dimension": dim, "value": v,
                                 "count": int(r["count"])})
        self.last_metrics = metrics
        hits.sort(key=lambda h: (_search_sort_key(query.sort, h["value"]),
                                 h["dimension"]))
        hits = hits[:query.limit]
        t0, _ = table.time_boundary
        druid = [{"timestamp": iso(t0), "result": hits}]
        return QueryResult(query, hits, druid, metrics)

    def _search_counts_mesh(self, plan, table, coded, cards, metrics):
        """Search's code counts over the mesh: per device, the row mask
        and the counts of its own rows (one copy each), summed on the
        host; padding segments are invalid rows and count nothing.
        Across processes every rank's sum crosses in one gather_masks."""
        mesh = self.mesh

        def launch():
            env, valid, seg_mask, consts = self._prepare(plan, metrics)
            metrics["mask_kernel"] = plan.mask_reason is None
            if plan.mask_reason is not None:
                metrics["mask_reason"] = plan.mask_reason
            masks = sh.launch_per_device(
                mesh, plan.kernel,
                sh.device_args(env, valid, seg_mask, consts))
            self._note_chip_dispatch(mesh.local_ids)
            ds = self._dataset(table)
            return sh.map_shards(
                mesh, lambda m, *cs: search_counts(
                    m.reshape(-1), [x.reshape(-1) for x in cs], cards),
                masks, *[ds.col(d) for d in coded])

        def merge(hosts):
            # across processes: every rank's sum, added in rank order
            with sh.on_device(mesh.devices[0]):
                return np.sum([t.cpu().numpy() for t in collective.
                               gather_masks(np.sum(hosts, axis=0),
                                            metrics=metrics)], axis=0)

        with self._pipeline_slot():
            out = self._staged_fetch_all(
                launch, metrics,
                merge=merge if sh.is_multihost(mesh) else None)
        metrics["num_shards"] = mesh.size
        return out if sh.is_multihost(mesh) else np.sum(out, axis=0)

    def _run_time_boundary(self, query, table) -> QueryResult:
        self.last_metrics = {"host_copies": 0, "route": "manifest"}
        t0, t1 = table.time_boundary
        intervals = query.intervals or (ETERNITY,)
        lo = max(t0, min(iv.start for iv in intervals))
        hi = min(t1, max(iv.end for iv in intervals) - 1)
        result = {}
        if query.bound in (None, "minTime"):
            result["minTime"] = iso(lo)
        if query.bound in (None, "maxTime"):
            result["maxTime"] = iso(hi)
        druid = [{"timestamp": iso(lo), "result": result}]
        return QueryResult(query, [result], druid, self.last_metrics)

    def _run_segment_metadata(self, query, table) -> QueryResult:
        self.last_metrics = {"host_copies": 0, "route": "manifest"}
        cols = table.column_metadata(set(query.to_include) or None)
        t0, t1 = table.time_boundary
        record = {
            "id": f"{table.name}_merged",
            "intervals": [f"{iso(t0)}/{iso(t1 + 1)}"],
            "columns": cols,
            "numRows": table.num_rows,
            "size": int(sum(c.get("size", 0) for c in cols.values())),
        }
        return QueryResult(query, [record], [record], self.last_metrics)


def _seg_partials(plan, env, valid, seg_mask, consts, lo: int, W: int):
    """Per-segment partials of the window [lo, lo + W) on one device:
    the group key extended to (window segment, group). Fused plans run
    the segment-extended fused reduce (one launch); others (HLL, theta)
    the generic reduce with the same extended key."""
    K = plan.total_groups
    if plan.fused_reason is None:
        prog = fused_reduce.program(plan, plan.table)
        sums, mins = fused_reduce.fused_reduce_seg(
            prog, fused_reduce.program_inputs(prog, env), valid, seg_mask,
            K, lo, W)
        return fused_reduce.partials(plan, sums, mins)
    sl = slice(lo, lo + W)
    flat = {kind: {c: a[sl].reshape(-1) for c, a in env[kind].items()}
            for kind in ("cols", "nulls")}
    base = (valid[sl] & seg_mask[sl, None]).reshape(-1)
    key, mask, fenv = plan.front_half(flat, base, consts)
    seg_local = torch.arange(W, dtype=torch.int32, device=key.device) \
        .repeat_interleave(valid.shape[1])
    # int32 is safe: tier1_bypass_reason refuses key spaces of 2^31 and
    # more
    key2 = seg_local * K + key.to(torch.int32)
    return group_reduce(key2, mask, fenv, plan.agg_plans, W * K, consts)


def _concat_owner_tables(owners: list) -> dict:
    """The exchange's owner tables (host numpy, each compact: its first
    `_count` slots live) -> one compact table of their disjoint keys in
    key order, as the single-device sparse route gives it."""
    counts = [int(o["_count"]) for o in owners]
    out = {n: np.concatenate([o[n][:k] for o, k in zip(owners, counts)])
           for n in owners[0] if n != "_count"}
    order = np.argsort(out["_keys"], kind="stable")
    out = {n: v[order] for n, v in out.items()}
    out["_count"] = np.int32(sum(counts))
    return out


def search_counts(mask: torch.Tensor, codes: list, cards: list) -> \
        torch.Tensor:
    """Per coded dimension, the count of each dictionary code (0 = null)
    among the rows the mask admits, packed into one int64 vector of
    sum(card + 1) slots in dimension order.

    Each dimension is one shared-memory histogram over its codes
    (torch.histc on float64: exact below 2^53 rows, and a bin is exactly
    its code), with the rows outside the mask sent below the histogram's
    range, where histc drops them. Unlike torch.bincount it reads no
    value back to the host, and unlike a scatter-add it does not
    serialise millions of atomics on a few addresses."""
    outs = []
    for col, card in zip(codes, cards):
        x = torch.where(mask, col.to(torch.float64), -1.0)
        outs.append(torch.histc(x, bins=card + 1, min=-0.5,
                                max=card + 0.5))
    return torch.cat(outs).to(torch.int64)


def _embed_windowed_mask(mask: np.ndarray, win, n_segments: int) -> \
        np.ndarray:
    """A mask over the dispatched segment window back into the full
    segment stack, [S, R]: the assembly indexes rows by global segment
    id, and the segments outside the window were pruned, so their rows
    are all False."""
    if win is None:
        return mask.reshape(n_segments, -1)
    lo, W = win
    w = mask.reshape(W, -1)
    full = np.zeros((n_segments, w.shape[1]), bool)
    full[lo:lo + W] = w
    return full


def _gather_rows(table, mask, cols, offset, limit, descending):
    """Columnar assembly: pick (segment, row) takes under the
    offset/limit budget, then decode and convert each column once
    (dictionary decode, tolist, null substitution) and zip into the
    wire's list of dicts at the end."""
    seg_iter = table.segments[::-1] if descending else table.segments
    takes = []       # (segment, row-index array)
    n_taken = 0
    skipped = 0
    budget = None if limit is None else offset + limit
    for s in seg_iter:
        m = mask[s.meta.segment_id]
        idx = np.nonzero(m)[0]
        if descending:
            idx = idx[::-1]
        if idx.size == 0:
            continue
        if budget is not None and skipped + n_taken + idx.size > budget:
            idx = idx[:budget - skipped - n_taken]
        take = idx
        if skipped < offset:
            drop = min(offset - skipped, take.size)
            skipped += drop
            take = take[drop:]
        if take.size:
            takes.append((s, take))
            n_taken += take.size
        if budget is not None and skipped + n_taken >= budget:
            break
    if not takes:
        return []

    out_cols = []
    for c in cols:
        v = np.concatenate([s.columns[c][take] for s, take in takes])
        d = table.dictionaries.get(c)
        if d is not None:
            out_cols.append(d.decode(v).tolist())
            continue
        vals = v.tolist()  # numpy -> plain python in C
        if any(c in s.null_masks for s, _ in takes):
            nm = np.concatenate(
                [s.null_masks[c][take] if c in s.null_masks
                 else np.zeros(take.size, bool) for s, take in takes])
            if nm.any():
                vals = [None if n else x for x, n in zip(vals, nm)]
        if v.dtype.kind == "f":
            vals = [None if x != x else x for x in vals]  # NaN -> null
        out_cols.append(vals)
    return [dict(zip(cols, row)) for row in zip(*out_cols)]


def _search_sort_key(sort: str, value: str):
    if sort == "strlen":
        return (len(value), value)
    if sort == "alphanumeric":
        # natural order: digit runs compare numerically
        import re
        parts = re.split(r"(\d+)", value)
        return tuple((1, int(p)) if p.isdigit() else (0, p)
                     for p in parts if p != "")
    return value  # lexicographic


def _search_matcher(sq):
    if sq.fragments:
        frags = [f if sq.case_sensitive else f.lower() for f in sq.fragments]

        def m(v):
            s = v if sq.case_sensitive else v.lower()
            return all(f in s for f in frags)
        return m
    needle = sq.value if sq.case_sensitive else sq.value.lower()

    def m(v):
        s = v if sq.case_sensitive else v.lower()
        return needle in s
    return m


def wait_event(event) -> None:
    """Stage 2's wait for its copy: the CUDA event recorded after the
    queued device-to-host copy (it releases the GIL while it blocks). A
    module function, so that a caller can wrap the one wait of a
    route — chip_smoke.py lifts torch's sync debug mode around it."""
    event.synchronize()


def _np_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


def _world() -> int:
    """The processes of the default torch.distributed group (1 when no
    group is initialized)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _invert_sort_key(k: np.ndarray):
    if k.dtype.kind in "fiu":
        return -k.astype(np.float64)
    # lexicographic descending for strings: invert via codes trick
    uniq, inv = np.unique(k, return_inverse=True)
    return -inv

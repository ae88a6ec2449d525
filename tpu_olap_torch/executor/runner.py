"""QueryRunner: execute a QuerySpec against a registered table.

The analog of the reference's DruidRDD.compute + broker round-trip
(SURVEY.md §4.2) collapsed into an in-process call: lower -> device
dispatch over the resident column stacks -> ONE device-to-host copy ->
host finalize and assembly.

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
that gathers concurrent `execute` callers into one batch. Device work
runs under `dispatch_lock`; coalesced callers wait outside it.

The semantic result cache (executor.resultcache) sits in front: tier 2
serves a repeated aggregate's whole result before the lock, with no
launch and no copy; tier 1 serves the segments a moving window has seen
and computes the rest in one launch of the segment-extended fused reduce
(`_run_agg_segcached`). Every table's resident stacks are accounted in
one HbmLedger under `hbm_budget_bytes`. `compute_partials` is the cube
materializer's entry point, and `workload` profiles every completed
statement for the cube advisor.

Resilience, as in the JAX package: `execute` checks the full-result
cache, then the circuit breaker, the coalescer, an admission slot and
`dispatch_lock`, in that order. Every device dispatch runs through
`_dispatch`: the "dispatch" fault site, up to `dispatch_retries + 1`
attempts with the table's resident state purged between them, the
retried errors in the metrics (`retries`, `retry_errors`), and one
breaker failure when the attempts run out. The last error then
propagates (the engine serves the statement from the fallback
interpreter when `fallback_on_device_failure` is set). The "host-transfer"
site fires before each device-to-host copy and rides the same
accounting. The breaker's healer probes the device on its own thread
(`_probe_device`: a small reduction and a stream synchronize on the
card) and on success evicts the resident datasets, keeping the compiled
kernels. `stages`, the StageScheduler, runs the background graphs
(compactor, WAL flush, cube maintainer). The per-query deadline with
its wedge recovery and the pipelined two-stage mode come with ROADMAP
queue A item 12b, the mesh with item 13.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

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
from tpu_olap_torch.kernels import fused_reduce
from tpu_olap_torch.kernels.groupby import (UnsupportedAggregation,
                                            group_reduce, merge_partials)
from tpu_olap_torch.kernels.sparse_groupby import SENTINEL
from tpu_olap_torch.ir.query import (GroupByQuerySpec, ScanQuerySpec,
                                     SearchQuerySpec,
                                     SegmentMetadataQuerySpec,
                                     SelectQuerySpec, TimeBoundaryQuerySpec,
                                     TimeseriesQuerySpec, TopNQuerySpec)
from tpu_olap_torch.obs.workload import (WorkloadProfiler, fingerprint_ir,
                                         in_introspection)
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


_nesting = threading.local()


@contextlib.contextmanager
def nested_execution():
    """Mark the statements run inside this block, on this thread, as
    nested in an outer one (inlined subqueries, derived bodies): they
    dispatch directly and never enter the coalescer, whose leader would
    run them on its own thread outside the outer statement."""
    _nesting.depth = getattr(_nesting, "depth", 0) + 1
    try:
        yield
    finally:
        _nesting.depth -= 1


def in_nested_execution() -> bool:
    return getattr(_nesting, "depth", 0) > 0


class QueryRunner:
    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device)
        # serializes device dispatch and the caches below; the engine's
        # device_lock is this object. Coalesced callers wait outside it
        # and the batch leader takes it (executor.batch).
        self.dispatch_lock = threading.RLock()
        self._datasets: dict[str, DeviceDataset] = {}
        self._plan_cache: dict = {}
        # last observed group count per query template and route: sizes
        # the next run's packed / sparse cap
        self._cap_hints: dict = {}
        self._tls = threading.local()   # per-thread last_metrics
        self._coalescer = None
        self._batch_seq = 0
        # one ledger over every table's resident stacks; per-chip
        # attribution comes with the multi-GPU port (item 13)
        self._ledger = HbmLedger(self.config.hbm_budget_bytes)
        self.result_cache = ResultCache(self.config)
        self.workload = WorkloadProfiler(
            max_templates=self.config.workload_max_templates,
            latency_window=self.config.workload_latency_window,
            enabled=self.config.workload_profile_enabled)
        # bounded admission in front of dispatch_lock, and the device
        # circuit breaker whose healer probes through _healer_probe
        self.admission = AdmissionController(
            self.config.max_inflight_dispatches,
            self.config.admission_queue_limit)
        self.breaker = CircuitBreaker(
            self.config.breaker_failure_threshold,
            self.config.breaker_open_cooldown_s,
            probe=self._healer_probe)
        self._attempt_local = threading.local()  # the dispatch attempt
        # the stage scheduler: the background periodic graphs (compactor,
        # WAL flush, cube maintainer) run on its background pool
        self.stages = StageScheduler(self.config, admission=self.admission,
                                     inject=self._inject)
        if (self.config.batch_window_ms or 0) > 0:
            self.set_batch_window(self.config.batch_window_ms)

    def _inject(self, stage: str):
        """Fire the configured fault injector at `stage` with the current
        dispatch attempt (set by _dispatch), so that a fault at e.g.
        host-transfer rides the same retry accounting as a dispatch
        fault."""
        maybe_inject(self.config, stage,
                     getattr(self._attempt_local, "value", 0))

    @property
    def last_metrics(self) -> dict:
        """The metrics of the last query this thread ran."""
        return getattr(self._tls, "metrics", {})

    @last_metrics.setter
    def last_metrics(self, metrics: dict):
        self._tls.metrics = metrics

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

    def _execute_batch_boxed(self, queries, table) -> list:
        from tpu_olap_torch.executor.batch import run_batch
        # one admission slot per batch submission: the shared pass is one
        # device occupancy however many statements ride it
        with self.admission.slot(None):
            with self.dispatch_lock:
                return run_batch(self, queries, table)

    def _next_batch_id(self) -> int:
        self._batch_seq += 1
        return self._batch_seq

    def execute(self, query, table) -> QueryResult:
        # the full-result cache first: a hit takes no slot and no lock,
        # launches nothing and copies nothing, and keeps serving through
        # an open breaker
        res = self._serve_full_cache(query, table)
        if res is not None:
            self.last_metrics = res.metrics
            return res
        # the breaker next: while open, fail in microseconds (the engine
        # serves fallback-capable statements from the interpreter)
        # instead of queueing work onto a sick device
        self.breaker.check()
        if self._coalescer is not None and not in_nested_execution():
            from tpu_olap_torch.executor.batch import AGG_QUERY_TYPES
            if isinstance(query, AGG_QUERY_TYPES):
                # waits outside dispatch_lock so that concurrent callers
                # can coalesce; the batch leader takes it
                res = self._coalescer.submit(query, table)
                self.last_metrics = res.metrics
                return res
        with self.admission.slot(None):
            with self.dispatch_lock:
                self.breaker.check()
                return self._execute(query, table)

    def _dispatch(self, call, metrics: dict, table_name: str):
        """Run one device dispatch with retry-based recovery: on failure,
        purge the table's resident state (its stacks could be poisoned
        by a device reset; other tables' stay warm) and re-run, up to
        `dispatch_retries + 1` attempts. Every retried error is kept in
        metrics["retry_errors"]; exhausting the attempts counts one
        breaker failure and re-raises. Structural refusals
        (UnsupportedAggregation) and taxonomy errors (QueryError) pass
        through untouched: retrying cannot change them."""
        attempts = max(1, self.config.dispatch_retries + 1)
        for attempt in range(attempts):
            try:
                self._attempt_local.value = attempt
                maybe_inject(self.config, "dispatch", attempt)
                out = call()
                # a success resets the breaker's consecutive failures
                self.breaker.record_success()
                return out
            except (UnsupportedAggregation, QueryError):
                raise
            except Exception as e:
                metrics.setdefault("retry_errors", []).append(
                    f"{type(e).__name__}: {e}")
                if attempt + 1 >= attempts:
                    # terminal: one breaker failure (the attempts the
                    # retry layer absorbed are not breaker events)
                    self.breaker.record_failure()
                    raise
                metrics["retries"] = attempt + 1
                with self.dispatch_lock:
                    self.clear_cache(table_name)
            finally:
                self._attempt_local.value = 0

    def _guarded_dispatch(self, call, metrics: dict, table_name: str):
        """_dispatch behind a breaker check: the batch executor's shared
        pass. The JAX package also runs it under the per-query deadline
        with its wedge reprobe; that branch comes with ROADMAP queue A
        item 12b."""
        self.breaker.check()
        return self._dispatch(call, metrics, table_name)

    def _copy(self, buf: torch.Tensor, metrics: dict) -> np.ndarray:
        """to_host behind the "host-transfer" fault site."""
        self._inject("host-transfer")
        return to_host(buf, metrics)

    def _fetch(self, out: dict, metrics: dict) -> dict:
        """_fetch behind the "host-transfer" fault site."""
        self._inject("host-transfer")
        return _fetch(out, metrics)

    # ------------------------------------------------ device health

    def _probe_device(self, timeout: float) -> bool:
        """A small reduction on the runner's device, on a watchdog
        thread; True iff it returns the right sum within `timeout`. On the
        card the thread synchronizes the current CUDA stream, so a hung
        or failed device shows. The "reprobe" fault site lives here, so
        a failing probe is testable without a sick device."""
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

    def _recover_after_probe(self):
        """The probe succeeded: evict the resident datasets (stacks a
        device reset would poison) and the plans' device constants and
        segment masks, but keep the compiled kernels (the plans and the
        process's cubin cache): recompiling every template would stall
        the first queries after recovery. Holds dispatch_lock (the
        serialized form; the pipelined mode's bounded acquire comes
        with item 12b). Slots stranded in the admission pipeline and
        the stage pools are reclaimed too."""
        with self.dispatch_lock:
            for ds in list(self._datasets.values()):
                ds.evict()
            self._datasets.clear()
            for _, plan in list(self._plan_cache.values()):
                plan.__dict__.pop("_device_consts", None)
                plan.__dict__.pop("_device_seg_mask", None)
        self.admission.reset_pipeline()
        self.stages.reclaim_stranded()

    def _healer_probe(self) -> bool:
        """The breaker healer's half-open probe: the same round trip, then
        the recovery purge, so that the first query after recovery starts
        from fresh stacks."""
        if not self._probe_device(10.0):
            return False
        self._recover_after_probe()
        return True

    def _execute(self, query, table) -> QueryResult:
        t0 = time.perf_counter()
        if isinstance(query, TimeBoundaryQuerySpec):
            res = self._run_time_boundary(query, table)
        elif isinstance(query, SegmentMetadataQuerySpec):
            res = self._run_segment_metadata(query, table)
        elif isinstance(query, SearchQuerySpec):
            res = self._run_search(query, table)
        elif isinstance(query, (ScanQuerySpec, SelectQuerySpec)):
            res = self._run_scan(query, table)
        elif isinstance(query, (TimeseriesQuerySpec, GroupByQuerySpec,
                                TopNQuerySpec)):
            res = self._run_agg(query, table)
        else:
            raise TypeError(f"unknown query type {type(query).__name__}")
        res.metrics["total_ms"] = (time.perf_counter() - t0) * 1000
        fp = self._observe(res.metrics, query, table)
        self._store_full_cache(query, table, res, fp)
        return res

    # --------------------------------------------- semantic result cache

    _CACHEABLE_QUERY_TYPES = ("timeseries", "groupBy", "topN")

    def _cacheable(self, query, table) -> bool:
        return (self.result_cache.full_enabled and not in_introspection()
                and getattr(query, "query_type", None)
                in self._CACHEABLE_QUERY_TYPES
                and getattr(table, "generation", None) is not None)

    def _serve_full_cache(self, query, table) -> QueryResult | None:
        """Tier-2 lookup: a hit returns a fresh QueryResult sharing the
        cached rows (cache_hit, cache_tier "full", path "cache", route
        "cache", rows_scanned 0, no launch and no copy). None = miss or
        bypass; the caller executes."""
        if not self._cacheable(query, table):
            return None
        t0 = time.perf_counter()
        hit = self.result_cache.get_full(query, table)
        if hit is None:
            return None
        rows, druid, meta = hit
        m = {"route": "cache", "host_copies": 0, "cache_hit": True,
             "cache_tier": "full", "rows_scanned": 0,
             "segments_scanned": 0,
             "segments_total": meta.get("segments_total", 0),
             "rows_returned": len(rows),
             "total_ms": (time.perf_counter() - t0) * 1000}
        self._observe(m, query, table, meta.get("_wl_fp"))
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

    def _observe(self, m: dict, query, table, fp=None):
        """Stamp a completed statement's metrics (query_type, datasource,
        path) and fold them into the workload profiler, once per
        statement. Returns the fingerprint."""
        m.setdefault("query_type", getattr(query, "query_type", "?"))
        m.setdefault("datasource", table.name)
        m.setdefault("cache_hit", False)
        m["path"] = _metric_path(m)
        if in_introspection():
            return fp
        if fp is None:
            fp = self.fingerprint(query, table.name)
        if fp is not None:
            m.setdefault("template_id", fp.template_id)
        self.workload.observe(m, fp)
        return fp

    def clear_cache(self, table_name: str | None = None):
        """Drop one table's resident columns, memoized plans, cap hints
        and both result-cache tiers, or every table's (None): the next
        query re-uploads."""
        self.result_cache.clear(table_name)
        if table_name is None:
            for ds in list(self._datasets.values()):
                ds.evict()
            for store in (self._datasets, self._plan_cache, self._cap_hints):
                store.clear()
            return
        ds = self._datasets.pop(table_name, None)
        if ds is not None:
            ds.evict()
        for store in (self._plan_cache, self._cap_hints):
            for k in [k for k in store if k[0] == table_name]:
                del store[k]

    def device_bytes(self) -> int:
        """Resident device bytes over every table's dataset."""
        return sum(ds.resident_bytes() for ds in self._datasets.values())

    def _dataset(self, table) -> DeviceDataset:
        ds = self._datasets.get(table.name)
        if ds is None or ds.table is not table:
            prev = ds
            # the superseded snapshot rides in as `prev`: its resident
            # stacks rebase on the device (only the changed segments'
            # rows upload). It is evicted after the new dataset has
            # taken its stacks; in-flight queries that hold its tensors
            # keep them alive by reference.
            ds = DeviceDataset(table, self.device, self._ledger, prev=prev)
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
        """Memoized lower(): re-lowering an unchanged query costs
        milliseconds of pure Python per execution. Keyed on the full
        query JSON plus the config; a table identity check invalidates on
        re-registration."""
        import json
        key = (table.name,
               json.dumps(query.to_json(), sort_keys=True, default=str),
               repr(self.config))
        hit = self._plan_cache.get(key)
        if hit is not None and hit[0] is table:
            return hit[1]
        plan = lower(query, table, self.config)
        if len(self._plan_cache) > 512:
            self._plan_cache.pop(next(iter(self._plan_cache)))
        self._plan_cache[key] = (table, plan)
        return plan

    def _device_consts(self, plan: PhysicalPlan) -> dict:
        """The plan's ConstPool on the device, once per plan. Scalars ride
        as 1-element tensors: torch lets a 0-d int64 tensor take the
        dtype of an int8 column it meets (and wrap), where numpy and JAX
        promote to int64; a 1-element tensor promotes like numpy."""
        consts = getattr(plan, "_device_consts", None)
        if consts is None:
            consts = plan._device_consts = {
                k: torch.as_tensor(np.atleast_1d(v)).to(self.device)
                for k, v in plan.pool.consts.items()}
        return consts

    def _prepare(self, plan: PhysicalPlan, metrics: dict, pinned=None):
        """Dataset env + derived streams + validity/segment masks + scan
        metrics. The working set (`pinned`, default the plan's own; a
        fused batch passes its legs' union) is pinned in the ledger
        while it builds, so that nothing it reads is evicted before the
        launch that reads it."""
        table = plan.table
        ds = self._dataset(table)
        if pinned is None:
            pinned = self.pins([plan])
        env = ds.env(plan.columns, plan.null_cols, pinned)
        consts = self._device_consts(plan)
        for dp in plan.dim_plans:
            if dp.cache_token is not None:
                env["cols"][dp.derived_name] = ds.derived(
                    dp.cache_token,
                    lambda dp=dp: self._build_derived(ds, consts, dp,
                                                      pinned), pinned)
        bp = plan.bucket_plan
        if bp is not None and bp.cache_token:
            env["cols"][bp.derived_name] = ds.derived(
                bp.cache_token,
                lambda: bp.build_stream(ds.col(TIME_COLUMN, pinned), consts)
                .to(torch.int32), pinned)
        for token, src, cname in plan.filter_streams:
            env["cols"]["\0d:" + token] = ds.derived(
                token, lambda src=src, cname=cname:
                    _take(consts[cname], ds.col(src, pinned))
                    .to(torch.int32), pinned)
        valid = ds.valid(pinned)
        kept = plan.pruned_ids if not plan.empty else []
        # once per plan: a host-to-device copy per query would sync
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

    @staticmethod
    def _build_derived(ds, consts, dp, pinned=frozenset()) -> torch.Tensor:
        """One precomputed dim id stream [S, R] int32 from its resident
        source column (dictionary codes for remap, __time for
        timeformat)."""
        src = dp.source_col if dp.source_col is not None else TIME_COLUMN
        env = {"cols": {src: ds.col(src, pinned)}, "nulls": {}}
        return dp.ids(env, consts).to(torch.int32)

    def _segment_window(self, plan: PhysicalPlan, n_segments: int):
        """(lo, W) covering every pruned segment, or None. Interval and
        bounds pruning is mask-only inside the kernel (pruned segments
        still cost their bytes); with time-partitioned ingest the pruned
        set is contiguous on the segment axis, so the dispatch slices the
        [S, R] working set down to a pow2-quantized window and reads ONLY
        those bytes. Skipped when the window saves <25%."""
        ids = plan.pruned_ids
        if plan.empty or not ids:
            return None
        lo, hi = min(ids), max(ids) + 1
        W = _next_pow2(hi - lo)
        if 4 * W >= 3 * n_segments:
            return None
        return min(lo, n_segments - W), W

    def _dispatch_args(self, plan: PhysicalPlan, metrics: dict):
        """(env, valid, seg_mask, consts) of the plan's kernel, cut to
        the segment window when it saves enough."""
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
        """Unpacked route: dispatch the plan's kernel and fetch every
        partial table with one device-to-host copy."""
        args = self._dispatch_args(plan, metrics)
        t0 = time.perf_counter()
        out = self._fetch(plan.kernel(*args), metrics)
        metrics["execute_ms"] = (time.perf_counter() - t0) * 1000
        return out

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
        buffer back. The cap adapts per template, with a sized retry when
        a run overflows its hint. Returns (idx, compact, layout), or None
        when the groups exceed `result_group_cap` (the caller re-runs
        unpacked)."""
        args = self._dispatch_args(plan, metrics)
        cap_limit = min(self.config.result_group_cap, plan.total_groups)
        key, cap = self._cap_hint(plan, "packed", cap_limit, cap_limit)
        t0 = time.perf_counter()
        while True:
            layout = make_layout(plan, self.config, cap)
            buf = build_packer(plan.kernel, plan, layout)(*args)
            count, idx, compact = unpack(self._copy(buf, metrics), layout)
            if count <= layout.cap:
                break
            if count > cap_limit:
                metrics["result_groups"] = count
                return None
            cap = min(cap_limit, _next_pow2(count))
        self._cap_hints[key] = count
        metrics["execute_ms"] = (time.perf_counter() - t0) * 1000
        metrics["result_groups"] = count
        metrics["result_cap"] = layout.cap
        return idx, compact, layout

    def _run_sparse(self, plan: PhysicalPlan, metrics: dict) -> dict:
        """Sparse route: the sort-based group-by with an adaptive compact
        table cap; each attempt is one copy back. Past
        `sparse_group_budget` present groups it raises
        UnsupportedAggregation, and the engine serves the query from the
        fallback interpreter."""
        args = self._dispatch_args(plan, metrics)
        cap_limit = min(self.config.sparse_group_budget, plan.total_groups)
        key, cap = self._cap_hint(plan, "sparse",
                                  self.config.sparse_group_cap, cap_limit)
        t0 = time.perf_counter()
        reruns = []
        while True:
            out = self._fetch(plan.make_sparse_kernel(cap)(*args), metrics)
            count = int(out["_count"])
            if count <= cap:
                break
            if count > cap_limit:
                raise UnsupportedAggregation(
                    f"{count} present groups exceed sparse budget "
                    f"{cap_limit}")
            reruns.append(cap)
            cap = min(cap_limit, _next_pow2(count))
        self._cap_hints[key] = count
        metrics["execute_ms"] = (time.perf_counter() - t0) * 1000
        metrics["result_groups"] = count
        metrics["result_cap"] = cap
        metrics["sparse_reruns"] = reruns  # the caps that overflowed
        return out

    def _run_agg(self, query, table) -> QueryResult:
        metrics = self.last_metrics = {"host_copies": 0}
        t0 = time.perf_counter()
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
            arrays = finalize_aggs(out, plan.agg_plans, specs, keep_raw)
            eval_post_aggs(arrays, query.post_aggregations)
            names = self._out_names(query)
            pm = out["_keys"] != SENTINEL  # empty slots fill the tail
            present = out["_keys"][pm]
            sub = {n: np.asarray(arrays[n])[pm] for n in names}
            res = self._emit_groupby(query, plan, present, sub)
            res.metrics = metrics
            metrics["assemble_ms"] = (time.perf_counter() - t0) * 1000
            return res

        if self.result_cache.seg_enabled:
            arrays = self._run_agg_segcached(query, plan, metrics, specs,
                                             keep_raw, table)
            if arrays is not None:
                t0 = time.perf_counter()
                eval_post_aggs(arrays, query.post_aggregations)
                res = self._assemble_agg(query, plan, arrays)
                res.metrics = metrics
                metrics["assemble_ms"] = (time.perf_counter() - t0) * 1000
                return res

        packed = None if keep_raw else self._dispatch(
            lambda: self._run_packed(plan, metrics), metrics, table.name)
        if packed is not None:
            metrics["route"] = "packed"
            idx, compact, layout = packed
            t0 = time.perf_counter()
            for p in plan.agg_plans:
                if p.kind == "hll" and \
                        getattr(specs.get(p.name), "round", True):
                    compact[p.name] = np.round(compact[p.name])
            arrays = densify(idx, compact, layout, plan.agg_plans)
        else:
            # theta set ops, or a packed overflow past result_group_cap
            metrics["route"] = "unpacked"
            partials = self._dispatch(
                lambda: self._run_partials(plan, metrics), metrics,
                table.name)
            t0 = time.perf_counter()
            arrays = finalize_aggs(partials, plan.agg_plans, specs,
                                   keep_raw)
        eval_post_aggs(arrays, query.post_aggregations)
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
        reason = rc.tier1_bypass_reason(plan)
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
        hits = rc.get_segments(tkey, table, plan, covered)
        to_compute = sorted([s for s in covered if s not in hits]
                            + always_compute)
        if to_compute:
            fresh = self._dispatch(
                lambda: self._run_seg_partials(plan, metrics, to_compute),
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
        return finalize_aggs(merged, plan.agg_plans, specs, keep_raw)

    def _run_seg_partials(self, plan: PhysicalPlan, metrics: dict,
                          compute_ids: list) -> dict:
        """One pass computing PER-SEGMENT partials for `compute_ids`:
        {segment id: partials dict of CPU tensors}. The group key is
        extended to (window segment, group) over the window [lo, lo + W)
        of the segments to compute (W a power of two, so that a plan
        compiles at most log2(S) variants and a sliding window of the
        same W compiles nothing), and the segment mask admits only
        `compute_ids`. Fused plans launch the segment-extended fused
        reduce once (kernels.fused_reduce.fused_reduce_seg); others (HLL,
        theta) run the generic reduce with the same extended key. Either
        way one copy brings every segment's partials back. A failure
        raises: nothing serves the plain path in its place."""
        env, valid, _, consts = self._prepare(plan, metrics)
        table = plan.table
        seg_mask = self._dataset(table).segment_mask(compute_ids)
        # only the computed segments are read
        metrics["segments_scanned"] = len(compute_ids)
        metrics["rows_scanned"] = int(sum(
            table.segments[i].meta.n_valid for i in compute_ids))
        S = valid.shape[0]
        K = plan.total_groups
        lo, hi = min(compute_ids), max(compute_ids) + 1
        W = min(_next_pow2(hi - lo), S)
        lo = min(lo, S - W)
        metrics["segments_window"] = W
        t0 = time.perf_counter()
        if plan.fused_reason is None:
            prog = fused_reduce.program(plan, table)
            sums, mins = fused_reduce.fused_reduce_seg(
                prog, fused_reduce.program_inputs(prog, env), valid,
                seg_mask, K, lo, W)
            out = fused_reduce.partials(plan, sums, mins)
        else:
            sl = slice(lo, lo + W)
            flat = {kind: {c: a[sl].reshape(-1)
                           for c, a in env[kind].items()}
                    for kind in ("cols", "nulls")}
            base = (valid[sl] & seg_mask[sl, None]).reshape(-1)
            key, mask, fenv = plan.front_half(flat, base, consts)
            seg_local = torch.arange(W, dtype=torch.int32,
                                     device=key.device) \
                .repeat_interleave(valid.shape[1])
            # int32 is safe: tier1_bypass_reason refuses key spaces of
            # 2^31 and more
            key2 = seg_local * K + key.to(torch.int32)
            out = group_reduce(key2, mask, fenv, plan.agg_plans, W * K,
                               consts)
        host = self._fetch(out, metrics)
        metrics["execute_ms"] = (time.perf_counter() - t0) * 1000
        shaped = {n: torch.from_numpy(a).reshape((W, K) + a.shape[1:])
                  for n, a in host.items()}
        return {sid: {n: a[sid - lo] for n, a in shaped.items()}
                for sid in compute_ids}

    def compute_partials(self, query, table):
        """Run an aggregation query and return its RAW mergeable
        partials instead of finalized rows: the cube materializer's
        entry point (tpu_olap_torch.cubes). Returns (plan, present flat
        group ids [G] int64, {name: [G, ...] compact partial arrays},
        metrics). Rides the cached lowering and the dense partials route
        (the fused reduce on the card, one copy) or the sparse route,
        under an admission slot, the breaker check, dispatch_lock and the
        retry layer, so that a background cube build queues behind (and
        sheds with) foreground traffic."""
        with self.admission.slot(None), self.dispatch_lock:
            self.breaker.check()
            metrics = self.last_metrics = {"host_copies": 0}
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
        plan = self._lower_cached(query, table)
        metrics["lower_ms"] = (time.perf_counter() - t0) * 1000
        t0 = time.perf_counter()
        mask = self._dispatch(
            lambda: self._copy(self._run_mask(plan, metrics).reshape(-1),
                               metrics), metrics, table.name)
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
        events = _gather_rows(table, mask, cols, offset, limit, descending)
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
                return self._copy(search_counts(
                    mask, [ds.col(d)[sl].reshape(-1) for d in coded],
                    cards), metrics)
            packed = self._dispatch(counts, metrics, table.name)
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


def _metric_path(m: dict) -> str:
    """Which execution flavor served a statement (the JAX package's
    path label): "cache" for a full-result hit (no dispatch ran),
    "cube" for a cube serve, "batch" for a shared or deduplicated pass,
    "sparse", "fused" (the fused reduce) or "dense" (the generic
    reduce); tier-1 partial hits keep their dispatch's label."""
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


def to_host(buf: torch.Tensor, metrics: dict) -> np.ndarray:
    """The one device-to-host copy of a query route: a 1-D tensor to a
    numpy array (counted in metrics["host_copies"], its bytes in
    metrics["host_bytes"])."""
    metrics["host_copies"] = metrics.get("host_copies", 0) + 1
    metrics["host_bytes"] = metrics.get("host_bytes", 0) \
        + buf.numel() * buf.element_size()
    return buf.cpu().numpy()


def _fetch(out: dict, metrics: dict) -> dict:
    """{name: device tensor} -> {name: numpy array} in ONE device-to-host
    copy: every tensor's bytes concatenate into one uint8 buffer."""
    names = list(out)
    # fresh dense copies: a column view such as sums[:, 0] keeps its
    # stride even where torch calls it contiguous (size-1 dims), and
    # viewing bytes needs stride 1
    ts = [out[n].new_empty(out[n].shape).copy_(out[n]) for n in names]
    if not ts:
        return {}
    host = to_host(torch.cat([t.reshape(-1).view(torch.uint8) for t in ts]),
                   metrics)
    res, off = {}, 0
    for n, t in zip(names, ts):
        nb = t.numel() * t.element_size()
        res[n] = host[off:off + nb].view(_np_dtype(t.dtype)).reshape(t.shape)
        off += nb
    return res


def _np_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


def _invert_sort_key(k: np.ndarray):
    if k.dtype.kind in "fiu":
        return -k.astype(np.float64)
    # lexicographic descending for strings: invert via codes trick
    uniq, inv = np.unique(k, return_inverse=True)
    return -inv

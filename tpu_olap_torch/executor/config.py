"""Engine configuration — the knobs this package reads.

A trimmed counterpart of the JAX package's EngineConfig: the host-side
lowering budgets, planner switches, fallback-interpreter bounds and
the mesh's knobs keep their names and defaults; the device knobs are
`device` and `use_fused_reduce`. Left out by design: the JAX package's
numpy-platform batch knobs (`batch_chunk_segments`,
`batch_cpu_threads`: the port's CPU path is the plain torch version of
its kernels), its Pallas knobs (`use_pallas`, `pallas_*`: the port's
kernels are its own), its backend switches (`platform`, `enable_x64`:
`device` picks the device, and torch computes in int64 without a
switch), `max_segments_per_dispatch` (read by nothing in the JAX package
either) and the free-form `extra` dict.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class EngineConfig:
    # where the resident columns live and the reduces run: "cuda"
    # (default) or "cpu". With "cuda" and no card the engine raises — it
    # never carries on on the CPU.
    device: str = "cuda"
    # the fused grouped reduce (kernels.fused_reduce): "auto" runs it on
    # cuda for every plan its eligibility accepts, "force" also on cpu
    # (through its plain version), "never" keeps the generic torch reduce
    use_fused_reduce: str = "auto"

    # accumulator dtypes for LONG / DOUBLE aggregations
    long_dtype: object = np.int64
    double_dtype: object = np.float64

    # largest dense group space lowering builds; past it a GroupBy takes
    # the sort-based sparse group-by (kernels.sparse_groupby)
    dense_group_budget: int = 1 << 22
    # theta sketch nominal-entries cap (k x groups x 8 B of device memory)
    theta_k_cap: int = 1 << 14
    # largest dense id space of one numeric / timeFormat dimension
    numeric_dim_label_budget: int = 1 << 22

    # sparse group-by: first compact-table size (grows to the next power
    # of two on overflow) and the most PRESENT groups it serves; past it
    # lowering raises UnsupportedAggregation and the engine serves the
    # query from the fallback interpreter
    sparse_group_cap: int = 1 << 15
    sparse_group_budget: int = 1 << 21
    # theta sketch width on the sparse path: [cap, k] tables stay modest
    # (256 -> about 6% relative standard error)
    sparse_theta_k_cap: int = 256
    # the mesh's sparse merge: every device compacts its own groups, then
    # "exchange" hash-partitions the compact entries to owner devices
    # (hash of the key mod D), copies them device to device and merges
    # per owner, so the present groups may reach D x sparse_group_budget
    # and skew only loads one owner; "gather" merges every device's table
    # at the host broker within one device's budget
    sparse_merge: str = "exchange"
    # most [groups x radix] elements of dense per-group sketch state
    # (theta tables, HLL register files); past it a GroupBy takes the
    # sparse path with the clamped sketch width, other shapes decline
    dense_sketch_state_budget: int = 1 << 28

    # packed results: most non-empty groups shipped back in the one
    # compacted buffer of a dense aggregate query (executor.packing);
    # past it the query re-runs unpacked (same answer, larger copy)
    result_group_cap: int = 1 << 16

    # the mesh (executor.sharding): the segment axis split over this many
    # devices, segment i on device i mod D (interleaved placement, so a
    # time range load-balances and the per-device window prunes each
    # device's share). Each aggregate launches once per device; None or 1
    # = one device. D may exceed the cards only after
    # utils.platform.force_virtual_devices (tests, the smoke); on the CPU
    # the mesh is D entries of the CPU device.
    num_shards: int | None = None

    # the cost model (planner.cost) picks a mesh aggregate's merge:
    # "historicals" copies every device's partial table to the host and
    # the broker folds them; "broker" copies them to the mesh's first
    # device, folds there and copies one table back. The four constants
    # default to the fitted entry of planner/cost_calibration.json for
    # the engine's device type; set them to pin. shard_merge_factor
    # scales the modeled merge bytes.
    cost_model_enabled: bool = True
    shard_merge_factor: float = 1.0
    cost_scan_ns_per_row_col: float | None = None
    cost_merge_ns_per_byte: float | None = None
    cost_collective_lat_us: float | None = None
    cost_gspmd_overhead: float | None = None
    # pin the merge ("historicals" | "broker"); None = the cost model
    force_strategy: str | None = None

    # Timeseries: omit buckets with no rows (Druid skipEmptyBuckets)
    skip_empty_buckets: bool = False
    # planner: GROUP BY one dim + ORDER BY metric + LIMIT -> TopN
    allow_topn: bool = True
    topn_max_threshold: int = 100_000
    # planner: COUNT(DISTINCT) -> approximate cardinality (HLL)
    allow_count_distinct: bool = True
    # time zone of time-function extraction in SQL
    time_zone: str = "UTC"

    # fallback interpreter (planner.fallback) at scale: parquet-backed
    # tables whose footer row count exceeds fallback_chunk_rows run the
    # fallback over streamed row-group chunks of fallback_chunk_batch_rows
    # (partial aggregation; bounded resident rows) instead of
    # materializing one frame; a chunked NON-aggregate result, or a
    # chunked DISTINCT aggregate's (group, value) pair set, larger than
    # fallback_scan_row_cap refuses with a clear error instead of eating
    # host memory.
    fallback_chunk_rows: int = 4_000_000
    fallback_chunk_batch_rows: int = 1 << 20
    fallback_scan_row_cap: int = 20_000_000
    # correlation shapes the magic-set rewrite cannot serve run a bounded
    # nested loop: one subquery execution per distinct outer key tuple,
    # refused legibly past this cap
    corr_nested_loop_cap: int = 2048
    # chunked-fallback aggregate parallelism (fork pool over parquet row
    # groups; the children run pandas only, never torch or CUDA): 0 =
    # auto (min(8, cpu count)), 1 = sequential. The timeout bounds how
    # long a stuck pool can stall a query before the sequential loop
    # takes over; it scales up with the table's row count
    # (fallback._parallel_timeout_s).
    fallback_parallel_workers: int = 0
    fallback_parallel_timeout_s: float = 45.0
    # FROM/JOIN (SELECT ...) bodies route back through the engine's
    # statement executor (the device path when rewritable). False keeps
    # the interpreter pure — bench.parity.pure_config() derives that
    # oracle config, so the fallback side of every parity check stays an
    # independent pandas execution.
    fallback_derived_on_device: bool = True

    # shared-scan batch execution (executor.batch): compatible aggregate
    # queries against one table run as one pass over the union segment
    # window, their fused-reduce legs in ONE launch of the multi-leg
    # kernel (kernels.fused_reduce.fused_reduce_multi) and one copy
    # back. batch_window_ms > 0 turns on the request coalescer:
    # concurrent QueryRunner.execute() callers of aggregate queries wait
    # up to this window and ride one batch. 0 = off (execute_batch() and
    # Engine.sql_batch still batch explicitly).
    batch_window_ms: float = 0.0
    # most logical queries per fused dispatch; larger batches split
    batch_max_queries: int = 16

    # device residency budget (bytes) for the resident column stacks of
    # every table (executor.dataset.HbmLedger): past it the
    # least-recently-used unpinned stacks evict. None = unbounded.
    hbm_budget_bytes: int | None = None

    # semantic result cache (executor.resultcache). Tier 2: full results
    # keyed by (normalized query JSON, table generation), a byte-budget
    # LRU. Tier 1: per-segment partial aggregates keyed by (generation,
    # segment id, query template minus intervals): a repeated aggregate
    # over a moving window recomputes only the uncached segments, in one
    # launch of the segment-extended fused reduce, and merges the rest on
    # the host. Both invalidate generationally on registration and DROP
    # and clear with CLEAR DRUID CACHE. Off by default, as in the JAX
    # package: serving deployments opt in.
    result_cache_enabled: bool = False
    result_cache_max_bytes: int = 256 << 20
    segment_cache_enabled: bool = False
    segment_cache_max_bytes: int = 512 << 20
    # segments with fewer valid rows than this floor are recomputed
    # rather than cached
    segment_cache_min_rows: int = 256
    # most per-segment state elements (segments x groups x agg radix)
    # the one-pass per-segment dispatch may allocate; plans past it
    # bypass tier 1
    segment_cache_state_budget: int = 1 << 22

    # materialized rollup cubes (tpu_olap_torch.cubes): the planner's
    # aggregate-rewrite pass serves a covered aggregate by folding a
    # registered cube's stored partials instead of scanning the base
    # table. Cubes exist only once created (DDL, Engine.create_cube,
    # advisor specs).
    cube_rewrite_enabled: bool = True
    # background maintainer: rebuild cubes whose base table's generation
    # moved (a stale cube is never served either way). False = refresh
    # only through REFRESH DRUID CUBES / CubeRegistry.refresh_now.
    cube_auto_refresh: bool = True
    cube_refresh_interval_s: float = 2.0
    # serve-time fold budget: most [groups x per-agg state radix]
    # elements the host fold may allocate
    cube_serve_state_budget: int = 1 << 22
    # serve-cost bailout: serve from a cube only when its interval-kept
    # row count is at least this factor below the base rows the query
    # would scan after pruning; <= 1 disables the check. The default is
    # the JAX package's; PERF.md has the crossover measured on the card.
    cube_serve_min_reduction: float = 16.0

    # --- real-time ingest (segments/delta.py, segments/wal.py) ---
    # Engine.append lands rows in a mutable in-memory delta scope,
    # queryable at once alongside sealed segments; a WAL makes
    # acknowledged appends crash-durable and a background compactor
    # seals deltas into time-partitioned segments. ingest_wal_dir:
    # directory of the per-table write-ahead logs; None disables
    # durability (appends stay queryable, but do not survive a crash).
    ingest_wal_dir: str | None = None
    # fsync policy: "always" (fsync before acknowledging), "interval"
    # (a background graph fsyncs every ingest_wal_flush_interval_s;
    # process crashes lose nothing, power loss may lose the last
    # interval), "never" (tests and benchmarks)
    ingest_wal_fsync: str = "always"
    ingest_wal_flush_interval_s: float = 0.05
    # replay an existing WAL when a table is first registered in this
    # process (crash recovery); re-registering a live table resets its
    # log instead (the appends belonged to the old data)
    ingest_wal_replay: bool = True
    # backpressure bound: most delta rows per table before appends shed
    # with IngestBackpressure (retry after ingest_retry_after_s until a
    # compaction has been observed); 0 = unbounded
    ingest_max_delta_rows: int = 1 << 20
    ingest_retry_after_s: float = 1.0
    # background compactor: seal deltas of at least ingest_compact_rows
    # rows every ingest_compact_interval_s (and on an append's wake).
    # False = compact only through Engine.compact_now.
    ingest_auto_compact: bool = True
    ingest_compact_rows: int = 1 << 16
    ingest_compact_interval_s: float = 2.0
    # durable sealed-segment store (segments/store.py): a checkpoint
    # spills the sealed scope as checksummed chunk files under an
    # atomically swapped manifest, so that recovery replays only the
    # WAL tail past the checkpoint's watermark. None disables it
    # (recovery replays the whole WAL).
    ingest_store_dir: str | None = None
    # manifests kept per table (>= 2): the WAL truncates only through
    # the oldest kept manifest's watermark, so a corrupt newest
    # checkpoint falls back to the previous one with its WAL tail
    ingest_store_keep_manifests: int = 2
    # checkpoint after every compaction; False = only through
    # Engine.checkpoint_now / CHECKPOINT DRUID TABLE
    ingest_store_checkpoint_on_compact: bool = True

    # --- resilience (tpu_olap_torch.resilience) ---
    # a failed device dispatch is retried this many times, the table's
    # resident state purged between attempts
    dispatch_retries: int = 1
    # after the retries, serve the statement from the pandas fallback
    # interpreter (recorded in the metrics: path, retries, retry_errors)
    # instead of raising; False = raise
    fallback_on_device_failure: bool = True
    # fault hook: callable(stage: str, attempt: int) -> None that may
    # raise (None in production). A plain callable fires only at the
    # "dispatch" site; one with a `stages` attribute (None = every site)
    # fires at the sites it names (resilience.faults).
    fault_injector: object = None
    # admission control: at most max_inflight_dispatches hold slots, at
    # most admission_queue_limit wait for one, the next caller is shed
    # with QueryShed; <= 0 disables admission
    max_inflight_dispatches: int = 8
    admission_queue_limit: int = 64
    # circuit breaker: this many consecutive terminal device failures
    # open it; while open, fallback-capable statements are served by the
    # interpreter (path "fallback_breaker") and the rest refuse with
    # BreakerOpen. A healer thread probes the device every
    # breaker_open_cooldown_s and closes it on success. <= 0 disables it.
    breaker_failure_threshold: int = 5
    breaker_open_cooldown_s: float = 5.0
    # per-query deadline (seconds) on the device work of a statement: the
    # work runs on a watchdog thread that the caller abandons on expiry
    # with QueryDeadlineExceeded (served by the fallback when
    # fallback_on_device_failure is set). An abandoned CUDA kernel keeps
    # running on the stream until it ends; the device is marked wedged
    # and re-probed before it is trusted again. None = no deadline.
    query_deadline_s: float | None = None
    # pipelined two-stage execution: stage 1 (enqueue) holds
    # dispatch_lock while the kernels launch and the result's copy into
    # pinned host memory is queued; stage 2 (transfer, finalize,
    # assemble) waits on the copy's CUDA event without the lock, so it
    # overlaps other statements' enqueues. The value bounds how many
    # statements sit between the two stages at once (graph admission);
    # 0 = serialized (dispatch_lock held across the whole statement).
    pipeline_depth: int = 4
    # with a mesh, a failure that outlasts the retries halves the device
    # count (the mesh is rebuilt over the first half, every table's
    # stacks re-placed): the in-process analog of re-sharding the
    # segment manifest after a device loss
    degrade_shards_on_retry: bool = False

    # observability (obs.trace, obs.metrics, obs.events, obs.slo), with
    # the JAX package's defaults: per-statement span trees (a ring of
    # trace_history_limit, and traces slower than slow_query_ms in a slow
    # ring of slow_log_limit), the history ring of history_limit records
    # (Engine.counters stays exact past eviction), the structured event
    # log (a ring, plus a JSON-lines file at event_log_path rotated past
    # event_log_max_bytes), and the latency SLO: statements within
    # slo_latency_ms count good, and the burn rate is the bad fraction
    # over slo_window_s divided by the error budget (1 - slo_target).
    tracing_enabled: bool = True
    trace_history_limit: int = 128
    slow_query_ms: float = 250.0
    slow_log_limit: int = 64
    history_limit: int = 1024
    event_log_limit: int = 2048
    event_log_path: str | None = None
    event_log_max_bytes: int = 64 * 1024 * 1024
    event_log_rotate_keep: int = 3
    slo_latency_ms: float = 500.0
    slo_target: float = 0.99
    slo_window_s: float = 3600.0
    # per-statement device profile: when set, each statement's stage graph
    # runs under a torch.profiler session (CPU and, on a CUDA engine,
    # CUDA activity) written as a Chrome trace into a directory of its own
    # beneath this one (obs.profile.profile_query); the record's
    # "profile_trace" names it. Opt-in: a session costs milliseconds.
    profile_dir: str | None = None

    # telemetry plane (obs.timeseries + obs.sentinel), with the JAX
    # package's defaults: a periodic `telemetry` background graph on the
    # stage scheduler snapshots every metric series into bounded
    # per-series rings (sys.metrics_history, GET /debug/timeseries) and
    # runs the regression sentinel's resource checks. interval <= 0
    # disables the graph; retention bounds each series' ring.
    telemetry_enabled: bool = True
    telemetry_interval_s: float = 5.0
    telemetry_retention: int = 360
    # regression sentinel (obs.sentinel): EWMA and moment baselines per
    # query template and per stage; a served statement slower than
    # max(floor, factor * baseline) after `min_samples` warm-up raises a
    # latency_drift alert attributed to the stage whose busy + wait moved
    # most. Resource alerts (hbm_pressure, eviction_thrash, wal_lag,
    # breaker_open, admission_shed) fire on the telemetry tick; an alert
    # not re-confirmed for clear_after_s clears. Alerts surface as
    # events, alerts_active{kind}, sys.alerts and GET /debug/health.
    sentinel_enabled: bool = True
    sentinel_min_samples: int = 8
    sentinel_ewma_alpha: float = 0.2
    sentinel_latency_factor: float = 3.0
    sentinel_latency_floor_ms: float = 10.0
    sentinel_clear_after_s: float = 60.0
    sentinel_hbm_pressure: float = 0.90   # of hbm_budget_bytes
    sentinel_eviction_thrash: int = 32    # evictions per tick
    sentinel_wal_lag_records: int = 1024  # unsynced WAL frames
    sentinel_alert_limit: int = 256       # sys.alerts history ring

    # workload profiler (obs.workload): every completed statement folds
    # into bounded per-template rolling stats, the demand signal of the
    # cube advisor. workload_max_templates bounds distinct templates
    # (least-recently-seen evicts); workload_latency_window bounds the
    # per-template latency ring.
    workload_profile_enabled: bool = True
    workload_max_templates: int = 512
    workload_latency_window: int = 512

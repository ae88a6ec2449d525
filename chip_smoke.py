"""Chip smoke test of the PyTorch/CUDA port (tpu_olap_torch) on one GPU.

    python3 chip_smoke.py [--rows N] [--reps R]

Phases, each printing its own line; any failure exits nonzero:
  1. the card: name, power limit, torch and CUDA versions (no card: fail);
  2. build: NVRTC located (no kernel needs nvcc), SSB at SF1 (6,000,000
     lineorder rows, seed 0) generated and registered, and each of the 13
     queries
     run once through Engine.sql: lowering generates and compiles the
     plan's kernel with NVRTC (the on-disk cubin cache is emptied
     first), so this run's latency includes the compile. Per plan: compile
     ms, registers, spill bytes, stack, shared memory, blocks per SM.
     Then each query once more with other literals
     (ssb.QUERIES_OTHER_LITERALS): a new plan whose program has the
     same structure, so it must reuse the kernel (NVRTC compiles and
     first-run latency printed);
  3. hold the generated kernel against the plain torch version on the
     card on synthetic row programs at the main path's row count, K from
     1 to 65,536 (shared and global group tables; each case compiles its
     own kernel; exact equality);
  4. the main path: all 13 queries through Engine.sql with the fused
     kernel ("auto", counts set to 0 just before) and with the generic
     torch reduce ("never"); the frames must agree, two must agree with
     an independent pandas reference, and the generated kernel must
     launch on every query. Every launch of the main path is then
     replayed through the generated kernel and the plain version (exact
     equality) — after the launch counts are read. The queries with
     other literals must agree with the generic reduce too, and their
     launches are replayed the same way;
     Every query must take the packed route (finalize, compaction and
     packing on the card) with one device-to-host copy;
  5. timings, each beside the card's name and power limit: per-query
     p50s of both modes and each query's first (compile-included) run;
     the generated kernel's device time at q1.1's, q2.1's, q2.2's,
     q3.1's and q4.3's inputs, beside the bound, the plain version's
     time and one torch index_add_ call over the pre-selected rows (the
     yardstick of the reduce half); a per-query time breakdown. Kernel
     times are taken twice: with the inputs warm in L2 from the launch
     before, and cold (L2 overwritten before each launch, the overwrite
     not counted); the JSON line carries the cold times;
  6. the packed path: the 13 queries once more under
     torch.cuda.set_sync_debug_mode("error"), lifted only around stage
     2's wait for the one device-to-host copy (queued non-blocking into
     pinned memory in stage 1), so any host sync before it fails; then each
     query's packed and unpacked p50, in turns in one call;
  7. the distinct-count queries x1-x4 (ssb.DISTINCT_QUERIES: dense HLL
     and theta, packed; a theta intersection, unpacked; a four-dimension
     GROUP BY past the dense budget, sparse): first run, p50, route,
     fused_reason, sparse re-runs, host copies and peak device memory
     per query; x4's top 100 and x3 against pandas exactly, x1 and x2
     within the harness's approximate band of pandas nunique; the HLL
     registers, theta tables and sparse partials made on the card equal
     to those the same torch functions make from the same rows on CPU
     tensors; device time by kernel under torch.profiler;
  8. the query types other than the aggregates on the same table:
     three Scans through Engine.sql (q1.1's filter with LIMIT 100; one
     month of __time, ORDER BY __time DESC LIMIT 50 OFFSET 1000, which
     cuts the segment window; a selective filter with no LIMIT), three
     chained select_page pages, three Searches (the SEARCH verb over
     every dimension, one IN c_city, s_city with strlen order, one over
     a numeric and a coded dimension), TimeBoundary, SegmentMetadata,
     EXPLAIN DRUID REWRITE, and CLEAR DRUID CACHE followed by the first
     scan again. The row-mask kernel must launch once on every scan and
     search (counts set to 0 just before), each answer must equal the
     same query on an Engine(device="cpu") over the same segments
     exactly, the selective scan must equal pandas, scans, pages and
     coded searches must take one device-to-host copy with no host sync
     before it (set_sync_debug_mode("error")), and every mask launch is
     replayed against the plain version (exact) after the counts are
     read. Per query: first run, p50, route, copies and bytes; the mask
     kernel's device time cold and warm against its bound;
  9. the TPC-H shapes (bench.tpch: the 25 statements of the JAX
     package's TPC-H suite, all 22 shapes) over a 6,001,215-row olps fact
     (seed 0) written as a four-file parquet dataset and registered from
     its paths, so the fallback streams row groups, and Q11 and Q18 once
     more with literals that keep about half the brands at this scale
     (bench.tpch.scaled_subqueries; each must keep some brands and not
     all, where the suite's keep none and all): each statement must
     take the path bench.tpch gives it, the answers of every statement
     with device work (rewritten ones, inlined subqueries, derived
     bodies) must equal the port's pandas fallback over the same
     statement with nothing on the device (chunked, or whole-frame for
     Q20's correlated body), and those whose device work is all B1 must
     run without a host sync before their copies. Per statement: path,
     route, fallback_reason, fused_reason, B1 launches (counts set to 0
     just before), fork-pool use, host copies, first run, p50 over 3
     runs (1 for a statement slower than 1 s, none past 10 s) and, for
     Q11 and Q18 and their variants, the NVRTC compiles of the second
     run (must be 0);
     the device busy share of each statement with device work (Q20
     aside). Then Q4 serial and
     on a 4-process fork pool forked after CUDA initialisation (equal),
     a ROLLUP as a union of three device legs (one B1 launch each, equal
     to the whole-frame fallback), and every B1 launch of the phase
     replayed against the plain version (exact);
  10. SSB at SF10: write_ssb_parquet at 60,000,000 lineorder rows (seed
     0), register_ssb_parquet (write and ingest seconds, host peak RSS,
     segments), the 13 queries (B1 and the packed route on every one,
     counts set to 0 just before; first run, p50 over 3, device busy
     share under torch.profiler, resident device bytes), every launch
     replayed against the plain version (exact), B1's cold and warm time
     at q1.1, q2.1 and q3.1 against the bound at SF10's bytes, phase 11's
     batch (a) over the SF10 segments (checked as in phase 11; the
     multi-leg kernel's cold and warm time against the SF10 bound), and
     q1.1 and q2.1 against the chunked pandas fallback over the same
     parquet (exact);
  11. shared-scan batches (executor.batch) on the SF1 engine: (a) the 13
     queries as one Engine.sql_batch, (b) a dashboard storm of 8 x q2.1
     and 4 x q3.1, (c) 8 threads each sending its own statement through
     Engine.sql with the coalescer on (batch_window_ms=5). Each with the
     counts set to 0 just before: every statement equals its single run
     exactly, the multi-leg kernel launches once per fused group, B1
     once per single leg and never for a fused one, one copy per group,
     and (a) and (b) run under set_sync_debug_mode("error") lifted only
     for the copy's wait. Per batch: its fused groups and single legs, first
     run (NVRTC compile of a new composition included) and p50 against
     the sum of its statements' single p50s; per composition the
     compile record (registers, spills); device busy under
     torch.profiler; every multi-leg launch replayed against the plain
     version (exact) after the counts are read; the kernel's cold and
     warm time at (a)'s largest fused group against its bound (the
     union window's bytes read once), its plain version and its legs'
     B1 launches one after another (the yardstick: no torch call
     computes a batch).
  12. caches and cubes on the SF1 engine: (a) tier 1 of the result
     cache (segment_cache_enabled) under a month-granularity timeseries
     and q2.1, each over three year partitions sliding by one, three
     steps: every step == the statement with caches off exactly, the
     segments computed == the new ones, one launch of the
     segment-extended B1 per step (counts set to 0 just before), each
     launch replayed against its plain version (exact), warm step p50s
     against caches off, and the kernel's cold and warm time against
     its bound over the computed segments, the plain version and one
     index_add_; (b) tier 2 (result_cache_enabled): the 13 queries
     twice, the second pass served from the cache with no launch of
     any wrapper, no host CUDA launch or copy call under torch.profiler
     and no copy, frames equal; hit p50s; (c) an engine over the same
     segments with hbm_budget_bytes at 40% of the 13 queries' resident
     bytes: answers == the unbudgeted engine's, evictions > 0,
     torch.cuda.memory_allocated never more than the budget plus the
     largest single query's working set over its start, p50s against
     the unbudgeted engine; (d) the 13 queries profiled, the advisor's
     specs (cube_specs_from_workload) built with create_cube (build
     time, B1 launches, stored bytes), then the 13 with the rewrite on:
     cube serves by metrics["path"] == "cube" (at least one), every
     answer == the base path exactly, per-query base and cube p50s.
  13. real-time ingest over the SF1 segments, WAL (fsync "always") and
     checkpoint store in a temp dir: (a) 38 batches of 32,768 lineorder
     rows (ssb._gen_lineorder, seed 1, order dates in 1998, order keys
     after the base's; 1,000 rows of step 20 with a brand the dictionary
     lacks), appended one by one: the first 32 acknowledged, the 33rd
     shed with IngestBackpressure (delta_rows and the WAL unchanged);
     q2.1 after each append, and q1.1, q3.1 and q4.3 too every 4th step
     and at steps 1 and 20 (B1 launched on each, counts set to 0 just
     before), at steps 1, 8 and 32 all 13 against pandas over the base
     frame plus the appended rows (per-group sums of the base, taken
     once, and of the appended rows) and against the generic torch
     reduce on the card; ack ms,
     q2.1's first run after an append vs its repeat p50, host-to-device
     bytes per append (rebase_rows_uploaded, rebased stacks) vs a full
     re-stack, NVRTC compiles per step, peak device memory, B1 replayed
     at steps 1, 20 and 32 (exact) and timed at step 32's q2.1 vs its
     bound; (b) a second engine with tier 1 on and the advisor's cubes:
     four appends, phase 12 (a)'s q2.1 over 1996-1998 computing only the
     delta segments in one segment-extended launch (replayed, exact),
     after appends 2 and 4 the 13 with cubes (serves folding delta
     segments), every answer == caches and cubes off; (c) compact_now: seconds, sealed segments before and
     after, the 13 == step 32's answers, p50s beside phase 5's; (d)
     batches 33-36, checkpoint_now (seconds, bytes), batches 37-38,
     close, a new engine over the same directories (recovery seconds:
     store load + the 2-batch WAL tail), the 13 == the old engine's;
     (e) dispatch faults open the breaker, q2.1 is served with path
     fallback_breaker == B1's answer, the healer's CUDA probe closes it
     within EngineConfig's cooldown + 1 s of the trip (timed inside the
     healer) and q2.1 launches B1 again ((e) runs between (c) and (d),
     on the ingest engine).
  14. pipeline and deadline, on engines over the SF1 segments: (a) the
     pipelined two-stage mode (pipeline_depth 4, the default) against
     the serialized one (0): the 13 in one thread, p50 over --reps per
     mode with the modes alternating, then 8 threads each running the 13
     in its own order (seed = thread index) 3 rounds; every answer ==
     phase 4's frame exactly, B1 once per statement and one copy each
     (counts set to 0 just before); per mode the wall time, statements
     per second, per-query p50 and p99 and dispatch_lock_wait_ms p50 and
     p99 from the registry; which routes still sync with the host before
     stage 2's wait (each under set_sync_debug_mode("error")), and the 13
     on the pipelined engine under it, lifted only around the event
     wait; (b) a real wedge: query_deadline_s 0.5, a fault injector
     that launches torch.cuda._sleep at the dispatch site, sized to spin
     3 s on the stream (B1 queues behind it); in each mode q2.1 raises
     QueryDeadlineExceeded within 0.65 s (deadline_exceeded recorded),
     again while the spin runs (device_probe_failed), and after the spin
     answers on the card (device_probe_recovered, stacks re-uploaded, no
     NVRTC compile, == phase 4's frame), the breaker closed; (c) the 13
     as one shared-scan batch behind a spin: every guarded dispatch
     raises QueryDeadlineExceeded within 0.65 s and every leg is boxed
     with it; after the spin the batch == phase 11 (a)'s answers; (d)
     EXPLAIN ANALYZE of q3.2: its spans with their ms (the root's
     children sum to within its total), counters() and the registry's
     lock-wait, transfer and deadline lines.
  15. serving and observability, on engines over the SF1 segments, before
     the SF1 engine closes: (a) a QueryServer on 127.0.0.1:0 over a
     CUDA engine; the 13 over POST /sql (the counts set to 0 just
     before: B1 once per statement, packed, one copy each), every answer
     == phase 4's frame (assert_frame_parity, and the JSON rows exactly),
     each X-Query-Id in sys.queries and GET /debug/queries; q2.1's native
     query over POST /druid/v2 == Engine.execute_ir; each query's p50
     over HTTP against Engine.sql's (5 runs each, in
     turns), and a kept-alive GET /healthz with TCP_NODELAY (as served)
     against Nagle on; (b) 8 HTTP clients x 3 rounds of the 13 (own order
     each, keep-alive): statements/s, p50/p99, every answer == phase 4's
     rows, B1 once per statement, while a thread scrapes GET /metrics
     (scrape ms; the text parsed in the Prometheus grammar of
     tests/test_observability.py); (c) recompiles_total +1 for a new
     structure and +0 for its other literals, sys.devices' hbm_bytes ==
     the ledger's bytes_in_use <= torch.cuda.memory_allocated, every
     sys.* table answers, history unchanged over them; (d) POST
     /debug/profile on a handler thread while a client runs q2.1 over
     HTTP (the client starts once the session is live): every launch
     call past the session's obs.profile.SESSION_PRIMERS has its kernel
     (by correlation id) and B1 sits under a q2.1 query id (up to
     PROFILE_TRIES captures); a profile_dir engine writes one
     trace per statement, each with B1 under the statement's id; then
     POST /ingest of 32,768 rows that the next POST /sql counts; (e) on
     an engine of its own, after a 20-statement q2.1 baseline, 0.2 s at
     the stage-transfer fault site fires latency_drift attributed to
     "transfer", shown in sys.alerts and GET /debug/health, cleared
     after sentinel_clear_after_s; (f) a 1 s torch.cuda._sleep spin at
     the dispatch site under a 0.5 s deadline: POST /sql 504, GET
     /readyz 503 while it spins, and after it q2.1 200 and /readyz 200.
  16. the mesh (executor.sharding), after 15, at most 60 s: 4 logical
     devices laid over the one card (utils.platform.
     force_virtual_devices(4)), engines at num_shards=4 over the SF1
     segments (98 segments padded to 100, 25 per device). (a) the 13
     under "historicals" and under force_strategy="broker": every answer
     == phase 4's exactly, B1 4 launches per statement, each on its
     device's stacks, 4 or 1 device-to-host copies; every launch replayed
     against the plain version (exact); B1 at q2.1 on one device's
     inputs against its bound; p50 over 3 runs of D=1, D=4 historicals
     and D=4 broker in turns; the "cuda" entry of planner/
     cost_calibration.json fitted from those p50s (printed, the merge's
     bytes term from the datasheet); (b) x4 under "exchange" and
     "gather" == D=1 exactly; (c) phase 12 (a)'s q2.1 sliding window with
     tier 1: 4 segment-extended launches per step, == caches off exactly,
     no NVRTC compile at a local window width seen before, every launch
     replayed (exact); (d) the 13 as one sql_batch: the multi-leg kernel
     4 times per fused group, B1 4 times per single leg, every answer ==
     phase 4's, replayed (exact); (e) phase 8's scans, pages and
     searches: the row-mask kernel 4 times each, == a D=1 engine's
     exactly, replayed (exact); (f) a failed first dispatch with
     degrade_shards_on_retry: 4 -> 2 devices, q2.1 == phase 4's; (g)
     sys.devices: 4 rows whose hbm_bytes sum to the ledger's, at most
     torch.cuda.memory_allocated. The 4 devices share one card: no
     cross-device copy and no multi-GPU speed is measured.
  17. the mesh across processes (tpu_olap_torch.bench.multihost), after
     16, at most 90 s: 2 ranks spawned, each opening a gloo process group
     (file:// store) and an engine of 2 logical devices on the one card
     (global D = 4: 50 of the 100 padded segments per rank's card), over
     the SF1 segments handed over in a file. Every rank runs the 13, x4,
     scan A, the SEARCH verb, the 13 as one batch, q2.1 with tier 1 on
     and sys.devices: every answer == phase 4's (or a one-device
     engine's), rank 0's == rank 1's exactly, B1 2 launches per aggregate
     per rank and one collective per aggregate (bytes printed), the row
     mask 2 launches per scan or search, the batch's legs alone and tier
     1 refused with the JAX package's reasons, sys.devices' process per
     device; the sum of the 13's p50s at world 2 beside phase 16's. With
     two cards or more it runs again over NCCL, one card per rank; with
     one it prints "nccl: not run (1 card)".
  Every engine the smoke builds has fallback_on_device_failure off
  (new_engine), so a failure on the card's path fails the smoke instead
  of being served by the pandas interpreter; (e) turns it on only for
  the serve while the breaker is open.
Every engine runs pipelined (EngineConfig.pipeline_depth 4) unless a
phase says otherwise. The phases run in the order 1-4, 10, 5-8, 11, 12,
13, 14, 15, 16, 17, 9. Every torch.profiler
reading stands only when
its profile holds one device activity for each kernel launch, copy and
fill the host issued in it (`profiled`): the profiler now and then drops
device activities on the chip machine (the first kernels of a session:
see PROFILE_PRIMERS).
The second-to-last lines are the kernel table as JSON and the card's
`nvidia-smi` name and power limit; the last line is the result JSON.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
# The row programs are integer code: 132 SMs x 64 INT32 lanes x 1.98 GHz
# (H100 SXM boost clock) = 16.7e12 32-bit integer operations per second.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
GEN_KERNEL = "fused_reduce_gen"        # the generated kernel's name
MASK_KERNEL = "row_mask_gen"           # the row-mask kernel's
AB_QUERIES = ("q1.1", "q2.1", "q2.2", "q3.1", "q4.3")
SF10_ROWS = 60_000_000                 # SSB lineorder rows of phase 10


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def new_engine(**cfg):
    """A port Engine with `fallback_on_device_failure` off unless `cfg`
    sets it: a failure on the card's path must fail the smoke, not be
    answered by the pandas interpreter."""
    from tpu_olap_torch import Engine
    cfg.setdefault("fallback_on_device_failure", False)
    return Engine(**cfg)


def smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            f"nvidia-smi gave no output: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def cuda_ms(fn, iters: int, between=None) -> float:
    """Mean device time of fn() over iters launches (CUDA events); with
    `between`, it runs before each launch and each launch is timed on
    its own, so its time is not counted."""
    import torch
    fn()
    torch.cuda.synchronize()
    if between is None:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters
    pairs = []
    for _ in range(iters):
        between()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


PROFILE_TRIES = 3
# In most phases the profiler lost the first 3-4 kernels of every session
# (a pause before the work, or a discarded warm-up step, did not help),
# so each session starts with this many tiny kernels of its own, which
# the readings leave out.
PROFILE_PRIMERS = 8
PRIMER_KERNEL = "spin_kernel"            # torch.cuda._sleep's kernel


def profiled(run, cpu=False):
    """Run `run()` under torch.profiler (CUDA activity, and CPU with
    `cpu`) until the profile holds one device activity for each kernel
    launch, copy and fill the host issued in it, at most PROFILE_TRIES
    times. Returns (profile, None), or (None, why not). On the chip
    machine the profiler has dropped device activities while it kept the
    host's launch and copy calls (the first kernels of a session, see
    PROFILE_PRIMERS): a profile whose device side does not count the
    measured work's calls is not a measurement."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    why = None
    for _ in range(PROFILE_TRIES):
        try:
            with profile(activities=acts) as prof:
                for _ in range(PROFILE_PRIMERS):
                    torch.cuda._sleep(100)
                torch.cuda.synchronize()
                run()
                torch.cuda.synchronize()
        except RuntimeError as e:  # CUPTI unavailable: a reading, not a fault
            return None, f"profiler failed: {e}"
        calls = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CPU]
        launched = sum(e.count for e in calls if e.key.startswith(
            ("cudaLaunchKernel", "cuLaunchKernel"))) - PROFILE_PRIMERS
        copied = sum(e.count for e in calls if e.key.startswith(
            ("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")))
        dev = device_events(prof)
        copies = sum(e.count for e in dev
                     if e.key.startswith(("Memcpy", "Memset")))
        kernels = sum(e.count for e in dev) - copies
        if launched + copied and (kernels, copies) == (launched, copied):
            return prof, None
        apis = {e.key: e.count for e in calls
                if e.key.startswith(("cudaLaunch", "cuLaunch"))}
        seen: dict = {}
        for e in dev:
            seen[e.key[:90]] = seen.get(e.key[:90], 0) + e.count
        why = (f"profiler saw {kernels} of {launched} kernel launches "
               f"{apis} and {copies} of {copied} copies and fills; device "
               f"activities seen {seen}")
    return None, f"{why}, {PROFILE_TRIES} tries"


def device_ms(fn, iters: int, kernel: str = "", between=None):
    """Device time of one fn() call, summed over the kernels it launches
    whose name holds `kernel` (torch.profiler, CUDA activity), or None
    when no profile of the calls is whole (see `profiled`). Unlike CUDA
    events around a loop, host launch gaps do not count. `between` runs
    before each call; its kernels count only if their names hold
    `kernel`."""
    import torch
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            if between is not None:
                between()
            fn()
    prof, _ = profiled(run)
    if prof is None:
        return None
    total = sum(e.self_device_time_total for e in device_events(prof)
                if kernel in e.key)
    return total / iters / 1000 if total > 0 else None


def timed(fn, iters: int, kernel: str = "", between=None):
    """(ms, how): device time per call under the profiler, else CUDA
    events around each call, queued behind a GPU-side wait of about
    0.1 ms (after `between`) so that the host's work for the call is done
    before the card reaches it."""
    import torch
    ms = device_ms(fn, iters, kernel, between)
    if ms is not None:
        return ms, "profiler device time"

    def hide_host():
        if between is not None:
            between()
        torch.cuda._sleep(200_000)  # cycles: ~0.1 ms at 1.98 GHz
    return cuda_ms(fn, iters, hide_host), \
        "CUDA events, each call behind a 0.1 ms GPU wait"


def device_events(prof):
    """The profile's device activities (kernels, copies, fills) by name.
    A CPU operator's entry carries the device time of the kernels it
    launched too, so summing over every entry would count it twice.
    The session's primer kernels (see `profiled`) are left out."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and PRIMER_KERNEL not in e.key]


def device_busy(runs, kernel=GEN_KERNEL) -> str:
    """Device time per query under torch.profiler, against the profiled
    wall clock: summed kernel time, the share of the kernels whose name
    holds `kernel`, and the idle share. `runs`: {name: fn() that runs
    the query}. A query reads "not measured" when no profile of it is
    whole (see `profiled`)."""
    import torch
    parts = []
    for name, run in runs.items():
        wall = []

        def timed_run(run=run):
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1000)
        prof, why = profiled(timed_run, cpu=True)
        if prof is None:
            parts.append(f"{name} not measured ({why})")
            continue
        evs = device_events(prof)
        dev = sum(e.self_device_time_total for e in evs) / 1000
        share = sum(e.self_device_time_total for e in evs
                    if kernel in e.key) / 1000
        parts.append(f"{name} busy {dev:.3f} ms of {wall[-1]:.3f} ms "
                     f"(idle {1 - dev / wall[-1]:.1%}, {kernel} "
                     f"{share:.3f} ms)")
    return "device busy under torch.profiler: " + "; ".join(parts)


def max_abs_diff(got, want) -> int:
    """Largest |got - want| over paired output tensors (0 when empty)."""
    return max((int((g.long() - w.long()).abs().max()) for g, w in
                zip(got, want) if g.numel()), default=0)


def synthetic_case(n, K, mixed, gen):
    """A row program and its inputs at n rows ([S, 65,536] blocks, some
    rows invalid, one segment pruned): the SSB shape (mask from a flag
    stream, key from a stream, _rows + one sum) or a mixed shape (a
    remainder filter, a negative-capable sum, a filtered count, a
    non-null count, a min and a negated max over nullable input)."""
    import torch
    from tpu_olap_torch.kernels import rowprog
    R = 65536
    S = -(-n // R)
    dev = "cuda"
    lo, hi = -(1 << 31) + 1, (1 << 31) - 1

    def ints(a, b, dtype=torch.int32):
        return torch.randint(a, b, (S, R), dtype=dtype, device=dev,
                             generator=gen)

    def flags(p):
        return torch.rand((S, R), device=dev, generator=gen) < p

    valid = flags(0.95)
    seg = torch.ones(S, dtype=torch.bool, device=dev)
    seg[S // 2] = False
    if not mixed:
        slots = (("k", "col", torch.int32), ("v", "col", torch.int32),
                 ("f", "col", torch.bool), ("", "base", torch.bool))
        t = {"k": ints(0, K), "v": ints(-1000, 10_000_000),
             "f": flags(0.7)}

        def row_fn(s):
            k, v, f, base = s
            return base & f, k, [(None, None), (v, None)], []
    else:
        slots = (("k", "col", torch.int32), ("a", "col", torch.int32),
                 ("b", "col", torch.int16), ("c", "col", torch.int32),
                 ("f", "col", torch.bool), ("nb", "null", torch.bool),
                 ("", "base", torch.bool))
        t = {"k": ints(0, K), "a": ints(lo, hi),
             "b": ints(-30000, 30000, torch.int16), "c": ints(lo, hi),
             "f": flags(0.5), "nb": flags(0.3)}

        def row_fn(s):
            k, a, b, c, f, nb, base = s
            nn = ~nb
            mask = base & (torch.remainder(a, 3) != 0)
            return (mask, k, [(None, None), (a, None), (None, f),
                              (None, nn)], [(b, nn), (-c, nn)])
    prog = rowprog.trace(row_fn, slots)
    inputs = [None if kind == "base" else t[name]
              for name, kind, _ in slots]
    return prog, inputs, valid, seg, K


def kernel_bound(prog, inputs, valid, seg_mask, K, sums):
    """(bytes_ms, ops_ms, bytes): the least time of one call with these
    inputs. Bytes: each row's valid byte; the streams of the mask's cone
    for every valid row of a kept segment; the other streams the program
    reads for the rows that pass; the program's tables and the group
    tables once. Operations: the cone's arithmetic instructions per
    valid row of a kept segment, the rest and one update per column per
    passing row, over the card's INT32 rate. Each instruction counts as
    one operation, including those the generated kernel still computes
    in 64 bits (several 32-bit instructions each), so the operations
    bound stays a lower bound."""
    import numpy as np
    from tpu_olap_torch.kernels import rowprog
    n_base = int((valid & seg_mask[:, None]).sum())
    n_sel = int(sums[:, 0].sum())   # column 0 is _rows
    read = valid.numel() + seg_mask.numel() + prog.data.nbytes
    for s in prog.loaded_slots:
        rows = n_base if s in prog.cone_slots else n_sel
        read += rows * inputs[s].element_size()
    written = K * (8 * prog.n_sum + 4 * (prog.n_cols - prog.n_sum))
    pc = prog.exit_pc
    alu = ~np.isin(prog.ins[:, 0], (rowprog.LOAD, rowprog.IMM,
                                    rowprog.EXITZ))
    ops = int(alu[:pc].sum()) * n_base \
        + (int(alu[pc + 1:].sum()) + prog.n_cols) * n_sel
    return ((read + written) / HBM_BYTES_PER_S * 1e3,
            ops / INT32_OPS_PER_S * 1e3, read + written)


def check_kernel(fr, case, label):
    """Generated kernel vs the plain version on one case; fails on any
    difference. Returns (max error, generated outputs)."""
    import torch
    got = fr.fused_reduce(*case)
    torch.cuda.synchronize()
    want = fr.fused_reduce_ref(*case)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"generated kernel output {g.shape}/{g.dtype} vs plain "
                 f"{w.shape}/{w.dtype} at {label}")
    err = max_abs_diff(got, want)
    if err:
        fail(f"generated kernel disagrees with the plain version at "
             f"{label}: max |kernel - plain| = {err}")
    return err, got


def kernel_times(name, a, sums, max_err, launches, tag, flush_l2,
                 label="", phase=None) -> dict:
    """B1's generated kernel at one main-path launch's inputs `a` (its
    group sums `sums` from the replay): device time warm (inputs left in
    the 50 MB L2 by the launch before) and cold (L2 overwritten before
    every launch, as the bound assumes), against the bound, the plain
    version and one torch index_add_ over the selected rows. Prints one
    line; returns the kernel's JSON entry."""
    import torch
    from tpu_olap_torch.kernels import fused_reduce as fr
    from tpu_olap_torch.kernels import rowprog
    prog, inputs, valid, seg_mask, K = a
    bytes_ms, ops_ms, nbytes = kernel_bound(*a, sums)
    bound = max(bytes_ms, ops_ms)
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    warm, cold, hows = [], [], {}
    for _ in range(2):
        for runs, between in ((warm, None), (cold, flush_l2)):
            ms, how = timed(lambda: fr.fused_reduce(*a), 20, GEN_KERNEL,
                            between)
            runs.append(ms)
            hows[how] = None
    gen_ms = sum(cold) / 2
    plain_ms, plain_how = timed(lambda: fr.fused_reduce_ref(*a), 5)
    # yardstick: one torch call reducing the same sum columns over the
    # selected rows' keys, gathered outside the timing
    base = (valid & seg_mask[:, None]).reshape(-1)
    regs = rowprog.evaluate(prog, inputs, base.numel(), "cuda")
    sel = base & (regs[prog.mask_reg] != 0)
    k_sel = regs[prog.key_reg][sel]
    src = torch.stack(
        [torch.ones_like(k_sel) if v < 0 else regs[v][sel]
         for v in prog.val_regs[:prog.n_sum]], 1)
    out = torch.zeros((K, prog.n_sum), dtype=torch.int64, device="cuda")
    lib_ms, lib_how = timed(lambda: out.index_add_(0, k_sel, src), 20)
    event_ms = cuda_ms(lambda: fr.fused_reduce(*a), 20)
    n_sel = int(sums[:, 0].sum())
    kern = fr.compiled(prog, K, "cuda")
    del regs, sel, src, out
    at = f"{name}{label}"
    phase = phase or ("10" if label else "5")
    print(f"[{phase} kernel] at {at} (N={valid.numel()}, "
          f"rows in kept segments {int((valid & seg_mask[:, None]).sum())}, "
          f"selected {n_sel}, K={K}, columns {prog.n_cols}): generated, warm "
          f"L2 {warm[0]:.4f} / {warm[1]:.4f} ms, cold L2 {cold[0]:.4f} / "
          f"{cold[1]:.4f} ms ({'; '.join(hows)}) | bound {bound:.4f} ms "
          f"({nbytes} B, {by}; bytes {bytes_ms:.4f}, operations "
          f"{ops_ms:.4f}) = generated at {gen_ms / bound:.1f}x the bound "
          f"cold, {sum(warm) / 2 / bound:.1f}x warm | plain "
          f"{plain_ms:.4f} ms ({plain_how}) | index_add_ over the selected "
          f"rows {lib_ms:.4f} ms ({lib_how}) | back-to-back wrapper calls between CUDA "
          f"events {event_ms:.4f} ms each | grid {kern.last_grid} "
          f"blocks ({kern.blocks_per_sm} per SM) {tag}", flush=True)
    # ms: cold-L2 device time, the bound's own terms
    return {"name": "fused_reduce", "route": "cuda",
            "source": "tpu_olap_torch/csrc/fused_reduce_gen.cuh",
            "replaces": "tpu_olap/kernels/pallas_reduce.py:536",
            "launches": launches, "max_abs_err": max_err, "ms": gen_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms, "at": at}


def plan_report(kern) -> str:
    """A generated kernel's compile record, one line."""
    r = kern.report
    spill = r.get("spill_bytes", "not reported")
    return (f"compile {kern.compile_ms:.1f} ms"
            f"{' (disk cache)' if kern.cached else ''}, "
            f"{kern.registers} registers (ptxas: "
            f"{r.get('registers', 'not reported')}), spill bytes {spill}, "
            f"stack {r.get('stack_bytes', 'not reported')} B, local "
            f"{kern.local_bytes} B, shared table {kern.smem_bytes} B, "
            f"{kern.blocks_per_sm} blocks of {kern.threads} threads per SM "
            f"({kern.max_blocks} launched at most)")


class SyncChecked:
    """torch.cuda.set_sync_debug_mode("error") around a block, lifted
    only inside runner.wait_event (stage 2's wait for the route's one
    device-to-host copy, which stage 1 queued non-blocking into pinned
    memory), so any other host sync raises."""

    def __enter__(self):
        import torch
        from tpu_olap_torch.executor import runner as runner_mod
        self.real = real = runner_mod.wait_event

        def wait_allowed(event):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return real(event)
            finally:
                torch.cuda.set_sync_debug_mode("error")

        runner_mod.wait_event = wait_allowed
        torch.cuda.set_sync_debug_mode("error")
        return self

    def __exit__(self, *exc):
        import torch
        from tpu_olap_torch.executor import runner as runner_mod
        torch.cuda.set_sync_debug_mode(0)
        runner_mod.wait_event = self.real
        return False


def packed_phase(eng, reps, tag):
    """Phase 6: no host sync before the one copy of the packed route;
    packed against unpacked p50s, in turns."""
    import numpy as np
    from tpu_olap_torch.bench import ssb
    eng.config.use_fused_reduce = "auto"
    with SyncChecked():
        for name, q in ssb.QUERIES.items():
            try:
                eng.sql(q)
            except RuntimeError as e:
                fail(f"{name}: the packed route syncs with the host before "
                     f"its copy: {e}")
            m = eng.runner.last_metrics
            if m["route"] != "packed" or m["host_copies"] != 1:
                fail(f"{name} under sync debug: route {m['route']}, "
                     f"{m['host_copies']} copies")
    print("[6 packed] 13/13 queries ran the packed route under "
          "torch.cuda.set_sync_debug_mode('error') (lifted only for stage "
          "2's wait on the one device-to-host copy): no host sync before "
          "it", flush=True)

    def unpacked(plan, metrics):
        return None  # _run_agg then takes the unpacked route

    times = {}
    for name, q in ssb.QUERIES.items():
        ts = {"packed": [], "unpacked": []}
        for route in ("packed", "unpacked", "unpacked", "packed") * reps:
            if route == "unpacked":
                eng.runner._run_packed = unpacked
            t = time.perf_counter()
            eng.sql(q)
            ms = (time.perf_counter() - t) * 1000
            eng.runner.__dict__.pop("_run_packed", None)
            if eng.runner.last_metrics["route"] != route:
                fail(f"{name} took {eng.runner.last_metrics['route']}, "
                     f"not {route}")
            ts[route].append(ms)
        times[name] = {r: float(np.median(v)) for r, v in ts.items()}
        print(f"[6 packed] {name} p50 packed {times[name]['packed']:.3f} ms |"
              f" unpacked {times[name]['unpacked']:.3f} ms ({2 * reps} runs "
              f"each, in turns) {tag}", flush=True)
    tot = {r: sum(t[r] for t in times.values()) for r in ("packed",
                                                          "unpacked")}
    print(f"[6 packed] sum of the 13 p50s: packed {tot['packed']:.3f} ms, "
          f"unpacked {tot['unpacked']:.3f} ms {tag}", flush=True)


def top_kernels(fn, n=6) -> str:
    """The n kernels with the most device time in one fn() call, under
    torch.profiler; "not measured" when no profile of it is whole."""
    prof, why = profiled(fn, cpu=True)
    if prof is None:
        return f"not measured ({why})"
    evs = [e for e in device_events(prof) if e.self_device_time_total > 0]
    evs.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in evs) / 1000
    return f"device {total:.3f} ms in {len(evs)} kernels; " + "; ".join(
        f"{e.key[:70]} x{e.count} {e.self_device_time_total / 1000:.3f} ms"
        for e in evs[:n])


def distinct_phase(eng, d, reps, tag):
    """Phase 7: x1-x4 on the card, checked against pandas and against the
    same torch functions on CPU tensors."""
    import numpy as np
    import torch
    from tpu_olap_torch.bench import ssb
    from tpu_olap_torch.bench.parity import assert_frame_parity
    routes = {"x1": "packed", "x2": "packed", "x3": "unpacked",
              "x4": "sparse"}
    got = {}
    for name, q in ssb.DISTINCT_QUERIES.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        got[name] = eng.sql(q)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t) * 1000
        m = dict(eng.runner.last_metrics)
        peak = torch.cuda.max_memory_allocated()
        if m["route"] != routes[name]:
            fail(f"{name} took the {m['route']} route")
        if m["route"] == "sparse" and bool(m["sparse_reruns"]) != \
                (m["result_groups"] > eng.config.sparse_group_cap):
            fail(f"{name}: {m['result_groups']} groups against a first cap "
                 f"of {eng.config.sparse_group_cap}, re-runs at "
                 f"{m['sparse_reruns']}")
        ts, unpacked = [], []
        for _ in range(reps):
            t = time.perf_counter()
            eng.sql(q)
            ts.append((time.perf_counter() - t) * 1000)
            if m["route"] == "packed":
                # the same query unpacked: its sketch state crosses
                eng.runner._run_packed = lambda plan, metrics: None
                t = time.perf_counter()
                eng.sql(q)
                unpacked.append((time.perf_counter() - t) * 1000)
                del eng.runner._run_packed
        if unpacked:
            print(f"[7 distinct] {name} p50 in turns: packed "
                  f"{float(np.median(ts)):.3f} ms, unpacked "
                  f"{float(np.median(unpacked)):.3f} ms {tag}", flush=True)
        print(f"[7 distinct] {name}: {len(got[name])} rows, route "
              f"{m['route']}, fused_reason {m.get('fused_reason')!r}, "
              f"groups {m.get('result_groups')}, sparse re-runs at caps "
              f"{m.get('sparse_reruns', [])}, host copies {m['host_copies']}"
              f" | first run {first:.1f} ms, p50 {float(np.median(ts)):.3f} "
              f"ms (later runs' host copies "
              f"{eng.runner.last_metrics['host_copies']}) | "
              f"torch.cuda.max_memory_allocated {peak} {tag}", flush=True)
    # x3 and x4 against pandas exactly, x1 and x2 within the approx band
    for _, r in got["x3"].iterrows():
        sub = d[d.c_region == r["c_region"]]
        want = len(set(sub[sub.d_year == 1997].lo_custkey)
                   & set(sub[sub.d_year == 1998].lo_custkey))
        if int(r["retained"]) != want:
            fail(f"x3 {r['c_region']}: {r['retained']} != pandas {want}")
    m = (d.c_region == "AMERICA") & (d.s_region == "AMERICA")
    ref = (d[m].groupby(["d_year", "c_city", "s_city", "p_brand1"])
           .agg(revenue=("lo_revenue", "sum"),
                orders=("lo_revenue", "size"))
           .reset_index().sort_values("revenue", ascending=False).head(100))
    assert_frame_parity(got["x4"].astype({"d_year": np.int64}),
                        ref.astype({"d_year": np.int64}), ordered=True,
                        label="x4/pandas")
    for name, keys, col, src in (
            ("x1", ["d_yearmonth", "s_nation"], "customers", "lo_custkey"),
            ("x2", ["c_region", "d_year"], "parts", "lo_partkey")):
        ref = d.groupby(keys)[src].nunique().reset_index(name=col)
        g = got[name][keys + [col]].astype({k: ref[k].dtype for k in keys})
        assert_frame_parity(g, ref, approx_cols=(col,),
                            label=f"{name}/pandas")
        err = np.abs(g.sort_values(keys)[col].to_numpy()
                     / ref.sort_values(keys)[col].to_numpy() - 1)
        print(f"[7 distinct] {name} vs pandas nunique: {len(ref)} groups, "
              f"relative error max {err.max():.4f}, mean {err.mean():.4f}"
              f" (band 0.12)", flush=True)
    print("[7 distinct] x3 == pandas set intersections, x4 top 100 == "
          "pandas groupby", flush=True)
    # the sketch state and sparse partials: card against CPU tensors
    runner = eng.runner
    for name in ("x1", "x2", "x3", "x4"):
        pq = eng.planner.plan(ssb.DISTINCT_QUERIES[name])
        plan = runner._lower_cached(pq.query, pq.entry.segments)
        env, valid, seg, consts = runner._dispatch_args(plan, {})
        kern = plan.make_sparse_kernel(1 << 18) if plan.sparse \
            else plan.kernel
        on_card = {k: v.cpu() for k, v in kern(env, valid, seg,
                                               consts).items()}
        cpu_env = {g: {c: a.cpu() for c, a in env[g].items()}
                   for g in ("cols", "nulls")}
        on_cpu = kern(cpu_env, valid.cpu(), seg.cpu(),
                      {k: v.cpu() for k, v in consts.items()})
        names = sorted(on_cpu)
        for k in names:
            a, b = on_card[k], on_cpu[k]
            if a.shape != b.shape or a.dtype != b.dtype or \
                    not torch.equal(a, b):
                fail(f"{name} {k}: the card's partial differs from the CPU's")
        sk = [p.name for p in plan.agg_plans if p.kind in ("hll", "theta")]
        print(f"[7 state] {name}: {len(names)} partial tables equal on the "
              f"card and on CPU tensors exactly (sketch state: "
              f"{[(k, tuple(on_card[k].shape)) for k in sk]})", flush=True)
    # device time by kernel: the HLL scatter, the theta sort, the sparse
    # sort
    for name in ssb.DISTINCT_QUERIES:
        q = ssb.DISTINCT_QUERIES[name]
        print(f"[7 device] {name} under torch.profiler: "
              f"{top_kernels(lambda: eng.sql(q))} {tag}", flush=True)


# -- phase 8: scans, select pages, searches and metadata -------------------

SCAN_A = ("SELECT lo_extendedprice, lo_discount, lo_quantity, d_year FROM "
          "lineorder WHERE d_year = 1993 AND lo_discount BETWEEN 1 AND 3 "
          "AND lo_quantity < 25 LIMIT 100")
SCAN_B = ("SELECT __time, lo_orderkey, lo_revenue, c_city FROM lineorder "
          "WHERE __time >= TIMESTAMP '1995-03-01' AND "
          "__time < TIMESTAMP '1995-04-01' AND lo_quantity < 3 "
          "ORDER BY __time DESC LIMIT 50 OFFSET 1000")
SCAN_C = ("SELECT lo_orderkey, lo_revenue, lo_quantity, c_city FROM "
          "lineorder WHERE p_brand1 = 'MFGR#2221' AND s_region = 'AMERICA'")
SEARCH_VERB = "SEARCH DRUID DATASOURCE lineorder FOR 'united'"
SEARCH_CITIES = {"queryType": "search", "dataSource": "lineorder",
                 "searchDimensions": ["c_city", "s_city"],
                 "query": {"type": "insensitive_contains", "value": "united"},
                 "limit": 20, "sort": {"type": "strlen"}}
SEARCH_NUMERIC = {"queryType": "search", "dataSource": "lineorder",
                  "searchDimensions": ["d_year", "c_region"],
                  "query": {"type": "insensitive_contains", "value": "9"}}
TIME_BOUNDARY = {"queryType": "timeBoundary", "dataSource": "lineorder"}
TIME_BOUNDS = [{"queryType": "timeBoundary", "dataSource": "lineorder",
                "bound": b, "intervals": ["1994-05-01/1996-02-01"]}
               for b in ("minTime", "maxTime")]
SEGMENT_METADATA = {"queryType": "segmentMetadata",
                    "dataSource": "lineorder"}


def mask_bound(prog, inputs, valid, seg_mask):
    """(bytes_ms, ops_ms, bytes) of one row-mask launch on these inputs:
    the valid bytes of kept segments, the mask cone's streams for their
    valid rows, the program's tables and the mask written (every row);
    operations: the cone's instructions per valid row of a kept
    segment, over the card's INT32 rate."""
    import numpy as np
    from tpu_olap_torch.kernels import rowprog
    kept = int(seg_mask.sum())
    n_base = int((valid & seg_mask[:, None]).sum())
    read = kept * valid.shape[1] + seg_mask.numel() + prog.data.nbytes
    for s in prog.cone_slots:
        read += n_base * inputs[s].element_size()
    nbytes = read + valid.numel()
    alu = ~np.isin(prog.ins[:prog.exit_pc, 0],
                   (rowprog.LOAD, rowprog.IMM, rowprog.EXITZ))
    ops = int(alu.sum()) * n_base
    return (nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3,
            nbytes)


def scan_phase(eng, d, reps, tag, flush_l2):
    """Phase 8: the non-aggregate query types on the card, each against
    an Engine(device="cpu") over the same segments. Returns the row-mask
    kernel's JSON entry."""
    import numpy as np
    import pandas as pd
    import torch
    from tpu_olap_torch.bench import ssb
    from tpu_olap_torch.kernels import fused_reduce as fr
    from tpu_olap_torch.kernels import row_mask as rm
    eng.config.use_fused_reduce = "auto"
    entry = eng.catalog.get("lineorder")
    seg = entry.segments
    cpu = new_engine(device="cpu")
    cpu.register_table("lineorder", None, time_column=entry.time_column,
                       star_schema=ssb.star_schema(), segments=seg)
    pages = [0, 100, 200]

    def page(e, off):
        return e.select_page("lineorder", columns=("c_city", "s_city"),
                             page_size=100, offset=off)

    # (name, kind, fn(engine) -> result, mask launches, host copies)
    queries = [
        ("scan A", "scan", lambda e: e.sql(SCAN_A), 1, 1),
        ("scan B", "scan", lambda e: e.sql(SCAN_B), 1, 1),
        ("scan C", "scan", lambda e: e.sql(SCAN_C), 1, 1),
        *[(f"select page {i + 1}", "select",
           lambda e, o=o: page(e, o), 1, 1) for i, o in enumerate(pages)],
        ("search verb", "search", lambda e: e.sql(SEARCH_VERB), 1, 1),
        ("search IN c_city, s_city", "search",
         lambda e: e.execute_ir(SEARCH_CITIES), 1, 1),
        ("search d_year, c_region", "search",
         lambda e: e.execute_ir(SEARCH_NUMERIC), 1, 2),
        ("time boundary", "metadata",
         lambda e: e.execute_ir(TIME_BOUNDARY), 0, 0),
        *[(f"time boundary {q['bound']}", "metadata",
           lambda e, q=q: e.execute_ir(q), 0, 0) for q in TIME_BOUNDS],
        ("segment metadata", "metadata",
         lambda e: e.execute_ir(SEGMENT_METADATA), 0, 0),
        ("explain scan A", "verb",
         lambda e: e.sql("EXPLAIN DRUID REWRITE " + SCAN_A), 0, 0),
    ]

    def same(a, b, label):
        if isinstance(a, pd.DataFrame):
            try:
                pd.testing.assert_frame_equal(a, b, check_exact=True)
            except AssertionError as e:
                fail(f"{label}: the card's frame differs from the CPU "
                     f"engine's: {e}")
        elif isinstance(a, tuple):
            if a != b:
                fail(f"{label}: the card's page differs from the CPU's")
        elif a.rows != b.rows or a.druid != b.druid:
            fail(f"{label}: the card's result differs from the CPU's")

    def size(r):
        if isinstance(r, tuple):
            return len(r[0])
        return len(r) if isinstance(r, pd.DataFrame) else len(r.rows)

    # the main path: every mask launch recorded (its inputs) for replay
    calls, current = {}, [None]
    real = rm.row_mask

    def record(*a):
        calls.setdefault(current[0], a)
        return real(*a)

    rm.row_mask = record
    rm.launches = 0
    fr_before = fr.launches
    got, first, metrics, launched = {}, {}, {}, {}
    try:
        for name, _, fn, _, _ in queries:
            current[0] = name
            before = rm.launches
            t = time.perf_counter()
            got[name] = fn(eng)
            torch.cuda.synchronize()
            first[name] = (time.perf_counter() - t) * 1000
            launched[name] = rm.launches - before
            metrics[name] = dict(eng.runner.last_metrics)
        mask_launches = rm.launches
        numeric_fused = fr.launches - fr_before
    finally:
        rm.row_mask = real
    for name, kind, fn, want_launches, want_copies in queries:
        m = metrics[name]
        if launched[name] != want_launches:
            fail(f"{name}: the row-mask kernel launched {launched[name]} "
                 f"times, not {want_launches}")
        if kind in ("scan", "select", "search") and (
                m.get("host_copies") != want_copies
                or not m.get("mask_kernel")):
            fail(f"{name}: {m.get('host_copies')} device-to-host copies, "
                 f"mask kernel {m.get('mask_kernel')} "
                 f"({m.get('mask_reason')})")
        same(got[name], fn(cpu), name)
        if size(got[name]) == 0:
            fail(f"{name} returned nothing")
    if numeric_fused < 1:
        fail("the numeric search dimension's GroupBy did not launch the "
             "fused kernel")
    print(f"[8 scan] {len(queries)} queries: answers == Engine(device="
          f"'cpu') exactly; row-mask launches per query "
          f"{json.dumps(launched)} ({mask_launches} in all); fused-kernel "
          f"launches of the numeric search dimension {numeric_fused}",
          flush=True)

    # scan C against pandas on the denormalized frame
    m = (d.p_brand1 == "MFGR#2221") & (d.s_region == "AMERICA")
    c = got["scan C"]
    if len(c) != int(m.sum()) or any(
            int(c[k].sum()) != int(d[k][m].sum())
            for k in ("lo_orderkey", "lo_revenue", "lo_quantity")):
        fail(f"scan C: {len(c)} rows against pandas {int(m.sum())}, or "
             "its column sums differ")
    # scan B cuts the segment window and its offset crosses a segment
    mb = metrics["scan B"]
    if "segments_window" not in mb:
        fail("scan B did not cut the segment window")
    plan = cpu.runner._lower_cached(cpu.planner.plan(SCAN_B).query, seg)
    per_seg = cpu.runner._run_mask(plan, {}).sum(1)
    per_seg = [int(x) for x in per_seg if int(x)][::-1]   # descending
    if not per_seg or per_seg[0] > 1000:
        fail(f"scan B's OFFSET 1000 stays in its first segment: passing "
             f"rows per segment, descending {per_seg}")
    print(f"[8 scan] scan C == pandas ({len(c)} rows, column sums); scan B "
          f"window {mb['segments_window']} of {mb['segments_total']} "
          f"segments, passing rows per segment descending {per_seg}: "
          f"OFFSET 1000 crosses from the first into a later one",
          flush=True)

    # replay every mask launch: kernel against its plain version
    max_err = 0
    for name, a in calls.items():
        k = rm.row_mask(*a)
        torch.cuda.synchronize()
        ref = rm.row_mask_ref(*a)
        if k.shape != ref.shape or k.dtype != ref.dtype:
            fail(f"{name}: row-mask kernel output {k.shape}/{k.dtype} vs "
                 f"plain {ref.shape}/{ref.dtype}")
        diff = int((k != ref).sum())
        max_err = max(max_err, diff)
        if diff:
            fail(f"{name}: the row-mask kernel disagrees with the plain "
                 f"version on {diff} rows")
    print(f"[8 replay] {len(calls)} row-mask launches replayed: kernel == "
          f"plain version on every row", flush=True)

    # no host sync before the one copy
    with SyncChecked():
        for name, kind, fn, _, _ in queries:
            if kind in ("scan", "select", "search"):
                try:
                    fn(eng)
                except RuntimeError as e:
                    fail(f"{name}: a host sync before the copy: {e}")
    print("[8 sync] scans, pages and searches ran under torch.cuda."
          "set_sync_debug_mode('error'), lifted only for the copy's wait: "
          "no host sync before it", flush=True)

    # timings
    for name, kind, fn, _, _ in queries:
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn(eng)
            ts.append((time.perf_counter() - t) * 1000)
        m = metrics[name]
        print(f"[8 query] {name} ({kind}): {size(got[name])} rows | first "
              f"run {first[name]:.1f} ms, p50 {float(np.median(ts)):.3f} ms "
              f"| route {m.get('route')}, host copies {m.get('host_copies')},"
              f" bytes copied {m.get('host_bytes', 0)}, mask launches "
              f"{launched[name]}, window {m.get('segments_window', '-')} "
              f"{tag}", flush=True)
    busy = device_busy({name: (lambda fn=fn: fn(eng))
                        for name, kind, fn, _, _ in queries
                        if kind in ("scan", "select", "search")},
                       MASK_KERNEL)
    print(f"[8 device] {busy} {tag}", flush=True)
    for name, kind, fn, _, _ in queries:
        if name in ("scan A", "scan C", "search verb"):
            print(f"[8 device] {name} under torch.profiler: "
                  f"{top_kernels(lambda fn=fn: fn(eng), 4)} {tag}",
                  flush=True)
    t = time.perf_counter()
    out = eng.sql("CLEAR DRUID CACHE")
    clear_ms = (time.perf_counter() - t) * 1000
    if out.status[0] != "cleared cache" or eng.runner.device_bytes():
        fail(f"CLEAR DRUID CACHE left {eng.runner.device_bytes()} bytes")
    t = time.perf_counter()
    again = eng.sql(SCAN_A)
    torch.cuda.synchronize()
    again_ms = (time.perf_counter() - t) * 1000
    same(again, got["scan A"], "scan A after CLEAR DRUID CACHE")
    print(f"[8 query] CLEAR DRUID CACHE {clear_ms:.1f} ms, then scan A's "
          f"first run after re-upload {again_ms:.1f} ms (before the clear: "
          f"first run {first['scan A']:.1f} ms) {tag}", flush=True)

    # the kernel at each scan's inputs: device time warm and cold against
    # its bound, and the plain version's time
    entry_json = None
    for name in ("scan A", "scan B", "scan C"):
        a = calls[name]
        prog, inputs, valid, seg_mask = a
        bytes_ms, ops_ms, nbytes = mask_bound(*a)
        bound = max(bytes_ms, ops_ms)
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        warm, how = timed(lambda: rm.row_mask(*a), 20, MASK_KERNEL)
        cold, cold_how = timed(lambda: rm.row_mask(*a), 20, MASK_KERNEL,
                               flush_l2)
        plain, plain_how = timed(lambda: rm.row_mask_ref(*a), 5)
        kern = rm.compiled(prog, "cuda")
        print(f"[8 kernel] row mask at {name} ({valid.numel()} rows in the "
              f"window, {int(seg_mask.sum())} of {seg_mask.numel()} segments "
              f"kept, {len(prog.cone_slots)} cone streams, "
              f"{prog.exit_pc - prog.n_pro} row instructions): cold "
              f"{cold:.4f} ms ({cold_how}), warm {warm:.4f} ms ({how}) | "
              f"bound "
              f"{bound:.4f} ms ({nbytes} B, {by}; bytes {bytes_ms:.4f}, "
              f"operations {ops_ms:.4f}) = {cold / bound:.1f}x cold, "
              f"{warm / bound:.1f}x warm | plain {plain:.4f} ms "
              f"({plain_how}) | "
              f"{plan_report(kern)} {tag}", flush=True)
        if entry_json is None:
            entry_json = {
                "name": "row_mask", "route": "cuda",
                "source": "tpu_olap_torch/csrc/row_mask_gen.cuh",
                "replaces": "tpu_olap/executor/lowering.py:654 (_lower_mask,"
                            " an XLA program, not Pallas)",
                "launches": mask_launches, "max_abs_err": max_err,
                "ms": cold, "plain_ms": plain, "bound_ms": bound,
                "bound_by": by, "library_ms": None, "at": name}
    return entry_json



# -- phase 11: shared-scan batches -----------------------------------------

MULTI_KERNEL = "fused_reduce_multi_gen"   # the multi-leg kernel's name
STORM = ("q2.1",) * 8 + ("q3.1",) * 4    # a dashboard storm
COALESCED = ("q1.1", "q1.2", "q2.1", "q2.2", "q3.1", "q3.2", "q4.1", "q4.2")


def multi_bound(progs, inputs, valid, seg_masks, Ks, sums):
    """(bytes_ms, ops_ms, bytes) of one multi-leg launch, every input
    read once. Bytes: the valid bytes of the segments some leg keeps;
    a mask-cone stream over the valid rows of the union of the segments
    kept by the legs whose cone reads it; any other stream over the most
    rows that pass one leg reading it (a lower bound on their union,
    which is not known row by row); each leg's segment mask, tables and
    group table once. Operations: kernel_bound's, summed over the
    legs."""
    import numpy as np
    import torch
    from tpu_olap_torch.kernels import rowprog
    cone = {}    # data pointer -> (bytes per row, union of segment masks)
    passed = {}  # data pointer -> (bytes per row, most rows passing a leg)
    kept = seg_masks[0].clone()
    read, written, ops = 0, 0, 0
    for prog, ins, seg, K, s in zip(progs, inputs, seg_masks, Ks, sums):
        kept |= seg
        n_base = int((valid & seg[:, None]).sum())
        n_sel = int(s[:, 0].sum())   # column 0 is _rows
        read += seg.numel() + prog.data.nbytes
        for slot in prog.loaded_slots:
            t = ins[slot]
            key, size = t.data_ptr(), t.element_size()
            if slot in prog.cone_slots:
                _, segs = cone.get(key, (size, torch.zeros_like(seg)))
                cone[key] = (size, segs | seg)
            else:
                passed[key] = (size, max(passed.get(key, (size, 0))[1],
                                         n_sel))
        written += K * (8 * prog.n_sum + 4 * (prog.n_cols - prog.n_sum))
        pc = prog.exit_pc
        alu = ~np.isin(prog.ins[:, 0], (rowprog.LOAD, rowprog.IMM,
                                        rowprog.EXITZ))
        ops += int(alu[:pc].sum()) * n_base \
            + (int(alu[pc + 1:].sum()) + prog.n_cols) * n_sel
    read += int(kept.sum()) * valid.shape[1]
    for key, (size, segs) in cone.items():
        rows = int((valid & segs[:, None]).sum())
        read += size * max(rows, passed.pop(key, (size, 0))[1])
    read += sum(size * rows for size, rows in passed.values())
    return ((read + written) / HBM_BYTES_PER_S * 1e3,
            ops / INT32_OPS_PER_S * 1e3, read + written)


def check_multi(fr, a, label):
    """The multi-leg kernel vs its plain version on one recorded launch;
    fails on any difference. Returns (max error, the kernel's sums per
    leg)."""
    import torch
    got = fr.fused_reduce_multi(*a)
    torch.cuda.synchronize()
    want = fr.fused_reduce_multi_ref(*a)
    torch.cuda.synchronize()
    err = 0
    for leg, (g, w) in enumerate(zip(got, want)):
        for x, y in zip(g, w):
            if x.shape != y.shape or x.dtype != y.dtype:
                fail(f"multi-leg kernel leg {leg} output {x.shape}/{x.dtype}"
                     f" vs plain {y.shape}/{y.dtype} at {label}")
        err = max(err, max_abs_diff(g, w))
    if err:
        fail(f"multi-leg kernel disagrees with the plain version at {label}: "
             f"max |kernel - plain| = {err}")
    return err, [g[0] for g in got]


def multi_times(label, a, sums, max_err, launches, tag, flush_l2) -> dict:
    """The multi-leg kernel at one recorded launch's inputs `a`: device
    time warm and cold against its bound, the plain version, and the
    yardstick: its legs' B1 launches, one after another on the same
    inputs (no single torch call computes the batch). Prints one line;
    returns the kernel's JSON entry."""
    from tpu_olap_torch.kernels import fused_reduce as fr
    progs, inputs, valid, seg_masks, Ks = a
    bytes_ms, ops_ms, nbytes = multi_bound(*a, sums)
    bound = max(bytes_ms, ops_ms)
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    warm, cold, hows = [], [], {}
    for _ in range(2):
        for runs, between in ((warm, None), (cold, flush_l2)):
            ms, how = timed(lambda: fr.fused_reduce_multi(*a), 20,
                            MULTI_KERNEL, between)
            runs.append(ms)
            hows[how] = None
    multi_ms = sum(cold) / 2

    def legs_b1():
        for leg in zip(progs, inputs, seg_masks, Ks):
            p, i, s, K = leg
            fr.fused_reduce(p, i, valid, s, K)
    b1_ms, b1_how = timed(legs_b1, 10, GEN_KERNEL, flush_l2)
    plain_ms, plain_how = timed(lambda: fr.fused_reduce_multi_ref(*a), 3)
    kern = fr.compiled_multi(progs, Ks, "cuda")
    rows = int(sum(int((valid & s[:, None]).sum()) for s in seg_masks))
    print(f"[11 kernel] at {label} ({len(progs)} legs, K {list(Ks)}, valid "
          f"{valid.numel()} rows, leg rows in kept segments {rows}): "
          f"multi-leg warm L2 {warm[0]:.4f} / {warm[1]:.4f} ms, cold L2 "
          f"{cold[0]:.4f} / {cold[1]:.4f} ms ({'; '.join(hows)}) | bound "
          f"{bound:.4f} ms ({nbytes} B, {by}; bytes {bytes_ms:.4f}, "
          f"operations {ops_ms:.4f}) = {multi_ms / bound:.1f}x the bound "
          f"cold, {sum(warm) / 2 / bound:.1f}x warm | the legs' B1 launches "
          f"one after another, each cold: {b1_ms:.4f} ms ({b1_how}) | plain "
          f"{plain_ms:.4f} ms ({plain_how}) | grid {kern.last_grid} blocks "
          f"({kern.blocks_per_sm} per SM), {plan_report(kern)} {tag}",
          flush=True)
    return {"name": "fused_reduce_multi", "route": "cuda",
            "source": "tpu_olap_torch/csrc/fused_reduce_multi_gen.cuh",
            "replaces": "tpu_olap/executor/batch.py:441",
            "launches": launches, "max_abs_err": max_err, "ms": multi_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "at": label}


class MultiRecorder:
    """Records every call of fused_reduce_multi (its inputs, not copies)
    while active, for the replay after the counts are read."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from tpu_olap_torch.kernels import fused_reduce as fr
        self.real = real = fr.fused_reduce_multi

        def record(*a):
            self.calls.append(a)
            return real(*a)
        fr.fused_reduce_multi = record
        return self

    def __exit__(self, *exc):
        from tpu_olap_torch.kernels import fused_reduce as fr
        fr.fused_reduce_multi = self.real
        return False


def batch_layout(stmts, names) -> tuple:
    """(fused groups {batch_id: [names]}, single legs, B1 runs expected,
    multi-leg launches expected) from sql_batch's per-statement
    metrics."""
    groups, singles = {}, []
    b1 = multi = 0
    for name, m in zip(names, stmts):
        if m.get("route") == "batch":
            groups.setdefault(m["batch_id"], []).append(name)
        else:
            singles.append(name)
            b1 += not m.get("batch_dedup")
    seen = set()
    for name, m in zip(names, stmts):
        if m.get("route") == "batch" and m["batch_id"] not in seen:
            seen.add(m["batch_id"])
            multi += m["fused_batch"] > 0
    return groups, singles, b1, multi


def run_checked_batch(eng, names, single, label, tag, sync_checked=True):
    """One Engine.sql_batch of `names` with the launch counts set to 0 just
    before: each statement == its single run exactly, one multi-leg
    launch per fused group, no B1 launch for a fused leg, one copy per
    group (and, with sync_checked, no host sync before it). Returns
    (first-run ms, recorded multi-leg launches, multi-leg launches)."""
    import pandas as pd
    import torch
    from tpu_olap_torch.bench import ssb
    from tpu_olap_torch.kernels import fused_reduce as fr
    sqls = [ssb.QUERIES[n] for n in names]
    with MultiRecorder() as rec:
        fr.launches = fr.multi_launches = 0
        t = time.perf_counter()
        if sync_checked:
            with SyncChecked():
                try:
                    frames = eng.sql_batch(sqls)
                except RuntimeError as e:
                    fail(f"{label}: a host sync before a copy: {e}")
        else:
            frames = eng.sql_batch(sqls)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t) * 1000
        b1, multi = fr.launches, fr.multi_launches
    stmts = eng.runner.last_metrics["statements"]
    groups, singles, want_b1, want_multi = batch_layout(stmts, names)
    for name, f, m in zip(names, frames, stmts):
        try:
            pd.testing.assert_frame_equal(f, single[name])
        except AssertionError as e:
            fail(f"{label}: {name} differs from its single run: {e}")
        if m.get("host_copies") != 1:
            fail(f"{label}: {name} took {m.get('host_copies')} copies")
    if not groups or multi != want_multi or b1 != want_b1:
        fail(f"{label}: fused groups {groups}, singles {singles}: multi-leg "
             f"launches {multi} (want {want_multi}), B1 launches {b1} "
             f"(want {want_b1})")
    print(f"[11 batch] {label}: {len(names)} statements, fused groups "
          f"(batch_id: statements) {json.dumps(groups)}, single legs "
          f"{singles}; multi-leg launches {multi} (one per fused group), B1 "
          f"launches {b1} (one per single leg), one copy per group"
          + (" with no host sync before it" if sync_checked else "")
          + f"; every statement == its single run exactly; first run "
          f"{first:.1f} ms {tag}", flush=True)
    return first, rec.calls, multi


def batch_phase(eng, reps, tag, flush_l2):
    """Phase 11: shared-scan batches on the SF1 engine. Returns the
    multi-leg kernel's JSON entry at batch (a)'s largest fused group."""
    import threading

    import numpy as np
    import pandas as pd
    import torch
    from tpu_olap_torch.bench import ssb
    from tpu_olap_torch.kernels import cuda_build
    from tpu_olap_torch.kernels import fused_reduce as fr
    eng.config.use_fused_reduce = "auto"
    single, p50 = {}, {}
    for name, q in ssb.QUERIES.items():
        single[name] = eng.sql(q)
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            eng.sql(q)
            ts.append((time.perf_counter() - t) * 1000)
        p50[name] = float(np.median(ts))
    batches = {"(a) the 13 queries": tuple(ssb.QUERIES),
               "(b) storm 8 x q2.1 + 4 x q3.1": STORM}
    recorded, counts = {}, {}
    for label, names in batches.items():
        n_kernels = len(cuda_build._kernels)
        first, calls, multi = run_checked_batch(eng, names, single, label,
                                                tag)
        recorded[label], counts[label] = calls, multi
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            eng.sql_batch([ssb.QUERIES[n] for n in names])
            ts.append((time.perf_counter() - t) * 1000)
        singles = sum(p50[n] for n in names)
        print(f"[11 time] {label}: first run {first:.1f} ms (NVRTC compiles "
              f"{len(cuda_build._kernels) - n_kernels}), p50 "
              f"{float(np.median(ts)):.3f} ms over {reps} runs | the "
              f"statements' single p50s sum to {singles:.3f} ms {tag}",
              flush=True)
        for a in calls:
            kern = fr.compiled_multi(a[0], a[4], "cuda")
            print(f"[11 plan] {label}: {len(a[0])} legs, K {list(a[4])}: "
                  f"{plan_report(kern)}", flush=True)

    busy = device_busy(
        {label: (lambda names=names: eng.sql_batch(
            [ssb.QUERIES[n] for n in names])) for label, names
         in batches.items()}, kernel=MULTI_KERNEL)
    print(f"[11 device] {busy} {tag}", flush=True)

    # (c) the coalescer: 8 threads, each its own statement, one window
    eng.runner.set_batch_window(5)
    got, stmts, errors = {}, {}, []
    gate = threading.Barrier(len(COALESCED))

    def caller(name):
        try:
            gate.wait()
            got[name] = eng.sql(ssb.QUERIES[name])
            stmts[name] = dict(eng.runner.last_metrics)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"{name}: {e!r}")
    with MultiRecorder() as rec:
        fr.launches = fr.multi_launches = 0
        threads = [threading.Thread(target=caller, args=(n,))
                   for n in COALESCED]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        torch.cuda.synchronize()
        b1, multi = fr.launches, fr.multi_launches
    eng.runner.set_batch_window(0)
    if errors or any(th.is_alive() for th in threads):
        fail(f"(c) coalescer: {errors or 'a caller hung'}")
    for name in COALESCED:
        pd.testing.assert_frame_equal(got[name], single[name])
    sizes = [stmts[n].get("batch_size", 1) for n in COALESCED]
    groups, singles, want_b1, want_multi = batch_layout(
        [stmts[n] for n in COALESCED], COALESCED)
    if max(sizes) < 2 or multi != want_multi or b1 != want_b1:
        fail(f"(c) coalescer: batch sizes {sizes}, fused groups {groups}, "
             f"multi-leg launches {multi} (want {want_multi}), B1 {b1} "
             f"(want {want_b1})")
    recorded["(c) coalescer"] = rec.calls
    print(f"[11 batch] (c) coalescer, 8 threads, batch_window_ms=5: batch "
          f"sizes {sizes}, fused groups {json.dumps(groups)}, single legs "
          f"{singles}; multi-leg launches {multi}, B1 launches {b1}; every "
          f"answer == its single run exactly {tag}", flush=True)

    # every multi-leg launch of the phase against the plain version
    max_err, largest = 0, None
    for label, calls in recorded.items():
        for a in calls:
            err, sums = check_multi(fr, a, label)
            max_err = max(max_err, err)
            if label.startswith("(a)") and (
                    largest is None or len(a[0]) > len(largest[0][0])):
                largest = (a, sums)
    n = sum(len(c) for c in recorded.values())
    print(f"[11 replay] {n} multi-leg launches of the phase replayed: "
          f"kernel == plain version exactly", flush=True)
    return multi_times("batch SF1", *largest, max_err,
                       counts["(a) the 13 queries"], tag, flush_l2)


# -- phase 9: the TPC-H shapes over a parquet-registered fact ---------------

# -- 12. caches and cubes ---------------------------------------------------

TIER1_YEARS = ((1993, 1996), (1994, 1997), (1995, 1998))  # slides a year
TIER1_MONTHS = (
    "SELECT date_trunc('month', lo_orderdate_ts) AS m, "
    "sum(lo_revenue) AS revenue, count(*) AS n FROM lineorder WHERE "
    "lo_orderdate_ts >= TIMESTAMP '{lo}-01-01' AND "
    "lo_orderdate_ts < TIMESTAMP '{hi}-01-01' "
    "GROUP BY date_trunc('month', lo_orderdate_ts) ORDER BY m")


def tier1_statements(ssb):
    """{name: [SQL per step]}: a month-granularity timeseries and q2.1,
    each over a window of three year partitions that slides by one."""
    q21 = ssb.QUERIES["q2.1"]
    return {
        "months": [TIER1_MONTHS.format(lo=lo, hi=hi)
                   for lo, hi in TIER1_YEARS],
        "q2.1": [q21.replace(
            "WHERE ", f"WHERE lo_orderdate_ts >= TIMESTAMP '{lo}-01-01' "
            f"AND lo_orderdate_ts < TIMESTAMP '{hi}-01-01' AND ", 1)
            for lo, hi in TIER1_YEARS]}


def ssb_engine(seg, tables, **cfg):
    """An Engine over the SF1 engine's segments (no second ingest) and the
    four fallback-only dimension tables."""
    from tpu_olap_torch.bench import ssb
    e = new_engine(**cfg)
    e.register_table("lineorder", None, time_column=ssb.TIME_COL,
                     star_schema=ssb.star_schema(), segments=seg)
    for t in ("date", "customer", "supplier", "part"):
        e.register_table(t, tables[t], accelerate=False)
    return e


def host_cuda_calls(run) -> dict:
    """{CUDA runtime/driver call: count} of the kernel launches and
    copies the host issued while `run()` ran (torch.profiler, CPU
    activity, which records every such call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.key.startswith(
                ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy"))}


def seg_kernel_times(a, sums, max_err, launches, tag, flush_l2,
                     phase="12", at="tier1 q2.1",
                     where="tier-1 q2.1 step 1") -> dict:
    """The segment-extended B1 at one tier-1 launch's inputs `a` (its
    outputs' sums from the replay): device time warm and cold against
    its bound over the computed segments, the plain version, and one
    torch index_add_ over the selected rows' extended keys. Prints one
    line; returns the kernel's JSON entry."""
    import torch
    from tpu_olap_torch.kernels import fused_reduce as fr
    from tpu_olap_torch.kernels import rowprog
    prog, inputs, valid, seg_mask, K, lo, W = a
    kept = torch.nonzero(seg_mask).flatten().tolist()
    c_lo, c_hi = min(kept), max(kept) + 1   # the computed segments
    sl = slice(c_lo, c_hi)
    bytes_ms, ops_ms, nbytes = kernel_bound(
        prog, [None if t is None else t[sl] for t in inputs], valid[sl],
        seg_mask[sl], W * K, sums)
    bound = max(bytes_ms, ops_ms)
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    warm, cold, hows = [], [], {}
    for _ in range(2):
        for runs, between in ((warm, None), (cold, flush_l2)):
            ms, how = timed(lambda: fr.fused_reduce_seg(*a), 20, GEN_KERNEL,
                            between)
            runs.append(ms)
            hows[how] = None
    gen_ms = sum(cold) / 2
    plain_ms, plain_how = timed(
        lambda: fr.fused_reduce_ref(prog, inputs, valid, seg_mask, K,
                                    (lo, W)), 5)
    S, R = valid.shape
    base = (valid & seg_mask[:, None]).reshape(-1)
    regs = rowprog.evaluate(prog, inputs, base.numel(), "cuda")
    key = regs[prog.key_reg]
    seg_ids = torch.arange(S, device="cuda").repeat_interleave(R)
    sel = base & (regs[prog.mask_reg] != 0) & (key >= 0) & (key < K)
    k_sel = (key + (seg_ids - lo) * K)[sel]
    src = torch.stack(
        [torch.ones_like(k_sel) if v < 0 else regs[v][sel]
         for v in prog.val_regs[:prog.n_sum]], 1)
    out = torch.zeros((W * K, prog.n_sum), dtype=torch.int64, device="cuda")
    lib_ms, lib_how = timed(lambda: out.index_add_(0, k_sel, src), 20)
    kern = fr.compiled_seg(prog, K, W, "cuda")
    n_sel = int(sums[:, 0].sum())
    del regs, key, seg_ids, sel, src, out
    print(f"[{phase} kernel] segment-extended B1 at {where} (window "
          f"[{lo}, {lo + W}) of {S} segments, computed {c_lo}-{c_hi - 1}, "
          f"K={K}, W*K={W * K} groups, selected {n_sel}): warm L2 "
          f"{warm[0]:.4f} / {warm[1]:.4f} ms, cold L2 {cold[0]:.4f} / "
          f"{cold[1]:.4f} ms ({'; '.join(hows)}) | bound {bound:.4f} ms "
          f"({nbytes} B, {by}; bytes {bytes_ms:.4f}, operations "
          f"{ops_ms:.4f}) = {gen_ms / bound:.1f}x the bound cold, "
          f"{sum(warm) / 2 / bound:.1f}x warm | plain {plain_ms:.4f} ms "
          f"({plain_how}) | index_add_ over the selected rows' extended "
          f"keys {lib_ms:.4f} ms ({lib_how}) | {plan_report(kern)} {tag}",
          flush=True)
    return {"name": "fused_reduce_seg", "route": "cuda",
            "source": "tpu_olap_torch/csrc/fused_reduce_gen.cuh",
            "replaces": "tpu_olap/kernels/pallas_reduce.py:536",
            "launches": launches, "max_abs_err": max_err, "ms": gen_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms, "at": at}


def p50_ms(eng, q, reps) -> float:
    import numpy as np
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        eng.sql(q)
        ts.append((time.perf_counter() - t) * 1000)
    return float(np.median(ts))


def cache_phase(eng, tables, base_frames, reps, tag, flush_l2) -> dict:
    """Phase 12 on the SF1 engine: (a) tier 1 over a sliding window, (b)
    tier 2 over the 13 queries, (c) an HBM budget under the working set,
    (d) the advisor's cubes. Returns the segment-extended kernel's JSON
    entry."""
    import numpy as np
    import pandas as pd
    import torch
    from tpu_olap_torch.bench import ssb
    from tpu_olap_torch.bench.parity import assert_frame_parity
    from tpu_olap_torch.cubes import cube_specs_from_workload
    from tpu_olap_torch.kernels import fused_reduce as fr
    from tpu_olap_torch.kernels import row_mask
    seg = eng.catalog.get("lineorder").segments
    cfg = eng.config

    # (a) tier 1: the uncached segments in one segment-extended launch
    stmts = tier1_statements(ssb)
    off = {}
    for name, steps in stmts.items():
        for i, q in enumerate(steps):
            off[(name, i)] = eng.sql(q)  # caches off: the reference
    cfg.segment_cache_enabled, cfg.segment_cache_min_rows = True, 0
    calls, current, real = {}, [None], fr.fused_reduce_seg

    def record(*a):
        calls[current[0]] = a
        return real(*a)
    fr.fused_reduce_seg = record
    fr.seg_launches = fr.launches = 0
    per_step, rows_a = {}, []
    try:
        for name, steps in stmts.items():
            prev = set()
            for i, q in enumerate(steps):
                current[0] = (name, i)
                before = fr.seg_launches
                t = time.perf_counter()
                got = eng.sql(q)
                wall = (time.perf_counter() - t) * 1000
                m = eng.runner.last_metrics
                plan = eng.runner._lower_cached(eng.planner.plan(q).query,
                                                seg)
                new = sorted(set(plan.pruned_ids) - prev)
                prev = set(plan.pruned_ids)
                per_step[(name, i)] = fr.seg_launches - before
                pd.testing.assert_frame_equal(got, off[(name, i)])
                if m.get("route") != "segment_cache" \
                        or m.get("segments_computed") != len(new):
                    fail(f"tier 1 {name} step {i}: route {m.get('route')}, "
                         f"{m.get('segments_computed')} segments computed "
                         f"where {len(new)} are new")
                rows_a.append(
                    f"{name} step {i} ({TIER1_YEARS[i][0]}-"
                    f"{TIER1_YEARS[i][1] - 1}): cached "
                    f"{m.get('segments_cached')}, computed "
                    f"{m.get('segments_computed')}, window "
                    f"{m.get('segments_window')}, copies "
                    f"{m['host_copies']}, wall {wall:.3f} ms")
        torch.cuda.synchronize()
        seg_launches, b1_launches = fr.seg_launches, fr.launches
    finally:
        fr.fused_reduce_seg = real
    if any(n != 1 for n in per_step.values()) or b1_launches:
        fail(f"tier 1: segment-extended launches per step "
             f"{list(per_step.values())}, plain B1 launches {b1_launches}")
    if len(calls) != len(per_step):
        fail(f"tier 1: {len(calls)} steps launched of {len(per_step)}")
    max_err = 0
    for i, a in calls.items():
        got = fr.fused_reduce_seg(*a)
        prog, inputs, valid, seg_mask, K, lo, W = a
        want = fr.fused_reduce_ref(prog, inputs, valid, seg_mask, K,
                                   (lo, W))
        torch.cuda.synchronize()
        if any(g.shape != w.shape or g.dtype != w.dtype
               for g, w in zip(got, want)):
            fail(f"segment-extended kernel output shapes differ at call {i}")
        err = max_abs_diff(got, want)
        if err:
            fail(f"segment-extended kernel disagrees with the plain version "
                 f"at call {i}: max |kernel - plain| = {err}")
        max_err = max(max_err, err)
    for line in rows_a:
        print(f"[12 tier1] {line} {tag}", flush=True)
    # step timings: each step's statement served warm (its new segments
    # cached by the run above) against the same statement with caches off
    for name, steps in stmts.items():
        on = [p50_ms(eng, q, reps) for q in steps]
        cfg.segment_cache_enabled = False
        no = [p50_ms(eng, q, reps) for q in steps]
        cfg.segment_cache_enabled = True
        print(f"[12 tier1] {name}: every step == caches off exactly; one "
              f"segment-extended launch per step ({seg_launches} in all, "
              f"no plain B1 launch); replayed against the plain version: "
              f"max |kernel - plain| = {max_err}; p50 all segments cached "
              f"{', '.join(f'{x:.3f}' for x in on)} ms vs caches off "
              f"{', '.join(f'{x:.3f}' for x in no)} ms {tag}", flush=True)
    # the kernel at q2.1's second step: the one new year's segments
    a = calls[("q2.1", 1)]
    row = seg_kernel_times(a, fr.fused_reduce_seg(*a)[0], max_err,
                           seg_launches, tag, flush_l2)
    cfg.segment_cache_enabled = False
    eng.runner.result_cache.clear()

    # (b) tier 2: a repeated pass launches nothing and copies nothing
    cfg.result_cache_enabled = True
    first = {n: eng.sql(q) for n, q in ssb.QUERIES.items()}
    fr.launches = fr.seg_launches = fr.multi_launches = 0
    row_mask.launches = 0
    hits, metrics = {}, {}

    def second_pass():
        for n, q in ssb.QUERIES.items():
            hits[n] = eng.sql(q)
            metrics[n] = dict(eng.runner.last_metrics)
    api = host_cuda_calls(second_pass)
    counts = (fr.launches, fr.seg_launches, fr.multi_launches,
              row_mask.launches)
    for n in ssb.QUERIES:
        pd.testing.assert_frame_equal(hits[n], first[n])
        assert_frame_parity(hits[n], base_frames[n], label=f"tier 2 {n}")
        m = metrics[n]
        if m.get("route") != "cache" or m.get("host_copies") != 0:
            fail(f"tier 2 {n}: route {m.get('route')}, "
                 f"{m.get('host_copies')} copies")
    if any(counts) or any(api.values()):
        fail(f"tier 2 hits launched kernels or copied: wrapper counts "
             f"{counts}, host CUDA calls {api}")
    hit_p50 = {n: p50_ms(eng, q, reps) for n, q in ssb.QUERIES.items()}
    print(f"[12 tier2] 13/13 repeats served from the full-result cache == "
          f"the first pass exactly; kernel launches 0 (B1, segment, "
          f"multi-leg, row-mask wrappers), host CUDA launch and copy calls "
          f"under torch.profiler {sum(api.values())}, copies 0; hit p50 "
          f"{float(np.median(list(hit_p50.values()))):.4f} ms (per query "
          f"{', '.join(f'{n} {v:.4f}' for n, v in hit_p50.items())}) {tag}",
          flush=True)
    cfg.result_cache_enabled = False
    eng.runner.result_cache.clear()

    # (c) an HBM budget under the 13 queries' working set
    free = ssb_engine(seg, tables, device=cfg.device)
    solo = {}
    for n, q in ssb.QUERIES.items():
        # each query's working set: the peak it adds to an empty engine
        free.clear_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        free.sql(q)
        torch.cuda.synchronize()
        solo[n] = torch.cuda.max_memory_allocated() - m0
    free_frames = {n: free.sql(q) for n, q in ssb.QUERIES.items()}
    resident = free.runner.device_bytes()
    budget = int(0.4 * resident)
    tight = ssb_engine(seg, tables, device=cfg.device,
                       hbm_budget_bytes=budget)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    over, first_wall = 0, 0.0
    for n, q in ssb.QUERIES.items():
        t = time.perf_counter()
        got = tight.sql(q)
        torch.cuda.synchronize()
        first_wall += (time.perf_counter() - t) * 1000
        over = max(over, torch.cuda.max_memory_allocated() - m0)
        pd.testing.assert_frame_equal(got, free_frames[n])
        assert_frame_parity(got, base_frames[n], label=f"budget {n}")
    ledger = tight.runner._ledger
    if ledger.evictions < 1:
        fail(f"budget {budget} B of {resident} B resident: no eviction")
    if over > budget + max(solo.values()):
        fail(f"budgeted engine allocated {over} B over its start, past the "
             f"budget {budget} B plus the largest working set "
             f"{max(solo.values())} B")
    p_free, p_tight = {}, {}
    for n, q in ssb.QUERIES.items():
        p_free[n] = p50_ms(free, q, reps)
        p_tight[n] = p50_ms(tight, q, reps)
    print(f"[12 budget] hbm_budget_bytes {budget} (40% of the 13 queries' "
          f"{resident} resident bytes): 13/13 answers == the unbudgeted "
          f"engine's exactly; evictions {ledger.evictions}, bytes in use "
          f"{ledger.bytes_in_use}, ledger high watermark "
          f"{ledger.high_watermark}; torch.cuda.memory_allocated peak "
          f"{over} B over the start <= budget + the largest working set "
          f"({max(solo, key=solo.get)} {max(solo.values())} B); the 13 in "
          f"turn, evicting, {first_wall:.1f} ms; p50 (a query's repeats "
          f"find its stacks resident) budgeted vs unbudgeted "
          f"{', '.join(f'{n} {p_tight[n]:.3f}/{p_free[n]:.3f}' for n in p_free)}"
          f" ms {tag}", flush=True)
    for e in (free, tight):
        e.clear_cache()
    del free, tight, free_frames
    gc.collect()
    torch.cuda.empty_cache()

    # (d) cubes from the advisor over the 13 queries' profile
    cfg.cube_auto_refresh = False
    cfg.cube_rewrite_enabled = False
    eng.runner.workload.clear()
    for _ in range(2):
        for q in ssb.QUERIES.values():
            eng.sql(q)
    base_p50 = {n: p50_ms(eng, q, reps) for n, q in ssb.QUERIES.items()}
    specs, notes = cube_specs_from_workload(eng.runner.workload.snapshot(),
                                            eng, top=len(ssb.QUERIES))
    built = []
    for sp in specs:
        fr.launches = 0
        t = time.perf_counter()
        try:
            e = eng.create_cube(sp)
        except Exception as ex:  # noqa: BLE001 — reported per spec
            print(f"[12 cube] {sp.name} dims {list(sp.dimensions)} @ "
                  f"{sp.granularity}: build failed after "
                  f"{(time.perf_counter() - t) * 1000:.1f} ms: "
                  f"{type(ex).__name__}: {ex} {tag}", flush=True)
            continue
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1000
        built.append(sp.name)
        bm = e.build_metrics
        print(f"[12 cube] {sp.name} dims {list(sp.dimensions)} @ "
              f"{sp.granularity}: {e.data.n_rows} rows, build {ms:.1f} ms "
              f"(registry {e.build_ms:.1f} ms), route {bm.get('route')}, "
              f"B1 launches {fr.launches}, copies {bm.get('host_copies')}, "
              f"stored {e.storage_bytes} B + sketches "
              f"{e.data.sketch_bytes} B {tag}", flush=True)
    if not built:
        fail(f"no cube built from {len(specs)} specs: {notes}")
    cfg.cube_rewrite_enabled = True
    served, cube_p50 = [], {}
    for n, q in ssb.QUERIES.items():
        got = eng.sql(q)
        if eng.runner.last_metrics.get("path") == "cube":
            served.append(n)
        pd.testing.assert_frame_equal(got, base_frames[n])
        cube_p50[n] = p50_ms(eng, q, reps)
    if not served:
        fail("no SSB query was served from a cube")
    print(f"[12 cubes] {len(built)} cubes built of {len(specs)} specs; "
          f"served from a cube: {served} ({len(served)}/13), every answer "
          f"== the base path exactly; p50 base vs cube "
          f"{', '.join(f'{n} {base_p50[n]:.3f}/{cube_p50[n]:.3f}' for n in base_p50)}"
          f" ms; advisor notes {len(notes)} {tag}", flush=True)
    for name in built:
        eng.drop_cube(name)
    cfg.cube_rewrite_enabled = False
    eng.cubes.stop(join=True)
    return row


# -- 13. real-time ingest ---------------------------------------------------

INGEST_BATCH = 32_768             # rows per append
INGEST_BATCHES = 38               # 1,245,184 rows in all
INGEST_PER_STEP = ("q1.1", "q2.1", "q3.1", "q4.3")  # q2.1 every step,
INGEST_ALL4_EVERY = 4             # all four every 4th step (and 1, 20)
INGEST_FULL_STEPS = (1, 8, 32)    # the 13 checked against pandas here
INGEST_REPEAT_STEPS = (1, 8, 16, 24, 32)
INGEST_REPLAY_STEPS = (1, 20, 32)  # B1 launches replayed vs plain
NEW_BRAND_STEP = 20
NEW_BRAND = "MFGR#1241"           # brand 41 of MFGR#12: not in the base
TIER1_STREAM_YEARS = (1996, 1999)  # phase 12 (a)'s q2.1 over the stream
INGEST_CUBE_STEPS = (2, 4)        # (b): the 13 with cubes at these steps


# The 13 as pandas over the denormalized frame: (row filter, group
# columns, output columns). Each sums one measure (MEASURE), so per-group
# sums over the base and over the appended rows add up to the answer.
SSB_PANDAS = {
    "q1.1": (lambda d: (d.d_year == 1993) & d.lo_discount.between(1, 3)
             & (d.lo_quantity < 25), [], ["revenue"]),
    "q1.2": (lambda d: (d.d_yearmonthnum == 199401)
             & d.lo_discount.between(4, 6) & d.lo_quantity.between(26, 35),
             [], ["revenue"]),
    "q1.3": (lambda d: (d.d_weeknuminyear == 6) & (d.d_year == 1994)
             & d.lo_discount.between(5, 7) & d.lo_quantity.between(26, 35),
             [], ["revenue"]),
    "q2.1": (lambda d: (d.p_category == "MFGR#12")
             & (d.s_region == "AMERICA"),
             ["d_year", "p_brand1"], ["revenue", "d_year", "p_brand1"]),
    "q2.2": (lambda d: d.p_brand1.between("MFGR#2221", "MFGR#2228")
             & (d.s_region == "ASIA"),
             ["d_year", "p_brand1"], ["revenue", "d_year", "p_brand1"]),
    "q2.3": (lambda d: (d.p_brand1 == "MFGR#2239")
             & (d.s_region == "EUROPE"),
             ["d_year", "p_brand1"], ["revenue", "d_year", "p_brand1"]),
    "q3.1": (lambda d: (d.c_region == "ASIA") & (d.s_region == "ASIA")
             & d.d_year.between(1992, 1997),
             ["c_nation", "s_nation", "d_year"],
             ["c_nation", "s_nation", "d_year", "revenue"]),
    "q3.2": (lambda d: (d.c_nation == "UNITED STATES")
             & (d.s_nation == "UNITED STATES")
             & d.d_year.between(1992, 1997),
             ["c_city", "s_city", "d_year"],
             ["c_city", "s_city", "d_year", "revenue"]),
    "q3.3": (lambda d: d.c_city.isin(["UNITED KI1", "UNITED KI5"])
             & d.s_city.isin(["UNITED KI1", "UNITED KI5"])
             & d.d_year.between(1992, 1997),
             ["c_city", "s_city", "d_year"],
             ["c_city", "s_city", "d_year", "revenue"]),
    "q3.4": (lambda d: d.c_city.isin(["UNITED KI1", "UNITED KI5"])
             & d.s_city.isin(["UNITED KI1", "UNITED KI5"])
             & (d.d_yearmonth == "Dec1997"),
             ["c_city", "s_city", "d_year"],
             ["c_city", "s_city", "d_year", "revenue"]),
    "q4.1": (lambda d: (d.c_region == "AMERICA")
             & (d.s_region == "AMERICA")
             & d.p_mfgr.isin(["MFGR#1", "MFGR#2"]),
             ["d_year", "c_nation"], ["d_year", "c_nation", "profit"]),
    "q4.2": (lambda d: (d.c_region == "AMERICA")
             & (d.s_region == "AMERICA") & d.d_year.isin([1997, 1998])
             & d.p_mfgr.isin(["MFGR#1", "MFGR#2"]),
             ["d_year", "s_nation", "p_category"],
             ["d_year", "s_nation", "p_category", "profit"]),
    "q4.3": (lambda d: (d.c_region == "AMERICA")
             & (d.s_nation == "UNITED STATES") & d.d_year.isin([1997, 1998])
             & (d.p_category == "MFGR#14"),
             ["d_year", "s_city", "p_brand1"],
             ["d_year", "s_city", "p_brand1", "profit"]),
}
MEASURE = {
    "q1": lambda d: d.lo_extendedprice.astype("int64") * d.lo_discount,
    "q2": lambda d: d.lo_revenue.astype("int64"),
    "q3": lambda d: d.lo_revenue.astype("int64"),
    "q4": lambda d: d.lo_revenue.astype("int64") - d.lo_supplycost,
}


def ssb_partials(d) -> dict:
    """Each of the 13 over frame `d` as its measure's integer sums: a
    Series by group, or an int for q1.x."""
    out = {}
    for n, (keep, by, _) in SSB_PANDAS.items():
        x = d[keep(d)]
        v = MEASURE[n[:2]](x)
        out[n] = v.groupby([x[c] for c in by]).sum() if by \
            else int(v.sum())
    return out


def ssb_answers(*partials) -> dict:
    """The 13 answers as frames from the partials of disjoint frames."""
    import pandas as pd
    out = {}
    for n, (_, by, cols) in SSB_PANDAS.items():
        agg = cols[0] if cols[0] not in by else cols[-1]
        ps = [p[n] for p in partials]
        if not by:
            out[n] = pd.DataFrame({agg: [sum(ps)]})
            continue
        s = pd.concat(ps).groupby(level=list(range(len(by)))).sum()
        out[n] = s.rename(agg).reset_index()[cols]
    return out


def ingest_batches(tables, batch_rows, n_batches):
    """The append stream: lineorder rows of ssb._gen_lineorder (seed 1)
    over the base's customer, supplier and part counts, order keys after
    the base's and order dates from 1998's date keys only, denormalized
    with the base's dimensions. In step NEW_BRAND_STEP's batch, 1,000
    rows of category MFGR#12 carry a brand the dictionary lacks."""
    import numpy as np
    from tpu_olap_torch.bench import ssb
    rng = np.random.default_rng(1)
    d = tables["date"]
    lo = ssb._gen_lineorder(
        rng, batch_rows * n_batches, len(tables["customer"]),
        len(tables["supplier"]), len(tables["part"]),
        d.d_datekey[d.d_year == 1998].to_numpy(),
        start_key=int(tables["lineorder"].lo_orderkey.max()) + 1)
    dn = ssb.denormalize({**tables, "lineorder": lo})
    batches = [dn.iloc[i * batch_rows:(i + 1) * batch_rows]
               .reset_index(drop=True) for i in range(n_batches)]
    b = batches[NEW_BRAND_STEP - 1]
    idx = b.index[b.p_category == "MFGR#12"][:1000]
    if len(idx) < min(1000, batch_rows // 50):
        fail(f"step {NEW_BRAND_STEP}'s batch holds {len(idx)} MFGR#12 rows")
    b.loc[idx, "p_brand1"] = NEW_BRAND
    return batches, len(idx)


def ingest_engine(seg, tables, denorm, **cfg):
    """An Engine over the SF1 segments (no second ingest), with the base
    frame as the pandas fallback's view of lineorder, and the four
    fallback-only dimension tables. Returns (engine, seconds the
    lineorder registration took)."""
    from tpu_olap_torch.bench import ssb
    e = new_engine(**cfg)
    t = time.perf_counter()
    e.register_table("lineorder", denorm, time_column=ssb.TIME_COL,
                     star_schema=ssb.star_schema(), segments=seg)
    reg_s = time.perf_counter() - t
    for name in ("date", "customer", "supplier", "part"):
        e.register_table(name, tables[name], accelerate=False)
    return e, reg_s


def stack_bytes(ds) -> int:
    """Bytes of a dataset's column, null and validity stacks: what a full
    re-stack uploads."""
    out = sum(t.numel() * t.element_size()
              for store in (ds._cols, ds._nulls) for t in store.values()
              if t is not None)
    return out + (ds._valid.numel() if ds._valid is not None else 0)


def replay_b1(fr, calls, label) -> int:
    """Every recorded B1 call replayed through the kernel and its plain
    version (exact); the max |kernel - plain|. The replays' launches are
    not the main path's: the count is put back."""
    import torch
    err, n0 = 0, fr.launches
    for key, a in calls.items():
        got, want = fr.fused_reduce(*a), fr.fused_reduce_ref(*a)
        torch.cuda.synchronize()
        e = max_abs_diff(got, want)
        if e:
            fail(f"{label} {key}: max |kernel - plain| = {e}")
        err = max(err, e)
    fr.launches = n0
    return err


def ingest_phase(seg, tables, denorm, base_p50, workdir, reps, tag,
                 flush_l2, batch_rows=INGEST_BATCH,
                 n_batches=INGEST_BATCHES, max_delta=1 << 20) -> list:
    """Phase 13 on the SF1 segments: (a) the append stream, (b) tier 1 and
    cubes under appends, (c) compaction, (d) checkpoint and recovery, (e)
    the breaker. Returns the kernel table's rows of B1 and its
    segment-extended variant at this phase's inputs."""
    import os

    import numpy as np
    import pandas as pd
    import torch
    from tpu_olap_torch.bench import ssb
    from tpu_olap_torch.bench.parity import assert_frame_parity
    from tpu_olap_torch.cubes import cube_specs_from_workload
    from tpu_olap_torch.kernels import cuda_build
    from tpu_olap_torch.kernels import fused_reduce as fr
    from tpu_olap_torch.resilience import FaultInjector
    from tpu_olap_torch.resilience.errors import IngestBackpressure
    Q = ssb.QUERIES
    acked = max_delta // batch_rows
    if acked + 6 != n_batches:
        fail(f"{n_batches} batches of {batch_rows} rows do not fit "
             f"{acked} acknowledged + the shed + 5")
    t0 = time.perf_counter()
    batches, n_new = ingest_batches(tables, batch_rows, n_batches)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    base_parts = ssb_partials(denorm)   # the base's share of the pandas 13
    pandas_s = {0: time.perf_counter() - t0}
    wal_dir = os.path.join(workdir, "wal")
    cfg = dict(ingest_wal_dir=wal_dir,
               ingest_store_dir=os.path.join(workdir, "store"),
               ingest_wal_fsync="always", ingest_auto_compact=False,
               ingest_store_checkpoint_on_compact=False,
               ingest_max_delta_rows=max_delta, cube_auto_refresh=False)
    ing, _ = ingest_engine(seg, tables, denorm, **cfg)
    wal = os.path.join(wal_dir, "lineorder.wal")
    for n in INGEST_PER_STEP:
        ing.sql(Q[n])  # the base's plans compiled, its stacks resident
    print(f"[13 ingest] stream: {n_batches} batches of {batch_rows} rows "
          f"(ssb._gen_lineorder seed 1, 1998 order dates, {n_new} rows of "
          f"step {NEW_BRAND_STEP} with the new brand {NEW_BRAND}) generated "
          f"in {gen_s:.1f} s; ingest_max_delta_rows {max_delta}, WAL fsync "
          f"always", flush=True)

    # (a) the append stream, counts set to 0 just before
    calls, key, real = {}, [None], fr.fused_reduce

    def record(*a):
        if key[0] is not None:
            calls[key[0]] = a
        return real(*a)
    acks, first_q21, rep_q21, compiles, uploads = [], {}, {}, {}, {}
    per_query = {n: [] for n in INGEST_PER_STEP}
    step32, max_err, b1_row_args = {}, 0, None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fr.fused_reduce = record
    fr.launches = fr.seg_launches = 0
    t_a = time.perf_counter()
    try:
        for step in range(1, acked + 2):
            batch = batches[step - 1]
            if step == acked + 1:
                d0 = ing.catalog.get("lineorder").segments.delta_rows
                w0 = os.path.getsize(wal)
                try:
                    ing.append("lineorder", batch)
                    fail(f"batch {step} was acknowledged past "
                         f"ingest_max_delta_rows")
                except IngestBackpressure as e:
                    shed = e
                d1 = ing.catalog.get("lineorder").segments.delta_rows
                if d1 != d0 or os.path.getsize(wal) != w0:
                    fail(f"the shed batch changed the delta ({d0} -> {d1}) "
                         f"or the WAL ({w0} -> {os.path.getsize(wal)} B)")
                break
            t = time.perf_counter()
            ack = ing.append("lineorder", batch)
            acks.append((time.perf_counter() - t) * 1000)
            if ack["delta_rows"] != step * batch_rows:
                fail(f"step {step}: ack {ack}")
            before = {id(k) for k in cuda_build._kernels.values()}
            all4 = step % INGEST_ALL4_EVERY == 0 or step in (1, NEW_BRAND_STEP)
            for n in INGEST_PER_STEP if all4 else ("q2.1",):
                key[0] = (step, n) if step in INGEST_REPLAY_STEPS else None
                b0 = fr.launches
                t = time.perf_counter()
                ing.sql(Q[n])
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1000
                per_query[n].append(fr.launches - b0)
                if fr.launches == b0:
                    fail(f"step {step}: {n} launched B1 no time: "
                         f"{ing.runner.last_metrics}")
                if n == "q2.1":
                    first_q21[step] = ms
            key[0] = None
            new = [k for k in cuda_build._kernels.values()
                   if id(k) not in before]
            compiles[step] = (len(new), sum(k.compile_ms for k in new))
            ds = ing.runner._datasets["lineorder"]
            uploads[step] = (ds.h2d_bytes, ds.rebase_rows_uploaded,
                             ds.rebased_cols, stack_bytes(ds))
            if step in INGEST_REPEAT_STEPS:
                rep_q21[step] = p50_ms(ing, Q["q2.1"], 3)
            if step in INGEST_FULL_STEPS:
                # the 13 on B1 == pandas over the base frame plus the
                # appended rows, and == the generic torch reduce (the
                # card, no B1)
                got = {n: ing.sql(q) for n, q in Q.items()}
                t = time.perf_counter()
                want = ssb_answers(base_parts, ssb_partials(
                    pd.concat(batches[:step], ignore_index=True)))
                pandas_s[step] = time.perf_counter() - t
                for n in Q:
                    assert_frame_parity(got[n], want[n], label=f"ingest "
                                        f"step {step} {n} vs pandas")
                mode, ing.config.use_fused_reduce = \
                    ing.config.use_fused_reduce, "never"
                b0 = fr.launches
                for n, q in Q.items():
                    assert_frame_parity(got[n], ing.sql(q), ordered=True,
                                        label=f"ingest step {step} {n}")
                ing.config.use_fused_reduce = mode
                if fr.launches != b0:
                    fail("B1 launched under use_fused_reduce='never'")
                if step == acked:
                    step32 = got
            if step in INGEST_REPLAY_STEPS:
                max_err = max(max_err, replay_b1(fr, calls, "ingest"))
                if step == acked:
                    b1_row_args = calls[(step, "q2.1")]
                calls.clear()
        torch.cuda.synchronize()
        b1_launches = fr.launches
    finally:
        fr.fused_reduce = real
        key[0] = None
    peak = torch.cuda.max_memory_allocated()
    a_s = time.perf_counter() - t_a
    full = uploads[acked][3]
    print(f"[13 ingest] (a) {acked} appends acknowledged, batch "
          f"{acked + 1} shed with IngestBackpressure (retry_after_s "
          f"{shed.retry_after_s}), delta_rows and the WAL unchanged; ack "
          f"p50 {np.median(acks):.1f} ms, max {max(acks):.1f} ms; q2.1's "
          f"first run after an append p50 "
          f"{np.median(list(first_q21.values())):.2f} ms (max "
          f"{max(first_q21.values()):.2f}) vs its repeat p50 "
          f"{', '.join(f'step {s} {v:.2f}' for s, v in rep_q21.items())} "
          f"ms; B1 launches {b1_launches} ({', '.join(f'{n} {sum(v)}/{len(v)}' for n, v in per_query.items())} launches/runs); at steps "
          f"{INGEST_FULL_STEPS} the 13 == pandas over the base frame plus "
          f"the appended rows (per-group sums of each, the base's taken "
          f"once in {pandas_s[0]:.1f} s, then "
          f"{', '.join(f'{v:.1f}' for k, v in pandas_s.items() if k)} s) "
          f"and == the generic torch reduce; "
          f"torch.cuda.max_memory_allocated over the stream {peak} B; "
          f"{a_s:.1f} s {tag}", flush=True)
    for s in sorted(uploads):
        h, rows, cols, fb = uploads[s]
        n_c, c_ms = compiles[s]
        if s in (1, 2, NEW_BRAND_STEP, acked) or n_c:
            print(f"[13 step] {s}: ack {acks[s - 1]:.1f} ms; q2.1 first "
                  f"{first_q21[s]:.2f} ms; host-to-device {h} B "
                  f"(rebased stacks {cols}, rebase_rows_uploaded {rows}) "
                  f"vs a full re-stack's {fb} B; NVRTC compiles {n_c} "
                  f"({c_ms:.1f} ms) {tag}", flush=True)
    hs = [u[0] for u in uploads.values()]
    print(f"[13 ingest] host-to-device bytes per append p50 "
          f"{int(np.median(hs))} max {max(hs)} vs a full re-stack "
          f"{full} B; steps that compiled: "
          f"{[s for s, c in compiles.items() if c[0]]}; B1 replayed "
          f"against the plain version at steps {INGEST_REPLAY_STEPS}: max "
          f"|kernel - plain| = {max_err} {tag}", flush=True)
    rows = [kernel_times("q2.1", b1_row_args, fr.fused_reduce(*b1_row_args)[0],
                         max_err, b1_launches, tag, flush_l2,
                         label=" ingest", phase="13")]
    del b1_row_args

    # (b) tier 1 and cubes under appends, on a second engine
    tc, _ = ingest_engine(seg, tables, denorm, cube_auto_refresh=False,
                          ingest_auto_compact=False)
    tcfg = tc.config
    tcfg.cube_rewrite_enabled = False
    tc.runner.workload.clear()
    for _ in range(2):
        for q in Q.values():
            tc.sql(q)
    specs, _ = cube_specs_from_workload(tc.runner.workload.snapshot(), tc,
                                        top=len(Q))
    built = []
    for sp in specs:
        try:
            built.append(tc.create_cube(sp).spec.name)
        except Exception as ex:  # noqa: BLE001 — reported per spec
            print(f"[13 cube] {sp.name}: build failed: "
                  f"{type(ex).__name__}: {ex}", flush=True)
    lo, hi = TIER1_STREAM_YEARS
    qwin = Q["q2.1"].replace(
        "WHERE ", f"WHERE lo_orderdate_ts >= TIMESTAMP '{lo}-01-01' AND "
        f"lo_orderdate_ts < TIMESTAMP '{hi}-01-01' AND ", 1)
    tcfg.segment_cache_enabled, tcfg.segment_cache_min_rows = True, 0
    tc.sql(qwin)  # every sealed segment of the window cached
    seg_calls, real_seg = {}, fr.fused_reduce_seg

    def record_seg(*a):
        if key[0] is not None:
            seg_calls[key[0]] = a
        return real_seg(*a)
    fr.fused_reduce_seg = record_seg
    fr.seg_launches = fr.launches = 0
    steps_b, serves, seg_err = [], [], 0
    try:
        for step in range(1, 5):
            tc.append("lineorder", batches[step - 1])
            table = tc.catalog.get("lineorder").segments
            tcfg.cube_rewrite_enabled = False
            key[0] = step
            s0, b0 = fr.seg_launches, fr.launches
            got = tc.sql(qwin)
            m = dict(tc.runner.last_metrics)
            plan = tc.runner._lower_cached(tc.planner.plan(qwin).query,
                                           table)
            delta = [i for i in plan.pruned_ids
                     if not table.segment_sealed(i)]
            if (m.get("segments_computed") != len(delta)
                    or not m.get("segments_cached")
                    or fr.seg_launches - s0 != 1 or fr.launches != b0):
                fail(f"tier 1 step {step}: {m.get('segments_cached')} "
                     f"cached, {m.get('segments_computed')} computed where "
                     f"{len(delta)} delta segments are in the window; "
                     f"segment-extended launches {fr.seg_launches - s0}, "
                     f"B1 {fr.launches - b0}")
            tcfg.segment_cache_enabled = False
            key[0] = None   # the cube folds' launches are not recorded
            pd.testing.assert_frame_equal(got, tc.sql(qwin))
            steps_b.append(f"step {step}: cached "
                           f"{m['segments_cached']}, computed "
                           f"{m['segments_computed']} (the delta), window "
                           f"{m.get('segments_window')}, copies "
                           f"{m['host_copies']}")
            for n, q in (Q.items() if step in INGEST_CUBE_STEPS else ()):
                tcfg.cube_rewrite_enabled = True
                got = tc.sql(q)
                cm = tc.runner.last_metrics
                tcfg.cube_rewrite_enabled = False
                if cm.get("path") == "cube":
                    pd.testing.assert_frame_equal(got, tc.sql(q))
                    if cm.get("delta_segments"):
                        serves.append((step, n, cm["cube"],
                                       cm["delta_segments"]))
            tcfg.segment_cache_enabled = True
            a = seg_calls.get(step)
            if a is None:
                fail(f"tier 1 step {step} recorded no segment launch")
            n0 = fr.seg_launches
            got_k = fr.fused_reduce_seg(*a)
            fr.seg_launches = n0   # a replay, not the main path
            prog, inputs, valid, seg_mask, K, wlo, W = a
            want = fr.fused_reduce_ref(prog, inputs, valid, seg_mask, K,
                                       (wlo, W))
            torch.cuda.synchronize()
            seg_err = max(seg_err, max_abs_diff(got_k, want))
            if step < 4:
                seg_calls.clear()
        torch.cuda.synchronize()
        seg_launches = fr.seg_launches
    finally:
        fr.fused_reduce_seg = real_seg
        key[0] = None
    if seg_err:
        fail(f"segment-extended kernel disagrees with the plain version: "
             f"{seg_err}")
    if not serves:
        fail(f"no cube served with delta segments (cubes built: {built})")
    for line in steps_b:
        print(f"[13 tier1] {line} {tag}", flush=True)
    print(f"[13 cubes] {len(built)} advisor cubes over the sealed set; "
          f"serves folding delta segments (step, query, cube, delta "
          f"segments): {serves}; every answer == the cache-off, cube-off "
          f"run exactly; segment-extended launches {seg_launches}, "
          f"replayed: max |kernel - plain| = {seg_err} {tag}", flush=True)
    a = seg_calls[4]
    rows.append(seg_kernel_times(a, fr.fused_reduce_seg(*a)[0], seg_err,
                                 seg_launches, tag, flush_l2, phase="13",
                                 at="ingest tier1 q2.1",
                                 where="tier-1 q2.1 after 4 appends"))
    del a, seg_calls
    tc.close()
    tc.clear_cache()
    del tc

    # (c) compaction
    before = ing.catalog.get("lineorder").segments
    t = time.perf_counter()
    res = ing.compact_now("lineorder")
    compact_s = time.perf_counter() - t
    after = ing.catalog.get("lineorder").segments
    if res.get("status") != "compacted" or after.delta_rows:
        fail(f"compaction: {res}")
    p50c = {}
    for n, q in Q.items():
        assert_frame_parity(ing.sql(q), step32[n], ordered=True,
                            label=f"compacted {n}")
        p50c[n] = p50_ms(ing, q, reps)
    print(f"[13 compact] compact_now {compact_s:.2f} s ({res['mode']}, "
          f"{res['rows_sealed']} rows sealed, {res['delta_rows_folded']} "
          f"folded): sealed segments {before.sealed_count} + "
          f"{len(before.segments) - before.sealed_count} delta -> "
          f"{after.sealed_count}; the 13 == step {acked}'s answers; p50 "
          f"after vs phase 5 "
          f"{', '.join(f'{n} {p50c[n]:.3f}/{base_p50[n]:.3f}' for n in Q)}"
          f" ms {tag}", flush=True)

    # (e) the breaker on the card, on the ingest engine
    want21 = ing.sql(Q["q2.1"])   # B1's answer
    br = ing.runner.breaker
    cooldown = br.cooldown_s      # EngineConfig.breaker_open_cooldown_s
    trips = (ing.config.dispatch_retries + 1) * br.failure_threshold
    probes, real_probe = [], ing.runner._probe_device

    def probe(timeout):
        probes.append(real_probe(timeout))
        return probes[-1]
    # the healer's probe: when it starts and ends, from the trip (the
    # breaker closes as it returns True)
    heals, real_heal, opened = [], br.probe, [0.0]

    def heal():
        t = time.monotonic() - opened[0]
        ok = real_heal()
        heals.append((round(t, 3), round(time.monotonic() - opened[0], 3),
                      ok))
        return ok
    ing.runner._probe_device, br.probe = probe, heal
    ing.config.fault_injector = FaultInjector(
        stages={"dispatch"}, fail_calls=range(1, trips + 1))
    for _ in range(br.failure_threshold):
        try:
            ing.sql(Q["q1.1"])
            fail("an injected dispatch fault did not surface")
        except RuntimeError:
            pass
    opened[0] = br._opened_at
    ing.config.fault_injector = None
    if br.state != "open":
        fail(f"breaker {br.state} after {br.failure_threshold} failures")
    ing.config.fallback_on_device_failure = True   # serves while open
    b0 = fr.launches
    t = time.perf_counter()
    got = ing.sql(Q["q2.1"])
    serve_s = time.perf_counter() - t
    m = ing.runner.last_metrics
    ing.config.fallback_on_device_failure = False
    if m.get("path") != "fallback_breaker" or fr.launches != b0:
        fail(f"breaker open: path {m.get('path')}, B1 launches "
             f"{fr.launches - b0}")
    assert_frame_parity(got, want21, ordered=True, label="breaker")
    deadline = max(opened[0] + cooldown + 1.0, time.monotonic() + 1.0)
    while br.state != "closed" and time.monotonic() < deadline:
        time.sleep(0.02)
    if br.state != "closed" or not heals or not heals[-1][2] \
            or heals[-1][1] > cooldown + 1.0 or not probes \
            or not probes[-1]:
        fail(f"breaker {br.state}; healer probes (start s, end s, ok) "
             f"{heals} after it opened, cooldown {cooldown} s; CUDA probes "
             f"{probes}")
    b0 = fr.launches
    got = ing.sql(Q["q2.1"])
    if fr.launches == b0:
        fail("q2.1 after the breaker closed launched B1 no time")
    assert_frame_parity(got, want21, ordered=True, label="healed")
    print(f"[13 breaker] {br.failure_threshold} statements whose "
          f"{ing.config.dispatch_retries + 1} dispatch attempts all failed "
          f"opened the breaker; q2.1 then served with path "
          f"fallback_breaker in {serve_s:.1f} s == B1's answer; the "
          f"healer's probe (start s, end s after the trip, ok: {heals}; "
          f"CUDA probes {probes}) closed it within the cooldown "
          f"{cooldown} s + 1 s; q2.1 launched B1 again, == the same answer "
          f"{tag}", flush=True)
    ing.runner._probe_device, br.probe = real_probe, real_heal

    # (d) checkpoint and recovery
    for i in range(acked, acked + 4):   # the shed batch first
        ing.append("lineorder", batches[i])
    t = time.perf_counter()
    ck = ing.checkpoint_now("lineorder")
    ck_s = time.perf_counter() - t
    if ck.get("status") != "checkpointed":
        fail(f"checkpoint: {ck}")
    for i in range(acked + 4, n_batches):
        ing.append("lineorder", batches[i])
    old = {n: ing.sql(q) for n, q in Q.items()}
    ing.close()
    ing.clear_cache()
    del ing
    gc.collect()
    torch.cuda.empty_cache()
    rec, rec_s = ingest_engine(seg, tables, denorm, **cfg)
    st = rec.ingest._state("lineorder")
    if st.replayed_rows != 2 * batch_rows or \
            st.last_checkpoint.get("status") != "loaded":
        fail(f"recovery replayed {st.replayed_rows} rows, store "
             f"{st.last_checkpoint}")
    for n, q in Q.items():
        assert_frame_parity(rec.sql(q), old[n], ordered=True,
                            label=f"recovered {n}")
    print(f"[13 durable] checkpoint_now {ck_s:.2f} s (compacts batches "
          f"{acked + 1}-{acked + 4} first), {ck['segments']} segments, "
          f"{ck['bytes']} B spilled, {ck['files_written']} files written, "
          f"{ck['wal_frames_truncated']} WAL frames truncated; close; a new "
          f"engine over the same directories recovered in {rec_s:.2f} s "
          f"(store load + replay of {st.replayed_rows} rows, the "
          f"{n_batches - acked - 4}-batch WAL tail); the 13 == the old "
          f"engine's answers {tag}", flush=True)

    rec.close()
    rec.clear_cache()
    return rows


def uninlined_fallback(eng, sql):
    """The port's pandas fallback over `sql` with nothing on the device:
    the statement planned without the subquery hook (so uncorrelated
    subqueries stay in it), derived bodies kept in pandas
    (pure_config)."""
    from tpu_olap_torch.bench.parity import pure_config
    from tpu_olap_torch.planner.fallback import execute_fallback
    hook, eng.planner.run_subquery = eng.planner.run_subquery, None
    try:
        stmt = eng.planner.plan(sql).stmt
    finally:
        eng.planner.run_subquery = hook
    return execute_fallback(stmt, eng.catalog, pure_config(eng.config))


def tpch_phase(workdir, reps, tag):
    """Phase 9: the 25 TPC-H statements (all 22 shapes) and the scaled
    Q11 and Q18 over a 6,001,215-row olps fact registered from a
    multi-file parquet dataset."""
    import os

    import numpy as np
    import torch
    from tpu_olap_torch.bench import tpch
    from tpu_olap_torch.bench.parity import assert_frame_parity
    from tpu_olap_torch.kernels import cuda_build
    from tpu_olap_torch.kernels import fused_reduce as fr
    from tpu_olap_torch.planner import fallback as fb
    import pyarrow.parquet as pq

    t0 = time.perf_counter()
    paths = tpch.write_olps_parquet(os.path.join(workdir, "olps"),
                                    tpch.SF1_ROWS, seed=0)
    write_s = time.perf_counter() - t0
    t = time.perf_counter()
    eng = new_engine()
    tpch.register_olps(eng, paths)
    entry = eng.catalog.get("olps")
    groups = sum(pq.ParquetFile(p).metadata.num_row_groups for p in paths)
    print(f"[9 tpch] olps: {entry.segments.num_rows} rows (seed 0) written "
          f"as {len(paths)} parquet files, {groups} row groups, in "
          f"{write_s:.1f} s; register_table(paths) streamed them into "
          f"{len(entry.segments.segments)} segments in "
          f"{time.perf_counter() - t:.1f} s; fallback_chunk_rows "
          f"{eng.config.fallback_chunk_rows}, so the fallback streams row "
          f"groups", flush=True)
    # the same files as a plain table, served whole-frame by the pandas
    # fallback with nothing on the card (loaded on first use)
    oracle = new_engine(device="cpu", fallback_chunk_rows=1 << 62)
    tpch.register_olps(oracle, paths, accelerate=False)
    # Q11 and Q18 once more with literals that keep about half the brands
    # at this scale (the suite's keep none and all), from the oracle's
    # per-brand sums
    brands = oracle.sql("SELECT p_brand, sum(l_extendedprice) AS e, "
                        "sum(l_quantity) AS q FROM olps GROUP BY p_brand")
    queries = {**tpch.QUERIES,
               **tpch.scaled_subqueries(brands["e"], brands["q"])}

    # the chunked fallback's parallel path: did the fork pool serve?
    pool_served = []
    real_pool = fb._parallel_chunk_partials

    def pool_spy(*a, **kw):
        out = real_pool(*a, **kw)
        pool_served.append(out is not None)
        return out

    # the main path: every B1 launch of each statement's first run
    # recorded for the replay
    calls, current = [], [None]
    real = fr.fused_reduce

    def record(*a):
        if current[0] is not None:
            calls.append((current[0], a))
        return real(*a)

    fb._parallel_chunk_partials = pool_spy
    fr.fused_reduce = record
    fr.launches = 0
    n_device = n_synced = 0
    profiled_sql = {}  # statements with device work, for the busy share
    try:
        for name, (want_rw, sql) in queries.items():
            current[0] = name
            before, n_pool = fr.launches, len(pool_served)
            t = time.perf_counter()
            got = eng.sql(sql)
            torch.cuda.synchronize()
            first = (time.perf_counter() - t) * 1000
            current[0] = None
            launches = fr.launches - before
            pool = pool_served[n_pool:]
            plan, m = eng.last_plan, dict(eng.runner.last_metrics)
            nested = m.get("nested", [])
            if plan.rewritten != want_rw:
                fail(f"TPC-H {name}: rewritten {plan.rewritten}, expected "
                     f"{want_rw} ({plan.fallback_reason})")
            if (plan.fallback_reason or "").startswith("device failure"):
                fail(f"TPC-H {name}: served by the fallback after a device "
                     f"failure: {plan.fallback_reason}")
            if not want_rw and (m["route"] != "fallback"
                                or not plan.fallback_reason):
                fail(f"TPC-H {name}: served by {m['route']} without a "
                     f"fallback reason")
            device = [x for x in [m] + nested if x["route"] != "fallback"]
            check_ms = None
            if device:
                # a device answer against the pandas fallback: chunked over
                # the parquet, or whole-frame where a correlated body would
                # rerun the chunked scan once per outer key (Q20)
                n_device += 1
                whole = any(x["route"] == "fallback" for x in nested)
                t = time.perf_counter()
                want = uninlined_fallback(oracle if whole else eng, sql)
                check_ms = (time.perf_counter() - t) * 1000
                assert_frame_parity(got, want,
                                    approx_cols=("share", "supplier_cnt"),
                                    label=f"TPC-H {name} vs the fallback")
            if device and all(x.get("fused") for x in device):
                # no host sync before each device statement's own copy,
                # nested statements included (the generic torch reduce's
                # row selection syncs: Q16's HLL)
                n_synced += 1
                with SyncChecked():
                    try:
                        eng.sql(sql)
                    except RuntimeError as e:
                        fail(f"TPC-H {name}: a host sync before its copy: "
                             f"{e}")
            # p50 over `reps` runs after the first; one run for a statement
            # slower than 1 s and none past 10 s (its time is the
            # fallback's: the correlated shapes and Q20's inner
            # statement), to keep the smoke inside its limit as phases
            # were added
            runs = 0 if first > 10_000 else 1 if first > 1_000 else reps
            if device and first <= 10_000:
                profiled_sql[name] = sql
            n_kernels = len(cuda_build._kernels)
            ts = []
            for _ in range(runs):
                t = time.perf_counter()
                eng.sql(sql)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t) * 1000)
            compiles = len(cuda_build._kernels) - n_kernels
            if name.startswith(("q11", "q18")) and compiles:
                fail(f"TPC-H {name}: {compiles} NVRTC compiles on its "
                     f"second run")
            if name.endswith("scaled") and not 0 < len(got) < len(brands):
                fail(f"TPC-H {name}: {len(got)} of {len(brands)} brands")
            copies = sum(x.get("host_copies", 0) for x in [m] + nested)
            print(f"[9 query] {name}: path "
                  f"{'fallback' if m['route'] == 'fallback' else 'device'}, "
                  f"route {m['route']}, fallback_reason "
                  f"{plan.fallback_reason!r}, fused_reason "
                  f"{[x.get('fused_reason') for x in device]}, nested "
                  f"{[x.get('route') for x in nested]}, B1 launches "
                  f"{launches}, fork pool served {pool}, host copies "
                  f"{copies} | first run {first:.1f} ms, "
                  + (f"p50 {float(np.median(ts)):.3f} ms over {runs} run(s)"
                     if ts else "no repeat (first run past 10 s)")
                  + f", NVRTC compiles after the first run {compiles} | "
                  f"{len(got)} rows"
                  + ("" if check_ms is None else
                     f", == the {'whole-frame' if whole else 'chunked'} "
                     f"pandas fallback ({check_ms:.0f} ms)") + f" {tag}",
                  flush=True)
        total = fr.launches
    finally:
        fr.fused_reduce = real
        fb._parallel_chunk_partials = real_pool
    if total < 1:
        fail("phase 9 launched B1 no time")
    print(f"[9 tpch] {n_device} statements with device work == the port's "
          f"pandas fallback over the same statement with nothing on the "
          f"card (ints exact, floats rtol 1e-9, approximate columns rtol "
          f"0.12); {n_synced} whose device work is all B1 ran under "
          f"torch.cuda.set_sync_debug_mode('error'), lifted only for the "
          f"copies' waits: no host sync before them; B1 launches in the phase {total} "
          f"({time.perf_counter() - t0:.1f} s so far)", flush=True)

    busy = device_busy({n: (lambda q=q: eng.sql(q))
                        for n, q in profiled_sql.items()})
    print(f"[9 device] {busy} {tag}", flush=True)

    # the chunked fallback with and without the fork pool, after CUDA init
    sql = tpch.QUERIES["q4"][1]
    answers = {}
    for workers in (1, 4):
        eng.config.fallback_parallel_workers = workers
        pool_served.clear()
        fb._parallel_chunk_partials = pool_spy
        try:
            t = time.perf_counter()
            answers[workers] = eng.sql(sql)
            ms = (time.perf_counter() - t) * 1000
        finally:
            fb._parallel_chunk_partials = real_pool
        if not pool_served or any(pool_served) != (workers > 1) or \
                (workers > 1 and not all(pool_served)):
            fail(f"q4 with fallback_parallel_workers={workers}: fork pool "
                 f"served {pool_served}")
        print(f"[9 chunked] q4 with fallback_parallel_workers={workers}: "
              f"{ms:.1f} ms, fork pool served {pool_served} {tag}",
              flush=True)
    eng.config.fallback_parallel_workers = 0
    assert_frame_parity(answers[1], answers[4], ordered=True,
                        label="q4 serial vs fork pool")
    if entry._frame is not None:
        fail("the chunked fallback materialized the whole olps frame")
    print("[9 chunked] q4 serial == q4 over a 4-process fork pool forked "
          "after CUDA initialisation; the whole olps frame never loaded",
          flush=True)

    # ROLLUP: a union of device legs, one B1 launch each; against the
    # whole-frame fallback (the chunked one refuses grouping sets)
    before = fr.launches
    t = time.perf_counter()
    rollup = eng.sql(tpch.ROLLUP)
    ms = (time.perf_counter() - t) * 1000
    m = eng.runner.last_metrics
    legs = [leg["route"] for leg in m.get("legs", [])]
    if m["route"] != "grouping_sets" or legs != ["packed"] * 3 or \
            fr.launches - before != 3:
        fail(f"ROLLUP: route {m['route']}, legs {legs}, B1 launches "
             f"{fr.launches - before}")
    assert_frame_parity(rollup, uninlined_fallback(oracle, tpch.ROLLUP),
                        ordered=True, label="ROLLUP vs the pandas fallback")
    print(f"[9 rollup] ROLLUP(l_returnflag, l_linestatus): 3 device legs, "
          f"{fr.launches - before} B1 launches, {len(rollup)} rows == the "
          f"whole-frame pandas fallback; first run {ms:.1f} ms {tag}",
          flush=True)

    # every B1 launch of the main-path run against the plain version
    max_err = 0
    for name, a in calls:
        max_err = max(max_err, check_kernel(fr, a, f"TPC-H {name}")[0])
    print(f"[9 replay] {len(calls)} B1 launches of the phase replayed: "
          f"generated kernel == plain version exactly", flush=True)
    eng.clear_cache()
    return max_err


# -- phase 10: SSB at SF10 from parquet -------------------------------------

def sf10_phase(workdir, rows, reps, tag, flush_l2):
    """Phase 10: SSB at SF10 (60,000,000 lineorder rows) written as
    parquet and streamed into the card through register_ssb_parquet.
    Returns B1's JSON entries at q2.1 and the multi-leg kernel's at
    batch (a)."""
    import os
    import resource

    import numpy as np
    import torch
    from tpu_olap_torch.bench import ssb
    from tpu_olap_torch.bench.parity import assert_frame_parity
    from tpu_olap_torch.kernels import fused_reduce as fr

    t = time.perf_counter()
    paths, dims = ssb.write_ssb_parquet(os.path.join(workdir, "ssb"), rows,
                                        seed=0)
    write_s = time.perf_counter() - t
    rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t = time.perf_counter()
    eng = new_engine()
    ssb.register_ssb_parquet(eng, paths, dims)
    ingest_s = time.perf_counter() - t
    seg = eng.catalog.get("lineorder").segments
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(f"[10 sf10] write_ssb_parquet: {rows} lineorder rows (seed 0) in "
          f"{len(paths)} files in {write_s:.1f} s (spawned writers); "
          f"register_ssb_parquet streamed them into "
          f"{len(seg.segments)} segments of "
          f"{seg.block_rows} rows ({seg.num_rows} rows, time partition "
          f"{seg.time_partition}) in {ingest_s:.1f} s; host peak RSS "
          f"{rss * 1024} B (before the ingest {rss_before * 1024} B) {tag}",
          flush=True)

    calls, current = {}, [None]
    real = fr.fused_reduce

    def record(*a):
        calls.setdefault(current[0], a)
        return real(*a)

    got, first, metrics = {}, {}, {}
    fr.fused_reduce = record
    fr.launches = 0
    try:
        for name, q in ssb.QUERIES.items():
            current[0] = name
            before = fr.launches
            t = time.perf_counter()
            got[name] = eng.sql(q)
            torch.cuda.synchronize()
            first[name] = (time.perf_counter() - t) * 1000
            m = metrics[name] = dict(eng.runner.last_metrics)
            if fr.launches == before or m["route"] != "packed":
                fail(f"SF10 {name}: route {m['route']}, B1 launches "
                     f"{fr.launches - before} ({m.get('fused_reason')})")
        launches = fr.launches
    finally:
        fr.fused_reduce = real
    resident = eng.runner.device_bytes()
    print(f"[10 sf10] 13/13 queries took B1 and the packed route; B1 "
          f"launches {launches}; resident device bytes {resident}; "
          f"torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} {tag}", flush=True)
    for name, q in ssb.QUERIES.items():
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            eng.sql(q)
            ts.append((time.perf_counter() - t) * 1000)
        m = metrics[name]
        print(f"[10 query] {name} p50 {float(np.median(ts)):.3f} ms over "
              f"{reps} runs | first run {first[name]:.1f} ms | route "
              f"{m['route']}, host copies {m['host_copies']}, groups "
              f"{m.get('result_groups')} {tag}", flush=True)
    busy = device_busy({n: (lambda q=q: eng.sql(q))
                        for n, q in ssb.QUERIES.items()})
    print(f"[10 device] {busy} {tag}", flush=True)

    # every launch against the plain version, then B1's times at SF10
    shapes, max_err = {}, 0
    for name, a in calls.items():
        err, out = check_kernel(fr, a, f"SF10 {name}")
        max_err = max(max_err, err)
        shapes[name] = (a, out[0])
    print(f"[10 replay] {len(calls)} B1 launches replayed: generated kernel "
          f"== plain version exactly", flush=True)
    rows_json = [kernel_times(name, *shapes[name], max_err, launches, tag,
                              flush_l2, label=" SF10")
                 for name in ("q1.1", "q2.1", "q3.1")]

    # batch (a) of phase 11 once more, over SF10's segments
    _, calls, multi = run_checked_batch(eng, tuple(ssb.QUERIES), got,
                                        "(a) the 13 queries at SF10", tag)
    multi_err, largest = 0, None
    for a in calls:
        err, sums = check_multi(fr, a, "batch SF10")
        multi_err = max(multi_err, err)
        if largest is None or len(a[0]) > len(largest[0][0]):
            largest = (a, sums)
    print(f"[10 replay] {len(calls)} multi-leg launches replayed: kernel == "
          f"plain version exactly", flush=True)
    batch_row = multi_times("batch SF10", *largest, multi_err, multi, tag,
                            flush_l2)
    del calls, largest

    # q1.1 and q2.1 against the chunked pandas fallback over the parquet
    for name in ("q1.1", "q2.1"):
        t = time.perf_counter()
        ref = uninlined_fallback(eng, ssb.QUERIES[name])
        ms = (time.perf_counter() - t) * 1000
        assert_frame_parity(got[name], ref, ordered=True,
                            label=f"SF10 {name} vs the chunked fallback")
        print(f"[10 check] {name} ({len(ref)} rows) == the chunked pandas "
              f"fallback over the same parquet exactly ({ms:.1f} ms) {tag}",
              flush=True)
    if eng.catalog.get("lineorder")._frame is not None:
        fail("the SF10 fallback materialized the whole lineorder frame")
    eng.clear_cache()
    return rows_json[1], batch_row


PIPE_THREADS = 8                  # phase 14 (a): concurrent callers
PIPE_ROUNDS = 3                   # the 13 per thread, in its own order
WEDGE_DEADLINE_S = 0.5            # phase 14 (b)/(c): query_deadline_s
WEDGE_SLACK_S = 0.15              # a deadline's raise is due within this
WEDGE_SPIN_S = 3.0                # (b): the spin kernel's length


class Wedge:
    """A fault injector at the "dispatch" site that, once armed, launches
    torch.cuda._sleep (the profiler's primer kernel) on the current
    stream, sized to spin `seconds`, and returns: the statement's own
    kernels then queue behind it, as behind a hung kernel."""

    stages = {"dispatch"}

    def __init__(self, cycles_per_s):
        self.cycles_per_s = cycles_per_s
        self.seconds = 0.0
        self.fired_at = None

    def arm(self, seconds):
        self.seconds = seconds

    def __call__(self, stage, attempt):
        if self.seconds:
            import torch
            torch.cuda._sleep(int(self.seconds * self.cycles_per_s))
            self.fired_at = time.perf_counter()
            self.seconds = 0.0

    def drain(self):
        """Wait until the stream has run the spin out."""
        import torch
        t = time.perf_counter()
        while not torch.cuda.current_stream().query():
            if time.perf_counter() - t > 60:
                fail("the wedge's spin kernel never ended")
            time.sleep(0.02)


def spin_rate() -> float:
    """torch.cuda._sleep cycles per second on this card (CUDA events)."""
    import torch
    cycles = 1 << 27
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    return cycles / (a.elapsed_time(b) / 1000)


def stage1_syncs(seg, tables, frames) -> dict:
    """Which routes still sync with the host before stage 2's wait: each
    runs under SyncChecked on a pipelined engine over the SF1 segments
    (the breaker off and no retries, so that a sync error is one
    statement's failure). {route: "no sync" or the error}."""
    from tpu_olap_torch.bench import ssb
    eng = ssb_engine(seg, tables, breaker_failure_threshold=0,
                     dispatch_retries=0)
    routes = {
        "packed (the 13, B1)": lambda: [eng.sql(q)
                                        for q in ssb.QUERIES.values()],
        "generic reduce (q2.1, use_fused_reduce=never)":
            lambda: eng.sql(ssb.QUERIES["q2.1"]),
        "HLL, dense (x1)": lambda: eng.sql(ssb.DISTINCT_QUERIES["x1"]),
        "theta, dense (x2)": lambda: eng.sql(ssb.DISTINCT_QUERIES["x2"]),
        "theta set-op, unpacked (x3)":
            lambda: eng.sql(ssb.DISTINCT_QUERIES["x3"]),
        "sparse (x4)": lambda: eng.sql(ssb.DISTINCT_QUERIES["x4"]),
        "scan, mask (scan A)": lambda: eng.sql(SCAN_A),
        "search, coded (SEARCH verb)": lambda: eng.sql(SEARCH_VERB),
        "fused batch (the 13 as sql_batch)":
            lambda: eng.sql_batch(list(ssb.QUERIES.values())),
        "tier 1, segment-extended B1 (q2.1 window)":
            lambda: eng.sql(tier1_statements(ssb)["q2.1"][0]),
    }
    out = {}
    for label, run in routes.items():
        eng.config.use_fused_reduce = "never" if "generic" in label \
            else "auto"
        eng.config.segment_cache_enabled = "tier 1" in label
        run()   # warm outside the check: compiles, uploads
        with SyncChecked():
            try:
                run()
                out[label] = "no sync"
            except RuntimeError as e:
                out[label] = f"syncs ({str(e).splitlines()[0][:80]})"
    eng.close()
    return out


def gil_released(rate) -> tuple:
    """Whether torch.cuda.Event.synchronize releases the GIL: a thread
    waits on an event recorded behind a 0.4 s spin while this thread
    sleeps 10 ms and counts loop iterations for 0.2 s. Returns (this
    thread's wall s, iterations, iterations with no waiter): a wait that
    held the GIL would keep this thread off it until the spin ended."""
    import threading

    import torch

    def count(s):
        n, end = 0, time.perf_counter() + s
        while time.perf_counter() < end:
            n += 1
        return n
    base = count(0.2)
    torch.cuda._sleep(int(0.4 * rate))
    ev = torch.cuda.Event(blocking=True)
    ev.record()
    th = threading.Thread(target=ev.synchronize)
    t = time.perf_counter()
    th.start()
    time.sleep(0.01)
    n = count(0.2)
    wall = time.perf_counter() - t
    th.join()
    return wall, n, base


def stage_means(recs) -> dict:
    """Mean ms per statement of each stage section's run time, and of
    the lock wait and stage 2's copy wait, over `recs`."""
    out: dict = {}
    for r in recs:
        for st in r.get("stages", []):
            out[st["stage"]] = out.get(st["stage"], 0.0) + st["run_ms"]
        for k in ("lock_wait_ms", "transfer_ms"):
            out[k] = out.get(k, 0.0) + (r.get(k) or 0.0)
    return {k: round(v / max(1, len(recs)), 3) for k, v in out.items()}


def pipeline_phase(seg, tables, frames, reps, tag):
    """Phase 14: the pipelined two-stage mode against the serialized one,
    a real wedge under the per-query deadline, the batch under the
    deadline, and EXPLAIN ANALYZE's span tree, on the SF1 segments."""
    import random
    import threading

    import numpy as np
    import pandas as pd
    import torch
    from tpu_olap_torch.bench import ssb
    from tpu_olap_torch.executor.runner import QueryDeadlineExceeded
    from tpu_olap_torch.kernels import cuda_build
    from tpu_olap_torch.kernels import fused_reduce as fr
    names = list(ssb.QUERIES)
    t_phase = time.perf_counter()

    # (a) pipelined against serialized
    engs = {depth: ssb_engine(seg, tables, pipeline_depth=depth,
                              batch_window_ms=0)
            for depth in (4, 0)}
    mode = {4: "pipelined", 0: "serialized"}
    for e in engs.values():
        for q in ssb.QUERIES.values():
            e.sql(q)   # warm: stacks, plans
    ts = {d: {n: [] for n in names} for d in engs}
    one0 = {d: len(e.history) for d, e in engs.items()}
    for r in range(reps):
        for d in ((4, 0) if r % 2 == 0 else (0, 4)):
            for n in names:
                t = time.perf_counter()
                got = engs[d].sql(ssb.QUERIES[n])
                ts[d][n].append((time.perf_counter() - t) * 1000)
                if r == 0:
                    pd.testing.assert_frame_equal(got, frames[n])
    one1 = {d: len(e.history) for d, e in engs.items()}
    for d, e in engs.items():
        fr.launches = 0
        h0 = len(e.history)
        for n in names:
            e.sql(ssb.QUERIES[n])
        recs = list(e.history)[h0:]
        if fr.launches != len(names) or any(
                r.get("host_copies") != 1 or r.get("route") != "packed"
                or bool(r.get("pipelined")) != (d > 0) for r in recs):
            got = [(r.get("route"), r.get("host_copies"),
                    r.get("pipelined")) for r in recs]
            fail(f"14 (a) {mode[d]}: B1 launches {fr.launches} for "
                 f"{len(names)} statements; (route, copies, pipelined) "
                 f"{got}")
    for d, e in engs.items():
        p = {n: round(float(np.median(v)), 3) for n, v in ts[d].items()}
        means = stage_means(list(e.history)[one0[d]:one1[d]])
        print(f"[14 one thread] {mode[d]}: per-query p50 over {reps} runs "
              f"(modes alternating) {json.dumps(p)}; sum "
              f"{sum(p.values()):.3f} ms; mean ms per statement by stage "
              f"section {json.dumps(means)} {tag}", flush=True)
    for d, e in engs.items():
        e.runner.metrics.histogram("dispatch_lock_wait_ms").series.clear()
        lat, errs = [], []
        fr.launches = 0
        h0 = len(e.history)

        def worker(i, e=e, lat=lat, errs=errs):
            order = names[:]
            random.Random(i).shuffle(order)
            try:
                for _ in range(PIPE_ROUNDS):
                    for n in order:
                        t = time.perf_counter()
                        got = e.sql(ssb.QUERIES[n])
                        lat.append((n, (time.perf_counter() - t) * 1000))
                        pd.testing.assert_frame_equal(got, frames[n])
            except Exception as ex:  # noqa: BLE001 — fails the phase
                errs.append(f"{type(ex).__name__}: {ex}")

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(PIPE_THREADS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t
        n_stmt = PIPE_THREADS * PIPE_ROUNDS * len(names)
        recs = list(e.history)[h0:]
        if errs or len(lat) != n_stmt:
            fail(f"14 (a) {mode[d]}, {PIPE_THREADS} threads: {errs[:3]}")
        if fr.launches != n_stmt or any(r.get("host_copies") != 1
                                        for r in recs):
            fail(f"14 (a) {mode[d]}, {PIPE_THREADS} threads: B1 launches "
                 f"{fr.launches} for {n_stmt} statements, copies "
                 f"{sorted({r.get('host_copies') for r in recs})}")
        h = e.runner.metrics.histogram("dispatch_lock_wait_ms")
        by_q = {n: [ms for m, ms in lat if m == n] for n in names}
        print(f"[14 threads] {mode[d]}: {PIPE_THREADS} threads x "
              f"{PIPE_ROUNDS} rounds of the 13 (own order each), {n_stmt} "
              f"statements in {wall:.3f} s = {n_stmt / wall:.1f} "
              f"statements/s; every answer == phase 4's frame exactly, "
              f"B1 once per statement, one copy each; per-query p50/p99 ms "
              + json.dumps({n: [round(float(np.percentile(v, 50)), 3),
                                round(float(np.percentile(v, 99)), 3)]
                            for n, v in by_q.items()})
              + f"; dispatch_lock_wait_ms p50 {h.quantile(0.5):.3f} p99 "
              f"{h.quantile(0.99):.3f} (registry, "
              f"{sum(s.n for s in h.series.values())} waits) {tag}",
              flush=True)
    rate = spin_rate()
    wall, n, base = gil_released(rate)
    if wall > 0.3:
        fail(f"torch.cuda.Event.synchronize held the GIL: this thread "
             f"waited {wall:.3f} s behind a 0.4 s spin")
    print(f"[14 GIL] while a thread waited on an event behind a 0.4 s "
          f"spin, this thread ran {n} loop iterations in 0.2 s ({base} "
          f"with no waiter) and got back in {wall:.3f} s: "
          f"Event.synchronize releases the GIL {tag}", flush=True)
    pip = engs[4]
    syncs = stage1_syncs(seg, tables, frames)
    print(f"[14 stage 1] routes under set_sync_debug_mode('error') lifted "
          f"only for stage 2's event wait: {json.dumps(syncs)}", flush=True)
    if syncs["packed (the 13, B1)"] != "no sync":
        fail(f"the packed route syncs before stage 2's wait: "
             f"{syncs['packed (the 13, B1)']}")
    with SyncChecked():
        for n in names:
            try:
                pd.testing.assert_frame_equal(pip.sql(ssb.QUERIES[n]),
                                              frames[n])
            except RuntimeError as e:
                fail(f"14 (a) {n}: a host sync before stage 2's wait: {e}")
    print("[14 sync] the 13 on the pipelined engine under "
          "set_sync_debug_mode('error'), lifted only around stage 2's "
          "event wait: no host sync before it, answers exact", flush=True)
    for e in engs.values():
        e.close()

    # (b) a real wedge under the deadline
    print(f"[14 wedge] torch.cuda._sleep spins {rate / 1e9:.3f} G cycles/s "
          f"on this card", flush=True)
    q21 = ssb.QUERIES["q2.1"]
    for depth in (4, 0):
        wedge = Wedge(rate)
        e = ssb_engine(seg, tables, pipeline_depth=depth,
                       dispatch_retries=0, fault_injector=wedge)
        pd.testing.assert_frame_equal(e.sql(q21), frames["q2.1"])  # warm
        e.config.query_deadline_s = WEDGE_DEADLINE_S
        pd.testing.assert_frame_equal(e.sql(q21), frames["q2.1"])
        ds_before = e.runner._datasets["lineorder"]
        n_kernels = len(cuda_build._kernels)
        steps = []
        for i, want in enumerate(("deadline_exceeded",
                                  "device_probe_failed")):
            if i == 0:
                wedge.arm(WEDGE_SPIN_S)
            h0 = len(e.history)
            t = time.perf_counter()
            try:
                e.sql(q21)
                fail(f"14 (b) {mode[depth]} step {i + 1}: q2.1 answered "
                     f"behind the spin")
            except QueryDeadlineExceeded:
                pass
            took = time.perf_counter() - t
            if took > WEDGE_DEADLINE_S + WEDGE_SLACK_S or not any(
                    r.get(want) for r in list(e.history)[h0:]):
                fail(f"14 (b) {mode[depth]} step {i + 1}: raised after "
                     f"{took:.3f} s; records {list(e.history)[h0:]}")
            steps.append(took)
        wedge.drain()
        spun = time.perf_counter() - wedge.fired_at
        h0 = len(e.history)
        t = time.perf_counter()
        got = e.sql(q21)
        steps.append(time.perf_counter() - t)
        pd.testing.assert_frame_equal(got, frames["q2.1"])
        recs = list(e.history)[h0:]
        reup = e.runner._datasets["lineorder"] is not ds_before
        compiles = len(cuda_build._kernels) - n_kernels
        if not any(r.get("device_probe_recovered") for r in recs) \
                or not reup or compiles or e.runner.breaker.state != "closed" \
                or recs[-1].get("route") != "packed":
            fail(f"14 (b) {mode[depth]} recovery: records {recs}, stacks "
                 f"re-uploaded {reup}, NVRTC compiles {compiles}, breaker "
                 f"{e.runner.breaker.state}")
        print(f"[14 wedge] {mode[depth]}: a {WEDGE_SPIN_S:.0f} s spin "
              f"launched at the dispatch site, B1 queued behind it; q2.1 "
              f"raised QueryDeadlineExceeded in {steps[0]:.3f} s "
              f"(deadline {WEDGE_DEADLINE_S} s, deadline_exceeded "
              f"recorded); again while it spun in {steps[1]:.3f} s "
              f"(device_probe_failed); after the spin ended ({spun:.3f} s "
              f"after launch) answered on the card in {steps[2]:.3f} s "
              f"(device_probe_recovered, stacks re-uploaded, {compiles} "
              f"NVRTC compiles, == phase 4's frame); breaker "
              f"{e.runner.breaker.state} {tag}", flush=True)
        if depth == 4:
            deadline_lines = [ln for ln in e.metrics.render().splitlines()
                              if ln.startswith(
                                  "tpu_olap_deadline_exceeded_total")]
        e.close()

    # (c) the batch under the deadline
    wedge = Wedge(rate)
    e = ssb_engine(seg, tables, dispatch_retries=0, fault_injector=wedge,
                   breaker_failure_threshold=64)
    e.sql_batch(list(ssb.QUERIES.values()))   # warm: compositions, stacks
    e.config.query_deadline_s = WEDGE_DEADLINE_S
    queries = [e.planner.plan(q).query for q in ssb.QUERIES.values()]
    calls = []
    for attr in ("_guarded_dispatch", "_execute_guarded"):
        real = getattr(e.runner, attr)

        def timed_call(*a, real=real, attr=attr):
            t = time.perf_counter()
            try:
                return real(*a)
            except Exception as ex:
                calls.append((attr, time.perf_counter() - t,
                              type(ex).__name__))
                raise
        setattr(e.runner, attr, timed_call)
    wedge.arm(len(queries) * (WEDGE_DEADLINE_S + WEDGE_SLACK_S) + 1.0)
    t = time.perf_counter()
    boxed = e.runner._execute_batch_boxed(queries, seg)
    took = time.perf_counter() - t
    for attr in ("_guarded_dispatch", "_execute_guarded"):
        del e.runner.__dict__[attr]
    late = [c for c in calls if c[1] > WEDGE_DEADLINE_S + WEDGE_SLACK_S
            or c[2] != "QueryDeadlineExceeded"]
    if not all(isinstance(b, QueryDeadlineExceeded) for b in boxed) \
            or late or not calls:
        fail(f"14 (c): boxed {[type(b).__name__ for b in boxed]}; "
             f"dispatches (call, s, error) {calls}")
    wedge.drain()
    # the recovery's re-upload of every leg's stacks rides the first
    # dispatch: a looser deadline for it (the wedge flag is read only
    # under a deadline, so the reprobe still runs)
    e.config.query_deadline_s = 10 * WEDGE_DEADLINE_S
    outs = e.sql_batch(list(ssb.QUERIES.values()))
    if not any(r.get("device_probe_recovered") for r in e.history):
        fail("14 (c): the batch after the spin did not re-probe")
    for n, got in zip(names, outs):
        pd.testing.assert_frame_equal(got, frames[n])
    print(f"[14 batch] the 13 as one shared-scan batch behind the spin: "
          f"{len(calls)} guarded dispatches (fused groups and single "
          f"legs), each raised QueryDeadlineExceeded in "
          f"{min(c[1] for c in calls):.3f}-{max(c[1] for c in calls):.3f} s"
          f", every leg boxed QueryDeadlineExceeded ({took:.3f} s in all); "
          f"after the spin the batch == phase 11 (a)'s answers (phase 4's "
          f"frames, which (a) equals exactly) {tag}", flush=True)
    e.close()

    # (d) the trace
    e = ssb_engine(seg, tables)
    e.sql(ssb.QUERIES["q3.2"])
    ea = e.sql("EXPLAIN ANALYZE " + ssb.QUERIES["q3.2"])
    spans = [(s, ms) for s, ms in zip(ea["span"], ea["ms"])]
    root = spans[0][1]
    top = sum(ms for s, ms in spans if s.startswith("  ")
              and not s.startswith("    "))
    if spans[0][0] != "sql" or top > root + 1e-6:
        fail(f"14 (d): EXPLAIN ANALYZE spans {spans}")
    print(f"[14 trace] EXPLAIN ANALYZE q3.2 (ms): "
          + "; ".join(f"{'>' * ((len(s) - len(s.lstrip())) // 2)}"
                      f"{s.strip()} {ms:.3f}" for s, ms in spans)
          + f" | the root's children sum to {top:.3f} of {root:.3f} ms "
          f"{tag}", flush=True)
    lines = [ln for ln in e.metrics.render().splitlines()
             if ln.startswith(("tpu_olap_dispatch_lock_wait_ms_sum",
                               "tpu_olap_dispatch_lock_wait_ms_count",
                               "tpu_olap_inflight_transfers",
                               "tpu_olap_pipeline_inflight"))]
    print(f"[14 trace] counters() {json.dumps(e.counters())}; registry "
          f"{' | '.join(lines + deadline_lines)}", flush=True)
    e.close()
    print(f"[14 pipeline] phase 14 took {time.perf_counter() - t_phase:.1f}"
          f" s", flush=True)


# -- phase 15: serving and observability on the card ----------------------

HTTP_CLIENTS = 8                  # phase 15 (b): concurrent HTTP clients
HTTP_ROUNDS = 3                   # the 13 per client, in its own order
HTTP_REPS = 5                     # (a): timed runs per query and surface
HTTP_APPEND_ROWS = 32_768         # (a): rows of the POST /ingest batch
CAPTURE_MS = 1500                 # (d): the torch.profiler window
DRIFT_LATENCY_S = 0.2             # (e): injected stage-transfer latency
DRIFT_BASELINE = 20               # (e): q2.1 runs before the injection
READY_SPIN_S = 1.0                # (f): the wedge spin under /readyz
# one line of the Prometheus text format (tests/test_observability.py)
METRIC_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\")*\})?"
    r" (?P<value>[^ ]+)$")
SYS_TABLES = ("tables", "segments", "queries", "query_templates",
              "metrics", "caches", "cubes", "checkpoints", "devices",
              "metrics_history", "alerts")


class Http:
    """One keep-alive HTTP/1.1 connection to a QueryServer."""

    def __init__(self, srv):
        import http.client
        self.conn = http.client.HTTPConnection(srv.host, srv.port,
                                               timeout=120)

    def call(self, method, path, payload=None):
        """(status, headers, parsed body or text)."""
        body = None if payload is None else json.dumps(payload).encode()
        self.conn.request(method, path, body=body,
                          headers={"Content-Type": "application/json"})
        r = self.conn.getresponse()
        data = r.read().decode()
        try:
            data = json.loads(data)
        except json.JSONDecodeError:
            pass
        return r.status, dict(r.getheaders()), data

    def sql(self, q):
        """(status, query id, body) of POST /sql."""
        status, hdrs, body = self.call("POST", "/sql", {"query": q})
        return status, hdrs.get("X-Query-Id"), body

    def close(self):
        self.conn.close()


def http_frame(body):
    import pandas as pd
    return pd.DataFrame(body["rows"], columns=body["columns"])


def wire_rows(frame) -> list:
    """A frame as POST /sql's rows come back (the server's _jsonable and
    a JSON round trip)."""
    from tpu_olap_torch.api.server import _jsonable
    return json.loads(json.dumps(_jsonable(frame.to_dict("records")),
                                 default=str))


def check_metrics_text(text: str) -> int:
    """Fail unless every line of a /metrics scrape parses in the
    Prometheus text format with a finite value; the number of samples."""
    import math
    n = 0
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            if not re.match(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* ",
                            line):
                fail(f"15 (b): bad /metrics comment line {line!r}")
            continue
        m = METRIC_LINE.match(line)
        if not m or not math.isfinite(float(m.group("value"))):
            fail(f"15 (b): bad /metrics line {line!r}")
        n += 1
    return n


def trace_kernels(path, primers=0) -> tuple:
    """(host launch calls, [positions in launch order of the launches
    whose kernel the trace lacks], {query id: [kernel names]}) of an
    exported torch.profiler trace. A launch and its kernel share a
    correlation id."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches = sorted((e for e in events if e.get("ph") == "X" and str(
        e.get("name", "")).startswith(("cudaLaunchKernel",
                                       "cuLaunchKernel"))),
                      key=lambda e: e["ts"])
    kernels = [e for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    corr = {(e.get("args") or {}).get("correlation") for e in kernels}
    missing = [i for i, e in enumerate(launches)
               if (e.get("args") or {}).get("correlation") not in corr]
    by_q: dict = {}
    for e in kernels:
        q = (e.get("args") or {}).get("query_id")
        if q is not None:
            by_q.setdefault(q, []).append(e["name"])
    return len(launches), missing, by_q


def serving_phase(seg, tables, frames, tag):
    """Phase 15: the HTTP server, the sys tables, the registries, the
    torch.profiler capture, the sentinel and /readyz, on the SF1
    segments."""
    import random
    import threading

    import numpy as np
    import pandas as pd
    import torch
    from tpu_olap_torch.api.server import QueryServer
    from tpu_olap_torch.bench import ssb
    from tpu_olap_torch.bench.parity import assert_frame_parity
    from tpu_olap_torch.kernels import fused_reduce as fr
    from tpu_olap_torch.obs import profile
    from tpu_olap_torch.resilience.faults import FaultInjector
    names = list(ssb.QUERIES)
    t_phase = time.perf_counter()
    eng = ssb_engine(seg, tables, telemetry_interval_s=0.5)
    srv = QueryServer(eng).start()
    cli = Http(srv)
    try:
        for q in ssb.QUERIES.values():
            eng.sql(q)        # warm: plans, stacks

        # (a) the 13 over POST /sql, the counts set to 0 just before
        fr.launches = 0
        h0 = len(eng.history)
        qids = {}
        for n in names:
            status, qid, body = cli.sql(ssb.QUERIES[n])
            if status != 200 or not qid:
                fail(f"15 (a) {n}: HTTP {status}, X-Query-Id {qid}: "
                     f"{str(body)[:300]}")
            assert_frame_parity(http_frame(body), frames[n],
                                label=f"15 (a) {n} over HTTP")
            if body["rows"] != wire_rows(frames[n]):
                fail(f"15 (a) {n}: the rows over HTTP differ from phase "
                     f"5's frame")
            qids[n] = qid
        launched = fr.launches
        recs = list(eng.history)[h0:]
        if launched != len(names) or any(
                r.get("route") != "packed" or r.get("host_copies") != 1
                for r in recs):
            fail(f"15 (a): B1 launches {launched} for {len(names)} "
                 f"statements; routes {[r.get('route') for r in recs]}")
        known = set(eng.sql("SELECT query_id FROM sys.queries")["query_id"])
        _, _, dbg = cli.call("GET", "/debug/queries?n=128")
        missing = [n for n, q in qids.items()
                   if q not in known or q not in json.dumps(dbg)]
        if missing:
            fail(f"15 (a): X-Query-Id of {missing} not in sys.queries and "
                 f"/debug/queries")
        # q2.1's native query over /druid/v2
        ir = eng.planner.plan(ssb.QUERIES["q2.1"]).query.to_json()
        status, _, druid = cli.call("POST", "/druid/v2", ir)
        want = json.loads(json.dumps(eng.execute_ir(ir).druid,
                                     default=str))
        if status != 200 or druid != want:
            fail(f"15 (a) /druid/v2: HTTP {status}, "
                 f"{len(druid) if isinstance(druid, list) else druid} "
                 f"rows against Engine.execute_ir's {len(want)}")
        # a kept-alive request's round trip with TCP_NODELAY (as served)
        # and with Nagle's algorithm on (the JAX package's server), in
        # turns; the option applies to the connections accepted after it
        handler = srv.httpd.RequestHandlerClass
        hz = {True: [], False: []}
        for nodelay in (True, False, True, False):
            handler.disable_nagle_algorithm = nodelay
            c = Http(srv)
            for _ in range(20):
                t = time.perf_counter()
                c.call("GET", "/healthz")
                hz[nodelay].append((time.perf_counter() - t) * 1000)
            c.close()
        handler.disable_nagle_algorithm = True
        # p50 of each query over HTTP against Engine.sql, in turns
        ts = {(s, n): [] for s in ("http", "sql") for n in names}
        for r in range(HTTP_REPS):
            for s in (("http", "sql") if r % 2 == 0 else ("sql", "http")):
                for n in names:
                    t = time.perf_counter()
                    if s == "http":
                        cli.sql(ssb.QUERIES[n])
                    else:
                        eng.sql(ssb.QUERIES[n])
                    ts[(s, n)].append((time.perf_counter() - t) * 1000)
        p50 = {k: float(np.median(v)) for k, v in ts.items()}
        over = [p50[("http", n)] - p50[("sql", n)] for n in names]
        print(f"[15 http] 13/13 over POST /sql == phase 4's frames "
              f"(assert_frame_parity and the rows exactly), each with an "
              f"X-Query-Id that sys.queries and /debug/queries show; B1 "
              f"{launched} launches for the 13, packed, one copy each; "
              f"q2.1 over /druid/v2 == Engine.execute_ir; p50 ms over "
              f"{HTTP_REPS} runs (HTTP | Engine.sql) "
              + json.dumps({n: [round(p50[("http", n)], 3),
                                round(p50[("sql", n)], 3)]
                            for n in names})
              + f"; HTTP adds {float(np.median(over)):.3f} ms per "
              f"statement (median over the 13; {min(over):.3f}-"
              f"{max(over):.3f}); GET /healthz on a kept-alive connection "
              f"p50 {np.median(hz[True]):.3f} ms with TCP_NODELAY, "
              f"{np.median(hz[False]):.3f} ms with Nagle on {tag}",
              flush=True)

        # (b) 8 clients x 3 rounds of the 13, /metrics scraped meanwhile
        want_rows = {n: wire_rows(frames[n]) for n in names}
        lat, errs, scrapes = [], [], []
        done = threading.Event()
        fr.launches = 0
        h0 = len(eng.history)

        def client(i):
            c = Http(srv)
            order = names[:]
            random.Random(i).shuffle(order)
            try:
                for _ in range(HTTP_ROUNDS):
                    for n in order:
                        t = time.perf_counter()
                        status, _, body = c.sql(ssb.QUERIES[n])
                        lat.append((n, (time.perf_counter() - t) * 1000))
                        if status != 200 or body["rows"] != want_rows[n]:
                            errs.append(f"{n}: HTTP {status}")
            except Exception as ex:  # noqa: BLE001 — fails the phase
                errs.append(f"{type(ex).__name__}: {ex}")
            finally:
                c.close()

        def scraper():
            c = Http(srv)
            try:
                while not done.is_set():
                    t = time.perf_counter()
                    status, hdrs, text = c.call("GET", "/metrics")
                    scrapes.append(((time.perf_counter() - t) * 1000,
                                    status, text))
                    time.sleep(0.1)
            finally:
                c.close()

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(HTTP_CLIENTS)]
        sc = threading.Thread(target=scraper)
        t = time.perf_counter()
        sc.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t
        done.set()
        sc.join(timeout=30)
        n_stmt = HTTP_CLIENTS * HTTP_ROUNDS * len(names)
        recs = list(eng.history)[h0:]
        if errs or len(lat) != n_stmt:
            fail(f"15 (b): {len(lat)} of {n_stmt} answered; {errs[:3]}")
        if fr.launches != n_stmt or any(r.get("host_copies") != 1
                                        for r in recs):
            fail(f"15 (b): B1 launches {fr.launches} for {n_stmt} "
                 f"statements")
        if not scrapes or any(s[1] != 200 for s in scrapes):
            fail(f"15 (b): /metrics scrapes {[s[1] for s in scrapes]}")
        samples = check_metrics_text(scrapes[-1][2])
        sms = [s[0] for s in scrapes]
        all_ms = [ms for _, ms in lat]
        by_q = {n: [ms for m, ms in lat if m == n] for n in names}
        print(f"[15 clients] {HTTP_CLIENTS} HTTP clients x {HTTP_ROUNDS} "
              f"rounds of the 13 (own order each, keep-alive), {n_stmt} "
              f"statements in {wall:.3f} s = {n_stmt / wall:.1f} "
              f"statements/s; every answer == phase 4's rows, B1 once per "
              f"statement, one copy each; p50 {np.percentile(all_ms, 50):.3f}"
              f" p99 {np.percentile(all_ms, 99):.3f} ms; per-query p50/p99 "
              + json.dumps({n: [round(float(np.percentile(v, 50)), 3),
                                round(float(np.percentile(v, 99)), 3)]
                            for n, v in by_q.items()})
              + f"; GET /metrics during the load: {len(scrapes)} scrapes, "
              f"p50 {np.percentile(sms, 50):.3f} max {max(sms):.3f} ms, "
              f"{samples} samples, Prometheus grammar ok {tag}", flush=True)

        # (c) the registries
        rc = eng.metrics.counter("recompiles_total")
        cms = eng.metrics.counter("compile_ms_total")

        def compiles():
            return sum(s.value for s in list(rc.series.values()))
        new_q = ("SELECT p_mfgr, sum(lo_supplycost) AS sc, max(lo_tax) AS "
                 "mt FROM lineorder WHERE lo_quantity < {} GROUP BY p_mfgr")
        c0, m0 = compiles(), cms.value()
        got = eng.sql(new_q.format(17))
        c1, m1 = compiles(), cms.value()
        eng.sql(new_q.format(23))
        c2 = compiles()
        kinds = {k[0]: v.value for k, v in list(rc.series.items())}
        if (c1 - c0, c2 - c1) != (1, 0) or m1 <= m0 or len(got) == 0:
            fail(f"15 (c): recompiles_total rose {c1 - c0} for a new "
                 f"structure and {c2 - c1} for its other literals "
                 f"(compile_ms_total {m0} -> {m1}); by kind {kinds}")
        h = len(eng.history)
        sys_rows = {}
        for name in SYS_TABLES:
            sys_rows[name] = len(eng.sql(f"SELECT * FROM sys.{name}"))
        dev = eng.sql("SELECT hbm_bytes, device, platform FROM sys.devices")
        led = eng.runner._ledger.bytes_in_use
        alloc = torch.cuda.memory_allocated()
        hbm = int(dev["hbm_bytes"].iloc[0])
        if len(eng.history) != h or len(dev) != 1 or hbm != led \
                or hbm > alloc:
            fail(f"15 (c): history {h} -> {len(eng.history)} over the sys "
                 f"statements; sys.devices {dev.to_dict('records')} vs "
                 f"ledger {led}, memory_allocated {alloc}")
        print(f"[15 registries] recompiles_total +{c1 - c0} for a new "
              f"structure ({m1 - m0:.1f} ms of NVRTC in compile_ms_total), "
              f"+{c2 - c1} for the same structure with other literals; by "
              f"kind {json.dumps(kinds)}; sys.devices: {dev['device'][0]} "
              f"({dev['platform'][0]}) hbm_bytes {hbm} == the ledger's "
              f"bytes_in_use, <= torch.cuda.memory_allocated {alloc}; every "
              f"sys table answers (rows {json.dumps(sys_rows)}), history "
              f"unchanged over them {tag}", flush=True)

        # (d) a capture over HTTP while a client runs q2.1
        q21 = ssb.QUERIES["q2.1"]
        for attempt in range(PROFILE_TRIES):
            ran, box = [], {}

            def capture():
                c = Http(srv)
                try:
                    box["r"] = c.call("POST",
                                      f"/debug/profile?ms={CAPTURE_MS}")
                finally:
                    c.close()

            def q21_client(until):
                c = Http(srv)
                try:
                    while time.perf_counter() < until:
                        status, qid, _ = c.sql(q21)
                        ran.append((status, qid))
                        time.sleep(0.02)
                finally:
                    c.close()
            cap_t = threading.Thread(target=capture)
            t0 = time.perf_counter()
            cap_t.start()
            # the client starts once the session is live, after its
            # primer kernels (obs.profile.SESSION_PRIMERS)
            while not profile.capture_active():
                if time.perf_counter() - t0 > 10:
                    fail("15 (d): the capture did not start in 10 s")
                time.sleep(0.005)
            # the client's launches end well inside the window
            th = threading.Thread(target=q21_client, args=(
                time.perf_counter() + CAPTURE_MS / 1000.0 - 0.4,))
            th.start()
            th.join(timeout=60)
            cap_t.join(timeout=60)
            status, _, cap = box.get("r", (None, None, {}))
            if status != 200 or not cap.get("ok"):
                fail(f"15 (d): the capture degraded: HTTP {status} {cap}")
            path = os.path.join(cap["trace_dir"], profile.TRACE_FILE)
            n_launch, missing, by_q = trace_kernels(path)
            primers = profile.SESSION_PRIMERS
            lost = [i for i in missing if i >= primers]
            ok_ids = {q for s, q in ran if s == 200}
            under = {q for q, ks in by_q.items()
                     if q in ok_ids and GEN_KERNEL in ks}
            if n_launch > primers and not lost and under:
                break
            print(f"[15 profile] capture {attempt + 1}: {n_launch} launch "
                  f"calls, {len(lost)} past the session's {primers} "
                  f"primers without their kernel (positions {lost[:24]}), "
                  f"B1 under {len(under)} of {len(ok_ids)} q2.1 ids; "
                  f"again", flush=True)
        else:
            fail(f"15 (d): no complete capture with B1 under a q2.1 id in "
                 f"{PROFILE_TRIES} tries")
        pdir = tempfile.mkdtemp(prefix="chip_smoke-profile-")
        pe = ssb_engine(seg, tables, profile_dir=pdir,
                        telemetry_enabled=False)
        try:
            per_stmt = []
            for n in ("q2.1", "q3.1"):
                pe.sql(ssb.QUERIES[n])
                rec = pe.history[-1]
                n_l, miss, pq = trace_kernels(os.path.join(
                    rec["profile_trace"], profile.TRACE_FILE))
                if GEN_KERNEL not in pq.get(rec["query_id"], ()):
                    fail(f"15 (d): {n}'s profile_dir trace lacks B1 under "
                         f"{rec['query_id']}: {pq}; {n_l} launch calls, "
                         f"those at {miss[:80]} without their kernel")
                per_stmt.append(f"{n} {rec['query_id']}")
        finally:
            pe.close()
            shutil.rmtree(pdir, ignore_errors=True)
        print(f"[15 profile] POST /debug/profile?ms={CAPTURE_MS} on a "
              f"handler thread while a client ran q2.1 {len(ran)} times "
              f"(capture {attempt + 1}): "
              f"{n_launch} launch calls, each past the session's "
              f"{primers} primers with its kernel (correlation ids; "
              f"{len(missing)} primers' kernels lost), B1 "
              f"({GEN_KERNEL}) under {len(under)} of the "
              f"{len(ok_ids)} q2.1 query ids; profile_dir: one trace per "
              f"statement, each with B1 under its id ({', '.join(per_stmt)})"
              f" {tag}", flush=True)

        # (a) continued: POST /ingest, and the next /sql sees the rows
        rng = np.random.default_rng(2)
        d = tables["date"]
        lo = ssb._gen_lineorder(
            rng, HTTP_APPEND_ROWS, len(tables["customer"]),
            len(tables["supplier"]), len(tables["part"]),
            d.d_datekey[d.d_year == 1998].to_numpy(),
            start_key=int(tables["lineorder"].lo_orderkey.max()) + 1)
        batch = ssb.denormalize({**tables, "lineorder": lo})
        rows = json.loads(batch.to_json(orient="records",
                                        date_format="iso"))
        count_q = "SELECT count(*) AS n, sum(lo_revenue) AS r FROM lineorder"
        _, _, b0 = cli.sql(count_q)
        t = time.perf_counter()
        status, _, ack = cli.call("POST", "/ingest",
                                  {"table": "lineorder", "rows": rows})
        ack_s = time.perf_counter() - t
        _, _, b1 = cli.sql(count_q)
        n0, r0 = b0["rows"][0]["n"], b0["rows"][0]["r"]
        n1, r1 = b1["rows"][0]["n"], b1["rows"][0]["r"]
        if status != 200 or ack.get("rows") != HTTP_APPEND_ROWS \
                or n1 - n0 != HTTP_APPEND_ROWS \
                or r1 - r0 != int(batch.lo_revenue.sum()):
            fail(f"15 (a) /ingest: HTTP {status} {str(ack)[:200]}; count "
                 f"{n0} -> {n1}, revenue {r0} -> {r1}")
        print(f"[15 ingest] POST /ingest of {HTTP_APPEND_ROWS} rows "
              f"acknowledged in {ack_s:.3f} s (delta_rows "
              f"{ack['delta_rows']}); the next POST /sql counts them: "
              f"{n0} -> {n1} rows, revenue +{r1 - r0} == the batch's "
              f"{tag}", flush=True)
    finally:
        cli.close()
        srv.stop()

    # (e) drift attributed to the transfer stage, and (f) /readyz under
    # a wedge, on an engine of their own
    rate = spin_rate()
    wedge = Wedge(rate)
    aux = ssb_engine(seg, tables, telemetry_interval_s=0.2,
                     sentinel_min_samples=5, sentinel_clear_after_s=1.0,
                     dispatch_retries=0)
    srv = QueryServer(aux).start()
    cli = Http(srv)
    try:
        q21 = ssb.QUERIES["q2.1"]
        for _ in range(DRIFT_BASELINE):   # the first uploads the stacks
            cli.sql(q21)
        inj = FaultInjector(rate=1.0, stages={"stage-transfer"},
                            latency_s=DRIFT_LATENCY_S)
        aux.config.fault_injector = inj
        status, qid, _ = cli.sql(q21)
        aux.config.fault_injector = None
        alerts = [a for a in aux.runner.sentinel.active()
                  if a["kind"] == "latency_drift"]
        sys_alerts = aux.sql("SELECT kind, stage, status FROM sys.alerts")
        _, _, health = cli.call("GET", "/debug/health")
        if status != 200 or inj.faults != 1 or not alerts \
                or alerts[0]["stage"] != "transfer" \
                or alerts[0]["query_id"] != qid or health["ok"] \
                or list(sys_alerts["stage"]) != ["transfer"]:
            fail(f"15 (e): alerts {alerts}, sys.alerts "
                 f"{sys_alerts.to_dict('records')}, health {health}")
        a = alerts[0]
        t = time.perf_counter()
        while time.perf_counter() - t < 10:
            _, _, health = cli.call("GET", "/debug/health")
            if health["ok"]:
                break
            time.sleep(0.1)
        cleared = time.perf_counter() - t
        if not health["ok"] or aux.sql(
                "SELECT status FROM sys.alerts")["status"][0] != "cleared":
            fail(f"15 (e): the alert did not clear: {health}")
        print(f"[15 sentinel] {DRIFT_LATENCY_S} s injected at the "
              f"stage-transfer site after a {DRIFT_BASELINE}-statement "
              f"baseline: "
              f"latency_drift on q2.1 attributed to stage "
              f"'{a['stage']}' ({a['total_ms']} ms against a "
              f"{a['baseline_ms']} ms baseline, threshold "
              f"{a['threshold_ms']} ms), in sys.alerts and /debug/health; "
              f"cleared {cleared:.2f} s later (sentinel_clear_after_s 1.0, "
              f"telemetry tick 0.2 s) {tag}", flush=True)

        # (f) /readyz during a wedge spin, and after recovery
        aux.config.fault_injector = wedge
        aux.config.query_deadline_s = WEDGE_DEADLINE_S
        cli.sql(q21)           # under the deadline, before the wedge
        wedge.arm(READY_SPIN_S)
        t = time.perf_counter()
        status, _, body = cli.sql(q21)
        took = time.perf_counter() - t
        r_code, _, r_body = cli.call("GET", "/readyz")
        wedge.drain()
        status2, _, body2 = cli.sql(q21)
        r2_code, _, r2_body = cli.call("GET", "/readyz")
        if status != 504 or r_code != 503 or not r_body["wedged"] \
                or status2 != 200 or r2_code != 200 \
                or body2["rows"] != wire_rows(frames["q2.1"]):
            fail(f"15 (f): q2.1 behind the spin HTTP {status} in "
                 f"{took:.3f} s; /readyz {r_code} {r_body}; after the spin "
                 f"q2.1 HTTP {status2}, /readyz {r2_code} {r2_body}")
        print(f"[15 readyz] a {READY_SPIN_S:.0f} s spin at the dispatch "
              f"site: POST /sql q2.1 504 in {took:.3f} s (deadline "
              f"{WEDGE_DEADLINE_S} s), /readyz 503 (wedged); after the "
              f"spin q2.1 200 (re-probed, == phase 4's rows), /readyz 200 "
              f"{tag}", flush=True)
    finally:
        cli.close()
        srv.stop()
    print(f"[15 serving] phase 15 took {time.perf_counter() - t_phase:.1f}"
          f" s", flush=True)


MESH_D = 4                             # logical devices of phase 16
NVLINK4_BYTES_PER_S = 450e9            # H100 NVLink 4, one direction


def mesh_phase(seg, tables, frames, tag, flush_l2):
    """Phase 16: the mesh, MESH_D logical devices over the one card
    (utils.platform.force_virtual_devices), on engines over the SF1
    segments. Returns (the mesh's B1 JSON entry, the fitted "cuda"
    calibration entry)."""
    import math

    import numpy as np
    import pandas as pd
    import torch
    from tpu_olap_torch.bench import ssb
    from tpu_olap_torch.executor.sharding import pad_segments
    from tpu_olap_torch.kernels import cuda_build
    from tpu_olap_torch.kernels import fused_reduce as fr
    from tpu_olap_torch.kernels import row_mask as rm
    from tpu_olap_torch.utils.platform import force_virtual_devices
    D = MESH_D
    names = list(ssb.QUERIES)
    engines = []

    def engine(**cfg):
        e = ssb_engine(seg, tables, **cfg)
        engines.append(e)
        return e

    def same(got, want, label):
        try:
            pd.testing.assert_frame_equal(got, want, check_exact=True)
        except AssertionError as e:
            fail(f"16 {label}: the mesh's answer differs: {e}")

    force_virtual_devices(D)
    try:
        one = engine()
        mesh = engine(num_shards=D)
        devs = mesh.runner.mesh.devices
        n_seg = len(seg.segments)
        print(f"[16 mesh] {D} logical devices {[str(d) for d in devs]} over "
              f"{torch.cuda.device_count()} card(s): {n_seg} segments "
              f"padded to {pad_segments(n_seg, D)}, "
              f"{pad_segments(n_seg, D) // D} per device; the devices share "
              f"one card, so no cross-device copy and no multi-GPU speed "
              f"is measured here {tag}", flush=True)

        # (a) the 13 under both merges: B1 once per device per statement
        calls, current, real = {}, [None], fr.fused_reduce

        def record(*a):
            calls.setdefault(current[0], []).append(a)
            return real(*a)
        got, per = {}, {}
        fr.fused_reduce = record
        fr.launches = 0
        try:
            for strategy in ("historicals", "broker"):
                mesh.config.force_strategy = strategy
                for name in names:
                    current[0] = (strategy, name)
                    before = fr.launches
                    got[(strategy, name)] = mesh.sql(ssb.QUERIES[name])
                    per[(strategy, name)] = (fr.launches - before,
                                             dict(mesh.runner.last_metrics))
            torch.cuda.synchronize()
            b1_launches = fr.launches
        finally:
            fr.fused_reduce = real
        for (strategy, name), (n, m) in per.items():
            copies = D if strategy == "historicals" else 1
            if n != D or m.get("num_shards") != D \
                    or m.get("strategy") != strategy or not m.get("fused") \
                    or m.get("host_copies") != copies:
                fail(f"16 {name} {strategy}: B1 launches {n} (want {D}), "
                     f"num_shards {m.get('num_shards')}, strategy "
                     f"{m.get('strategy')}, fused {m.get('fused')} "
                     f"({m.get('fused_reason')}), copies "
                     f"{m.get('host_copies')} (want {copies})")
            same(got[(strategy, name)], frames[name], f"{name} {strategy}")
        max_err = 0
        for key, launched in calls.items():
            for c, a in enumerate(launched):
                if a[2].device != devs[c]:
                    fail(f"16 {key}: device {c}'s launch read tensors on "
                         f"{a[2].device}, not {devs[c]}")
                max_err = max(max_err, check_kernel(
                    fr, a, f"16 {key} device {c}")[0])
        print(f"[16 agg] the 13 under historicals and broker: every answer "
              f"== phase 4's exactly; B1 {D} launches per statement "
              f"({b1_launches} in all), each on its device's stacks; "
              f"device-to-host copies per statement: historicals {D}, broker "
              f"1; every launch replayed against the plain version: max "
              f"|kernel - plain| = {max_err} {tag}", flush=True)
        a = calls[("historicals", "q2.1")][0]
        row = kernel_times("q2.1", a, fr.fused_reduce(*a)[0], max_err,
                           b1_launches, tag, flush_l2, label=" mesh",
                           phase="16")

        # p50 over 3 runs, D = 1 and D = 4 in turns
        modes = (("D=1", one, None), ("D=4 historicals", mesh, "historicals"),
                 ("D=4 broker", mesh, "broker"))
        ts = {(label, n): [] for label, _, _ in modes for n in names}
        for name in names:
            q = ssb.QUERIES[name]
            for rep in range(4):   # the first is a warm-up
                for label, e, strategy in modes:
                    if strategy is not None:
                        e.config.force_strategy = strategy
                    t = time.perf_counter()
                    e.sql(q)
                    if rep:
                        ts[(label, name)].append(
                            (time.perf_counter() - t) * 1000)
        p50 = {k: float(np.median(v)) for k, v in ts.items()}
        for name in names:
            print(f"[16 p50] {name}: "
                  + " | ".join(f"{label} {p50[(label, name)]:.3f} ms"
                               for label, _, _ in modes) + f" {tag}",
                  flush=True)
        tot = {label: sum(p50[(label, n)] for n in names)
               for label, _, _ in modes}
        print("[16 p50] sum over the 13: " + " | ".join(
            f"{k} {v:.3f} ms" for k, v in tot.items()) + f" {tag}",
            flush=True)
        # the "cuda" calibration entry of planner/cost_calibration.json
        work = []
        for name in names:
            plan = one.runner._lower_cached(
                one.planner.plan(ssb.QUERIES[name]).query, seg)
            rows = sum(seg.segments[i].meta.n_valid for i in plan.pruned_ids)
            work.append(rows * max(1, len(plan.columns)))
        x = np.asarray(work, np.float64)
        y = np.asarray([p50[("D=1", n)] * 1e6 for n in names])  # ns
        slope, intercept = np.polyfit(x, y, 1)
        scan = float(slope) if slope > 0 else float(np.median(y / x))
        hops = max(1, math.ceil(math.log2(D)))
        lat = max(0.0, float(np.median(
            [p50[("D=4 historicals", n)] - p50[("D=1", n)]
             for n in names])) * 1000 / hops)
        over = float(np.median([p50[("D=4 broker", n)]
                                / p50[("D=4 historicals", n)]
                                for n in names]))
        fit = {"scan_ns_per_row_col": round(scan, 6),
               "merge_ns_per_byte": round(1e9 / NVLINK4_BYTES_PER_S, 6),
               "collective_lat_us": round(lat, 3),
               "gspmd_overhead": round(over, 4),
               "fitted_shards": D, "fitted_queries": len(names),
               "note": (f"chip_smoke.py phase 16 on {card_name(tag)}: "
                        f"scan = slope of the 13's D=1 p50 over rows x "
                        f"columns (intercept {intercept / 1e6:.3f} ms); "
                        f"collective_lat_us = median (D={D} historicals - "
                        f"D=1) p50 per merge step, the {D} devices sharing "
                        f"one card; gspmd_overhead = median D={D} broker / "
                        f"historicals p50; merge_ns_per_byte from the H100 "
                        f"datasheet (NVLink 4, 450 GB/s a direction), not "
                        f"measured: one card has no second device to copy "
                        f"to")}
        print(f"[16 calibration] {json.dumps({'cuda': fit})}", flush=True)

        # (b) the sparse group-by: x4 under exchange and gather
        x4 = ssb.DISTINCT_QUERIES["x4"]
        want = one.sql(x4)
        for merge in ("exchange", "gather"):
            mesh.config.sparse_merge = merge
            t = time.perf_counter()
            g = mesh.sql(x4)
            ms = (time.perf_counter() - t) * 1000
            m = mesh.runner.last_metrics
            if m.get("route") != "sparse" or m.get("num_shards") != D or \
                    m.get("sparse_merge") != (
                        "exchange" if merge == "exchange" else None):
                fail(f"16 x4 {merge}: route {m.get('route')}, shards "
                     f"{m.get('num_shards')}, merge {m.get('sparse_merge')}")
            same(g, want, f"x4 {merge}")
            print(f"[16 sparse] x4 under {merge}: == D=1 exactly; groups "
                  f"{m.get('result_groups')}, local cap "
                  f"{m.get('result_cap')}, re-runs {m.get('sparse_reruns')}"
                  + (f", largest owner table {m.get('result_cap_owner')}"
                     if merge == "exchange" else "")
                  + f", copies {m.get('host_copies')}, first run "
                  f"{ms:.1f} ms {tag}", flush=True)

        # (c) tier 1: phase 12 (a)'s q2.1 sliding window
        steps = tier1_statements(ssb)["q2.1"]
        off = [one.sql(q) for q in steps]   # caches off: the reference
        t1 = engine(num_shards=D, segment_cache_enabled=True,
                    segment_cache_min_rows=0)
        seg_calls, real_seg = [], fr.fused_reduce_seg

        def record_seg(*a):
            seg_calls.append(a)
            return real_seg(*a)
        fr.fused_reduce_seg = record_seg
        fr.seg_launches = fr.launches = 0
        lines, widths = [], set()
        try:
            for i, q in enumerate(steps):
                before, n_k = fr.seg_launches, len(cuda_build._kernels)
                g = t1.sql(q)
                m = dict(t1.runner.last_metrics)
                n_launch = fr.seg_launches - before
                compiles = len(cuda_build._kernels) - n_k
                W = m.get("segments_window_per_chip")
                same(g, off[i], f"tier 1 step {i}")
                if n_launch != D or m.get("route") != "segment_cache" \
                        or (W in widths and compiles):
                    fail(f"16 tier 1 step {i}: {n_launch} segment-extended "
                         f"launches (want {D}), route {m.get('route')}, "
                         f"{compiles} compiles at a local width {W} seen "
                         f"before")
                widths.add(W)
                lines.append(f"step {i}: computed {m['segments_computed']}, "
                             f"cached {m['segments_cached']}, local window "
                             f"{W}, {n_launch} launches, {compiles} NVRTC "
                             f"compiles, copies {m['host_copies']}")
            torch.cuda.synchronize()
            seg_total, b1_in_t1 = fr.seg_launches, fr.launches
        finally:
            fr.fused_reduce_seg = real_seg
        if b1_in_t1:
            fail(f"16 tier 1: {b1_in_t1} plain B1 launches")
        seg_err = 0
        for i, a in enumerate(seg_calls):
            prog, inputs, valid, seg_mask, K, lo, W = a
            gk = fr.fused_reduce_seg(*a)
            wk = fr.fused_reduce_ref(prog, inputs, valid, seg_mask, K,
                                     (lo, W))
            torch.cuda.synchronize()
            e = max_abs_diff(gk, wk)
            if e:
                fail(f"16 tier 1 call {i}: max |kernel - plain| = {e}")
            seg_err = max(seg_err, e)
        print(f"[16 tier1] q2.1 sliding a year, three steps, each == caches "
              f"off exactly: {'; '.join(lines)}; {seg_total} "
              f"segment-extended launches in all, replayed against the "
              f"plain version: max |kernel - plain| = {seg_err} {tag}",
              flush=True)

        # (d) the 13 as one batch: the multi-leg kernel per device
        mesh.config.force_strategy = None
        with MultiRecorder() as rec:
            fr.launches = fr.multi_launches = 0
            t = time.perf_counter()
            out = mesh.sql_batch([ssb.QUERIES[n] for n in names])
            torch.cuda.synchronize()
            first = (time.perf_counter() - t) * 1000
            b1, multi = fr.launches, fr.multi_launches
        stmts = mesh.runner.last_metrics["statements"]
        groups, singles, want_b1, want_multi = batch_layout(stmts, names)
        for name, f, m in zip(names, out, stmts):
            same(f, frames[name], f"batch {name}")
            if m.get("route") == "batch" and m.get("host_copies") != D:
                fail(f"16 batch {name}: {m.get('host_copies')} copies for "
                     f"its group (want {D})")
        if not groups or multi != D * want_multi or b1 != D * want_b1:
            fail(f"16 batch: groups {groups}, singles {singles}: multi-leg "
                 f"launches {multi} (want {D * want_multi}), B1 {b1} (want "
                 f"{D * want_b1})")
        multi_err = max(check_multi(fr, a, f"16 batch call {i}")[0]
                        for i, a in enumerate(rec.calls))
        print(f"[16 batch] the 13 as one sql_batch: fused groups "
              f"{json.dumps(groups)}, single legs {singles}; multi-leg "
              f"launches {multi} ({D} per fused group), B1 {b1} ({D} per "
              f"single leg), {D} copies per group, every answer == phase "
              f"4's exactly; replayed: max |kernel - plain| = {multi_err}; "
              f"first run {first:.1f} ms {tag}", flush=True)

        # (e) scans, pages and searches: the row mask per device
        def page(e, off):
            return e.select_page("lineorder", columns=("c_city", "s_city"),
                                 page_size=100, offset=off)
        scans = [("scan A", lambda e: e.sql(SCAN_A), D),
                 ("scan B", lambda e: e.sql(SCAN_B), D),
                 ("scan C", lambda e: e.sql(SCAN_C), D),
                 *[(f"select page {i + 1}", lambda e, o=o: page(e, o), D)
                   for i, o in enumerate((0, 100, 200))],
                 ("search verb", lambda e: e.sql(SEARCH_VERB), D),
                 ("search IN c_city, s_city",
                  lambda e: e.execute_ir(SEARCH_CITIES), D),
                 ("search d_year, c_region",
                  lambda e: e.execute_ir(SEARCH_NUMERIC), D)]
        mask_calls, real_mask = [], rm.row_mask

        def record_mask(*a):
            mask_calls.append(a)
            return real_mask(*a)
        rm.row_mask = record_mask
        rm.launches = 0
        counts = {}
        try:
            for name, fn, want_n in scans:
                before = rm.launches
                g = fn(mesh)
                n = rm.launches - before
                m = mesh.runner.last_metrics
                w = fn(one)
                if isinstance(g, pd.DataFrame):
                    same(g, w, name)
                elif isinstance(g, tuple):
                    if g != w:
                        fail(f"16 {name}: the mesh's page differs")
                elif g.rows != w.rows or g.druid != w.druid:
                    fail(f"16 {name}: the mesh's result differs")
                if n != want_n or not m.get("mask_kernel") \
                        or m.get("num_shards") != D:
                    fail(f"16 {name}: {n} row-mask launches (want {want_n}),"
                         f" mask kernel {m.get('mask_kernel')}, shards "
                         f"{m.get('num_shards')}")
                counts[name] = (n, m.get("host_copies"))
            torch.cuda.synchronize()
            mask_total = rm.launches
        finally:
            rm.row_mask = real_mask
        mask_err = 0
        for i, a in enumerate(mask_calls):
            gk, wk = rm.row_mask(*a), rm.row_mask_ref(*a)
            torch.cuda.synchronize()
            mask_err = max(mask_err, int((gk != wk).any()))
            if mask_err:
                fail(f"16 mask call {i}: the kernel differs from the plain "
                     f"version")
        print(f"[16 scan] scans, pages and searches == the D=1 engine's "
              f"exactly (rows in logical segment order); (row-mask "
              f"launches, copies) per statement {json.dumps(counts)}; "
              f"{mask_total} launches in all, replayed against the plain "
              f"version: max |kernel - plain| = {mask_err} {tag}",
              flush=True)

        # (f) degradation: a dispatch failure halves the mesh
        def inject(stage, attempt):
            if attempt == 0:
                raise RuntimeError("injected device failure")
        deg = engine(num_shards=D, dispatch_retries=1,
                     degrade_shards_on_retry=True, fault_injector=inject)
        g = deg.sql(ssb.QUERIES["q2.1"])
        m = deg.runner.last_metrics
        if m.get("degraded_shards") != D // 2 or \
                m.get("num_shards") != D // 2 or m.get("retries") != 1:
            fail(f"16 degradation: degraded to {m.get('degraded_shards')}, "
                 f"ran on {m.get('num_shards')}, retries {m.get('retries')}")
        same(g, frames["q2.1"], "degraded q2.1")
        print(f"[16 degrade] q2.1 with a failed first dispatch: {D} -> "
              f"{m['num_shards']} devices, == phase 4's exactly; retry "
              f"error {m.get('retry_errors')} {tag}", flush=True)

        # (g) sys.devices: one row per device, bytes summing to the ledger
        dev = mesh.sql("SELECT * FROM sys.devices")
        ledger = mesh.runner._ledger
        alloc = torch.cuda.memory_allocated()
        if len(dev) != D or int(dev.hbm_bytes.sum()) != ledger.bytes_in_use \
                or ledger.bytes_in_use > alloc:
            fail(f"16 sys.devices: {len(dev)} rows, hbm_bytes sum "
                 f"{int(dev.hbm_bytes.sum())} vs ledger "
                 f"{ledger.bytes_in_use}, memory_allocated {alloc}")
        print(f"[16 devices] sys.devices: {len(dev)} rows, segments "
              f"{dev.segments.tolist()}, dispatches "
              f"{dev.dispatches.tolist()}, hbm_bytes "
              f"{dev.hbm_bytes.tolist()} (sum == the ledger's "
              f"{ledger.bytes_in_use} <= memory_allocated {alloc}) {tag}",
              flush=True)
    finally:
        for e in engines:
            e.close()
        force_virtual_devices(0)
    return row, fit, tot


# -- phase 17: the mesh across processes -------------------------------------

MH_WORLD, MH_LOCAL = 2, 2              # ranks, logical devices per rank
MH_REPS = 3                            # timed runs after each first run
MH_TIER1 = "multi-host mesh (remote shards not addressable)"
MH_BATCH = "multi-host mesh legs run alone"


def multihost_phase(seg, tables, frames, mesh_p50, workdir, tag,
                    device="cuda"):
    """Phase 17: MH_WORLD ranks of MH_LOCAL logical devices each on the
    one card (global D = 4, as phase 16), spawned by tpu_olap_torch.
    bench.multihost over gloo, each on the SF1 segments (handed over in
    a file in `workdir`). Every rank runs the 13, x4, scan A, a coded
    search, the 13 as one batch, q2.1 with tier 1 on, and sys.devices.
    Each rank's answers must equal phase 4's (the 13) or a one-device
    engine's, rank 0's rank 1's exactly; each aggregate launches B1 once
    per local device and merges by one collective. With two cards or
    more it runs again over NCCL, one card per rank."""
    import functools

    import pandas as pd
    import torch
    from tpu_olap_torch.bench import multihost, ssb
    from tpu_olap_torch.bench.parity import assert_frame_parity
    names = list(ssb.QUERIES)
    x4 = ssb.DISTINCT_QUERIES["x4"]
    q21 = ssb.QUERIES["q2.1"]
    t_phase = time.perf_counter()

    # the one-device references of what phase 4 did not run
    one = ssb_engine(seg, tables)
    try:
        want = {"x4": one.sql(x4), "scan A": one.sql(SCAN_A),
                "search": one.sql(SEARCH_VERB)}
    finally:
        one.close()
    want.update(frames)
    path = os.path.join(workdir, "tables.pkl")
    t = time.perf_counter()
    multihost.write_tables(path, [
        ("lineorder", None, {"time_column": ssb.TIME_COL,
                             "star_schema": ssb.star_schema(),
                             "segments": seg}),
        *[(n, tables[n], {"accelerate": False})
          for n in ("date", "customer", "supplier", "part")]])
    write_s = time.perf_counter() - t
    statements = ([(n, ssb.QUERIES[n]) for n in names]
                  + [("x4", x4), ("scan A", SCAN_A), ("search", SEARCH_VERB),
                     ("batch", [ssb.QUERIES[n] for n in names]),
                     ("tier1 q2.1", q21, {"segment_cache_enabled": True,
                                          "segment_cache_min_rows": 0}),
                     ("devices", "SELECT * FROM sys.devices")])
    D = MH_WORLD * MH_LOCAL
    cards = torch.cuda.device_count() if device == "cuda" else 0
    backends = ["gloo"] + (["nccl"] if cards >= 2 else [])
    for backend in backends:
        t = time.perf_counter()
        ranks = multihost.run(
            MH_WORLD, MH_LOCAL, backend, device,
            functools.partial(multihost.file_engine, path=path,
                              cube_auto_refresh=False),
            statements, os.path.join(workdir, backend), repeats=MH_REPS,
            timeout_s=300)
        wall = time.perf_counter() - t
        for rec in ranks:
            r = rec["rank"]
            if not rec["is_multihost"] or rec["mesh"]["size"] != D \
                    or rec["imports_jax"]:
                fail(f"17 {backend} rank {r}: mesh {rec['mesh']}, imports "
                     f"JAX {rec['imports_jax']}")
            for label in [*names, "x4", "scan A", "search"]:
                try:
                    assert_frame_parity(rec["frames"][label], want[label],
                                        label=label)
                except AssertionError as e:
                    fail(f"17 {backend} rank {r} {label}: differs from the "
                         f"one-device answer: {e}")
            for name, got in zip(names, rec["frames"]["batch"]):
                try:
                    assert_frame_parity(got, want[name], label=name)
                except AssertionError as e:
                    fail(f"17 {backend} rank {r} batch {name}: {e}")
            for name in names:
                c, m = rec["counts"][name], rec["metrics"][name]
                if c["b1"] != MH_LOCAL or c["collectives"] != 1 \
                        or m.get("merge") != "collective" \
                        or m.get("strategy") != "broker":
                    fail(f"17 {backend} rank {r} {name}: B1 launches "
                         f"{c['b1']} (want {MH_LOCAL}), collectives "
                         f"{c['collectives']} (want 1), merge "
                         f"{m.get('merge')}, strategy {m.get('strategy')}")
            for label in ("scan A", "search"):
                if rec["counts"][label]["mask"] != MH_LOCAL:
                    fail(f"17 {backend} rank {r} {label}: row-mask launches "
                         f"{rec['counts'][label]['mask']} (want {MH_LOCAL})")
            cb = rec["counts"]["batch"]
            if cb["multi"] or cb["b1"] != MH_LOCAL * len(names) or \
                    rec["batch_reasons"]["batch"] != [MH_BATCH] * len(names):
                fail(f"17 {backend} rank {r} batch: multi-leg launches "
                     f"{cb['multi']}, B1 {cb['b1']}, reasons "
                     f"{set(rec['batch_reasons']['batch'])}")
            m1 = rec["metrics"]["tier1 q2.1"]
            if m1.get("segment_cache") != f"bypass: {MH_TIER1}" or \
                    rec["counts"]["tier1 q2.1"]["seg"]:
                fail(f"17 {backend} rank {r} tier 1: {m1.get('segment_cache')}"
                     f", segment-extended launches "
                     f"{rec['counts']['tier1 q2.1']['seg']}")
            dev = rec["frames"]["devices"]
            if list(dev.process) != [g // MH_LOCAL for g in range(D)]:
                fail(f"17 {backend} rank {r} sys.devices: process "
                     f"{list(dev.process)}")
        a, b = ranks
        for label in [*names, "x4", "scan A", "search"]:
            try:
                pd.testing.assert_frame_equal(a["frames"][label],
                                              b["frames"][label],
                                              check_exact=True)
            except AssertionError as e:
                fail(f"17 {backend} {label}: rank 0 != rank 1: {e}")
        for x, y in zip(a["frames"]["batch"], b["frames"]["batch"]):
            pd.testing.assert_frame_equal(x, y, check_exact=True)
        dense = {n: a["metrics"][n]["collective_bytes"] for n in names}
        print(f"[17 multihost] {backend}: world {MH_WORLD}, global D = {D} "
              f"({MH_LOCAL} logical devices per rank: rank 0 "
              f"{a['mesh']['devices']}, rank 1 {b['mesh']['devices']}); "
              f"segments handed over in a file ({write_s:.1f} s to write), "
              f"rank build {a['build_s']:.1f} / {b['build_s']:.1f} s; "
              f"{wall:.1f} s in all {tag}", flush=True)
        print(f"[17 multihost] {backend}: every rank's 13, x4, scan A, search"
              f" and batch == the one-device answers; rank 0 == rank 1 "
              f"exactly; B1 {MH_LOCAL} launches per aggregate per rank "
              f"({a['totals']['b1']} / {b['totals']['b1']} in all), row mask "
              f"{MH_LOCAL} per scan or search; one collective per aggregate, "
              f"bytes delivered per rank {json.dumps(dense)}; x4 "
              f"{a['counts']['x4']['collectives']} collectives "
              f"({a['counts']['x4']['collective_bytes']} B), scan A "
              f"{a['counts']['scan A']['collective_bytes']} B; all "
              f"collectives {a['totals']['collectives']} / "
              f"{b['totals']['collectives']} ({a['totals']['collective_bytes']}"
              f" / {b['totals']['collective_bytes']} B) {tag}", flush=True)
        print(f"[17 multihost] {backend}: batch of the 13: legs alone "
              f"('{MH_BATCH}'), multi-leg launches 0; tier 1: "
              f"'{a['metrics']['tier1 q2.1']['segment_cache']}'; sys.devices "
              f"process {list(a['frames']['devices'].process)} {tag}",
              flush=True)
        for name in names:
            print(f"[17 p50] {backend} {name}: rank 0 "
                  f"{a['p50_ms'][name]:.3f} ms | rank 1 "
                  f"{b['p50_ms'][name]:.3f} ms | first run rank 0 "
                  f"{a['first_ms'][name]:.1f} ms {tag}", flush=True)
        tot = [sum(rec["p50_ms"][n] for n in names) for rec in ranks]
        print(f"[17 p50] sum over the 13 at world {MH_WORLD} ({backend}, the "
              f"two ranks sharing the card): rank 0 {tot[0]:.3f} ms | rank 1"
              f" {tot[1]:.3f} ms | phase 16 one process D = 4: "
              + " | ".join(f"{k} {v:.3f} ms" for k, v in mesh_p50.items()
                           if k != "D=1")
              + f" | D=1 {mesh_p50.get('D=1', float('nan')):.3f} ms {tag}",
              flush=True)
    if "nccl" not in backends:
        print(f"[17 multihost] nccl: not run ({cards} card"
              f"{'' if cards == 1 else 's'}) {tag}", flush=True)
    print(f"[17 multihost] phase 17 took {time.perf_counter() - t_phase:.1f}"
          f" s", flush=True)


def card_name(tag: str) -> str:
    """The card's name and power limit out of a phase's tag."""
    return tag.strip("()")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=6_000_000,
                    help="SSB lineorder rows (SF1 = 6,000,000)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed runs per query after one warm-up (SF1 "
                         "phases; phases 9 and 10 take 3)")
    args = ap.parse_args()

    # -- 1. the card -------------------------------------------------------
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    import numpy as np
    # executor before kernels.fused_reduce: the order their import
    # cycle needs
    import tpu_olap_torch.executor  # noqa: F401
    from tpu_olap_torch.bench import ssb
    from tpu_olap_torch.bench.parity import assert_frame_parity
    from tpu_olap_torch.kernels import cuda_build
    from tpu_olap_torch.kernels import fused_reduce as fr

    kind = torch.cuda.get_device_name(0)
    card = smi_line()
    tag = f"({kind}, {card})"
    print(f"[1 card] {kind} | nvidia-smi: {card} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | devices "
          f"{torch.cuda.device_count()}", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    # every call of the wrapper is recorded by (phase, query): its inputs,
    # not copies, so it can be replayed against the plain version later
    calls, current = {}, [None]
    real = fr.fused_reduce

    def record(*a):
        calls.setdefault(current[0], a)
        return real(*a)

    print(f"[2 build] {cuda_build.nvrtc_version()} found; options "
          f"{' '.join(cuda_build.NVRTC_OPTIONS)}", flush=True)
    for f in list(cuda_build.BUILD.glob("gen-*")):
        f.unlink()  # compile every plan anew: compile ms are this run's
    tables = ssb.generate_tables(args.rows, seed=0)
    eng = new_engine()  # device "cuda", use_fused_reduce "auto"
    _, denorm = ssb.register_ssb(eng, tables=tables)
    seg = eng.catalog.get("lineorder").segments
    print(f"[2 ssb] generated and registered {seg.num_rows} rows in "
          f"{len(seg.segments)} segments in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    first_ms, plan_kernels, frames = {}, {}, {}

    def first_run(phase, name, q):
        """(ms, kernel, NVRTC compiles) of the query's first run."""
        current[0] = (phase, name)
        n_kernels = len(cuda_build._kernels)
        t = time.perf_counter()
        frames[(phase, name)] = eng.sql(q)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1000
        a = calls.get((phase, name))
        if a is None:
            fail(f"{name} ({phase}) made no fused-reduce call: "
                 f"{eng.runner.last_metrics.get('fused_reason')}")
        return (ms, fr.compiled(a[0], a[4], "cuda"),
                len(cuda_build._kernels) - n_kernels)

    fr.fused_reduce = record
    try:
        for name, q in ssb.QUERIES.items():
            first_ms[name], kern, n_new = first_run("first", name, q)
            shared = [n for n, k in plan_kernels.items() if k is kern]
            plan_kernels[name] = kern
            what = f"shares the kernel of {shared[0]}" if shared else \
                plan_report(kern)
            print(f"[2 plan] {name}: {what}; NVRTC compiles {n_new}; first "
                  f"run {first_ms[name]:.1f} ms (lower "
                  f"{eng.runner.last_metrics['lower_ms']:.1f} ms) {tag}",
                  flush=True)
        kernels = list({id(k): k for k in plan_kernels.values()}.values())
        spilled = [n for n, k in plan_kernels.items()
                   if k.report.get("spill_bytes", 0) > 0]
        print(f"[2 plan] 13 plans, {len(kernels)} kernels compiled in "
              f"{sum(k.compile_ms for k in kernels):.1f} ms of NVRTC; "
              f"plans that spill: {spilled or 'none'}", flush=True)
        # the queries with other literals: new plans of the same structure
        other_ms, other_compiles = {}, 0
        for name, q in ssb.QUERIES_OTHER_LITERALS.items():
            other_ms[name], kern, n_new = first_run("other", name, q)
            other_compiles += n_new
            same = kern is plan_kernels[name]
            print(f"[2 literals] {name} with other literals: first run "
                  f"{other_ms[name]:.1f} ms (lower "
                  f"{eng.runner.last_metrics['lower_ms']:.1f} ms) against "
                  f"{first_ms[name]:.1f} ms; NVRTC compiles {n_new}; "
                  + ("reuses the query's kernel" if same else
                     f"a kernel of its own: {plan_report(kern)}")
                  + f" {tag}", flush=True)
    finally:
        fr.fused_reduce = real
    print(f"[2 literals] 13 queries with other literals: {other_compiles} "
          f"NVRTC compiles, first runs {min(other_ms.values()):.1f}-"
          f"{max(other_ms.values()):.1f} ms (the queries' own first runs, "
          f"compile included: {min(first_ms.values()):.1f}-"
          f"{max(first_ms.values()):.1f} ms) {tag}", flush=True)
    print(f"[2 build] done in {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 3. kernels vs plain version ----------------------------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    max_err = 0
    for K in (1, 264, 6952, 65536):
        for mixed in (False, True):
            case = synthetic_case(args.rows, K, mixed, gen)
            err, _ = check_kernel(fr, case, f"K={K}")
            max_err = max(max_err, err)
            prog = case[0]
            kern = fr.compiled(prog, K, "cuda")
            path = "shared" if kern.smem_bytes else "global"
            print(f"[3 kernel] N={case[2].numel()} K={K} "
                  f"{'mixed' if mixed else 'ssb'} ({path} table, "
                  f"{len(prog.ins)} instructions; generated: "
                  f"{plan_report(kern)}): max |generated - plain| = "
                  f"{err}", flush=True)
    del case

    # -- 4. the main path --------------------------------------------------
    per_query, copies = {}, {}
    fr.fused_reduce = record
    fr.launches = 0
    try:
        for name, q in ssb.QUERIES.items():
            current[0] = name
            before = fr.launches
            frames[("auto", name)] = eng.sql(q)
            per_query[name] = fr.launches - before
            m = eng.runner.last_metrics
            if not m.get("fused"):
                fail(f"{name} did not take the fused reduce: "
                     f"{m.get('fused_reason')}")
            copies[name] = m["host_copies"]
            if m["route"] != "packed" or m["host_copies"] != 1:
                fail(f"{name} took the {m['route']} route with "
                     f"{m['host_copies']} device-to-host copies")
        torch.cuda.synchronize()
        launches = fr.launches
    finally:
        fr.fused_reduce = real
    missing = [n for n, c in per_query.items() if c < 1]
    if missing:
        fail(f"the generated kernel launched no time on {missing}")
    eng.config.use_fused_reduce = "never"
    before = fr.launches
    for name, q in ssb.QUERIES.items():
        frames[("never", name)] = eng.sql(q)
    if fr.launches != before:
        fail("the kernel launched under use_fused_reduce='never'")
    for name, q in ssb.QUERIES_OTHER_LITERALS.items():
        frames[("never other", name)] = eng.sql(q)
    for name in ssb.QUERIES:
        a, b = frames[("auto", name)], frames[("never", name)]
        if len(a) == 0:
            fail(f"{name} returned no rows")
        assert_frame_parity(a, b, label=name)
        assert_frame_parity(frames[("other", name)],
                            frames[("never other", name)],
                            label=f"{name} with other literals")
    # independent pandas reference for one ungrouped and one grouped query
    d = denorm
    m = (d.d_year == 1993) & d.lo_discount.between(1, 3) & \
        (d.lo_quantity < 25)
    ref11 = int((d.lo_extendedprice[m] * d.lo_discount[m]).sum())
    if int(frames[("auto", "q1.1")]["revenue"].iloc[0]) != ref11:
        fail(f"q1.1 {frames[('auto', 'q1.1')]['revenue'].iloc[0]} != "
             f"pandas {ref11}")
    m = (d.p_category == "MFGR#12") & (d.s_region == "AMERICA")
    ref21 = (d[m].groupby(["d_year", "p_brand1"], as_index=False)
             .lo_revenue.sum().rename(columns={"lo_revenue": "revenue"}))
    got21 = frames[("auto", "q2.1")][["d_year", "p_brand1", "revenue"]]
    assert_frame_parity(got21.astype({"d_year": np.int64}),
                        ref21[["d_year", "p_brand1", "revenue"]]
                        .astype({"d_year": np.int64}), label="q2.1/pandas")
    print(f"[4 ssb] 13/13 queries: fused == generic torch reduce, q1.1 and "
          f"q2.1 == pandas, the 13 with other literals == generic "
          f"torch reduce; generated-kernel launches per query "
          f"{json.dumps(per_query)} ({launches} in all); packed route, "
          f"device-to-host "
          f"copies per query {json.dumps(copies)}", flush=True)
    # replay each query's launch: generated kernel and plain version on
    # the same inputs
    shapes = {}
    main_calls = {k: a for k, a in calls.items() if isinstance(k, str)}
    other_err = max(check_kernel(fr, calls[("other", name)],
                                 f"{name} with other literals")[0]
                    for name in ssb.QUERIES)
    max_err = max(max_err, other_err)
    print(f"[4 replay] the 13 launches with other literals: max |generated "
          f"- plain| = {other_err}", flush=True)
    for name, a in main_calls.items():
        err, got = check_kernel(fr, a, name)
        max_err = max(max_err, err)
        prog = a[0]
        shapes[name] = (a, got[0])
        kern = fr.compiled(prog, a[4], "cuda")
        print(f"[4 replay] {name}: {len(prog.ins)} instructions "
              f"({prog.n_pro} immediates, then {prog.exit_pc - prog.n_pro} "
              f"per row before EXITZ), {len(prog.loaded_slots)} streams "
              f"read ({len(prog.cone_slots)} in the mask's cone), K={a[4]}, "
              f"{prog.n_cols} columns, grid {kern.last_grid} blocks: "
              f"max |generated - plain| = {err}", flush=True)

    # L2 overwritten before a launch timed cold (the bytes come from HBM,
    # as the bounds assume)
    l2 = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush_l2():
        l2.fill_(1)

    # -- 10. SSB at SF10 ----------------------------------------------------
    workdir = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        t = time.perf_counter()
        sf10_row, sf10_batch_row = sf10_phase(workdir, SF10_ROWS, 3, tag,
                                              flush_l2)
        print(f"[10 sf10] phase 10 took {time.perf_counter() - t:.1f} s",
              flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5. timings --------------------------------------------------------
    p50 = {}
    for mode in ("auto", "never"):
        eng.config.use_fused_reduce = mode
        for name, q in ssb.QUERIES.items():
            eng.sql(q)  # warm-up
            ts = []
            for _ in range(args.reps):
                t = time.perf_counter()
                eng.sql(q)
                ts.append((time.perf_counter() - t) * 1000)
            p50[(mode, name)] = float(np.median(ts))
    for name in ssb.QUERIES:
        print(f"[5 query] {name} p50 fused {p50[('auto', name)]:.3f} ms | "
              f"generic {p50[('never', name)]:.3f} ms | first run "
              f"(compile included) {first_ms[name]:.1f} ms {tag}",
              flush=True)

    # where the time goes: one more run per query, split by the runner's
    # own timers, then one under torch.profiler for the device's busy time
    eng.config.use_fused_reduce = "auto"
    for name, q in ssb.QUERIES.items():
        t = time.perf_counter()
        eng.sql(q)
        wall = (time.perf_counter() - t) * 1000
        m = eng.runner.last_metrics
        print(f"[5 breakdown] {name} wall {wall:.3f} ms | plan+render "
              f"{wall - m['total_ms']:.3f} | lower {m['lower_ms']:.3f} | "
              f"prepare {m['prepare_ms']:.3f} | execute (front half + "
              f"kernel + fetch) {m['execute_ms']:.3f} | finalize+assemble "
              f"{m['assemble_ms']:.3f} ms {tag}", flush=True)
    busy = device_busy({n: (lambda q=q: eng.sql(q))
                        for n, q in ssb.QUERIES.items()})
    print(f"[5 device] {busy} {tag}", flush=True)

    # the kernel at the main path's inputs, as recorded in phase 4, warm
    # and cold
    rows = [kernel_times(name, *shapes[name], max_err, launches, tag,
                         flush_l2) for name in AB_QUERIES]

    packed_phase(eng, args.reps, tag)
    distinct_phase(eng, denorm, args.reps, tag)

    resident = eng.runner.device_bytes()
    print(f"[5 memory] resident device bytes {resident}; "
          f"torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated()}"
          f" {tag}", flush=True)
    rows.append(scan_phase(eng, denorm, args.reps, tag, flush_l2))

    # -- 11. shared-scan batches --------------------------------------------
    t = time.perf_counter()
    rows.append(batch_phase(eng, args.reps, tag, flush_l2))
    print(f"[11 batch] phase 11 took {time.perf_counter() - t:.1f} s",
          flush=True)

    # -- 12. caches and cubes -----------------------------------------------
    t = time.perf_counter()
    rows.append(cache_phase(
        eng, tables, {n: frames[("auto", n)] for n in ssb.QUERIES},
        args.reps, tag, flush_l2))
    print(f"[12 cache] phase 12 took {time.perf_counter() - t:.1f} s",
          flush=True)

    # -- 13. real-time ingest ------------------------------------------------
    workdir = tempfile.mkdtemp(prefix="chip_smoke-ingest-")
    try:
        t = time.perf_counter()
        rows += ingest_phase(seg, tables, denorm,
                             {n: p50[("auto", n)] for n in ssb.QUERIES},
                             workdir, args.reps, tag, flush_l2)
        print(f"[13 ingest] phase 13 took {time.perf_counter() - t:.1f} s",
              flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 14. pipeline and deadline ------------------------------------------
    pipeline_phase(seg, tables, {n: frames[("auto", n)] for n in ssb.QUERIES},
                   args.reps, tag)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15. serving and observability --------------------------------------
    serving_phase(seg, tables, {n: frames[("auto", n)] for n in ssb.QUERIES},
                  tag)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 16. the mesh ---------------------------------------------------------
    t = time.perf_counter()
    mesh_row, _, mesh_p50 = mesh_phase(
        seg, tables, {n: frames[("auto", n)] for n in ssb.QUERIES}, tag,
        flush_l2)
    rows.append(mesh_row)
    print(f"[16 mesh] phase 16 took {time.perf_counter() - t:.1f} s",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 17. the mesh across processes ---------------------------------------
    workdir = tempfile.mkdtemp(prefix="chip_smoke-multihost-")
    try:
        multihost_phase(seg, tables,
                        {n: frames[("auto", n)] for n in ssb.QUERIES},
                        mesh_p50, workdir, tag)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    rows += [sf10_row, sf10_batch_row]

    # the SF1 engine's columns leave the card before phase 9
    eng.close()
    eng.clear_cache()
    del eng, denorm, tables, seg, frames, calls, main_calls, shapes
    gc.collect()
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        t = time.perf_counter()
        tpch_phase(workdir, 3, tag)
        print(f"[9 tpch] phase 9 took {time.perf_counter() - t:.1f} s",
              flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"kernels": [r for r in rows if r["at"] in (
        "q2.1", "q2.1 SF10", "scan A", "batch SF1", "batch SF10",
        "tier1 q2.1", "q2.1 ingest", "ingest tier1 q2.1", "q2.1 mesh")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

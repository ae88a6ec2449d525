"""Two-tier semantic result cache (the Druid caching hierarchy analog).

The reference system's hot path is Druid's cache stack: brokers answer
repeated queries from a full-result cache, historicals answer the
per-segment slices they already computed, and only the segments that
changed since the last ingest are recomputed. This module is that stack
for the in-process engine:

Tier 1 — per-segment partial aggregates (`SegmentCache`). Keyed by
  (table generation, segment id, query template minus intervals).  A
  cached entry holds the segment's UNFINALIZED partial-aggregate dict —
  exactly what `kernels.groupby.group_reduce` emits for one segment —
  so serving is a host-side `merge_partials` fold: sums/counts add,
  min/max reduce elementwise, HLL registers max-merge, theta tables
  re-merge EXACTLY (sketch merge is lossless).  A repeated aggregate
  over a moving time window recomputes only the uncached segments in
  one device pass (QueryRunner._run_seg_partials) and merges the rest
  from cache.  Entries are interval-independent by construction: only
  segments ENTIRELY covered by the query's intervals are stored (a
  straddling segment's partials depend on the row-level interval mask
  and always recompute), and bucketed layouts are re-anchored by bucket
  START TIMESTAMP at serve time (`_rebase`), so a day-granularity
  timeseries sliding its window re-uses yesterday's per-segment rows.
  Non-mergeable shapes bypass the tier (sparse group-by — its compact
  tables are capacity-dependent; scan/select/search — row sets, not
  partials; interval-dependent timeformat dimensions). On the card the
  uncached segments' partials come from one launch of the
  segment-extended fused reduce (kernels.fused_reduce.fused_reduce_seg;
  the generic reduce with the same extended key for sketch plans) and
  one copy back. Partials are CPU torch tensors throughout (fetched
  numpy arrays wrapped by torch.from_numpy), merged by the port's
  kernels.groupby.merge_partials. Under a mesh the uncached segments
  come from one segment-extended launch per device, and each entry is
  a cache shard of its segment's device (segment i on device i mod D).

Tier 2 — full results (`FullResultCache`). Keyed by (normalized query
  JSON including intervals, table generation).  A bounded LRU over the
  assembled rows/druid payloads with byte-budget eviction — the broker
  result cache: the BI-dashboard storm where eight users refresh the
  same panel costs one device pass.

Invalidation is generational: every `TableSegments` construction takes
the next per-table generation (segments/segment.py), so ingest and
re-registration orphan every cached entry for that table at key level —
a stale-generation entry can never be SERVED even before it is purged.
`invalidate_table` (called at registration) and `clear` (CLEAR DRUID
CACHE) purge eagerly so the byte gauges drop immediately.

Observability, as in the JAX package: hit/miss/bypass counters per tier
(`result_cache_requests_total{tier,result}`), eviction counters, byte and
entry gauges, `cache_invalidate` events, `snapshot()` (GET /debug/cache,
sys.caches) and the tier-1 census behind sys.devices and the HBM
ledger's `cache_pins` class (`shard_entries`, `shard_bytes`: the device
of an entry is its segment's under the interleaved placement).
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["ResultCache"]


def _approx_bytes(obj, _depth=0) -> int:
    """Cheap recursive payload-size estimate for byte-budget accounting.
    Long lists are sampled (first 64 entries extrapolated) so sizing a
    large Scan result never costs a full serialization pass."""
    if obj is None or isinstance(obj, (bool, int, float)):
        return 8
    if isinstance(obj, str):
        return 48 + len(obj)
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if _depth >= 6:
        return 64
    if isinstance(obj, dict):
        return 64 + sum(_approx_bytes(k, _depth + 1)
                        + _approx_bytes(v, _depth + 1)
                        for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        n = len(obj)
        if n == 0:
            return 56
        if n <= 64:
            return 56 + sum(_approx_bytes(x, _depth + 1) for x in obj)
        head = sum(_approx_bytes(x, _depth + 1) for x in obj[:64])
        return 56 + head * n // 64
    return 64


def _partials_bytes(partials: dict) -> int:
    return sum(v.numel() * v.element_size() for v in partials.values())


def _strip_intervals(qjson: dict) -> dict:
    """Top-level `intervals` removed: the one field of the query JSON a
    moving time window changes.  Filters keep every literal (a filter
    literal changes the partials, so it must fragment the key)."""
    return {k: v for k, v in qjson.items() if k != "intervals"}


def _config_sig(config) -> tuple:
    """The config knobs that change RESULT VALUES (not just execution
    strategy): dtype policy, sketch widths, granularity timezone.
    Anything else (pallas, batching, budgets that only reroute between
    numerically-equivalent paths) stays out so it cannot fragment the
    cache. The device is not among them: the card and the CPU give
    equal answers."""
    return (str(config.long_dtype), str(config.double_dtype),
            config.theta_k_cap, config.sparse_theta_k_cap,
            config.time_zone, config.skip_empty_buckets)


def _fill_value(name: str, plans_by_name: dict):
    """Identity fill for one partial array when re-anchoring a bucketed
    layout: additive state fills 0; min/max fill their fold identity;
    theta tables fill the EMPTY sentinel."""
    from tpu_olap_torch.kernels.groupby import _ident, torch_dtype
    from tpu_olap_torch.kernels.theta import EMPTY
    if name == "_rows" or name.startswith("_nn_"):
        return 0
    p = plans_by_name.get(name)
    if p is None:
        return 0
    if p.kind in ("min", "max"):
        return _ident(torch_dtype(p.acc_dtype), p.kind)
    if p.kind == "theta":
        return EMPTY
    return 0  # count/sum/hll: additive / max-merge from zero


class _SegmentEntry:
    __slots__ = ("partials", "n_buckets", "starts", "dim_sizes",
                 "bucket_kind", "nbytes", "table")

    def __init__(self, partials, plan, table_name):
        # copies, not views: a view would pin the whole [W*K] dispatch
        # buffer it was sliced from for the life of the cache entry
        self.partials = {k: v.clone(memory_format=torch.contiguous_format)
                         for k, v in partials.items()}
        bp = plan.bucket_plan
        self.n_buckets = plan.sizes[0] if plan.sizes else 1
        self.starts = np.asarray(bp.starts, np.int64).copy()
        self.dim_sizes = tuple(plan.sizes[1:])
        self.bucket_kind = bp.kind
        self.nbytes = _partials_bytes(self.partials) + 256
        self.table = table_name


class ResultCache:
    """Both tiers behind one lock, owned by QueryRunner.

    Thread-safety matches the runner's other caches: every mutation is
    a few dict ops under `_lock`, and cached tensors are immutable by
    convention (consumers merge/finalize into fresh tensors)."""

    def __init__(self, config, metrics=None, events=None):
        self.config = config
        self.events = events
        self._lock = threading.Lock()
        self._full: OrderedDict = OrderedDict()   # key -> (rows, druid, meta)
        self._seg: OrderedDict = OrderedDict()    # key -> _SegmentEntry
        self._full_bytes = 0
        self._seg_bytes = 0
        self.stats = {"full": {"hit": 0, "miss": 0, "bypass": 0,
                               "evict": 0},
                      "segment": {"hit": 0, "miss": 0, "bypass": 0,
                                  "evict": 0}}
        self._m_req = self._m_evict = None
        self._m_bytes = self._m_entries = None
        if metrics is not None:
            self._m_req = metrics.counter(
                "result_cache_requests_total",
                "Semantic result-cache lookups by tier and outcome "
                "(tier=full is per query, tier=segment is per segment "
                "consulted; bypass counts ineligible queries).",
                ("tier", "result"))
            self._m_evict = metrics.counter(
                "result_cache_evictions_total",
                "Byte-budget LRU evictions from the result caches.",
                ("tier",))
            self._m_bytes = metrics.gauge(
                "result_cache_bytes",
                "Bytes resident in the result caches.", ("tier",))
            self._m_entries = metrics.gauge(
                "result_cache_entries",
                "Entries resident in the result caches.", ("tier",))

    # ------------------------------------------------------------ enables

    @property
    def full_enabled(self) -> bool:
        return bool(self.config.result_cache_enabled)

    @property
    def seg_enabled(self) -> bool:
        return bool(self.config.segment_cache_enabled)

    # ------------------------------------------------------------- common

    def _count(self, tier: str, result: str, n: int = 1):
        if not n:
            return
        # under the lock: tier-2 lookups run BEFORE the dispatch lock by
        # design, so concurrent callers would otherwise lose increments
        # and /debug/cache would drift from the (locked) /metrics
        # counters. Callers never hold self._lock here.
        with self._lock:
            self.stats[tier][result] += n
        if self._m_req is not None:
            self._m_req.inc(n, tier=tier, result=result)

    def _refresh_gauges(self):
        if self._m_bytes is None:
            return
        self._m_bytes.set(self._full_bytes, tier="full")
        self._m_bytes.set(self._seg_bytes, tier="segment")
        self._m_entries.set(len(self._full), tier="full")
        self._m_entries.set(len(self._seg), tier="segment")

    def _evict_over_budget_locked(self, tier: str):
        """Oldest-first (LRU — hits move-to-end) until under budget."""
        if tier == "full":
            store, budget = self._full, self.config.result_cache_max_bytes
        else:
            store, budget = self._seg, self.config.segment_cache_max_bytes
        n = 0
        while store and self._bytes(tier) > max(0, int(budget)):
            _, victim = store.popitem(last=False)
            self._drop_bytes(tier, victim)
            n += 1
        if n:
            self.stats[tier]["evict"] += n
            if self._m_evict is not None:
                self._m_evict.inc(n, tier=tier)

    def _bytes(self, tier: str) -> int:
        return self._full_bytes if tier == "full" else self._seg_bytes

    def _drop_bytes(self, tier: str, victim):
        if tier == "full":
            self._full_bytes -= victim[2]["nbytes"]
        else:
            self._seg_bytes -= victim.nbytes

    # ------------------------------------------------------ tier 2 (full)

    def _full_key(self, query, table) -> tuple:
        return (table.name, table.generation,
                json.dumps(query.to_json(), sort_keys=True, default=str),
                _config_sig(self.config))

    def get_full(self, query, table):
        """(rows, druid, meta) or None.  Counts the hit/miss."""
        key = self._full_key(query, table)
        with self._lock:
            hit = self._full.get(key)
            if hit is not None:
                try:
                    self._full.move_to_end(key)
                except KeyError:
                    pass
        self._count("full", "hit" if hit is not None else "miss")
        return hit

    def put_full(self, query, table, rows, druid, meta: dict):
        key = self._full_key(query, table)
        meta = dict(meta)
        meta["nbytes"] = nbytes = (_approx_bytes(rows)
                                   + _approx_bytes(druid) + 512)
        if nbytes > max(0, int(self.config.result_cache_max_bytes)):
            return  # larger than the whole budget: never admit
        with self._lock:
            old = self._full.pop(key, None)
            if old is not None:
                self._full_bytes -= old[2]["nbytes"]
            self._full[key] = (rows, druid, meta)
            self._full_bytes += nbytes
            self._evict_over_budget_locked("full")
            self._refresh_gauges()

    # --------------------------------------------------- tier 1 (segment)

    def tier1_bypass_reason(self, plan, mesh=None) -> str | None:
        """None when the per-segment tier can serve this plan, else why
        not — surfaced in the metrics (`segment_cache`). A mesh is
        served too: its per-(device, segment) partials come back per
        device and merge at the broker (QueryRunner.
        _run_seg_partials_mesh); the budgets below use the padded segment
        count that launch covers. A mesh across processes is refused
        with the JAX package's reason."""
        if plan.kind != "agg":
            return "not an aggregation plan"
        if plan.sparse or plan.kernel is None:
            return "sparse group-by partials are capacity-dependent"
        if plan.empty or not plan.pruned_ids:
            return "no scanned segments"
        if any(dp.kind == "timeformat" for dp in plan.dim_plans):
            return "timeformat dimension layout is interval-dependent"
        n_seg = len(plan.table.segments)
        if mesh is not None:
            from tpu_olap_torch.executor.sharding import (is_multihost,
                                                         pad_segments)
            if is_multihost(mesh):
                return "multi-host mesh (remote shards not addressable)"
            n_seg = pad_segments(max(n_seg, 1), mesh.size)
        from tpu_olap_torch.kernels.groupby import partials_radix
        radix = partials_radix(plan.agg_plans)
        state = n_seg * plan.total_groups * radix
        if state > self.config.segment_cache_state_budget:
            return (f"per-segment state {n_seg}x{plan.total_groups}"
                    f"x{radix} exceeds segment_cache_state_budget")
        if n_seg * plan.total_groups >= (1 << 31):
            # the fused reduce's and the generic reduce's keys are int32
            return "per-segment key space overflows int32"
        return None

    def template_key(self, query, table) -> tuple:
        """The 'plan fingerprint minus interval': full query JSON with
        the top-level intervals stripped (filter/dim/agg literals all
        kept), plus the result-affecting config signature."""
        return (table.name,
                json.dumps(_strip_intervals(query.to_json()),
                           sort_keys=True, default=str),
                _config_sig(self.config))

    def get_segments(self, tkey, table, plan, seg_ids) -> dict:
        """{segment id: partials} for the cached subset of `seg_ids`,
        re-anchored to this plan's bucket layout.  Counts one hit/miss
        per segment consulted.  Keys carry each segment's SCOPE
        generation (segments/segment.py): sealed segments share the
        sealed generation, so their partials survive delta-only
        appends — the overall generation only re-keys them when the
        sealed set itself changes (registration, compaction)."""
        out = {}
        for sid in seg_ids:
            key = (tkey, table.segment_cache_token(sid), sid)
            with self._lock:
                e = self._seg.get(key)
                if e is not None:
                    try:
                        self._seg.move_to_end(key)
                    except KeyError:
                        pass
            if e is not None:
                served = self._serve_entry(e, plan,
                                           table.segments[sid].meta)
                if served is not None:
                    out[sid] = served
                    continue
            self._count("segment", "miss")
        self._count("segment", "hit", len(out))
        return out

    def put_segment(self, tkey, table, plan, sid, partials):
        entry = _SegmentEntry(partials, plan, table.name)
        key = (tkey, table.segment_cache_token(sid), sid)
        with self._lock:
            old = self._seg.pop(key, None)
            if old is not None:
                self._seg_bytes -= old.nbytes
            if entry.nbytes > max(
                    0, int(self.config.segment_cache_max_bytes)):
                self._refresh_gauges()
                return
            self._seg[key] = entry
            self._seg_bytes += entry.nbytes
            self._evict_over_budget_locked("segment")
            self._refresh_gauges()

    def _serve_entry(self, e: _SegmentEntry, plan, seg_meta):
        """Entry partials in THIS plan's group layout, or None when the
        layouts cannot be reconciled (then the segment recomputes).
        Dimension radixes must match exactly (they depend only on
        filter+dictionary, both in the key — a mismatch is defensive).
        Bucket layouts re-anchor by start timestamp: granularity `all`
        is layout-free; otherwise every bucket the segment's time range
        touches must exist in the new grid at the searchsorted position
        (true whenever the sliding window keeps the same granularity —
        the grids are phase-aligned — and false otherwise, which safely
        degrades to a recompute)."""
        n_new = plan.sizes[0] if plan.sizes else 1
        if e.dim_sizes != tuple(plan.sizes[1:]):
            return None
        if e.bucket_kind == "all" and plan.bucket_plan.kind == "all":
            return e.partials
        if e.n_buckets == n_new and np.array_equal(
                e.starts, np.asarray(plan.bucket_plan.starts, np.int64)):
            return e.partials
        return self._rebase(e, plan, seg_meta, n_new)

    def _rebase(self, e: _SegmentEntry, plan, seg_meta, n_new: int):
        new_starts = np.asarray(plan.bucket_plan.starts, np.int64)
        pos = np.searchsorted(new_starts, e.starts)
        pos_c = np.minimum(pos, n_new - 1)
        ok = new_starts[pos_c] == e.starts
        # old buckets the segment's rows can occupy
        b_lo = int(np.searchsorted(e.starts, seg_meta.time_min,
                                   side="right")) - 1
        b_hi = int(np.searchsorted(e.starts, seg_meta.time_max,
                                   side="right")) - 1
        b_lo, b_hi = max(b_lo, 0), min(b_hi, e.n_buckets - 1)
        if b_lo > b_hi or not ok[b_lo:b_hi + 1].all():
            return None
        d = 1
        for s in e.dim_sizes:
            d *= s
        plans_by_name = {p.name: p for p in plan.agg_plans}
        dst = torch.from_numpy(pos_c[ok])
        src = torch.from_numpy(np.nonzero(ok)[0])
        out = {}
        for name, arr in e.partials.items():
            tail = tuple(arr.shape[1:])
            a = arr.reshape((e.n_buckets, d) + tail)
            new = torch.full((n_new, d) + tail,
                             _fill_value(name, plans_by_name),
                             dtype=arr.dtype)
            new[dst] = a[src]
            out[name] = new.reshape((n_new * d,) + tail)
        return out

    # -------------------------------------------------------------- admin

    def cached_segments(self) -> set:
        """{(table, segment_id)} pairs with at least one live tier-1
        partial entry — the `cache_pinned` column of sys.segments
        (catalog.systables). Key layout: (tkey, token, sid) with tkey
        leading with the table name."""
        with self._lock:
            return {(k[0][0], k[2]) for k in self._seg}

    def shard_entries(self, num_shards: int) -> dict:
        """{chip index: live tier-1 entries}, the chip of segment sid
        being sid mod num_shards (the interleaved placement) — the
        census behind sys.devices and GET /debug/devices."""
        d = max(1, int(num_shards))
        out: dict = {}
        with self._lock:
            for k in self._seg:
                c = int(k[2]) % d
                out[c] = out.get(c, 0) + 1
        return out

    def shard_bytes(self, num_shards: int) -> dict:
        """{chip index: live tier-1 entry bytes}, as shard_entries — the
        `cache_pins` class the HbmLedger folds into its breakdown."""
        d = max(1, int(num_shards))
        out: dict = {}
        with self._lock:
            for k, e in self._seg.items():
                c = int(k[2]) % d
                out[c] = out.get(c, 0) + int(e.nbytes)
        return out

    def count_bypass(self, tier: str = "segment"):
        self._count(tier, "bypass")

    def clear(self, table: str | None = None,
              tiers: tuple = ("full", "segment")) -> dict:
        """Purge the given tiers (optionally one table's entries).
        Returns {tier: purged count} for the cache_clear event."""
        purged = {"full": 0, "segment": 0}
        with self._lock:
            if table is None:
                purged["full"], purged["segment"] = \
                    len(self._full), len(self._seg)
                self._full.clear()
                self._seg.clear()
                self._full_bytes = self._seg_bytes = 0
            else:
                if "full" in tiers:
                    for key in [k for k in list(self._full)
                                if k[0] == table]:
                        v = self._full.pop(key, None)
                        if v is not None:
                            self._full_bytes -= v[2]["nbytes"]
                            purged["full"] += 1
                if "segment" in tiers:
                    for key in [k for k in list(self._seg)
                                if k[0][0] == table]:
                        v = self._seg.pop(key, None)
                        if v is not None:
                            self._seg_bytes -= v.nbytes
                            purged["segment"] += 1
            self._refresh_gauges()
        return purged

    def invalidate_table(self, table: str):
        """Eager purge at ingest/DROP.  Correctness never depends on it
        (keys carry the generation), but the byte budget should not stay
        occupied by unreachable entries."""
        purged = self.clear(table)
        if self.events is not None and (purged["full"]
                                        or purged["segment"]):
            self.events.emit("cache_invalidate", table=table, **purged)
        return purged

    def invalidate_compacted(self, table: str, live_tokens: set):
        """Compaction swap: tier-2 purges fully (the overall generation
        moved, every full result is stale), but tier-1 keeps entries
        whose segment token is still LIVE — untouched partitions carry
        their Segment uid through the incremental rebuild
        (segments/delta.py), so only the delta-touched partitions'
        entries drop: under a mesh, only the cache shards of the devices
        that hold those segments."""
        purged = self.clear(table, tiers=("full",))
        with self._lock:
            dead = [k for k in list(self._seg)
                    if k[0][0] == table and k[1] not in live_tokens]
            for k in dead:
                v = self._seg.pop(k, None)
                if v is not None:
                    self._seg_bytes -= v.nbytes
            purged["segment"] = len(dead)
            self._refresh_gauges()
        if self.events is not None and (purged["full"]
                                        or purged["segment"]):
            self.events.emit("cache_invalidate", table=table,
                             scope="compacted", **purged)
        return purged

    def invalidate_full(self, table: str):
        """Tier-2-only purge for delta-only appends (docs/INGEST.md):
        full results cover the delta so they are stale (and already
        unreachable — the overall generation moved), but per-SEALED-
        segment partials stay servable and must survive."""
        purged = self.clear(table, tiers=("full",))
        if self.events is not None and purged["full"]:
            self.events.emit("cache_invalidate", table=table,
                             scope="full", **purged)
        return purged

    def snapshot(self) -> dict:
        """GET /debug/cache payload: both tiers' entries, bytes, budgets
        and counts."""
        with self._lock:
            return {
                "enabled": {"full": self.full_enabled,
                            "segment": self.seg_enabled},
                "full": {
                    "entries": len(self._full),
                    "bytes": self._full_bytes,
                    "budget_bytes": int(self.config.result_cache_max_bytes),
                    **dict(self.stats["full"]),
                },
                "segment": {
                    "entries": len(self._seg),
                    "bytes": self._seg_bytes,
                    "budget_bytes": int(
                        self.config.segment_cache_max_bytes),
                    "min_rows": int(self.config.segment_cache_min_rows),
                    **dict(self.stats["segment"]),
                },
            }

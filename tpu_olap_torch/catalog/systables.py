"""`sys.*` virtual datasources — the engine observable through its own
SQL (the Druid `sys` schema analog). A copy of the JAX package's
catalog/systables.py with the same eleven tables and columns.

A `sys.<name>` reference resolves through the catalog to a fresh
TableEntry whose frame builds from LIVE engine state at access time —
never ingested, never accelerated, never cached. The engine routes any
statement touching a sys datasource onto the host/interpreter path
inside `introspection_execution()` (obs.workload), so introspection
queries are served by the ordinary SQL machinery (filters, aggregates,
ORDER BY/LIMIT, joins — even against user tables) while appearing
nowhere in their own stats: no history record, no metrics, no SLO
observation, no profiler template, no cache entry.

Datasources:

  sys.tables           registered datasources + size/generation
  sys.segments         per-segment rows/interval/generation/bytes +
                       whether the tier-1 cache pins partials for it
  sys.queries          the per-query history ring (QueryRunner.history)
  sys.query_templates  the workload profiler (obs.workload) — count,
                       latency percentiles, cache hit-rate, dims, grains
  sys.metrics          the metrics registry, one row per series
  sys.caches           result-cache tiers + runner cache populations
                       (in this package the plan cache and, as "jit",
                       the in-process cache of NVRTC-compiled kernels)
  sys.cubes            materialized rollup cubes: dims/grain/rows,
                       base-vs-cube generation (stale detection),
                       build cost, rewrite serve counts
  sys.checkpoints      durable sealed-segment checkpoints per table:
                       manifest id, WAL watermark vs acked seq, spilled
                       bytes, chunk reuse
  sys.devices          per-device serving state: segments, resident
                       bytes, dispatches, tier-1 cache entries,
                       per-owner-class device bytes with
                       high-watermark + headroom. One row per mesh
                       device (one, the runner's torch device, without
                       a mesh)
  sys.metrics_history  the telemetry sampler's bounded per-series
                       rings (obs.timeseries) — the engine answers
                       SQL over its own recent metric history
  sys.alerts           the regression sentinel's alert history
                       (obs.sentinel): latency drift attributed to a
                       stage, HBM pressure, eviction thrash, WAL lag,
                       breaker/admission events
"""

from __future__ import annotations

import pandas as pd

SYS_PREFIX = "sys."

__all__ = ["SYS_PREFIX", "SysTableProvider", "stmt_uses_sys"]


def _expr_uses_sys(e, catalog) -> bool:
    """Expression-level subqueries (WHERE x IN (SELECT ... FROM
    sys.queries), EXISTS, scalar) reference sys datasources too — they
    must route the WHOLE statement onto the suppressed introspection
    path, or the inner sys scan would execute unsuppressed."""
    from tpu_olap_torch.ir.expr import BinOp, FuncCall, Subquery, WindowCall
    if isinstance(e, Subquery):
        return stmt_uses_sys(e.stmt, catalog)
    if isinstance(e, BinOp):
        return _expr_uses_sys(e.left, catalog) \
            or _expr_uses_sys(e.right, catalog)
    if isinstance(e, FuncCall):
        return any(_expr_uses_sys(a, catalog) for a in e.args)
    if isinstance(e, WindowCall):
        return any(_expr_uses_sys(a, catalog) for a in e.args) \
            or any(_expr_uses_sys(p, catalog) for p in e.partition_by) \
            or any(_expr_uses_sys(oe, catalog)
                   for oe, _ in e.order_by)
    return False


def stmt_uses_sys(stmt, catalog) -> bool:
    """True when any datasource reference in the statement tree —
    FROM/JOIN position, derived tables, or expression subqueries —
    resolves to a sys datasource (a REGISTERED table shadowing a sys
    name stays a user table)."""
    from tpu_olap_torch.planner.sqlparse import UnionStmt
    if stmt is None:
        return False
    if isinstance(stmt, UnionStmt):
        return any(stmt_uses_sys(p, catalog) for p in stmt.parts)
    if catalog.is_sys(getattr(stmt, "table", None)):
        return True
    if stmt_uses_sys(getattr(stmt, "derived", None), catalog):
        return True
    for j in getattr(stmt, "joins", ()):
        if catalog.is_sys(j.table) or \
                stmt_uses_sys(getattr(j, "derived", None), catalog):
            return True
        if j.on is not None and _expr_uses_sys(j.on, catalog):
            return True
    exprs = [e for e, _ in getattr(stmt, "projections", ())]
    exprs += list(getattr(stmt, "group_by", ()) or ())
    exprs.append(getattr(stmt, "where", None))
    exprs.append(getattr(stmt, "having", None))
    exprs += [o.expr for o in getattr(stmt, "order_by", ()) or ()]
    return any(e is not None and _expr_uses_sys(e, catalog)
               for e in exprs)


# ------------------------------------------------------- frame builders

def _tables_frame(engine) -> pd.DataFrame:
    dev = engine.runner.device_bytes_by_table()
    rows = []
    for name in engine.catalog.names():
        e = engine.catalog.get(name)
        acc = e.is_accelerated
        rows.append({
            "table": name,
            "accelerated": acc,
            # null until the lazy fallback frame materializes — listing
            # tables must not force a parquet load (same rule as /status)
            "rows": (e.segments.num_rows if acc else e.materialized_rows),
            "segments": len(e.segments.segments) if acc else 0,
            "generation": e.segments.generation if acc else None,
            "time_column": e.time_column,
            "device_bytes": dev.get(name, 0),
        })
    return pd.DataFrame(rows, columns=[
        "table", "accelerated", "rows", "segments", "generation",
        "time_column", "device_bytes"])


def _segments_frame(engine) -> pd.DataFrame:
    pinned = engine.runner.result_cache.cached_segments()
    rows = []
    for name in engine.catalog.names():
        e = engine.catalog.get(name)
        if not e.is_accelerated:
            continue
        ts = e.segments
        wm = ts.watermark
        for sid, s in enumerate(ts.segments):
            nbytes = sum(int(a.nbytes) for a in s.columns.values()) \
                + sum(int(a.nbytes) for a in s.null_masks.values())
            sealed = ts.segment_sealed(sid)
            rows.append({
                "table": name,
                "segment_id": s.meta.segment_id,
                "rows": s.meta.n_valid,
                "time_min": s.meta.time_min,
                "time_max": s.meta.time_max,
                # kind/watermark: sealed segments key
                # caches by the sealed generation and are complete up
                # to the table's watermark; delta blocks hold real-time
                # appends awaiting compaction
                "kind": "sealed" if sealed else "delta",
                "generation": ts.segment_generation(sid),
                "watermark": wm,
                "bytes": nbytes,
                "cache_pinned": (name, s.meta.segment_id) in pinned,
            })
    return pd.DataFrame(rows, columns=[
        "table", "segment_id", "rows", "time_min", "time_max", "kind",
        "generation", "watermark", "bytes", "cache_pinned"])


_QUERY_COLS = (
    "query_id", "ts_ms", "query_type", "datasource", "path",
    "template_id", "total_ms", "rows_scanned", "segments_scanned",
    "rows_returned", "cache_hit", "cache_tier", "failed", "pipelined",
    "batch_id", "fallback_reason")


def _queries_frame(engine) -> pd.DataFrame:
    recs = list(engine.runner.history)
    rows = []
    for r in recs:
        if r.get("query_type", "?") == "?":
            continue  # runner notes (healer/reprobe), not queries
        row = {c: r.get(c) for c in _QUERY_COLS}
        row["cache_hit"] = bool(r.get("cache_hit"))
        row["failed"] = bool(r.get("failed"))
        rows.append(row)
    return pd.DataFrame(rows, columns=list(_QUERY_COLS))


_TEMPLATE_COLS = (
    "template_id", "datasource", "query_type", "count", "failures",
    "p50_ms", "p95_ms", "p99_ms", "mean_ms", "total_ms", "rows_scanned",
    "segments_scanned", "cache_hit_rate", "cache_full_hits",
    "cache_segment_hits", "segments_cached", "dims", "granularities",
    "paths", "first_seen_ms", "last_seen_ms", "template")


def _templates_frame(engine) -> pd.DataFrame:
    return pd.DataFrame(engine.runner.workload.snapshot(),
                        columns=list(_TEMPLATE_COLS))


def _metrics_frame(engine) -> pd.DataFrame:
    engine.runner.refresh_resource_gauges()
    return pd.DataFrame(engine.metrics.snapshot_rows(), columns=[
        "name", "kind", "labels", "value", "count", "total"])


_CUBE_COLS = (
    "name", "base_table", "table", "dims", "granularity", "status",
    "rows", "base_generation", "cube_generation", "stale",
    "last_refresh_ms", "build_ms", "refreshes", "serve_count",
    "storage_bytes", "sketch_bytes", "error")


def _cubes_frame(engine) -> pd.DataFrame:
    """sys.cubes: the materialized-rollup registry (cubes/) —
    per cube: dims/grain, row count, the base table's LIVE ingest
    generation vs the generation the cube was built from (stale =
    mismatch: unservable until the maintainer rebuilds), build cost,
    and how many queries the rewrite pass served from it."""
    return pd.DataFrame(engine.cubes.snapshot(),
                        columns=list(_CUBE_COLS))


_CHECKPOINT_COLS = (
    "table", "checkpoint_id", "wal_watermark", "sealed_through_seq",
    "acked_seq", "checkpoints", "segments", "bytes", "chunks_reused",
    "manifests_retained", "last_status")


def _checkpoints_frame(engine) -> pd.DataFrame:
    """sys.checkpoints: the durable segment store (segments/store.py;
    the ingest manager) — per table: the newest manifest's id and WAL
    watermark (frames past it replay at recovery; frames at or below
    the LAG-ONE watermark are truncated), spilled bytes, and how many
    chunk files the last checkpoint reused instead of rewriting."""
    return pd.DataFrame(engine.ingest.store_rows(),
                        columns=list(_CHECKPOINT_COLS))


_DEVICE_COLS = (
    "index", "device", "platform", "process", "chips", "segments",
    "resident_bytes", "dispatches", "cache_shard_entries",
    "rebased_cols", "rebase_rows_uploaded", "hbm_bytes",
    "table_column_bytes", "cube_table_bytes", "inflight_bytes",
    "cache_pin_bytes", "hbm_high_watermark_bytes",
    "hbm_headroom_bytes")


def _devices_frame(engine) -> pd.DataFrame:
    """sys.devices: one row per mesh device, or one for the runner's
    torch device without a mesh (`device` and `platform` name it, e.g.
    "cuda:0" / "cuda") — the logical segments it owns under the
    interleaved placement, its resident bytes, dispatches, and tier-1
    cache entry counts.
    `rebased_*` columns surface the incremental rebase path (only
    delta-touched segments' rows re-upload on an ingest snapshot swap).
    The hbm_* columns are the ledger's exact per-owner-class
    attribution: table_column + cube_table + inflight bytes sum to
    hbm_bytes, summed over the rows, == HbmLedger.bytes_in_use;
    cache_pin_bytes is the tier-1
    ResultCache's byte census; high-watermark and headroom are against
    hbm_budget_bytes."""
    return pd.DataFrame(engine.runner.device_snapshot(),
                        columns=list(_DEVICE_COLS))


_METRICS_HISTORY_COLS = ("ts_ms", "name", "kind", "labels", "value",
                         "count")


def _metrics_history_frame(engine) -> pd.DataFrame:
    """sys.metrics_history: the telemetry sampler's bounded per-series
    rings (obs.timeseries) — one row per retained sample.
    Scalar series carry `value` (the counter/gauge level at ts_ms);
    histogram series carry (`value`=observation sum, `count`=n), the
    _sum/_count pair rates and means derive from. The engine answers
    SQL over its own recent telemetry with no external TSDB."""
    return pd.DataFrame(engine.runner.telemetry.rows(),
                        columns=list(_METRICS_HISTORY_COLS))


_ALERT_COLS = ("alert_id", "kind", "subject", "stage", "status",
               "fired_at_ms", "last_seen_ms", "cleared_at_ms", "count",
               "total_ms", "baseline_ms", "threshold_ms")


def _alerts_frame(engine) -> pd.DataFrame:
    """sys.alerts: the regression sentinel's alert history (active +
    cleared, obs.sentinel). `stage` names the attributed
    stage for latency_drift alerts; resource alerts (hbm_pressure,
    eviction_thrash, wal_lag, breaker_open, admission_shed) carry
    their condition under subject/count."""
    rows = [{c: a.get(c) for c in _ALERT_COLS}
            for a in engine.runner.sentinel.alert_rows()]
    return pd.DataFrame(rows, columns=list(_ALERT_COLS))


def _caches_frame(engine) -> pd.DataFrame:
    runner = engine.runner
    snap = runner.result_cache.snapshot()
    rows = []
    for tier in ("full", "segment"):
        t = snap[tier]
        rows.append({
            "cache": tier, "entries": t["entries"], "bytes": t["bytes"],
            "budget_bytes": t["budget_bytes"], "hit": t["hit"],
            "miss": t["miss"], "bypass": t["bypass"],
            "evict": t["evict"], "enabled": snap["enabled"][tier]})
    for cname, n in runner.cache_populations().items():
        rows.append({"cache": cname, "entries": n, "bytes": None,
                     "budget_bytes": None, "hit": None, "miss": None,
                     "bypass": None, "evict": None, "enabled": True})
    return pd.DataFrame(rows, columns=[
        "cache", "entries", "bytes", "budget_bytes", "hit", "miss",
        "bypass", "evict", "enabled"])


class SysTableProvider:
    """Resolves `sys.<name>` catalog lookups to lazily-built TableEntry
    objects over live engine state. Inside an introspection statement
    (obs.workload.introspection_scope) resolutions memoize per name, so
    however many times planning + execution consult the catalog — alias
    resolution, the scan, both sides of a self-join — the statement
    sees ONE point-in-time snapshot per sys table. Outside that scope
    each resolution is a fresh entry (never staler than its caller)."""

    _BUILDERS = {
        "sys.tables": _tables_frame,
        "sys.segments": _segments_frame,
        "sys.queries": _queries_frame,
        "sys.query_templates": _templates_frame,
        "sys.metrics": _metrics_frame,
        "sys.caches": _caches_frame,
        "sys.cubes": _cubes_frame,
        "sys.checkpoints": _checkpoints_frame,
        "sys.devices": _devices_frame,
        "sys.metrics_history": _metrics_history_frame,
        "sys.alerts": _alerts_frame,
    }

    def __init__(self, engine):
        self.engine = engine

    def has(self, name) -> bool:
        return name in self._BUILDERS

    def names(self):
        return sorted(self._BUILDERS)

    def entry(self, name):
        from tpu_olap_torch.catalog.catalog import TableEntry
        from tpu_olap_torch.obs.workload import introspection_scope
        scope = introspection_scope()
        if scope is not None and name in scope:
            return scope[name]
        build = self._BUILDERS[name]
        eng = self.engine
        entry = TableEntry(name=name, segments=None,
                           frame_source=lambda: build(eng))
        if scope is not None:
            scope[name] = entry
        return entry

"""Engine — the API surface (SURVEY.md §3.1): table registration (the
DefaultSource OPTIONS analog) from pandas, Arrow or parquet, the SQL entry
point, the raw-IR passthrough, paged Select, EXPLAIN and the statement
verbs of the reference's extended parser (`CLEAR DRUID CACHE`, `EXPLAIN
DRUID REWRITE`, `ON DRUID DATASOURCE … EXECUTE QUERY`, `SEARCH DRUID
DATASOURCE`), and the rollup-cube DDL (`CREATE DRUID CUBE … ON …`,
`CREATE DRUID CUBES FROM '<file>'`, `DROP DRUID CUBE`, `REFRESH DRUID
CUBES`).

Statements the planner rewrites run on the device path. The pandas
fallback interpreter (`planner.fallback`) serves a statement when the
planner did not rewrite it, its table is plain (`accelerate=False`), or
lowering raised one of the four `Unsupported*` types — and, as in the
JAX package, in two resilience cases: the device circuit breaker is
open (path "fallback_breaker"), or a device failure outlived the
runner's `dispatch_retries` and `fallback_on_device_failure` is set
(path "fallback", with the attempts' `retries` and `retry_errors` in
the metrics). With `fallback_on_device_failure` off both raise; an
admission shed (`QueryShed`) always raises. Each fallback answer
records its reason in `last_plan.fallback_reason` and
`runner.last_metrics["route"] == "fallback"`. Before the device path, a
rewritten aggregate that a materialized rollup cube covers is served by
folding the cube's stored partials on the host, plus the delta
segments' partials from the device (planner.cuberewrite; route
"cube").

Real-time ingest (segments.delta): `append`, `compact_now`,
`checkpoint_now` and the verbs `INSERT INTO … VALUES`, `COMPACT DRUID
TABLE`, `CHECKPOINT DRUID TABLE`; `register_table` replays a table's WAL
and restores its checkpoint, `drop_table` deletes both, and `close`
joins the background graphs (compactor, WAL flush, cube maintainer).

`sql_batch` runs several statements as one submission: rewritten
statements against one table share scans (executor.batch), and the
same fallback rule holds per statement.

Observability, as in the JAX package: every statement runs under a
trace (`sql`, `sql_batch` or `ir` root; `parse`, `plan`, `execute`,
`render` and the runner's spans below), leaves history records
(`history`, `counters()`, the fallback's own record included), and
counts once against the latency SLO — failures that propagate to the
client at the statement boundary (`_observe_failure`). `EXPLAIN ANALYZE
<sql>` runs the statement and returns its span tree. A deadline that
expires (`QueryDeadlineExceeded`) is a device failure: the fallback
serves it when `fallback_on_device_failure` is set.

The engine answers SQL over its own state through the `sys.*` tables
(catalog.systables: sys.tables, segments, queries, query_templates,
metrics, caches, cubes, checkpoints, devices, metrics_history, alerts).
A statement that reads one (in FROM, a join, a derived table or an
expression subquery) runs in the fallback interpreter on the host
(`_execute_sys_stmt`), never on the device, and leaves no trace, history
record, metric, SLO observation, workload template or cache entry — in
`sql` and in `sql_batch` alike. `append` takes a W3C `traceparent`. The
engine wires the regression sentinel's `wal` probe (`_wal_lag_probe`);
api.server.QueryServer serves it all over HTTP.
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading
import time

import numpy as np
import pandas as pd

from tpu_olap_torch.catalog import (Catalog, StarSchema, SysTableProvider,
                                    TableEntry, stmt_uses_sys)
from tpu_olap_torch.cubes import CubeRegistry
from tpu_olap_torch.executor.config import EngineConfig
from tpu_olap_torch.executor.dimplan import UnsupportedDimension
from tpu_olap_torch.executor.runner import QueryResult, QueryRunner
from tpu_olap_torch.ir.query import (SearchQueryContains, SearchQuerySpec,
                                     SelectQuerySpec)
from tpu_olap_torch.ir.serde import query_from_json
from tpu_olap_torch.kernels.filtereval import UnsupportedFilter
from tpu_olap_torch.kernels.groupby import UnsupportedAggregation
from tpu_olap_torch.kernels.timebucket import UnsupportedGranularity
from tpu_olap_torch.obs.trace import (Trace, current_query_id,
                                      in_nested_execution, nested_execution,
                                      parse_traceparent, span as _span,
                                      use_query_id, use_traceparent)
from tpu_olap_torch.obs.workload import (fingerprint_sql,
                                         introspection_execution)
from tpu_olap_torch.planner import DruidPlanner
from tpu_olap_torch.planner.cuberewrite import try_serve_cube
from tpu_olap_torch.planner.fallback import execute_fallback
from tpu_olap_torch.resilience.errors import (BreakerOpen, QueryShed,
                                              UserError)
from tpu_olap_torch.resilience.faults import maybe_inject
from tpu_olap_torch.segments.delta import IngestManager
from tpu_olap_torch.segments.ingest import (DEFAULT_BLOCK_ROWS, ingest_arrow,
                                            ingest_parquet_stream)

# the lowering refusals that send a statement to the fallback interpreter
_UNSUPPORTED = (UnsupportedAggregation, UnsupportedFilter,
                UnsupportedGranularity, UnsupportedDimension)


def _mark_slo_observed(e: BaseException):
    """Stamp an exception whose failure was already counted against the
    SLO (a recorded fallback failure) so that the statement boundary
    (Engine._observe_failure) never counts one served failure twice.
    Only for exceptions never shared across statements: the coalescer
    fans one exception object out to N callers, each its own served
    response."""
    try:
        e._slo_observed = True
    except Exception:  # noqa: BLE001 — slotted/exotic exceptions
        pass


def _failure_status(e: BaseException) -> int:
    """HTTP shape of a propagating failure: the taxonomy's http_status,
    or 400 for ValueError/KeyError and 500 for the rest."""
    status = getattr(e, "http_status", None)
    if status is None:
        return 400 if isinstance(e, (ValueError, KeyError)) else 500
    return int(status)


class Engine:
    """Engine(config) or Engine(**config fields), e.g.
    Engine(device="cpu")."""

    def __init__(self, config: EngineConfig | None = None, **overrides):
        config = config or EngineConfig()
        self.config = dataclasses.replace(config, **overrides) \
            if overrides else config
        self.catalog = Catalog()
        self.runner = QueryRunner(self.config)
        # the observability surfaces live on the runner, where records
        # complete; these aliases are the API
        self.tracer = self.runner.tracer
        self.metrics = self.runner.metrics
        # engine-level admin (clear, drop) and runner dispatch share one
        # lock (held for stage-1 enqueue only in pipelined mode)
        self.device_lock = self.runner.dispatch_lock
        self.planner = DruidPlanner(self.catalog, self.config)
        self.last_plan = None
        self._tls = threading.local()   # per-thread nested metrics
        # planner-initiated subquery execution: uncorrelated shapes
        # inline as literals so the outer query can push down; the inner
        # aggregate itself rides the device path when rewritable
        self.planner.run_subquery = self._run_stmt
        # fallback-initiated derived-table execution: a FROM/JOIN
        # (SELECT ...) body is usually the scan-heavy, device-eligible
        # part of a statement the interpreter serves — route it back
        # through the statement executor (fallback._run_inner_stmt)
        self.catalog.device_runner = self._run_stmt
        # sys.* virtual datasources (catalog.systables): the engine is
        # observable through its own SQL; a sys name resolves through
        # the catalog to a live-state frame served on the interpreter
        # path with accounting suppressed
        self.catalog.sys_provider = SysTableProvider(self)
        # materialized rollup cubes (tpu_olap_torch.cubes)
        self.cubes = CubeRegistry(self)
        # real-time ingest: deltas, WALs, the compactor, checkpoints
        self.ingest = IngestManager(self)
        # the regression sentinel's WAL sync-lag probe, consulted on the
        # telemetry tick: wired here because the runner, which owns the
        # sentinel, exists before the ingest manager
        self.runner.sentinel.add_probe("wal", self._wal_lag_probe)

    def _wal_lag_probe(self) -> dict:
        """{table: unsynced WAL frames} for tables with live WALs."""
        out = {}
        snap = self.ingest.snapshot() or {}
        for name, st in (snap.get("tables") or {}).items():
            wal = st.get("wal") if isinstance(st, dict) else None
            if wal and wal.get("lag_records") is not None:
                out[name] = int(wal["lag_records"])
        return out

    # ------------------------------------------------------- registration

    def register_table(self, name: str, data, time_column: str | None = None,
                       star_schema=None, accelerate: bool = True,
                       block_rows: int = DEFAULT_BLOCK_ROWS,
                       column_map: dict | None = None, columns=None,
                       time_partition="auto", segments=None, **options):
        """Register a datasource. `data`: pandas DataFrame, pyarrow Table,
        parquet path, or a list of parquet paths (a multi-file dataset).
        accelerate=False registers a plain (dimension) table served only
        by the fallback interpreter — the reference's non-druid-backed
        relation.

        Parquet inputs stream row-group batches into segments under
        bounded host memory (segments.ingest.ingest_parquet_stream); the
        fallback DataFrame materializes lazily on first fallback use, and
        a table past `fallback_chunk_rows` rows never materializes it: the
        fallback streams its row groups. `columns` optionally prunes the
        ingested column set — always POST-rename names (after
        column_map), for every input type; parquet reads skip pruned
        columns entirely.

        `segments` registers an already-built TableSegments instead of
        ingesting `data` (segments.carry builds one from another
        ingest's arrays); `data` may then be None.

        `time_partition` is the Druid segmentGranularity analog:
        "day"/"month"/"year" buckets rows into disjoint calendar
        partitions; "auto" (default) picks the finest granularity the
        table can amortize; None disables partitioning.
        """
        if data is None and segments is None:
            raise ValueError("register_table needs data or segments")
        # "ingest" fault site: a raised fault aborts registration before
        # any segment state is built, so that a failed ingest never
        # leaves a half-registered table behind
        maybe_inject(self.config, "ingest", 0)
        if not accelerate:
            segments = None
        column_map = dict(column_map) if column_map else None
        if column_map and time_column in column_map:
            time_column = column_map[time_column]
        table = None
        pq_fields = {}
        if isinstance(data, str) or (
                isinstance(data, (list, tuple)) and data
                and all(isinstance(p, str) for p in data)):
            import pyarrow.parquet as pq
            paths = [data] if isinstance(data, str) else list(data)
            inverse = {v: k for k, v in (column_map or {}).items()}
            read_cols = [inverse.get(c, c) for c in columns] \
                if columns else None

            def load_frame(_paths=tuple(paths), _cols=read_cols):
                f = pd.concat(
                    [pq.read_table(p, columns=_cols).to_pandas()
                     for p in _paths], ignore_index=True)
                return f.rename(columns=column_map) if column_map else f

            if accelerate and segments is None:
                segments = ingest_parquet_stream(
                    name, paths, time_column, block_rows,
                    columns=columns, column_map=column_map,
                    time_partition=time_partition)
            frame_source = load_frame
            pq_fields = dict(
                parquet_paths=tuple(paths),
                parquet_read_cols=tuple(read_cols) if read_cols else None,
                parquet_column_map=column_map,
                parquet_rows=sum(pq.ParquetFile(p).metadata.num_rows
                                 for p in paths))
        elif data is None or isinstance(data, pd.DataFrame):
            frame = data
            if frame is not None:
                if column_map:
                    frame = frame.rename(columns=column_map)
                if columns:
                    frame = frame[list(columns)]
                if accelerate and segments is None:
                    import pyarrow as pa
                    table = pa.Table.from_pandas(frame, preserve_index=False)
            frame_source = frame
        else:  # pyarrow table
            table = data
            if column_map:
                table = table.rename_columns(
                    [column_map.get(c, c) for c in table.schema.names])
            if columns:
                table = table.select(list(columns))

            def frame_source(_t=table):
                return _t.to_pandas()

        if accelerate and segments is None:
            segments = ingest_arrow(name, table, time_column, block_rows,
                                    time_partition=time_partition)
        star = star_schema
        if isinstance(star, dict):
            star = StarSchema.from_json(star)
        if segments is not None:
            segments.star = star  # FD-aware dim-domain restriction
        entry = TableEntry(name=name, segments=segments,
                           frame_source=frame_source,
                           time_column=time_column, star=star,
                           options=dict(options), **pq_fields)
        self.catalog.register(entry)
        # the fresh TableSegments took the next generation, orphaning
        # both result-cache tiers' entries for this name at key level:
        # purge them eagerly (a `cache_invalidate` event when there were
        # any), with the old data's resident stacks and plans
        with self.device_lock:
            self.runner.purge_device_state(name)
        self.runner.result_cache.invalidate_table(name)
        self.runner.events.emit(
            "ingest", table=name, accelerated=bool(accelerate),
            generation=segments.generation if segments is not None
            else None,
            rows=segments.num_rows if segments is not None else None,
            segments=len(segments.segments) if segments is not None
            else 0)
        # real-time ingest: a first registration with an existing WAL is
        # crash recovery (restore the checkpoint, replay the WAL tail to
        # the acknowledged state); re-registering a live table resets
        # its log and store instead (the appends belonged to the old
        # data)
        self.ingest.on_register(entry)
        # cube cascade: rollups over this table are now stale (the
        # rewrite pass stops serving them at its generation check) and
        # the maintainer wakes to rebuild them
        self.cubes.on_table_registered(name)
        return entry

    def append(self, table: str, rows,
               traceparent: str | None = None) -> dict:
        """Real-time append: `rows` (a list of dicts or a DataFrame,
        columns within the table's schema, time under the registered
        time column or ``__time``) land in the table's mutable delta and
        are queryable at once alongside the sealed segments, through the
        same kernels and caches. With `ingest_wal_dir` set the batch is
        framed into the table's write-ahead log before it is
        acknowledged, so that a crash replays to the acknowledged state
        at the next registration. A delta at `ingest_max_delta_rows`
        sheds with IngestBackpressure, never dropping a row. SQL:
        ``INSERT INTO t (cols) VALUES (...)``.

        Returns {table, rows, generation, sealed_generation, delta_rows,
        watermark, wal_seq}. A valid W3C `traceparent` is stamped into the
        ack and the events the append emits; an invalid one is
        ignored."""
        tp = parse_traceparent(traceparent)
        with use_traceparent(tp["traceparent"] if tp else None):
            ack = self.ingest.append(table, rows)
        if tp is not None and isinstance(ack, dict):
            ack.setdefault("traceparent", tp["traceparent"])
        return ack

    def compact_now(self, table: str | None = None):
        """Seal the delta rows into time-partitioned sealed segments, now
        (the background compactor's synchronous spelling). `table=None`
        compacts every table with a non-empty delta."""
        if table is None:
            return self.ingest.compact_all()
        return self.ingest.compact_now(table)

    def checkpoint_now(self, table: str | None = None):
        """Checkpoint a table's sealed scope durably: compact the delta,
        spill the sealed segments as checksummed chunk files under
        `ingest_store_dir`, advance the manifest atomically and truncate
        the WAL through the lag-one watermark; a restart then replays
        only the tail past it. SQL: ``CHECKPOINT DRUID TABLE t``.
        `table=None` checkpoints every table with ingest state."""
        if table is None:
            return self.ingest.checkpoint_all()
        return self.ingest.checkpoint_now(table)

    def close(self):
        """Cancel and join every background graph the engine owns — the
        compactor and WAL flushers, the cube maintainer — and the stage
        scheduler's ticker, and close the WALs. The engine stays
        queryable; appends reopen WALs and re-register their graphs on
        demand. Call it before dropping an engine, or its threads
        outlive it. The telemetry graph stops with the others, and the
        event log's file sink is flushed."""
        self.ingest.stop()
        self.cubes.stop(join=True)
        self.runner.stages.stop()
        self.runner.events.flush(2.0)

    def register_lookup(self, name: str, mapping: dict):
        """Register a named lookup map (Druid lookup extraction fn). SQL
        reaches it as LOOKUP(col, 'name') in projections, GROUP BY and
        filters (SURVEY.md §3.3 lookup extraction dims)."""
        self.catalog.lookups[name] = {str(k): v for k, v in mapping.items()}

    @property
    def _nested(self) -> list:
        """The runner metrics of the statements the current statement ran
        inside it (inlined subqueries, derived tables), on this thread;
        reset per Engine.sql."""
        nested = getattr(self._tls, "nested", None)
        if nested is None:
            nested = self._tls.nested = []
        return nested

    @_nested.setter
    def _nested(self, value: list):
        self._tls.nested = value

    # ---------------------------------------------------------------- SQL

    def sql(self, query: str) -> pd.DataFrame:
        """Plan, execute on the device path or in the fallback
        interpreter, and return a DataFrame. `runner.last_metrics` then
        says which route served the statement ("fallback" for the
        interpreter, "grouping_sets" for a union of device legs), and
        "nested" lists the metrics of the statements it ran inside it;
        `history` holds its records.

        Statement verbs beyond SELECT (SURVEY.md §3.1): `CLEAR DRUID
        CACHE [table]`, `EXPLAIN DRUID REWRITE <sql>`, `EXPLAIN ANALYZE
        <sql>`, `ON DRUID DATASOURCE <ds> EXECUTE QUERY '<json>'` and
        `SEARCH DRUID DATASOURCE <ds> FOR '<text>' [IN d1, d2] [LIMIT
        n]`."""
        return self._sql_traced(query)[0]

    def _sql_traced(self, query: str, traceparent: str | None = None):
        """sql() plus the completed trace (None for statement verbs or
        with tracing off): the EXPLAIN ANALYZE entry point. A valid W3C
        `traceparent` is stamped on the root span and the records; an
        invalid one is ignored."""
        tp = parse_traceparent(traceparent)
        with use_traceparent(tp["traceparent"] if tp else None):
            return self._sql_traced_inner(query, tp)

    def _sql_traced_inner(self, query: str, tp: dict | None = None):
        verb = _match_verb(query)
        if verb is not None:
            return verb(self), None
        from tpu_olap_torch.planner.sqlparse import parse_sql
        pre_stmt = None
        if _SYS_HINT_RE.search(query):
            # probable sys.* introspection statement: confirm against the
            # parsed tree (a string literal mentioning "sys." must not
            # take a user query off the device) and serve it outside the
            # trace. A parse failure defers to the traced path, so that
            # the error records like any other bad statement; a confirmed
            # non-sys parse is reused below.
            try:
                pre_stmt = parse_sql(query)
            except Exception:
                pre_stmt = None
            if pre_stmt is not None \
                    and stmt_uses_sys(pre_stmt, self.catalog):
                return self._execute_sys_stmt(pre_stmt), None
        self._nested = []
        with self.tracer.trace("sql") as root:
            root.set(sql=query)
            if tp is not None:
                root.set(traceparent=tp["traceparent"],
                         trace_id=tp["trace_id"],
                         parent_span_id=tp["parent_id"])
            try:
                with root.span("parse"):
                    stmt = pre_stmt if pre_stmt is not None \
                        else parse_sql(query)
                with root.span("plan") as sp:
                    plan = self.planner.plan_stmt(stmt, query)
                    sp.set(rewritten=plan.rewritten)
                    if plan.fallback_reason:
                        sp.set(fallback_reason=plan.fallback_reason)
                self.last_plan = plan
                out = self._execute_plan(plan)
            except Exception as e:
                # statement-boundary SLO accounting: a failure no inner
                # record counted (a shed, a refusal, a device failure
                # with fallback off) counts here, once
                self._observe_failure(e)
                raise
        if self._nested:
            self.runner.last_metrics["nested"] = self._nested
        return out, root if isinstance(root, Trace) else None

    def _observe_failure(self, e: BaseException):
        """Count a failure propagating to the client against the SLO:
        exactly once (sites whose record already counted it marked the
        exception), never for nested statements (the outer statement
        accounts), and never for client-shaped errors (a 400 for bad SQL
        must not burn the error budget; 429 and up do)."""
        if getattr(e, "_slo_observed", False) or in_nested_execution():
            return
        if _failure_status(e) < 429:
            return
        self.runner.slo.observe(0.0, failed=True)

    def _execute_plan(self, plan) -> pd.DataFrame:
        if getattr(plan.stmt, "grouping_sets", None) is not None \
                and not plan.rewritten:
            out = self._try_grouping_sets_union(plan)
            if out is not None:
                return out
        if plan.rewritten and self.cubes.active:
            # a covered aggregate is served by folding stored cube rows
            # instead of scanning the base table; None falls through to
            # the device path, never an error
            res = try_serve_cube(self, plan)
            if res is not None:
                with _span("render"):
                    return self._frame_from(plan, res)
        device = {}
        device_ms = 0.0   # the wall a failed device attempt burned
        if plan.rewritten:
            t_dev = time.perf_counter()
            try:
                with _span("execute"):
                    res = self.runner.execute(plan.query,
                                              plan.entry.segments)
            except _UNSUPPORTED as e:
                # a shape lowering refuses (e.g. a sparse GroupBy past
                # sparse_group_budget): the interpreter serves it
                plan.query = None
                plan.fallback_reason = f"lowering failed: {e}"
                device_ms = (time.perf_counter() - t_dev) * 1000
            except QueryShed:
                # overload: the slower interpreter would amplify it
                raise
            except BreakerOpen as e:
                # the device is sick, the host is fine: degraded but
                # exact serving from the interpreter
                if not self.config.fallback_on_device_failure:
                    raise
                plan.query = None
                plan.fallback_reason = f"breaker open: {e}"
                device = {"fallback_breaker": True}
            except Exception as e:
                # the runner's retries ran out (a launch or CUDA error,
                # a failed copy) or the deadline expired
                # (QueryDeadlineExceeded): the interpreter serves the
                # statement, recorded as such, or the error propagates
                if not self.config.fallback_on_device_failure:
                    raise
                plan.query = None
                plan.fallback_reason = \
                    f"device failure: {type(e).__name__}: {e}"
                device_ms = (time.perf_counter() - t_dev) * 1000
                m = self.runner.last_metrics
                device = {k: m[k] for k in ("retries", "retry_errors")
                          if k in m}
            else:
                with _span("render"):
                    return self._frame_from(plan, res)
        return self._execute_fallback_recorded(plan, device_ms, device)

    def _execute_fallback_recorded(self, plan, device_ms: float = 0.0,
                                   device=None) -> pd.DataFrame:
        """The pandas interpreter over the whole statement, under a
        `fallback` span and with its own history record (query_type
        "fallback"; path "fallback_breaker" while the breaker is open,
        else "fallback"), as the device routes record theirs. `device_ms`
        is the wall a failed device attempt already burned (the SLO
        classifies the latency the user saw); after a device failure the
        runner's retries ride along. A failure records too, then
        propagates."""
        stmt = plan.stmt
        entry = plan.entry if plan.entry is not None \
            else self.catalog.maybe(getattr(stmt, "table", None) or "")
        rows = 0
        if entry is not None:
            rows = (entry.segments.num_rows if entry.is_accelerated
                    else entry.materialized_rows) or 0
        device = dict(device or {})
        m = {"query_type": "fallback", "route": "fallback",
             "datasource": getattr(stmt, "table", None) or "(derived)",
             "rows_scanned": rows, "cache_hit": False, "host_copies": 0,
             "fallback_reason": plan.fallback_reason, **device}
        if device_ms > 0:
            m["device_attempt_ms"] = round(device_ms, 3)
        if self.runner.workload.enabled:
            try:
                m["_wl"] = fingerprint_sql(plan.sql or "", stmt,
                                           m["datasource"])
            except Exception:  # noqa: BLE001 — profiling never raises
                pass
        t0 = time.perf_counter()
        with _span("fallback") as sp:
            sp.set(reason=plan.fallback_reason)
            try:
                out = execute_fallback(stmt, self.catalog, self.config)
            except Exception as e:
                m["failed"] = True
                m["total_ms"] = (time.perf_counter() - t0) * 1000
                if _failure_status(e) < 429:
                    # a client-shaped failure (unsupported SQL -> 400) is
                    # recorded but never burns the SLO error budget
                    m["client_error"] = True
                self.runner.last_metrics = self.runner.record(m)
                if not in_nested_execution():
                    _mark_slo_observed(e)   # record() accounted for it
                raise
            m["total_ms"] = (time.perf_counter() - t0) * 1000
            m["rows_returned"] = len(out)
            self.runner.last_metrics = self.runner.record(m)
        return out

    def _try_grouping_sets_union(self, plan):
        """GROUPING SETS/ROLLUP/CUBE on the device path: a union of
        per-set GROUP BY dispatches — each leg differs only in its
        dimension list, so the legs share their plain GROUP BY twins'
        kernels. Absent group keys / GROUPING() markers are reattached
        as constant columns after each leg runs. Returns None when the
        shape cannot be unioned (SELECT *; ORDER BY not on an output
        column; a derived or plain source) — the caller then takes the
        whole-statement fallback."""
        from tpu_olap_torch.planner.fallback import (FallbackError,
                                                     _sort_order_items,
                                                     grouping_set_legs,
                                                     union_order_keys)
        stmt = plan.stmt
        # only worth decomposing when the legs can ride the device path:
        # an unaccelerated or derived source would re-run the scan/join
        # once per set where the whole-statement fallback filters once
        # (and gating here keeps that fallback an independent oracle for
        # the union path in tests)
        if stmt.derived is not None or stmt.grouping_sets == []:
            return None
        entry = self.catalog.maybe(stmt.table)
        if entry is None or not entry.is_accelerated:
            return None
        try:
            out_names, legs = grouping_set_legs(stmt)
        except FallbackError:
            return None
        order_keys = union_order_keys(stmt, out_names) \
            if stmt.order_by else []
        if order_keys is None:
            return None  # union ORDER BY must name output columns
        t0 = time.perf_counter()
        frames, leg_plans, leg_metrics = [], [], []
        for leg_stmt, consts in legs:
            lp = self.planner.plan_stmt(leg_stmt)
            leg_plans.append(lp)
            with nested_execution():
                # legs are internal: one SLO observation and one `query`
                # event for the whole union, below
                f = self._execute_plan(lp)
            leg_metrics.append(self.runner.last_metrics)
            for name, val in consts.items():
                # absent group keys reattach as np.nan (float64 NULL),
                # matching the whole-statement fallback's dtype — a bare
                # None would make an object column that breaks numeric
                # comparisons/sorts over the union
                f[name] = np.nan if val is None else val
            frames.append(f.loc[:, out_names])
        plan.grouping_legs = leg_plans
        n_dev = sum(1 for lp in leg_plans if lp.rewritten)
        plan.fallback_reason = (
            None if n_dev == len(leg_plans) else
            f"grouping-sets union: {n_dev}/{len(leg_plans)} legs "
            "device-rewritten")
        out = pd.concat(frames, ignore_index=True) if frames else \
            pd.DataFrame(columns=out_names)
        if order_keys:
            out = _sort_order_items(out, order_keys, stmt.order_by)
        lo = stmt.offset
        hi = None if stmt.limit is None else lo + stmt.limit
        out = out.iloc[lo:hi].reset_index(drop=True)
        # the union is the served response: one SLO observation and one
        # `query` event over every leg (the legs' records were nested)
        if not in_nested_execution():
            total_ms = (time.perf_counter() - t0) * 1000
            self.runner.slo.observe(total_ms)
            self.runner.events.emit(
                "query",
                query_id=current_query_id() or self.tracer.new_query_id(),
                query_type="groupBy", path="grouping_sets",
                datasource=stmt.table, total_ms=round(total_ms, 3),
                cache_hit=False)
        self.runner.last_metrics = {
            "route": "grouping_sets",
            "host_copies": sum(m.get("host_copies", 0)
                               for m in leg_metrics),
            "legs": leg_metrics}
        return out

    def _execute_sys_stmt(self, stmt) -> pd.DataFrame:
        """Serve a sys.* introspection statement (catalog.systables) in
        the fallback interpreter on the host: a sys datasource never
        dispatches to the device and is never cached, and its execution
        is accounting-suppressed — no trace, no history record, no metric
        or SLO observation, no workload template — so introspection can
        never recurse into its own stats. The statement still gets the
        planner's normalization passes, so aliases, windows over groups
        and expression simplification behave as in any other fallback
        statement."""
        from tpu_olap_torch.obs.trace import detached_trace
        from tpu_olap_torch.planner.exprutil import simplify_stmt
        from tpu_olap_torch.planner.plan import _apply_windows_over_groups
        from tpu_olap_torch.planner.sqlparse import UnionStmt
        # detached_trace: a sys statement inside a live trace (an
        # sql_batch submission) must not leak its spans into that trace
        with introspection_execution(), nested_execution(), \
                detached_trace():
            stmt = self.planner._resolve_aliases(stmt)
            stmt = _apply_windows_over_groups(stmt)
            if not isinstance(stmt, UnionStmt):
                stmt = simplify_stmt(stmt)
            return execute_fallback(stmt, self.catalog, self.config)

    def _run_stmt(self, stmt) -> pd.DataFrame:
        """Execute one parsed statement end to end (device path when
        rewritable, else the fallback) — the planner's subquery executor
        and the fallback's derived-table executor. Does not touch
        last_plan: the user-visible plan is the outer statement's. Marked
        nested: its record adds no second SLO observation or `query`
        event to the outer statement's."""
        with nested_execution():
            out = self._execute_plan(self.planner.plan_stmt(stmt))
        self._nested.append(self.runner.last_metrics)
        return out

    # -------------------------------------------------------------- batch

    def sql_batch(self, queries) -> list[pd.DataFrame]:
        """Execute several SQL statements as one submission. Rewritten
        statements against one table run as a shared-scan batch
        (executor.batch): identical statements scan once, and compatible
        aggregates share one pass and one copy back. Statement verbs,
        grouping sets and statements the planner does not rewrite run
        alone, as through `sql`. A leg whose lowering raised one of the
        four `Unsupported*` refusals is served by the single path (and
        so by the fallback interpreter), as is a leg of a shared pass that
        met an open breaker or, with `fallback_on_device_failure` set,
        failed on the device after its retries or its deadline (the
        single path retries it and may fall back; its metrics carry
        "batch_error"). An admission shed, and any other failure, raises.
        Results come back in input order; `runner.last_metrics`
        then holds each statement's metrics under "statements"."""
        return self.sql_batch_ids(queries)[0]

    def sql_batch_ids(self, queries, traceparent: str | None = None):
        """sql_batch plus each statement's query id (parallel to the
        results; "-" for a statement verb), the id its records carry. A
        valid W3C `traceparent` covers every statement of the
        submission."""
        tp = parse_traceparent(traceparent)
        with use_traceparent(tp["traceparent"] if tp else None):
            return self._sql_batch_ids_inner(queries, tp)

    def _sql_batch_ids_inner(self, queries, tp: dict | None = None):
        queries = list(queries)
        outs: list = [None] * len(queries)
        plans: dict[int, object] = {}
        groups: dict[str, list[int]] = {}
        metrics: list = [{} for _ in queries]
        # one query id per statement, minted up front so that the fused
        # legs' records stay attributable
        qids = [self.tracer.new_query_id() for _ in queries]
        batch_errors: dict[int, str] = {}
        self._nested = []
        with self.tracer.trace("sql_batch") as root:
            root.set(statements=len(queries))
            if tp is not None:
                root.set(traceparent=tp["traceparent"],
                         trace_id=tp["trace_id"],
                         parent_span_id=tp["parent_id"])
            for i, q in enumerate(queries):
                verb = _match_verb(q)
                if verb is not None:
                    # statement verbs and sys.* introspection leave no
                    # history record: "-" keeps the id list positional
                    outs[i], qids[i] = verb(self), "-"
                    continue
                if _SYS_HINT_RE.search(q):
                    from tpu_olap_torch.planner.sqlparse import parse_sql
                    try:
                        stmt = parse_sql(q)
                    except Exception:
                        stmt = None  # the plan span raises it properly
                    if stmt is not None \
                            and stmt_uses_sys(stmt, self.catalog):
                        outs[i] = self._execute_sys_stmt(stmt)
                        qids[i] = "-"
                        continue
                with root.span("plan", query_id=qids[i]):
                    plan = self.planner.plan(q)
                if plan.rewritten and self.cubes.active:
                    # cube-covered statements are served at once and
                    # never join a fused base-table scan they do not need
                    with use_query_id(qids[i]):
                        res = try_serve_cube(self, plan)
                    if res is not None:
                        outs[i] = self._frame_from(plan, res)
                        metrics[i] = res.metrics
                        self.last_plan = plan
                        continue
                plans[i] = plan
                if plan.rewritten and \
                        getattr(plan.stmt, "grouping_sets", None) is None:
                    groups.setdefault(plan.entry.name, []).append(i)
            for name, idxs in groups.items():
                if len(idxs) < 2:
                    continue
                try:
                    boxed = self.runner._execute_batch_boxed(
                        [plans[i].query for i in idxs],
                        self.catalog.get(name).segments,
                        [qids[i] for i in idxs])
                except QueryShed:
                    # a shed aborts the whole submission: every statement
                    # without a result yet is a served failure
                    self._observe_unserved(outs)
                    raise
                for i, b in zip(idxs, boxed):
                    if isinstance(b, BaseException):
                        if not _single_path_serves(b, self.config):
                            self._observe_unserved(outs)
                            raise b
                        batch_errors[i] = f"{type(b).__name__}: {b}"
                        continue
                    outs[i] = self._frame_from(plans[i], b)
                    metrics[i] = b.metrics
            for i, plan in plans.items():
                if outs[i] is not None:
                    continue
                # single statements run inside the sql_batch trace but
                # record under their own ids
                with use_query_id(qids[i]):
                    try:
                        outs[i] = self._execute_plan(plan)
                    except Exception as e:
                        if _failure_status(e) >= 429:
                            self._observe_unserved(
                                outs, skip=i if getattr(
                                    e, "_slo_observed", False) else None)
                        raise
                metrics[i] = self.runner.last_metrics
                if i in batch_errors:
                    metrics[i]["batch_error"] = batch_errors[i]
            if plans:
                self.last_plan = plans[max(plans)]
        self.runner.last_metrics = {"route": "sql_batch",
                                    "statements": metrics}
        return outs, qids

    def _observe_unserved(self, outs, skip=None):
        """A submission aborted: count each statement without a result
        (but `skip`, whose own record counted it) as a failure."""
        for j, o in enumerate(outs):
            if o is None and j != skip:
                self.runner.slo.observe(0.0, failed=True)

    def _frame_from(self, plan, res: QueryResult) -> pd.DataFrame:
        cols = {}
        for o in plan.outputs:
            vals = [r.get(o.source) for r in res.rows]
            if o.cast == "int":
                vals = [int(v) if v is not None else None for v in vals]
            elif o.cast == "datetime":
                # naive UTC timestamps, matching pandas semantics
                vals = pd.to_datetime(vals, utc=True).tz_localize(None)
            cols[o.name] = vals
        return pd.DataFrame(cols, columns=[o.name for o in plan.outputs])

    def explain(self, query: str) -> dict:
        """EXPLAIN DRUID REWRITE analog: the chosen QuerySpec (or the
        fallback reason) without executing (SURVEY.md §4.5), plus the
        cost model's merge decision for an aggregate ("cost",
        planner.cost, at the configured num_shards; the reference logs
        its DruidQueryCostModel choice the same way, SURVEY.md §6)."""
        plan = self.planner.plan(query)
        out = plan.explain()
        if plan.rewritten and plan.entry.is_accelerated:
            from tpu_olap_torch.executor.lowering import lower
            from tpu_olap_torch.planner import cost as cost_mod
            try:
                phys = lower(plan.query, plan.entry.segments, self.config)
                if phys.kind == "agg":  # a scan has no merge to choose
                    out["cost"] = cost_mod.decide(
                        phys, self.config,
                        self.config.num_shards or 1).to_json()
            except _UNSUPPORTED as e:
                out["cost"] = {"error": str(e)}
        return out

    # -------------------------------------------------------- passthrough

    def execute_ir(self, query) -> QueryResult:
        """Raw query-IR passthrough (`ON DRUID DATASOURCE ds EXECUTE QUERY
        '<json>'`): accepts a QuerySpec or Druid-shaped JSON dict; every
        query type."""
        if isinstance(query, dict):
            query = query_from_json(query)
        entry = self.catalog.get(query.data_source)
        if not entry.is_accelerated:
            raise ValueError(
                f"table {query.data_source!r} is not accelerated")
        # the root trace gives the runner's records and the boundary
        # accounting below one query id. The raw-IR path has no
        # fallback: a propagating failure is the served response and
        # counts against the SLO here (the runner's failed record is
        # interim), with its terminal `query` event
        with self.tracer.trace("ir", datasource=query.data_source):
            try:
                return self.runner.execute(query, entry.segments)
            except (QueryShed, BreakerOpen):
                self.runner.slo.observe(0.0, failed=True)
                raise
            except Exception:
                self.runner.slo.observe(0.0, failed=True)
                self.runner.events.emit(
                    "query",
                    query_id=current_query_id()
                    or self.tracer.new_query_id(),
                    query_type=getattr(query, "query_type", "?"),
                    path="raw_ir", datasource=query.data_source,
                    total_ms=0.0, cache_hit=False, failed=True)
                raise

    def select_page(self, table: str, columns=None, page_size: int = 100,
                    offset: int = 0, descending: bool = False,
                    filter_spec=None, intervals=()):
        """Paged Select (SURVEY.md §3.3 SelectSpec): one page of raw rows
        plus the paging offset to pass back for the next page. Returns
        (rows, next_offset). The SQL spellings LIMIT/OFFSET map to Scan;
        this is the resumable-cursor flavor."""
        q = SelectQuerySpec(
            data_source=table, intervals=tuple(intervals),
            filter=filter_spec,
            dimensions=tuple(columns or ()), metrics=(),
            page_size=page_size, paging_offset=offset,
            descending=descending)
        res = self.execute_ir(q)
        return res.rows, offset + len(res.rows)

    # -------------------------------------------------------------- admin

    def clear_cache(self, table: str | None = None):
        """CLEAR DRUID CACHE analog: drop the device-resident columns and
        memoized plans of one table, or of every table (catalog entries
        stay registered)."""
        with self.device_lock:
            self.runner.clear_cache(table)

    def drop_table(self, name: str):
        """DROP the datasource: purge its resident columns, memoized
        plans, cap hints and both result-cache tiers, unregister it,
        delete its delta, WAL and checkpoint store, and drop the cubes
        over it with their storage tables. A later registration under the
        same name starts from nothing."""
        with self.device_lock:
            self.runner.clear_cache(name)
        self.catalog.drop(name)
        # ingest cascade: the delta state dies with the table, and its
        # WAL and checkpoint store are deleted
        self.ingest.on_drop(name)
        self.cubes.on_table_dropped(name)
        self.runner.events.emit("drop", table=name)

    # -------------------------------------------------------------- cubes

    def create_cube(self, spec):
        """Materialize a rollup cube. `spec` is a CubeSpec or its JSON
        dict: {name, datasource, dimensions, granularity,
        aggregations[, virtualColumns]} — the payload `CREATE DRUID
        CUBES FROM '<file>'` reads and `cube_specs_from_workload`
        writes. Builds synchronously on the device; returns the
        registry entry. A failed build raises and is recorded on the
        entry."""
        return self.cubes.create(spec)

    def drop_cube(self, name: str) -> bool:
        """DROP DRUID CUBE analog: unregister the cube and its backing
        segment table. Returns False when no such cube exists."""
        return self.cubes.drop(name)

    # ------------------------------------------------------ observability

    @property
    def history(self):
        """Per-statement records (the runner's bounded history ring)."""
        return self.runner.history

    def counters(self) -> dict:
        """Aggregate counters, kept incrementally at record time: exact
        after history-ring eviction."""
        return self.runner.counters()


def _single_path_serves(err: BaseException, config) -> bool:
    """Whether a boxed batch leg's failure goes to the single-query path
    (which retries it, and falls back as `_execute_plan` says) rather
    than out of sql_batch."""
    if isinstance(err, _UNSUPPORTED + (BreakerOpen,)):
        return True
    return isinstance(err, Exception) and not isinstance(err, QueryShed) \
        and config.fallback_on_device_failure


# --------------------------------------------------------------------------
# Statement-level verbs (the reference's SparklineDataParser additions)

_CLEAR_RE = re.compile(
    r"^\s*clear\s+druid\s+cache(?:\s+(\w+))?\s*;?\s*$", re.I)
_EXPLAIN_RE = re.compile(
    r"^\s*explain\s+druid\s+rewrite\s+(.+?)\s*;?\s*$", re.I | re.S)
_EXPLAIN_ANALYZE_RE = re.compile(
    r"^\s*explain\s+analyze\s+(.+?)\s*;?\s*$", re.I | re.S)
_EXEC_RE = re.compile(
    r"^\s*on\s+druid\s+datasource\s+(\w+)\s+execute\s+query\s+"
    r"'(.+)'\s*;?\s*$", re.I | re.S)
_SEARCH_RE = re.compile(
    r"^\s*search\s+druid\s+datasource\s+(\w+)\s+for\s+'((?:[^']|'')*)'"
    r"(?:\s+in\s+([\w\s,]+?))?(?:\s+limit\s+(\d+))?\s*;?\s*$", re.I)
# rollup-cube DDL: CREATE DRUID CUBE <name> ON <table> [DIMENSIONS (a, b)]
# [GRANULARITY g] AGGREGATES (sum(x), ...); CREATE DRUID CUBES FROM
# '<specs.json>'; DROP DRUID CUBE <name>; REFRESH DRUID CUBES
_CREATE_CUBE_RE = re.compile(
    r"^\s*create\s+druid\s+cube\s+(\w+)\s+on\s+(\w+)\s+(.*?)\s*;?\s*$",
    re.I | re.S)
_CREATE_CUBES_FROM_RE = re.compile(
    r"^\s*create\s+druid\s+cubes\s+from\s+'((?:[^']|'')+)'\s*;?\s*$",
    re.I)
_DROP_CUBE_RE = re.compile(
    r"^\s*drop\s+druid\s+cube\s+(\w+)\s*;?\s*$", re.I)
_REFRESH_CUBES_RE = re.compile(
    r"^\s*refresh\s+druid\s+cubes\s*;?\s*$", re.I)
# real-time ingest verbs: INSERT INTO t (a, b) VALUES (...), (...) and
# COMPACT DRUID TABLE t, the SQL spellings of Engine.append and
# Engine.compact_now; CHECKPOINT DRUID TABLE t spills the sealed scope to
# the durable segment store and truncates the WAL (Engine.checkpoint_now)
_INSERT_RE = re.compile(
    r"^\s*insert\s+into\s+(\w+)\s*\(([^)]*)\)\s*values\s*(.+?)\s*;?\s*$",
    re.I | re.S)
_COMPACT_RE = re.compile(
    r"^\s*compact\s+druid\s+table\s+(\w+)\s*;?\s*$", re.I)
_CHECKPOINT_RE = re.compile(
    r"^\s*checkpoint\s+druid\s+table\s+(\w+)\s*;?\s*$", re.I)


# cheap pre-parse hint that a statement MIGHT reference a sys.* virtual
# datasource (catalog.systables): a match still confirms against the
# parsed tree before taking the introspection path
_SYS_HINT_RE = re.compile(r"\bsys\.[A-Za-z_]\w*", re.I)


def _match_verb(query: str):
    m = _CLEAR_RE.match(query)
    if m:
        table = m.group(1)
        return lambda eng: _run_clear(eng, table)
    m = _EXPLAIN_RE.match(query)
    if m:
        inner = m.group(1)
        return lambda eng: _run_explain(eng, inner)
    m = _EXPLAIN_ANALYZE_RE.match(query)
    if m:
        inner = m.group(1)
        return lambda eng: _run_explain_analyze(eng, inner)
    m = _EXEC_RE.match(query)
    if m:
        ds, body = m.group(1), m.group(2).replace("''", "'")
        return lambda eng: _run_passthrough(eng, ds, body)
    m = _SEARCH_RE.match(query)
    if m:
        ds, pat = m.group(1), m.group(2).replace("''", "'")
        dims = tuple(d.strip() for d in m.group(3).split(",")) \
            if m.group(3) else ()
        limit = int(m.group(4)) if m.group(4) else 1000
        return lambda eng: _run_search_verb(eng, ds, pat, dims, limit)
    m = _CREATE_CUBE_RE.match(query)
    if m:
        name, base, clauses = m.group(1), m.group(2), m.group(3)
        return lambda eng: _run_create_cube(eng, name, base, clauses)
    m = _CREATE_CUBES_FROM_RE.match(query)
    if m:
        path = m.group(1).replace("''", "'")
        return lambda eng: _run_create_cubes_from(eng, path)
    m = _DROP_CUBE_RE.match(query)
    if m:
        name = m.group(1)
        return lambda eng: _run_drop_cube(eng, name)
    if _REFRESH_CUBES_RE.match(query):
        return _run_refresh_cubes
    m = _INSERT_RE.match(query)
    if m:
        table, cols, values = m.group(1), m.group(2), m.group(3)
        return lambda eng: _run_insert(eng, table, cols, values)
    m = _COMPACT_RE.match(query)
    if m:
        table = m.group(1)
        return lambda eng: _run_compact(eng, table)
    m = _CHECKPOINT_RE.match(query)
    if m:
        table = m.group(1)
        return lambda eng: _run_checkpoint(eng, table)
    return None


_TS_LITERAL_RE = re.compile(r"^timestamp\s+'((?:[^']|'')*)'$", re.I)


def _parse_sql_literal(tok: str):
    """One VALUES literal -> python scalar: NULL, TRUE/FALSE, numbers,
    'string' ('' escapes), TIMESTAMP 'iso'."""
    t = tok.strip()
    up = t.upper()
    if up == "NULL":
        return None
    if up == "TRUE":
        return 1
    if up == "FALSE":
        return 0
    m = _TS_LITERAL_RE.match(t)
    if m:
        return m.group(1).replace("''", "'")
    if t.startswith("'"):
        if not t.endswith("'") or len(t) < 2:
            raise UserError(f"unterminated string literal {tok!r}")
        return t[1:-1].replace("''", "'")
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        raise UserError(
            f"cannot parse INSERT literal {tok!r}") from None


def _run_insert(eng: Engine, table: str, cols: str,
                values: str) -> pd.DataFrame:
    """INSERT INTO t (a, b, ...) VALUES (...), (...) — the SQL spelling
    of Engine.append. Literal lists are quote-aware
    (strings may contain commas/parens); every tuple must match the
    column list's arity."""
    names = [c.strip() for c in cols.split(",") if c.strip()]
    if not names:
        raise UserError("INSERT INTO needs a column list")
    rows = []
    for tup in _split_top_commas(values):
        t = tup.strip()
        if not (t.startswith("(") and t.endswith(")")):
            raise UserError(
                f"INSERT VALUES expects parenthesized tuples, got "
                f"{t[:40]!r}")
        items = _split_top_commas(t[1:-1])
        if len(items) != len(names):
            raise UserError(
                f"INSERT tuple has {len(items)} values for "
                f"{len(names)} columns")
        rows.append({n: _parse_sql_literal(v)
                     for n, v in zip(names, items)})
    out = eng.append(table, rows)
    return pd.DataFrame([{
        "table": table, "rows": out["rows"],
        "delta_rows": out["delta_rows"],
        "generation": out["generation"],
        "wal_seq": out["wal_seq"]}])


def _run_compact(eng: Engine, table: str) -> pd.DataFrame:
    res = eng.compact_now(table)
    if res is None:
        return pd.DataFrame([{"table": table, "status": "empty-delta",
                              "rows_sealed": 0, "ms": 0.0}])
    if res.get("status") != "compacted":
        # skipped, not empty: a compaction already in flight or the
        # breaker is open — the operator should retry
        return pd.DataFrame([{"table": table, "status": res["status"],
                              "rows_sealed": 0, "ms": 0.0}])
    return pd.DataFrame([{
        "table": table, "status": "compacted",
        "rows_sealed": res["rows_sealed"],
        "ms": round(res["ms"], 3)}])


def _run_checkpoint(eng: Engine, table: str) -> pd.DataFrame:
    """CHECKPOINT DRUID TABLE t: compact + spill
    + manifest advance + WAL truncation, reported honestly — `status`
    is `checkpointed`, `noop` (sealed scope unchanged since the last
    manifest), `busy`, `no-store` (ingest_store_dir unset), or `error`
    (from the compaction's auto-hook)."""
    res = eng.checkpoint_now(table)
    return pd.DataFrame([{
        "table": table, "status": res.get("status"),
        "checkpoint_id": res.get("checkpoint_id"),
        "segments": res.get("segments"),
        "files_written": res.get("files_written"),
        "chunks_reused": res.get("chunks_reused"),
        "bytes": res.get("bytes"),
        "wal_frames_truncated": res.get("wal_frames_truncated"),
        "ms": round(res.get("ms") or 0.0, 3)}])


def _run_clear(eng: Engine, table: str | None) -> pd.DataFrame:
    eng.clear_cache(table)
    return pd.DataFrame({"status": [
        f"cleared cache for {table}" if table else "cleared cache"]})


def _run_explain(eng: Engine, inner_sql: str) -> pd.DataFrame:
    info = eng.explain(inner_sql)
    lines = json.dumps(info, indent=2, default=str).splitlines()
    return pd.DataFrame({"plan": lines})


def _run_explain_analyze(eng: Engine, inner_sql: str) -> pd.DataFrame:
    """EXPLAIN ANALYZE <sql>: RUNS the statement and returns its span
    tree as rows (one per span, indented by depth; the attributes as a
    JSON detail column). Stage spans are wall-clock children of the
    root, so they sum to within its total."""
    frame, trace = eng._sql_traced(inner_sql)
    if trace is None:
        return pd.DataFrame({
            "span": ["(no trace: tracing disabled or statement verb)"],
            "ms": [0.0], "detail": ["{}"]})
    rows = []
    for depth, s in trace.walk():
        detail = dict(s.attrs)
        if depth == 0:
            detail["query_id"] = trace.query_id
            detail["rows_returned"] = len(frame)
        rows.append({"span": ("  " * depth) + s.name,
                     "ms": round(s.duration_ms or 0.0, 3),
                     "detail": json.dumps(detail, default=str)})
    return pd.DataFrame(rows, columns=["span", "ms", "detail"])


def _run_passthrough(eng: Engine, datasource: str, body: str) -> pd.DataFrame:
    spec = json.loads(body)
    spec.setdefault("dataSource", datasource)
    return eng.execute_ir(spec).to_pandas()


def _run_search_verb(eng: Engine, datasource: str, pattern: str,
                     dims: tuple, limit: int) -> pd.DataFrame:
    """SEARCH DRUID DATASOURCE t FOR 'pat' [IN d1, d2] [LIMIT n] — the
    SQL spelling of SearchQuerySpec (SURVEY.md §3.3)."""
    q = SearchQuerySpec(
        data_source=datasource, intervals=(),
        search_dimensions=dims,
        query=SearchQueryContains(pattern, case_sensitive=False),
        limit=limit)
    return eng.execute_ir(q).to_pandas()


# ------------------------------------------------------------- cube DDL

_CUBE_CLAUSE_RE = re.compile(
    r"(dimensions|aggregates|granularity)\b\s*", re.I)


def _scan_quote(s: str, i: int) -> int:
    """Index just past the SQL string literal starting at s[i] == "'"
    ('' is the escape). Unterminated -> len(s)."""
    i += 1
    n = len(s)
    while i < n:
        if s[i] == "'":
            if i + 1 < n and s[i + 1] == "'":
                i += 2
                continue
            return i + 1
        i += 1
    return n


def _split_top_commas(s: str) -> list[str]:
    """Comma split at paren depth 0, quote-aware (aggregate lists nest
    parens, and filter literals may contain commas/parens)."""
    out, depth, cur, i, n = [], 0, [], 0, len(s)
    while i < n:
        ch = s[i]
        if ch == "'":
            j = _scan_quote(s, i)
            cur.append(s[i:j])
            i = j
            continue
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
        i += 1
    tail = "".join(cur).strip()
    if tail:
        out.append(tail)
    return out


def _parse_cube_clauses(clauses: str) -> dict:
    """DIMENSIONS (...) / GRANULARITY g / AGGREGATES (...) in any
    order -> spec fields. Parenthesized lists are matched by depth so
    aggregate expressions may contain commas and parens."""
    out = {"dimensions": (), "granularity": "all", "aggregations": ()}
    i, n = 0, len(clauses)
    while i < n:
        m = _CUBE_CLAUSE_RE.match(clauses, i)
        if m is None:
            if clauses[i].isspace():
                i += 1
                continue
            raise UserError(
                f"cannot parse CREATE DRUID CUBE clause at "
                f"{clauses[i:i + 40]!r}")
        kw = m.group(1).lower()
        i = m.end()
        if kw == "granularity":
            g = re.match(r"\s*(\w+)", clauses[i:])
            if g is None:
                raise UserError("GRANULARITY needs a grain name")
            out["granularity"] = g.group(1)
            i += g.end()
            continue
        j = clauses.find("(", i)
        if j < 0 or clauses[i:j].strip():
            # junk between the keyword and its list must not silently
            # drop items (DIMENSIONS cat (region) would lose `cat`)
            raise UserError(f"{kw.upper()} needs a parenthesized list")
        depth, k = 0, j
        while k < n:
            c = clauses[k]
            if c == "'":
                # parens/commas inside a filter literal (e.g.
                # FILTER (WHERE cat = 'a)')) are text, not structure
                k = _scan_quote(clauses, k)
                continue
            if c == "(":
                depth += 1
            elif c == ")":
                depth -= 1
                if depth == 0:
                    break
            k += 1
        if depth != 0:
            raise UserError(f"unbalanced parens in {kw.upper()} list")
        items = _split_top_commas(clauses[j + 1:k])
        if kw == "dimensions":
            out["dimensions"] = tuple(items)
        else:
            out["aggregations"] = tuple(items)
        i = k + 1
    return out


def _cube_status_frame(rows) -> pd.DataFrame:
    return pd.DataFrame(rows, columns=["cube", "status", "detail"])


def _run_create_cube(eng: Engine, name, base, clauses) -> pd.DataFrame:
    from tpu_olap_torch.cubes import CubeSpec
    fields = _parse_cube_clauses(clauses)
    spec = CubeSpec(name=name, datasource=base, source="ddl", **fields)
    entry = eng.create_cube(spec)
    return _cube_status_frame([{
        "cube": name, "status": entry.status,
        "detail": f"{entry.data.n_rows} rows @ {spec.granularity} "
                  f"in {entry.build_ms:.0f} ms"}])


def _run_create_cubes_from(eng: Engine, path: str) -> pd.DataFrame:
    """CREATE DRUID CUBES FROM '<file.json>': materialize every spec in
    the file (a list, or {"cubes": [...]} — the exact artifact
    cubes.cube_specs_from_workload writes). Per-spec isolation:
    one bad spec reports its error without aborting the rest."""
    with open(path) as f:
        payload = json.load(f)
    specs = payload.get("cubes", payload) if isinstance(payload, dict) \
        else payload
    if not isinstance(specs, list):
        raise UserError(f"{path!r}: expected a list of cube specs")
    rows = []
    for s in specs:
        cname = (s or {}).get("name", "?") if isinstance(s, dict) else "?"
        try:
            entry = eng.create_cube(s)
            rows.append({"cube": entry.spec.name,
                         "status": entry.status,
                         "detail": f"{entry.data.n_rows} rows in "
                                   f"{entry.build_ms:.0f} ms"})
        except Exception as e:  # noqa: BLE001 — per-spec isolation
            rows.append({"cube": cname, "status": "error",
                         "detail": str(e)[:300]})
    return _cube_status_frame(rows)


def _run_drop_cube(eng: Engine, name: str) -> pd.DataFrame:
    found = eng.drop_cube(name)
    return _cube_status_frame([{
        "cube": name, "status": "dropped" if found else "absent",
        "detail": ""}])


def _run_refresh_cubes(eng: Engine) -> pd.DataFrame:
    results = eng.cubes.refresh_now()
    if not results:
        return _cube_status_frame([])
    return _cube_status_frame([
        {"cube": n, "status": "ok" if r == "ok" else "error",
         "detail": "" if r == "ok" else r}
        for n, r in sorted(results.items())])

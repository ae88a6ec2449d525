"""Engine — the API surface (SURVEY.md §3.1): table registration (the
DefaultSource OPTIONS analog), the SQL entry point, the raw-IR
passthrough, paged Select, EXPLAIN and the statement verbs of the
reference's extended parser (`CLEAR DRUID CACHE`, `EXPLAIN DRUID
REWRITE`, `ON DRUID DATASOURCE … EXECUTE QUERY`, `SEARCH DRUID
DATASOURCE`).

Statements the planner rewrites run on the device path. A statement it
does not rewrite needs the pandas fallback interpreter, which is not
ported yet: it raises `FallbackNotPorted`; so do the verbs of subsystems
not ported yet (cube DDL, INSERT, COMPACT, CHECKPOINT, EXPLAIN ANALYZE:
`NotYetPorted`, naming the ROADMAP item). A failure on the card
propagates — nothing reroutes a query off the device.
"""

from __future__ import annotations

import dataclasses
import json
import re

import pandas as pd

from tpu_olap_torch.catalog import Catalog, StarSchema, TableEntry
from tpu_olap_torch.executor.config import EngineConfig
from tpu_olap_torch.executor.runner import QueryResult, QueryRunner
from tpu_olap_torch.ir.query import (SearchQueryContains, SearchQuerySpec,
                                     SelectQuerySpec)
from tpu_olap_torch.ir.serde import query_from_json
from tpu_olap_torch.planner import DruidPlanner, FallbackNotPorted


class NotYetPorted(NotImplementedError):
    """A statement verb of a subsystem the port does not have yet."""
from tpu_olap_torch.segments.ingest import DEFAULT_BLOCK_ROWS, ingest_arrow


class Engine:
    """Engine(config) or Engine(**config fields), e.g.
    Engine(device="cpu")."""

    def __init__(self, config: EngineConfig | None = None, **overrides):
        config = config or EngineConfig()
        self.config = dataclasses.replace(config, **overrides) \
            if overrides else config
        self.catalog = Catalog()
        self.runner = QueryRunner(self.config)
        self.planner = DruidPlanner(self.catalog, self.config)
        self.last_plan = None

    # ------------------------------------------------------- registration

    def register_table(self, name: str, data, time_column: str | None = None,
                       star_schema=None, accelerate: bool = True,
                       block_rows: int = DEFAULT_BLOCK_ROWS,
                       time_partition="auto", segments=None, **options):
        """Register a datasource from a pandas DataFrame. accelerate=False
        registers a plain (dimension) table — the reference's
        non-druid-backed relation, served only by the fallback
        interpreter (not ported yet).

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
        if not accelerate:
            segments = None
        elif segments is None:
            import pyarrow as pa
            segments = ingest_arrow(
                name, pa.Table.from_pandas(data, preserve_index=False),
                time_column, block_rows, time_partition=time_partition)
        star = star_schema
        if isinstance(star, dict):
            star = StarSchema.from_json(star)
        if segments is not None:
            segments.star = star  # FD-aware dim-domain restriction
        entry = TableEntry(name=name, segments=segments,
                           frame_source=data, time_column=time_column,
                           star=star, options=dict(options))
        self.catalog.register(entry)
        self.runner.clear_cache(name)
        return entry

    # ---------------------------------------------------------------- SQL

    def sql(self, query: str) -> pd.DataFrame:
        """Plan, execute on the device path, and return a DataFrame.

        Statement verbs beyond SELECT (SURVEY.md §3.1): `CLEAR DRUID
        CACHE [table]`, `EXPLAIN DRUID REWRITE <sql>`, `ON DRUID
        DATASOURCE <ds> EXECUTE QUERY '<json>'` and `SEARCH DRUID
        DATASOURCE <ds> FOR '<text>' [IN d1, d2] [LIMIT n]`."""
        verb = _match_verb(query)
        if verb is not None:
            return verb(self)
        plan = self.planner.plan(query)
        self.last_plan = plan
        return self._execute_plan(plan)

    def _execute_plan(self, plan) -> pd.DataFrame:
        if not plan.rewritten:
            raise FallbackNotPorted(
                f"not yet ported: fallback interpreter "
                f"({plan.fallback_reason})")
        if not plan.entry.is_accelerated:
            raise FallbackNotPorted(
                f"not yet ported: fallback interpreter (table "
                f"{plan.entry.name!r} is not accelerated)")
        res = self.runner.execute(plan.query, plan.entry.segments)
        return self._frame_from(plan, res)

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
        fallback reason) without executing (SURVEY.md §4.5). The JAX
        package adds the cost model's dispatch decision ("cost"), which
        waits for planner/cost.py (not ported yet)."""
        return self.planner.plan(query).explain()

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
        return self.runner.execute(query, entry.segments)

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
        self.runner.clear_cache(table)


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
# verbs of subsystems the port does not have yet: (pattern, what, where
# the ROADMAP queues it)
_NOT_PORTED = (
    (re.compile(r"^\s*(create|drop|refresh)\s+druid\s+cubes?\b", re.I),
     "rollup-cube DDL", "queue A item 11 (caches and cubes)"),
    (re.compile(r"^\s*insert\s+into\s", re.I),
     "INSERT (real-time ingest)", "queue A item 12 (ingest)"),
    (re.compile(r"^\s*compact\s+druid\s+table\b", re.I),
     "COMPACT DRUID TABLE", "queue A item 12 (ingest)"),
    (re.compile(r"^\s*checkpoint\s+druid\s+table\b", re.I),
     "CHECKPOINT DRUID TABLE", "queue A item 12 (durable store)"),
    (_EXPLAIN_ANALYZE_RE, "EXPLAIN ANALYZE (query tracing)",
     "queue A item 14 (surface and tooling)"),
)


def _match_verb(query: str):
    m = _CLEAR_RE.match(query)
    if m:
        table = m.group(1)
        return lambda eng: _run_clear(eng, table)
    m = _EXPLAIN_RE.match(query)
    if m:
        inner = m.group(1)
        return lambda eng: _run_explain(eng, inner)
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
    for pattern, what, item in _NOT_PORTED:
        if pattern.match(query):
            raise NotYetPorted(f"not yet ported: {what}; see ROADMAP.md "
                               f"{item}")
    return None


def _run_clear(eng: Engine, table: str | None) -> pd.DataFrame:
    eng.clear_cache(table)
    return pd.DataFrame({"status": [
        f"cleared cache for {table}" if table else "cleared cache"]})


def _run_explain(eng: Engine, inner_sql: str) -> pd.DataFrame:
    info = eng.explain(inner_sql)
    lines = json.dumps(info, indent=2, default=str).splitlines()
    return pd.DataFrame({"plan": lines})


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

"""DruidPlanner analog: SELECT statement -> QuerySpec (or fallback).

Implements the reference's rewrite pipeline in its order (SURVEY.md §4.2):
join collapse against the declared star schema, projection/filter pushdown
with interval extraction (IntervalConditionExtractor), aggregate
translation (AVG -> sum/count post-agg, COUNT DISTINCT -> HLL cardinality,
sum over expressions -> virtual columns), and limit/topN selection
(allowTopN). Any non-expressible construct raises RewriteError, which the
engine turns into transparent pandas-fallback execution — never an error
(SURVEY.md §2 property 2).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from tpu_olap_torch.catalog.catalog import TableEntry
from tpu_olap_torch.ir import filters as F
from tpu_olap_torch.ir.aggregations import (CardinalityAggregation,
                                            CountAggregation, MaxAggregation,
                                            MinAggregation, SumAggregation,
                                            ThetaSketchAggregation)
from tpu_olap_torch.ir.dimensions import (DefaultDimensionSpec,
                                          ExtractionDimensionSpec,
                                          TimeFormatExtractionFn, VirtualColumn)
from tpu_olap_torch.ir.expr import BinOp, Col, Expr, FuncCall, Lit
from tpu_olap_torch.ir.granularity import AllGranularity, PeriodGranularity
from tpu_olap_torch.ir.interval import ETERNITY, Interval
from tpu_olap_torch.ir.limit import LimitSpec, OrderByColumnSpec
from tpu_olap_torch.ir.having import (AndHaving, EqualToHaving, GreaterThanHaving,
                                      LessThanHaving, NotHaving, OrHaving)
from tpu_olap_torch.ir.postaggs import (ArithmeticPostAgg, ConstantPostAgg,
                                        FieldAccessPostAgg)
from tpu_olap_torch.ir.query import (GroupByQuerySpec, ScanQuerySpec,
                                     TimeseriesQuerySpec, TopNQuerySpec)
from tpu_olap_torch.planner.exprutil import (contains_agg as _contains_agg,
                                             expr_key as _key, render as _render,
                                             split_and as _split_and)
from tpu_olap_torch.planner.sqlparse import (AGG_FUNCS, OrderItem, SelectStmt,
                                             parse_sql)
from tpu_olap_torch.segments.segment import ColumnType, TIME_COLUMN
from tpu_olap_torch.utils import timeutil


class RewriteError(Exception):
    """Query shape not expressible on the device path -> fallback."""


_CMP = ("==", "!=", "<", "<=", ">", ">=")
_TIME_FUNCS = {"year": ("YYYY", "int"), "month": ("MM", "int"),
               "day": ("dd", "int"), "dayofmonth": ("dd", "int"),
               "quarter": ("Q", "int"), "hour": ("HH", "int"),
               "minute": ("mm", "int"), "second": ("ss", "int")}
_TRUNC_UNITS = {"second": "PT1S", "minute": "PT1M", "hour": "PT1H",
                "day": "P1D", "week": "P1W", "month": "P1M",
                "quarter": "P3M", "year": "P1Y"}
# scalar functions the device expression evaluator implements
# (kernels.exprs._call) — anything else in a virtual column or expression
# filter must fall back BEFORE dispatch, not die inside the kernel
_DEVICE_FUNCS = {"abs", "floor", "ceil", "sqrt", "log", "exp", "pow", "if",
                 "min", "max", "least", "greatest", "cast_long",
                 "cast_double"}


@dataclass
class OutputColumn:
    name: str           # SQL output name
    source: str         # key in executor result rows
    cast: str | None = None  # None | "int" | "datetime"


@dataclass
class PlanResult:
    stmt: SelectStmt
    entry: TableEntry
    query: object = None            # QuerySpec when rewritten
    outputs: list = field(default_factory=list)
    fallback_reason: str | None = None
    sql: str | None = None

    @property
    def rewritten(self) -> bool:
        return self.query is not None

    def explain(self) -> dict:
        """The `EXPLAIN DRUID REWRITE` payload (SURVEY.md §4.5)."""
        if self.rewritten:
            return {"rewritten": True, "datasource": self.entry.name,
                    "query": self.query.to_json(),
                    "outputs": [o.name for o in self.outputs]}
        return {"rewritten": False, "reason": self.fallback_reason,
                "table": self.entry.name if self.entry is not None
                else self.stmt.table}


def _outside_subset(stmt) -> str | None:
    """'subquery' / 'window function' when the statement contains a
    construct the rewrite rules don't cover, else None."""
    from tpu_olap_torch.ir.expr import Subquery, WindowCall

    def walk(e):
        if isinstance(e, Subquery):
            return "subquery"
        if isinstance(e, WindowCall):
            return "window function"
        if isinstance(e, BinOp):
            return walk(e.left) or walk(e.right)
        if isinstance(e, FuncCall):
            if e.name == "in_subquery":
                return "subquery"
            for a in e.args:
                r = walk(a)
                if r:
                    return r
        return None

    exprs = ([e for e, _ in stmt.projections] + stmt.group_by
             + [stmt.where, stmt.having]
             + [o.expr for o in stmt.order_by]
             + [j.on for j in stmt.joins])
    for e in exprs:
        if e is not None:
            r = walk(e)
            if r:
                return r
    return None


_FALLBACK_FUNCS = ("corr_scalar_map", "corr_exists_map", "corr_in_map",
                   "corr_exists_cmp_map")


def _scan_stmt_nodes(stmt):
    """One traversal over every expression-bearing clause (via
    map_stmt_exprs, the shared walker — incl. grouping_sets) collecting
    what subquery inlining needs to know up front: nested SELECTs,
    window-function presence (inlining would be discarded, so don't
    execute anything), and decorrelated corr_* map nodes (only the
    fallback evaluator applies those). Returns (substmts, has_window,
    has_corr_nodes)."""
    from tpu_olap_torch.ir.expr import Subquery, WindowCall
    from tpu_olap_torch.planner.exprutil import map_stmt_exprs
    subs: list = []
    flags = {"window": False, "corr": False}

    def visit(e):
        if isinstance(e, Subquery):
            subs.append(e.stmt)
        elif isinstance(e, WindowCall):
            flags["window"] = True
            for a in e.args:
                visit(a)
            for p in e.partition_by:
                visit(p)
            for oe, _ in e.order_by:
                visit(oe)
        elif isinstance(e, BinOp):
            visit(e.left)
            visit(e.right)
        elif isinstance(e, FuncCall):
            if e.name in _FALLBACK_FUNCS:
                flags["corr"] = True
            for a in e.args:
                visit(a)
        return e

    map_stmt_exprs(stmt, visit)
    return subs, flags["window"], flags["corr"]


def _apply_windows_over_groups(stmt):
    """Recursive application of the grouped-window rewrite: union parts,
    derived tables (incl. inlined CTEs), and join subqueries each get
    the same treatment as the top-level statement."""
    from tpu_olap_torch.planner.sqlparse import UnionStmt
    if isinstance(stmt, UnionStmt):
        stmt.parts = [_apply_windows_over_groups(p) for p in stmt.parts]
        return stmt
    if stmt.derived is not None:
        stmt.derived = _apply_windows_over_groups(stmt.derived)
    for j in stmt.joins:
        if j.derived is not None:
            j.derived = _apply_windows_over_groups(j.derived)
    return _windows_over_groups(stmt)


def _windows_over_groups(stmt):
    """Standard SQL evaluates window functions AFTER grouping, over the
    grouped rows. The fallback interpreter already evaluates windows
    over derived tables, so a grouped query containing a window rewrites
    to exactly that: an inner SELECT doing the grouping (group keys +
    every aggregate the outer mentions, auto-named), and an outer SELECT
    evaluating the windows over it. `SELECT cat, rank() OVER (ORDER BY
    sum(p) DESC) FROM t GROUP BY cat` becomes `SELECT cat, rank() OVER
    (ORDER BY __a0 DESC) FROM (SELECT cat, sum(p) AS __a0 ... GROUP BY
    cat)`. (The reference served these through Spark SQL, SURVEY.md
    §3.1.)"""
    from tpu_olap_torch.ir.expr import WindowCall
    from tpu_olap_torch.planner.exprutil import contains_window
    from tpu_olap_torch.planner.sqlparse import AGG_FUNCS, SelectStmt

    outer_exprs = [p for p, _ in stmt.projections] \
        + [o.expr for o in stmt.order_by]
    if not stmt.group_by or not any(contains_window(e)
                                    for e in outer_exprs):
        return stmt

    aggs: dict = {}  # expr key -> FuncCall

    def collect(e):
        if isinstance(e, FuncCall) and e.name in AGG_FUNCS:
            aggs.setdefault(_key(e), e)
            return
        if isinstance(e, BinOp):
            collect(e.left)
            collect(e.right)
        elif isinstance(e, WindowCall):
            for a in e.args:
                collect(a)
            for p in e.partition_by:
                collect(p)
            for oe, _ in e.order_by:
                collect(oe)
        elif isinstance(e, FuncCall):
            for a in e.args:
                collect(a)

    for e in outer_exprs:
        collect(e)

    # inner projections: group keys first (plain Cols keep their name,
    # computed keys get stable synthetic names), then the aggregates
    sub: dict = {}  # expr key -> replacement Col
    inner_proj = []
    for i, g in enumerate(stmt.group_by):
        name = g.name if isinstance(g, Col) else f"__g{i}"
        inner_proj.append((g, None if isinstance(g, Col) else name))
        sub[_key(g)] = Col(name)
    for j, (k, a) in enumerate(sorted(aggs.items())):
        inner_proj.append((a, f"__a{j}"))
        sub[k] = Col(f"__a{j}")

    from tpu_olap_torch.ir.expr import map_expr

    def rewrite(e):
        return map_expr(e, lambda x: sub.get(_key(x)))

    inner = SelectStmt(
        projections=inner_proj, table=stmt.table, joins=stmt.joins,
        where=stmt.where, group_by=stmt.group_by, having=stmt.having,
        table_alias=stmt.table_alias, grouping_sets=stmt.grouping_sets,
        derived=stmt.derived)
    outer = SelectStmt(
        # unaliased projections keep the ORIGINAL expression's rendered
        # name — the rewritten tree would leak __a0/__g0 into headers
        projections=[(rewrite(p), alias or _render(p))
                     for p, alias in stmt.projections],
        table="__winagg", derived=inner, distinct=stmt.distinct,
        limit=stmt.limit, offset=stmt.offset)
    for o in stmt.order_by:
        o.expr = rewrite(o.expr)
    outer.order_by = stmt.order_by
    return outer


class DruidPlanner:
    """Registers no global state — one instance per Engine (the reference's
    DruidPlanner(sqlContext) kept per-session rule lists, SURVEY.md §3.2)."""

    def __init__(self, catalog, config):
        self.catalog = catalog
        self.config = config
        # stmt -> DataFrame executor the Engine wires in: lets the
        # planner evaluate uncorrelated subqueries eagerly (device path
        # when rewritable) so the OUTER query can still push down
        self.run_subquery = None

    def plan(self, sql: str) -> PlanResult:
        return self.plan_stmt(parse_sql(sql), sql)

    def _scope_columns(self, stmt) -> set:
        """Source column names visible to this statement's GROUP BY /
        ORDER BY: base/join tables from the catalog (footer-cheap) plus
        derived-table output names. Best-effort — an unknown table just
        contributes nothing, and alias substitution stays conservative
        (a name that might be a column is never treated as an alias)."""
        from tpu_olap_torch.ir.expr import Col
        from tpu_olap_torch.planner.sqlparse import UnionStmt
        cols: set = set()

        def add_derived(d):
            sel = d.parts[0] if isinstance(d, UnionStmt) else d
            for p, alias in sel.projections:
                if alias:
                    cols.add(alias)
                elif isinstance(p, Col):
                    cols.add(p.name)

        def add_entry(name):
            ent = self.catalog.maybe(name)
            if ent is not None:
                try:
                    cols.update(ent.column_names())
                except Exception:  # noqa: BLE001 — unreadable footer etc.
                    pass

        if stmt.derived is not None:
            add_derived(stmt.derived)
        elif stmt.table:
            add_entry(stmt.table)
        for j in stmt.joins:
            if j.derived is not None:
                add_derived(j.derived)
            else:
                add_entry(j.table)
        return cols

    def _resolve_aliases(self, stmt):
        """Apply output-alias resolution to a statement tree: each
        SELECT scope (union parts, derived tables, join subqueries)
        resolves against its own FROM columns."""
        from tpu_olap_torch.planner.sqlparse import (UnionStmt,
                                                     resolve_output_aliases)
        if isinstance(stmt, UnionStmt):
            for p in stmt.parts:
                self._resolve_aliases(p)
            return stmt
        if stmt.derived is not None:
            self._resolve_aliases(stmt.derived)
        for j in stmt.joins:
            if j.derived is not None:
                self._resolve_aliases(j.derived)
        # cheap early-out before touching catalog metadata: resolution
        # can only matter when some projection is aliased AND a
        # GROUP BY / ORDER BY clause exists to reference it
        if not ((stmt.group_by or stmt.order_by or stmt.grouping_sets)
                and any(alias for _, alias in stmt.projections)):
            return stmt
        return resolve_output_aliases(stmt, self._scope_columns(stmt))

    def plan_stmt(self, stmt, sql: str = "") -> PlanResult:
        # shapes outside the rewrite rules run on the fallback path (the
        # reference delegated them to full Spark SQL, SURVEY.md §3.1) —
        # declined here, never an error
        from tpu_olap_torch.planner.exprutil import simplify_stmt
        from tpu_olap_torch.planner.sqlparse import UnionStmt
        stmt = self._resolve_aliases(stmt)
        stmt = _apply_windows_over_groups(stmt)
        if not isinstance(stmt, UnionStmt):
            # normalize expressions once so the rewriter and the fallback
            # interpreter see the same tree (ExprUtil, SURVEY.md §3.2)
            stmt = simplify_stmt(stmt)
        if isinstance(stmt, UnionStmt):
            entry = self.catalog.maybe(stmt.table)
            return PlanResult(
                stmt=stmt, entry=entry, sql=sql,
                fallback_reason=f"{stmt.op.upper()} executes on the "
                                "fallback path")
        if stmt.derived is not None:
            return PlanResult(
                stmt=stmt, entry=None, sql=sql,
                fallback_reason="derived table (FROM subquery) executes "
                                "on the fallback path")
        outside = _outside_subset(stmt)
        if outside == "subquery" and self.run_subquery is not None:
            # the reference's architecture for this shape: Spark executed
            # the subquery, the rewritten outer query pushed to Druid
            # (SURVEY.md §3.1). Inline uncorrelated subquery results as
            # literals and try the device path for the outer query;
            # anything that doesn't fully inline keeps the fallback.
            alt = self._inline_uncorrelated(stmt)
            if alt is not None:
                entry = self.catalog.get(stmt.table)
                # the inlined statement is the one to keep for ANY
                # execution path: its subqueries already ran, so a
                # fallback after a failed outer rewrite replays literals
                # instead of re-executing the inner aggregates
                result = PlanResult(stmt=alt, entry=entry, sql=sql)
                try:
                    _Rewriter(self, alt, entry, result).run()
                    return result
                except RewriteError as e:
                    result.query = None
                    result.fallback_reason = str(e)
                    return result
        if outside is not None:
            return PlanResult(
                stmt=stmt, entry=self.catalog.get(stmt.table), sql=sql,
                fallback_reason=f"{outside} executes on the fallback path")
        entry = self.catalog.get(stmt.table)
        result = PlanResult(stmt=stmt, entry=entry, sql=sql)
        try:
            _Rewriter(self, stmt, entry, result).run()
        except RewriteError as e:
            result.query = None
            result.fallback_reason = str(e)
        return result

    def _inline_uncorrelated(self, stmt):
        """Execute every uncorrelated scalar/IN/EXISTS subquery via
        run_subquery and inline the results as literals. None when
        nothing inlined, the statement still carries subquery constructs
        (correlated shapes resolve to corr_* map nodes only the fallback
        evaluator understands), or resolution failed."""
        from tpu_olap_torch.planner import fallback as fb
        from tpu_olap_torch.planner.exprutil import simplify_stmt
        # pre-scan BEFORE any execution: a correlated member can only
        # resolve to corr_* map nodes we would discard, a window
        # function keeps the whole statement on the fallback anyway,
        # and _resolve_subqueries runs inner statements eagerly —
        # bailing here keeps that work single-execution
        subs, has_window, _ = _scan_stmt_nodes(stmt)
        if has_window or not subs:
            return None
        for sub in subs:
            if not fb._uncorrelated(sub):
                return None
        try:
            resolved = fb._resolve_subqueries(
                stmt, self.catalog, self.config, run=self.run_subquery)
        except fb.FallbackError:
            return None
        if resolved is stmt:
            return None
        resolved = simplify_stmt(resolved)
        if _outside_subset(resolved) is not None:
            return None
        _, _, has_corr = _scan_stmt_nodes(resolved)
        if has_corr:
            return None
        return resolved


class _Rewriter:
    def __init__(self, planner: DruidPlanner, stmt, entry, result):
        self.planner = planner
        self.catalog = planner.catalog
        self.config = planner.config
        self.stmt = stmt
        self.entry = entry
        self.result = result
        self.table = entry.segments
        self.rename: dict[str, str] = {}
        self.vcols: list[VirtualColumn] = []
        self.aggs: list = []
        self.postaggs: list = []
        self._agg_by_key: dict = {}
        self._names = (f"a{i}" for i in itertools.count())
        self.alias_of: dict = {}  # structural expr key -> SQL alias

    # ------------------------------------------------------------- pipeline

    def run(self):
        if not self.entry.is_accelerated:
            raise RewriteError(f"table {self.entry.name!r} is not "
                               "druid-backed (no segment index)")
        stmt = self.stmt
        if stmt.grouping_sets is not None:
            raise RewriteError(
                "GROUPING SETS/ROLLUP/CUBE execute on the fallback path")
        conjuncts = _split_and(stmt.where)
        conjuncts = self._collapse_joins(conjuncts)
        conjuncts = [self._resolve(e) for e in conjuncts]
        intervals, conjuncts = self._extract_intervals(conjuncts)
        filter_spec = None
        if conjuncts:
            filter_spec = F.and_of(*[self._to_filter(e) for e in conjuncts])

        group_exprs = [self._resolve(e) for e in stmt.group_by]
        projections = []
        for e, a in stmt.projections:
            r = self._resolve(e)
            if a is None and r != e and not (isinstance(e, Col)
                                             and "." in e.name):
                # star-join renames (r_name -> c_region) and time-column
                # mapping (ts -> __time) must not leak into the output
                # header: the column is named by what the user wrote
                a = _render(e)
            elif a is None and isinstance(e, Col) and "." in e.name:
                a = e.name.split(".")[-1]
            projections.append((r, a))
        if stmt.distinct:
            if self._has_agg(projections):
                raise RewriteError("SELECT DISTINCT with aggregates")
            if group_exprs:
                raise RewriteError("SELECT DISTINCT with GROUP BY")
            group_exprs = [e for e, _ in projections]

        for e, a in projections:
            if a is not None:
                self.alias_of[_key(e)] = a

        if not group_exprs and not self._has_agg(projections):
            return self._build_scan(projections, filter_spec, intervals)
        return self._build_agg(projections, group_exprs, filter_spec,
                               intervals)

    # ---------------------------------------------------------------- joins

    def _collapse_joins(self, conjuncts):
        """JoinTransform (SURVEY.md §4.3): every joined table must be a
        declared star dimension whose FK edge appears as an equi-join
        condition AND whose fact-side linking column is derivable from the
        denormalized fact — directly (a fact column), through an earlier
        collapsed dimension (snowflake dim⋈dim chains), or through the
        declared FunctionalDependencies' closure (SURVEY.md §3.4: the
        reference validates the join tree against StarSchema FK chains +
        FDs). Dim columns then rename to fact columns."""
        stmt = self.stmt
        if not stmt.joins:
            return conjuncts
        if any(j.using is not None for j in stmt.joins):
            raise RewriteError("USING joins execute on the fallback path")
        if any(j.derived is not None for j in stmt.joins):
            raise RewriteError("derived table / CTE in JOIN position "
                               "executes on the fallback path")
        star = self.entry.star
        if star is None:
            raise RewriteError("join query but no star schema declared")
        conjuncts = list(conjuncts)
        # columns derivable from the denormalized fact row, in bare-name
        # space (grows as dimensions collapse — chain joins link through
        # earlier dims' columns)
        known = set(self.table.schema)
        if self.entry.time_column:
            known.add(self.entry.time_column)
        known = star.fd_closure(known)

        def collapse(j):
            """Collapse one join into (renames, new conjuncts); returns an
            error string when the join cannot collapse YET (it may become
            collapsible after another dimension provides its link)."""
            nonlocal conjuncts, known
            sd = star.dim(j.table)
            if sd is None:
                raise RewriteError(
                    f"joined table {j.table!r} is not a declared star "
                    "dimension")
            cand = _split_and(j.on) if j.on is not None else conjuncts
            found = None
            for c in cand:
                pair = _equi_join_cols(c)
                if pair and star.matches_join(j.table, *pair):
                    found = c
                    break
            if found is None:
                return f"no FK join condition for star dimension {j.table!r}"
            if sd.fact_key not in known:
                return (
                    f"join to {j.table!r} is not subsumed by the star "
                    f"schema: linking column {sd.fact_key!r} is not on "
                    "the fact table, not provided by another collapsed "
                    "dimension, and not implied by any declared "
                    "functional dependency")
            if j.on is not None:
                conjuncts.extend(
                    c for c in _split_and(j.on) if c is not found)
            else:
                conjuncts.remove(found)
            # rename dim columns -> denormalized fact columns; every dim
            # column (mapped or not) joins the known set so snowflake
            # chains can link through it
            dim_entry = self.catalog.maybe(j.table)
            dim_cols = (list(dim_entry.frame.columns)
                        if dim_entry is not None else [])
            known.add(sd.dim_key)
            for c in dim_cols:
                known.add(c)
                fact_col = sd.fact_column(c)
                if fact_col in self.table.schema or \
                        fact_col == self.entry.time_column:
                    self.rename[c] = fact_col
                    self.rename[f"{j.table}.{c}"] = fact_col
            known = star.fd_closure(known)
            return None

        # fixed point over the join list: SQL join order need not follow
        # the chain direction (the reference walks the whole tree too)
        pending = list(stmt.joins)
        for j in pending:
            if j.kind != "inner":
                raise RewriteError(f"{j.kind} join not collapsible")
        while pending:
            errors = []
            still = []
            for j in pending:
                err = collapse(j)
                if err is not None:
                    errors.append(err)
                    still.append(j)
            if len(still) == len(pending):  # no progress
                raise RewriteError(errors[0])
            pending = still
        return conjuncts

    # ---------------------------------------------------- column resolution

    def _resolve(self, e: Expr) -> Expr:
        if e is None:
            return None
        if isinstance(e, Col):
            name = e.name
            if "." in name:
                qual, base = name.split(".", 1)
                if qual == self.entry.name:
                    name = base
                elif name in self.rename:
                    name = self.rename[name]
                else:
                    name = base
            name = self.rename.get(name, name)
            if name == self.entry.time_column:
                name = TIME_COLUMN
            return Col(name)
        if isinstance(e, BinOp):
            return BinOp(e.op, self._resolve(e.left), self._resolve(e.right))
        if isinstance(e, FuncCall):
            return FuncCall(e.name, tuple(self._resolve(a) for a in e.args))
        return e

    def _check_col(self, name: str) -> str:
        if name == "*":
            raise RewriteError("* not valid here")
        if name not in self.table.schema:
            raise RewriteError(f"unknown column {name!r}")
        return name

    def _col_type(self, name: str):
        return self.table.schema[self._check_col(name)]

    # ----------------------------------------------------- interval extract

    def _extract_intervals(self, conjuncts):
        """IntervalConditionExtractor analog (SURVEY.md §3.2): conjuncts
        over the time column become query intervals. A conjunct that is an
        OR of pure time ranges becomes a multi-interval list (the SQL
        spelling of Druid's interval arrays) — intervals across conjuncts
        intersect pairwise, and overlapping results coalesce."""
        sets = []  # each conjunct's interval alternatives (OR = union)
        rest = []
        for c in conjuncts:
            got = self._time_condition(c)
            if got is not None:
                sets.append([got])
                continue
            alts = self._or_intervals(c)
            if alts is not None:
                sets.append(alts)
                continue
            if _mentions_time_fn(c):
                raise RewriteError(
                    f"time condition not extractable: {c!r}")
            rest.append(c)
        acc = [ETERNITY]
        for s in sets:
            acc = [x for a in acc for b in s
                   if (x := a.intersect(b)) is not None]
            if not acc:
                acc = [Interval(0, 0)]
                break
        acc.sort(key=lambda iv: iv.start)
        merged = []
        for iv in acc:
            if merged and iv.start <= merged[-1].end:
                if iv.end > merged[-1].end:
                    merged[-1] = Interval(merged[-1].start, iv.end)
            else:
                merged.append(iv)
        intervals = () if merged == [ETERNITY] else tuple(merged)
        return intervals, rest

    def _or_intervals(self, e):
        """Intervals for a disjunction of pure time ranges (each branch
        may be an AND of time conditions); None when any branch involves
        non-time predicates."""
        if isinstance(e, BinOp) and e.op == "||":
            left = self._or_intervals(e.left)
            right = self._or_intervals(e.right)
            if left is None or right is None:
                return None
            return left + right
        iv = None
        for p in _split_and(e):
            got = self._time_condition(p)
            if got is None:
                return None
            if iv is None:
                iv = got
            else:
                x = iv.intersect(got)
                iv = x if x is not None else Interval(0, 0)
        return [iv] if iv is not None else None

    def _time_condition(self, e) -> Interval | None:
        if not isinstance(e, BinOp) or e.op not in _CMP:
            return None
        left, right = e.left, e.right
        op = e.op
        if isinstance(right, (Col, FuncCall)) and isinstance(left, Lit):
            left, right = right, left
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        if not isinstance(right, Lit):
            return None
        # year(__time) CMP N
        if isinstance(left, FuncCall) and left.name == "year" and \
                len(left.args) == 1 and left.args[0] == Col(TIME_COLUMN) and \
                isinstance(right.value, int):
            y = right.value
            lo = timeutil.date_to_millis(y)
            hi = timeutil.date_to_millis(y + 1)
            return {"==": Interval(lo, hi),
                    "<": Interval(-(2**62), lo),
                    "<=": Interval(-(2**62), hi),
                    ">": Interval(hi, 2**62),
                    ">=": Interval(lo, 2**62)}.get(op)
        # __time CMP 'date literal' / epoch-millis number
        if left == Col(TIME_COLUMN):
            v = right.value
            if isinstance(v, str):
                try:
                    ms = timeutil.parse_iso_datetime(v)
                except ValueError:
                    return None
            elif isinstance(v, (int, float)):
                ms = int(v)
            else:
                return None
            return {"==": Interval(ms, ms + 1),
                    "<": Interval(-(2**62), ms),
                    "<=": Interval(-(2**62), ms + 1),
                    ">": Interval(ms + 1, 2**62),
                    ">=": Interval(ms, 2**62)}.get(op)
        return None

    # -------------------------------------------------------------- filters

    def _to_filter(self, e) -> F.FilterSpec:
        if isinstance(e, Lit):
            # constant predicates appear when subquery inlining folds
            # e.g. EXISTS(...) to TRUE/FALSE
            if e.value:
                return None  # and_of drops the no-op conjunct
            raise RewriteError("statically false predicate")
        if isinstance(e, BinOp) and e.op == "&&":
            return F.and_of(self._to_filter(e.left), self._to_filter(e.right))
        if isinstance(e, BinOp) and e.op == "||":
            return F.OrFilter((self._to_filter(e.left),
                               self._to_filter(e.right)))
        if isinstance(e, FuncCall) and e.name == "not":
            return F.NotFilter(self._to_filter(e.args[0]))
        if isinstance(e, FuncCall) and e.name == "is_null":
            col = self._filter_col(e.args[0])
            return F.SelectorFilter(col, None)
        if isinstance(e, FuncCall) and e.name == "in_list":
            vals = []
            for a in e.args[1:]:
                if not isinstance(a, Lit):
                    raise RewriteError("non-literal IN list")
                vals.append(a.value)
            if not isinstance(e.args[0], Col):
                # extraction IN: upper(g) IN (...) -> in filter with an
                # extractionFn (one predicate table, one device gather)
                ext = self._extraction_of(e.args[0])
                if ext is not None:
                    col, fn = ext
                    return F.InFilter(col, tuple(vals), fn)
            col = self._filter_col(e.args[0])
            return F.InFilter(col, tuple(vals))
        if isinstance(e, FuncCall) and e.name == "in_list_packed":
            # inlined IN-subquery result: one Lit holding every value
            vals = tuple(e.args[1].value)
            lhs = e.args[0]
            if not isinstance(lhs, Col):
                ext = self._extraction_of(lhs)
                if ext is not None:
                    col, fn = ext
                    return F.InFilter(col, vals, fn)
            col = self._filter_col(lhs)
            if self._col_type(col) is not ColumnType.STRING \
                    and len(vals) > 8192:
                # numeric in-lists broadcast rows x values on the device;
                # string lists compile to a dictionary-sized table and
                # have no such limit
                raise RewriteError(
                    f"packed numeric IN list of {len(vals)} values "
                    "exceeds the device broadcast budget")
            return F.InFilter(col, vals)
        if isinstance(e, FuncCall) and e.name == "like":
            col = self._filter_col(e.args[0])
            pat = e.args[1]
            if not isinstance(pat, Lit) or not isinstance(pat.value, str):
                raise RewriteError("LIKE pattern must be a string literal")
            if self._col_type(col) is not ColumnType.STRING:
                raise RewriteError(f"LIKE over non-string column {col!r}")
            return F.LikeFilter(col, pat.value)
        if isinstance(e, BinOp) and e.op in _CMP:
            left, right, op = e.left, e.right, e.op
            if isinstance(left, Lit) and (isinstance(right, Col) or
                                          isinstance(right, FuncCall)):
                left, right = right, left
                op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
            if isinstance(right, Lit) and right.value is None:
                # comparison with a NULL literal (e.g. an empty scalar
                # subquery inlined as Lit(None)) matches no rows — the
                # fallback's guard rule. SelectorFilter(col, None) would
                # read it as IS NULL; IS NULL itself arrives as the
                # is_null FuncCall, not a comparison.
                raise RewriteError(
                    "comparison with NULL literal matches no rows")
            if isinstance(right, Lit) and op in ("==", "!="):
                ext = self._extraction_of(left)
                if ext is not None:
                    col, fn = ext
                    f = F.SelectorFilter(col, right.value, fn)
                    return F.NotFilter(f) if op == "!=" else f
            if isinstance(right, Lit) and isinstance(right.value, str) \
                    and op in ("<", "<=", ">", ">="):
                # range over an extraction: substr(c, 1, 2) BETWEEN ...
                ext = self._extraction_of(left)
                if ext is not None:
                    col, fn = ext
                    v = right.value
                    if op in ("<", "<="):
                        return F.BoundFilter(
                            col, upper=v, upper_strict=(op == "<"),
                            extraction_fn=fn)
                    return F.BoundFilter(
                        col, lower=v, lower_strict=(op == ">"),
                        extraction_fn=fn)
            if isinstance(left, Col) and isinstance(right, Col):
                ca = self._check_col(left.name)
                cb = self._check_col(right.name)
                sa = self._col_type(ca) is ColumnType.STRING
                sb = self._col_type(cb) is ColumnType.STRING
                if sa != sb:
                    raise RewriteError(
                        f"comparison between string and numeric columns "
                        f"({ca!r}, {cb!r})")
                # row-vs-row equality: the columnComparison filter
                # (TPC-H Q5/Q7 `c_nation = s_nation`); <> composes as
                # NOT, under which NULL rows match — same as the
                # fallback's pandas semantics. Numeric pairs take the
                # same filter (not ExpressionFilter) so they stay
                # Pallas-eligible; ordered numeric comparisons fall
                # through to the expression path below.
                if op == "==":
                    return F.ColumnComparisonFilter((ca, cb))
                if op == "!=":
                    return F.NotFilter(F.ColumnComparisonFilter((ca, cb)))
                if sa:
                    raise RewriteError(
                        "ordered comparison between string columns")
            if op == "!=":
                # general `a <> b` must lower as NOT(a = b): a bare
                # ExpressionFilter(!=) would exclude NULL operands
                # (boolean leaf rule) while the fallback's pandas
                # `NaN != x` is True — NOT(==) matches the fallback
                inner = self._to_filter(BinOp("==", left, right))
                return F.NotFilter(inner)
            if isinstance(left, Col) and isinstance(right, Lit):
                col = self._check_col(left.name)
                v = right.value
                typ = self._col_type(col)
                ordering = ("lexicographic"
                            if typ is ColumnType.STRING
                            and isinstance(v, str) else "numeric")
                if op == "==":
                    return F.SelectorFilter(col, v)
                if op == "!=":
                    return F.NotFilter(F.SelectorFilter(col, v))
                if op in ("<", "<="):
                    return F.BoundFilter(col, upper=v,
                                         upper_strict=(op == "<"),
                                         ordering=ordering)
                return F.BoundFilter(col, lower=v,
                                     lower_strict=(op == ">"),
                                     ordering=ordering)
            # general expression comparison
            return self._expression_filter(e)
        raise RewriteError(f"cannot translate predicate {e!r}")

    def _filter_col(self, e) -> str:
        if not isinstance(e, Col):
            raise RewriteError(f"expected a column, got {e!r}")
        return self._check_col(e.name)

    def _expression_filter(self, e) -> F.FilterSpec:
        _check_device_expr(e)
        for c in e.columns():
            if self._col_type(c) is ColumnType.STRING:
                raise RewriteError(
                    f"expression predicate over string column {c!r}")
        return F.ExpressionFilter(e)

    def _extraction_of(self, e) -> tuple[str, object] | None:
        """substr/substring/regexp_extract over a string column with
        literal args -> (column, ExtractionFunctionSpec) — the SQL
        spelling of the reference's extraction dimensions/filters
        (SURVEY.md §3.3)."""
        from tpu_olap_torch.ir.dimensions import (RegexExtractionFn,
                                                  SubstringExtractionFn)
        if not (isinstance(e, FuncCall) and e.args
                and isinstance(e.args[0], Col)):
            return None
        if e.name in ("substr", "substring") and len(e.args) in (2, 3) \
                and all(isinstance(a, Lit) for a in e.args[1:]):
            col = self._check_col(e.args[0].name)
            if self._col_type(col) is not ColumnType.STRING:
                raise RewriteError(
                    f"{e.name} over non-string column {col!r}")
            start = int(e.args[1].value)
            if start < 1:
                raise RewriteError("substr start index is 1-based")
            length = int(e.args[2].value) if len(e.args) == 3 else None
            return col, SubstringExtractionFn(start - 1, length)
        if e.name in ("upper", "lower") and len(e.args) == 1:
            from tpu_olap_torch.ir.dimensions import CaseExtractionFn
            col = self._check_col(e.args[0].name)
            if self._col_type(col) is not ColumnType.STRING:
                raise RewriteError(
                    f"{e.name} over non-string column {col!r}")
            return col, CaseExtractionFn(e.name)
        if e.name == "regexp_extract" and len(e.args) == 2 and \
                isinstance(e.args[1], Lit) and isinstance(e.args[1].value,
                                                          str):
            col = self._check_col(e.args[0].name)
            if self._col_type(col) is not ColumnType.STRING:
                raise RewriteError(
                    f"regexp_extract over non-string column {col!r}")
            return col, RegexExtractionFn(e.args[1].value)
        if e.name == "lookup_map" and len(e.args) == 2 and \
                isinstance(e.args[1], Lit):
            # subquery resolution inlines lookup() as lookup_map with the
            # mapping items baked in; same extraction, no catalog read
            from tpu_olap_torch.ir.dimensions import LookupExtractionFn
            col = self._check_col(e.args[0].name)
            if self._col_type(col) is not ColumnType.STRING:
                raise RewriteError(
                    f"lookup over non-string column {col!r}")
            return col, LookupExtractionFn(tuple(e.args[1].value))
        if e.name == "lookup" and len(e.args) == 2 and \
                isinstance(e.args[1], Lit) and isinstance(e.args[1].value,
                                                          str):
            from tpu_olap_torch.ir.dimensions import LookupExtractionFn
            lname = e.args[1].value
            mapping = self.catalog.lookups.get(lname)
            if mapping is None:
                raise RewriteError(f"unknown lookup {lname!r}")
            col = self._check_col(e.args[0].name)
            if self._col_type(col) is not ColumnType.STRING:
                raise RewriteError(
                    f"lookup over non-string column {col!r}")
            return col, LookupExtractionFn(tuple(mapping.items()))
        return None

    # ----------------------------------------------------------- aggregates

    def _has_agg(self, projections) -> bool:
        return any(_contains_agg(e) for e, _ in projections)

    def _name_for(self, e) -> str:
        return self.alias_of.get(_key(e)) or next(self._names)

    def _vcol_for(self, e: Expr) -> tuple[str, str]:
        """Expression -> (virtual column name, value type)."""
        _check_device_expr(e)
        for c in e.columns():
            if self._col_type(c) is ColumnType.STRING:
                raise RewriteError(f"aggregate over string column {c!r}")
        vt = "long"
        for c in e.columns():
            if self.table.schema[c] is ColumnType.DOUBLE:
                vt = "double"
        if _has_division(e) or _has_float_lit(e) or _has_cast_double(e):
            vt = "double"
        for v in self.vcols:
            if v.expression == e:
                return v.name, v.output_type
        name = f"v{len(self.vcols)}"
        self.vcols.append(VirtualColumn(name, e, vt))
        return name, vt

    def _agg_field(self, e: Expr) -> tuple[str, str]:
        """Aggregate input -> (field name, "long"|"double")."""
        if isinstance(e, Col):
            col = self._check_col(e.name)
            typ = self._col_type(col)
            if typ is ColumnType.STRING:
                raise RewriteError(f"aggregate over string column {col!r}")
            return col, ("double" if typ is ColumnType.DOUBLE else "long")
        return self._vcol_for(e)

    def _make_agg(self, e: FuncCall) -> str:
        """Aggregate call -> IR aggregation (deduped); returns output name."""
        k = _key(e)
        if k in self._agg_by_key:
            return self._agg_by_key[k]
        name = self._name_for(e)
        fn = e.name
        if fn == "count" and not e.args:
            self.aggs.append(CountAggregation(name))
        elif fn in ("sum", "min", "max"):
            if len(e.args) != 1:
                raise RewriteError(f"{fn} takes one argument")
            arg = e.args[0]
            if fn == "sum" and self._case_to_filter(arg, name):
                pass  # sum(CASE WHEN c THEN x ELSE 0) -> filtered agg
            else:
                fieldn, vt = self._agg_field(arg)
                cls = {"sum": SumAggregation, "min": MinAggregation,
                       "max": MaxAggregation}[fn]
                self.aggs.append(cls(name, fieldn, vt))
        elif fn == "count":  # count(col): non-null count
            fieldn, _ = self._agg_field(e.args[0])
            from tpu_olap_torch.ir.aggregations import FilteredAggregation
            self.aggs.append(FilteredAggregation(
                F.NotFilter(F.SelectorFilter(fieldn, None)),
                CountAggregation(name)))
        elif fn in ("count_distinct", "approx_count_distinct"):
            if fn == "count_distinct" and not self.config.allow_count_distinct:
                raise RewriteError(
                    "COUNT(DISTINCT) disabled (allow_count_distinct=False); "
                    "exact distinct runs on the fallback path")
            cols = []
            for a in e.args:
                if not isinstance(a, Col):
                    raise RewriteError("COUNT(DISTINCT expr) not supported")
                cols.append(self._check_col(a.name))
            self.aggs.append(CardinalityAggregation(name, tuple(cols),
                                                    by_row=len(cols) > 1))
        elif fn == "theta_sketch":
            if len(e.args) != 1:
                raise RewriteError("theta_sketch takes one column")
            col = self._filter_col(e.args[0])
            self.aggs.append(ThetaSketchAggregation(name, col))
        elif fn == "avg":
            fieldn, vt = self._agg_field(e.args[0])
            s = next(self._names)
            c = next(self._names)
            self.aggs.append(SumAggregation(s, fieldn, vt))
            self.aggs.append(CountAggregation(c))
            # "quotient": a GLOBAL aggregate over zero matching rows
            # still emits its one row, and AVG of nothing is NULL per
            # SQL — the "/" post-agg's x/0 -> 0 rule would say 0
            # (grouped rows always have count >= 1, so no difference
            # there; found by fuzz seed 664)
            self.postaggs.append(ArithmeticPostAgg(
                name, "quotient",
                (FieldAccessPostAgg(s), FieldAccessPostAgg(c))))
        elif fn == "agg_filter":
            # standard-SQL `agg(...) FILTER (WHERE cond)` -> the IR's
            # FilteredAggregation (SURVEY.md §3.3 "filtered aggregator")
            self._make_filtered_agg(e, name)
        else:
            raise RewriteError(f"unknown aggregate {fn!r}")
        self._agg_by_key[k] = name
        return name

    def _case_to_filter(self, arg, name: str) -> bool:
        """sum(CASE WHEN cond THEN x ELSE 0 END) -> filtered aggregator
        (Druid's own translation). Lets conditions over STRING columns
        ride the filter machinery — as a virtual-column expression the
        string codes would be rejected. Returns True when handled."""
        from tpu_olap_torch.ir.aggregations import FilteredAggregation
        if not (isinstance(arg, FuncCall) and arg.name == "if"
                and len(arg.args) == 3):
            return False
        cond, then, other = arg.args
        # ELSE 0 only: with ELSE NULL an all-non-matching group sums to
        # SQL NULL, not the filtered aggregator's empty-sum 0
        if not (isinstance(other, Lit) and other.value == 0
                and other.value is not False):
            return False
        try:
            fs = self._to_filter(cond)
        except RewriteError:
            return False  # condition outside the filter algebra
        if isinstance(then, Lit) and then.value == 1 \
                and then.value is not True:
            self.aggs.append(FilteredAggregation(fs, CountAggregation(name)))
            return True
        if isinstance(then, Lit):
            return False  # sum of a non-unit constant: no direct agg
        fieldn, vt = self._agg_field(then)
        self.aggs.append(FilteredAggregation(
            fs, SumAggregation(name, fieldn, vt)))
        return True

    def _make_filtered_agg(self, e: FuncCall, name: str) -> None:
        import dataclasses

        from tpu_olap_torch.ir.aggregations import FilteredAggregation
        inner, cond = e.args
        if not isinstance(inner, FuncCall) or inner.name == "agg_filter":
            raise RewriteError("FILTER must wrap a single plain aggregate")
        fs = self._to_filter(cond)
        if inner.name == "avg":
            # filtered avg = filtered sum / filtered row count
            fieldn, vt = self._agg_field(inner.args[0])
            s = next(self._names)
            c = next(self._names)
            self.aggs.append(FilteredAggregation(
                fs, SumAggregation(s, fieldn, vt)))
            self.aggs.append(FilteredAggregation(fs, CountAggregation(c)))
            # "quotient" (true division): a group with NO filter-matching
            # rows divides 0 by 0 and must render NULL per SQL AVG
            # semantics — the "/" post-agg's x/0 -> 0 rule would say 0
            self.postaggs.append(ArithmeticPostAgg(
                name, "quotient",
                (FieldAccessPostAgg(s), FieldAccessPostAgg(c))))
            return
        # build the inner spec through the normal path, then re-own it:
        # pop it if newly created (and forget its dedup entry so a later
        # unfiltered use gets its own), or clone it if it was shared
        ik = _key(inner)
        fresh = ik not in self._agg_by_key
        n_before = len(self.aggs)
        inner_name = self._make_agg(inner)
        if fresh and len(self.aggs) == n_before + 1:
            spec = self.aggs.pop()
            del self._agg_by_key[ik]
        else:
            spec = next(
                a for a in self.aggs
                if (a.aggregator.name if isinstance(a, FilteredAggregation)
                    else a.name) == inner_name)
        if isinstance(spec, FilteredAggregation):
            # count(col) lowers to a not-null-filtered count: AND the two
            base = dataclasses.replace(spec.aggregator, name=name)
            self.aggs.append(FilteredAggregation(
                F.and_of(fs, spec.filter), base))
        else:
            self.aggs.append(FilteredAggregation(
                fs, dataclasses.replace(spec, name=name)))

    def _agg_output(self, e: Expr) -> str:
        """Projection expr (aggregate or arithmetic over aggregates) ->
        output name, creating aggs/post-aggs as needed."""
        if isinstance(e, FuncCall) and e.name in AGG_FUNCS:
            return self._make_agg(e)
        k = _key(e)
        if k in self._agg_by_key:
            return self._agg_by_key[k]
        name = self._name_for(e)
        self.postaggs.append(self._to_postagg(e, name))
        self._agg_by_key[k] = name
        return name

    _THETA_SET_FNS = {"theta_sketch_intersect": "INTERSECT",
                      "theta_sketch_union": "UNION",
                      "theta_sketch_not": "NOT"}

    def _to_postagg(self, e: Expr, name: str = ""):
        if isinstance(e, Lit):
            return ConstantPostAgg(float(e.value), name)
        if isinstance(e, FuncCall) and e.name in self._THETA_SET_FNS:
            return self._theta_setop(e, name)
        if isinstance(e, FuncCall) and e.name == "theta_sketch_estimate" \
                and len(e.args) == 1:
            from tpu_olap_torch.ir.postaggs import ThetaSketchEstimatePostAgg
            inner = e.args[0]
            if isinstance(inner, FuncCall) and \
                    inner.name in self._THETA_SET_FNS:
                return ThetaSketchEstimatePostAgg(
                    "", name, self._theta_setop(inner))
            return ThetaSketchEstimatePostAgg(
                self._theta_field(inner, "theta_sketch_estimate"), name)
        if isinstance(e, FuncCall) and e.name in AGG_FUNCS:
            return FieldAccessPostAgg(self._make_agg(e), name)
        if isinstance(e, BinOp) and e.op in ("+", "-", "*", "/"):
            return ArithmeticPostAgg(name, e.op,
                                     (self._to_postagg(e.left),
                                      self._to_postagg(e.right)))
        raise RewriteError(f"cannot translate aggregate expression {e!r}")

    def _theta_field(self, e: Expr, ctx: str) -> str:
        """An argument of `ctx` must BE a theta sketch: either
        theta_sketch(col) or theta_sketch(col) FILTER (WHERE ...)."""
        inner = e
        if isinstance(e, FuncCall) and e.name == "agg_filter":
            inner = e.args[0]
        if not (isinstance(inner, FuncCall)
                and inner.name == "theta_sketch"):
            raise RewriteError(
                f"{ctx} takes theta_sketch(...) arguments "
                f"(optionally with FILTER), got {inner!r}")
        return self._make_agg(e)

    def _theta_setop(self, e: FuncCall, name: str = ""):
        """SQL spelling of the datasketches set ops (SURVEY.md §3.3):
        theta_sketch_intersect/union/not over theta sketches -> the
        thetaSketchSetOp post-aggregation tree."""
        from tpu_olap_torch.ir.postaggs import ThetaSketchSetOpPostAgg
        if len(e.args) < 2:
            raise RewriteError(f"{e.name} takes at least two arguments")
        fields = []
        for a in e.args:
            if isinstance(a, FuncCall) and a.name in self._THETA_SET_FNS:
                fields.append(self._theta_setop(a))
            else:
                fields.append(FieldAccessPostAgg(
                    self._theta_field(a, e.name)))
        return ThetaSketchSetOpPostAgg(self._THETA_SET_FNS[e.name],
                                       tuple(fields), name)

    # ------------------------------------------------------------- group by

    def _classify_groups(self, group_exprs):
        """Group exprs -> (dimension specs, granularity, time outputs)."""
        dims = []
        granularity = AllGranularity()
        outputs = {}  # expr key -> OutputColumn
        trunc_seen = False
        for e in group_exprs:
            alias = self.alias_of.get(_key(e))
            if isinstance(e, Col):
                col = self._check_col(e.name)
                if col == TIME_COLUMN:
                    raise RewriteError("GROUP BY raw __time not supported "
                                       "(use date_trunc)")
                name = alias or col
                dims.append(DefaultDimensionSpec(col, name))
                outputs[_key(e)] = OutputColumn(name, name)
                continue
            if isinstance(e, FuncCall) and e.name in _TIME_FUNCS and \
                    len(e.args) == 1 and e.args[0] == Col(TIME_COLUMN):
                fmt, cast = _TIME_FUNCS[e.name]
                name = alias or _render(e)  # match fallback auto-naming
                dims.append(ExtractionDimensionSpec(
                    TIME_COLUMN,
                    TimeFormatExtractionFn(fmt, self.config.time_zone),
                    name))
                outputs[_key(e)] = OutputColumn(name, name, cast)
                continue
            ext = self._extraction_of(e)
            if ext is not None:
                col, fn = ext
                name = alias or _render(e)
                dims.append(ExtractionDimensionSpec(col, fn, name))
                outputs[_key(e)] = OutputColumn(name, name)
                continue
            if isinstance(e, FuncCall) and e.name == "date_trunc" and \
                    len(e.args) == 2 and isinstance(e.args[0], Lit) and \
                    e.args[1] == Col(TIME_COLUMN):
                unit = str(e.args[0].value).lower()
                if unit not in _TRUNC_UNITS:
                    raise RewriteError(f"unknown date_trunc unit {unit!r}")
                if trunc_seen:
                    raise RewriteError("multiple date_trunc group columns")
                trunc_seen = True
                granularity = PeriodGranularity(_TRUNC_UNITS[unit],
                                                self.config.time_zone)
                name = alias or _render(e)  # match fallback auto-naming
                outputs[_key(e)] = OutputColumn(name, "timestamp",
                                                "datetime")
                continue
            if isinstance(e, (BinOp, FuncCall)) and not _contains_agg(e) \
                    and not _mentions_time_fn(e) \
                    and TIME_COLUMN not in e.columns():
                # GROUP BY <integer expression> (histogram bucketing):
                # lower as a virtual column + dense numeric dimension;
                # _vcol_for types it, and anything non-LONG (division,
                # float literals, string inputs) rejects into fallback
                vname, vt = self._vcol_for(e)
                if vt != "long":
                    raise RewriteError(
                        f"GROUP BY expression {_render(e)!r} is not "
                        "integer-typed")
                name = alias or _render(e)
                dims.append(DefaultDimensionSpec(vname, name))
                outputs[_key(e)] = OutputColumn(name, name)
                continue
            raise RewriteError(f"cannot group by {e!r}")
        return dims, granularity, outputs

    # ------------------------------------------------------------- builders

    def _build_agg(self, projections, group_exprs, filter_spec, intervals):
        dims, granularity, group_outputs = \
            self._classify_groups(group_exprs)

        outputs = []
        for e, alias in projections:
            k = _key(e)
            if k in group_outputs:
                oc = group_outputs[k]
                outputs.append(OutputColumn(alias or oc.name, oc.source,
                                            oc.cast))
            elif _contains_agg(e):
                name = self._agg_output(e)
                outputs.append(OutputColumn(alias or _render(e), name))
            else:
                raise RewriteError(
                    f"projection {_render(e)} is neither grouped nor "
                    "aggregated")

        having_spec = None
        if self.stmt.having is not None:
            having_spec = self._to_having(self._resolve(self.stmt.having))

        limit_spec, topn = self._limit_transform(dims, granularity, outputs,
                                                 group_outputs)

        common = dict(
            data_source=self.entry.name,
            intervals=intervals,
            filter=filter_spec,
            virtual_columns=tuple(self.vcols),
            # SQL GROUP BY emits only non-empty buckets; but a global
            # aggregate (granularity=all, no dims) must emit its one row
            # even when nothing matches
            context=(("skipEmptyBuckets",
                      not isinstance(granularity, AllGranularity)),),
        )
        if not dims and having_spec is not None and \
                isinstance(granularity, AllGranularity):
            # a GLOBAL aggregate emits its one row even over empty input,
            # and HAVING then filters that row — the groupBy assembler
            # drops empty groups, and timeseries has no having clause,
            # so neither device shape preserves the semantics
            raise RewriteError(
                "global aggregate with HAVING executes on the fallback")
        if topn is not None and having_spec is None:
            metric, threshold, inverted = topn
            query = TopNQuerySpec(
                dimension=dims[0], metric=metric, threshold=threshold,
                inverted=inverted, granularity=granularity,
                aggregations=tuple(self.aggs),
                post_aggregations=tuple(self.postaggs), **common)
        elif not dims and limit_spec is None and having_spec is None:
            # HAVING forces the GroupBy shape: Druid's timeseries query
            # has no having clause, so lowering one here would silently
            # drop the filter (found by fuzz seed 1300 — a HAVING over a
            # rarely-zero aggregate made the drop visible)
            query = TimeseriesQuerySpec(
                granularity=granularity, aggregations=tuple(self.aggs),
                post_aggregations=tuple(self.postaggs), **common)
        else:
            query = GroupByQuerySpec(
                dimensions=tuple(dims), granularity=granularity,
                aggregations=tuple(self.aggs),
                post_aggregations=tuple(self.postaggs),
                having=having_spec, limit_spec=limit_spec, **common)
        self.result.query = query
        self.result.outputs = outputs

    def _to_having(self, e):
        if isinstance(e, BinOp) and e.op == "&&":
            return AndHaving((self._to_having(e.left),
                              self._to_having(e.right)))
        if isinstance(e, BinOp) and e.op == "||":
            return OrHaving((self._to_having(e.left),
                             self._to_having(e.right)))
        if isinstance(e, FuncCall) and e.name == "not":
            return NotHaving(self._to_having(e.args[0]))
        if isinstance(e, BinOp) and e.op in _CMP:
            left, right, op = e.left, e.right, e.op
            if isinstance(left, Lit):
                left, right = right, left
                op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
            if isinstance(left, Col) and not _contains_agg(left):
                # HAVING may address an aggregate by its projection alias
                # (Druid havingSpec names output aggregations)
                for pe, alias in self.stmt.projections:
                    if alias == left.name and _contains_agg(pe):
                        left = self._resolve(pe)
                        break
            if not isinstance(right, Lit) or not _contains_agg(left):
                raise RewriteError(f"HAVING predicate not on an aggregate: "
                                   f"{_render(e)}")
            name = self._agg_output(left)
            v = float(right.value)
            if op == ">":
                return GreaterThanHaving(name, v)
            if op == "<":
                return LessThanHaving(name, v)
            if op == "==":
                return EqualToHaving(name, v)
            if op == ">=":
                return NotHaving(LessThanHaving(name, v))
            if op == "<=":
                return NotHaving(GreaterThanHaving(name, v))
            if op == "!=":
                return NotHaving(EqualToHaving(name, v))
        raise RewriteError(f"cannot translate HAVING {_render(e)}")

    def _limit_transform(self, dims, granularity, outputs,
                         group_outputs=None):
        """ORDER BY + LIMIT -> LimitSpec; TopN eligibility per the
        reference's allowTopN rule (SURVEY.md §3.2 LimitTransform)."""
        stmt = self.stmt
        if not stmt.order_by and stmt.limit is None:
            return None, None
        by_source = {}
        for o in outputs:
            by_source.setdefault(o.name, o.source)
            by_source.setdefault(o.source, o.source)
        # ORDER BY a grouped EXPRESSION (e.g. the source column of an
        # aliased dim): resolve through the group-expr key map, not just
        # output names
        group_by_key = {k: oc.source
                        for k, oc in (group_outputs or {}).items()}
        cols = []
        for item in stmt.order_by:
            if item.nulls is not None:
                raise RewriteError(
                    "explicit NULLS FIRST/LAST ordering executes on the "
                    "fallback path")
            e = self._resolve(item.expr)
            key = _key(e)
            if key in self._agg_by_key:
                src = self._agg_by_key[key]
            elif isinstance(e, Col) and e.name in by_source:
                src = by_source[e.name]
            elif isinstance(item.expr, Col) and \
                    item.expr.name.split(".")[-1] in by_source:
                # the written name: star-join renames (r_name -> c_region)
                # resolve the expr away from the output header it matches
                src = by_source[item.expr.name.split(".")[-1]]
            elif key in group_by_key:
                src = group_by_key[key]
            elif _contains_agg(e):
                src = self._agg_output(e)
            else:
                raise RewriteError(
                    f"ORDER BY {_render(e)} is not an output column")
            dim_names = {d.name for d in dims}
            # physical columns take precedence over same-named virtual
            # columns (mirrors compile_dimension's resolution order)
            vlong = {v.name for v in self.vcols if v.output_type == "long"}
            long_dims = {d.name for d in dims
                         if isinstance(d, DefaultDimensionSpec)
                         and (self.table.schema.get(d.dimension)
                              is ColumnType.LONG
                              or (d.dimension not in self.table.schema
                                  and d.dimension in vlong))}
            order = ("lexicographic"
                     if src in dim_names and src not in long_dims
                     else "numeric")
            cols.append(OrderByColumnSpec(
                src, "descending" if item.descending else "ascending",
                order))
        limit_spec = LimitSpec(stmt.limit, tuple(cols), stmt.offset)

        topn = None
        agg_names = {a.name for a in self.aggs} | \
            {p.name for p in self.postaggs}
        if (self.config.allow_topn and len(dims) == 1
                and isinstance(granularity, AllGranularity)
                and stmt.limit is not None and stmt.offset == 0
                and stmt.limit <= self.config.topn_max_threshold
                and len(cols) == 1 and cols[0].dimension in agg_names):
            topn = (cols[0].dimension, stmt.limit,
                    cols[0].direction == "ascending")
        return limit_spec, topn

    def _build_scan(self, projections, filter_spec, intervals):
        cols = []
        outputs = []
        for e, alias in projections:
            if isinstance(e, Col) and e.name == "*":
                for c in self.table.schema:
                    cols.append(c)
                    outputs.append(OutputColumn(c, c))
                continue
            if not isinstance(e, Col):
                raise RewriteError(
                    "computed projections without GROUP BY are not pushed "
                    "down")
            c = self._check_col(e.name)
            cols.append(c)
            outputs.append(OutputColumn(alias or e.name, c))
        order = "none"
        if self.stmt.order_by:
            if len(self.stmt.order_by) != 1:
                raise RewriteError("scan ORDER BY must be the time column")
            item = self.stmt.order_by[0]
            e = self._resolve(item.expr)
            if e != Col(TIME_COLUMN):
                raise RewriteError("scan ORDER BY must be the time column")
            order = "descending" if item.descending else "ascending"
        query = ScanQuerySpec(
            data_source=self.entry.name,
            intervals=intervals,
            filter=filter_spec,
            virtual_columns=tuple(self.vcols),
            columns=tuple(cols),
            limit=self.stmt.limit,
            offset=self.stmt.offset,
            order=order,
        )
        self.result.query = query
        self.result.outputs = outputs


# ---------------------------------------------------------------------------


def _equi_join_cols(e):
    if isinstance(e, BinOp) and e.op == "==" and \
            isinstance(e.left, Col) and isinstance(e.right, Col):
        return (e.left.name.split(".")[-1], e.right.name.split(".")[-1])
    return None


def _mentions_time_fn(e) -> bool:
    if isinstance(e, FuncCall):
        if e.name in _TIME_FUNCS or e.name == "date_trunc":
            if any(Col(TIME_COLUMN) == a for a in e.args):
                return True
        return any(_mentions_time_fn(a) for a in e.args)
    if isinstance(e, BinOp):
        return _mentions_time_fn(e.left) or _mentions_time_fn(e.right)
    if isinstance(e, Col):
        return False
    return False


def _has_division(e) -> bool:
    if isinstance(e, BinOp):
        return e.op == "/" or _has_division(e.left) or _has_division(e.right)
    if isinstance(e, FuncCall):
        return any(_has_division(a) for a in e.args)
    return False


def _has_float_lit(e) -> bool:
    if isinstance(e, Lit):
        return isinstance(e.value, float)
    if isinstance(e, BinOp):
        return _has_float_lit(e.left) or _has_float_lit(e.right)
    if isinstance(e, FuncCall):
        return any(_has_float_lit(a) for a in e.args)
    return False


def _has_cast_double(e) -> bool:
    if isinstance(e, FuncCall):
        return e.name == "cast_double" or \
            any(_has_cast_double(a) for a in e.args)
    if isinstance(e, BinOp):
        return _has_cast_double(e.left) or _has_cast_double(e.right)
    return False


def _check_device_expr(e) -> None:
    """Reject expressions the device evaluator cannot run (unknown
    functions, NULL literals from CASE-without-ELSE) so the planner falls
    back cleanly instead of failing inside a device kernel."""
    if isinstance(e, Lit):
        if e.value is None:
            raise RewriteError(
                "NULL literal inside a device expression (add an ELSE "
                "branch to CASE)")
        return
    if isinstance(e, Col):
        return
    if isinstance(e, BinOp):
        _check_device_expr(e.left)
        _check_device_expr(e.right)
        return
    if isinstance(e, FuncCall):
        if e.name not in _DEVICE_FUNCS:
            raise RewriteError(
                f"function {e.name!r} not supported in device expressions")
        for a in e.args:
            _check_device_expr(a)
        return
    raise RewriteError(f"cannot compile expression {e!r}")



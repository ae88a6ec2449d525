"""Pandas fallback interpreter — the analog of the reference's
source-DataFrame scan path (SURVEY.md §4.4: rewrite failure ⇒ correct-but-
slow execution, never an error; BASELINE.json:7 keeps a CPU-fallback
config). Implements the same SELECT subset as the parser with the same
null semantics as the device kernels (comparisons with NULL are False,
nulls form their own group, COUNT(col) counts non-nulls), so the parity
harness can compare the two paths row for row.
"""

from __future__ import annotations

import re
import threading

import numpy as np
import pandas as pd

from tpu_olap_torch.ir.expr import (BinOp, Col, FuncCall, Lit, Subquery,
                              WindowCall)
from tpu_olap_torch.obs.trace import span as _obs_span
from tpu_olap_torch.planner.exprutil import (contains_agg as _contains_agg,
                                       expr_key as _k, map_stmt_exprs,
                                       render as _auto_name,
                                       split_and as _split_and)
from tpu_olap_torch.planner.sqlparse import (AGG_FUNCS, SelectStmt, UnionStmt)
from tpu_olap_torch.resilience.errors import QueryError
from tpu_olap_torch.segments.dictionary import _like_to_regex

_TIME_FUNCS = {"year", "month", "day", "dayofmonth", "quarter",
               "hour", "minute", "second"}
_THETA_SET_FNS = {"theta_sketch_intersect", "theta_sketch_union",
                  "theta_sketch_not"}


class FallbackError(QueryError):
    """The interpreter cannot serve this statement either (unsupported
    SQL shape, or a refused-at-scale result). The request itself is the
    problem, so the HTTP surface maps it to 400 — distinguishable from
    transient 429/503/504 resilience errors."""

    code = "unsupported_sql"
    retriable = False
    http_status = 400


def _run_inner_stmt(s, catalog, config) -> pd.DataFrame:
    """Execute a derived-table body: through the engine's statement
    executor when the catalog carries one (device path for rewritable
    inner aggregates — the reference's split: Spark consumed the
    subquery result, the rewritten inner pushed to Druid, SURVEY.md
    §3.1; soak r05 showed 100% of fuzz fallbacks were derived-table
    statements whose inner scans are exactly the device-eligible part),
    else the pandas interpreter."""
    runner = getattr(catalog, "device_runner", None)
    if runner is not None and config.fallback_derived_on_device:
        return _coerce_nullable_numeric(runner(s))
    return execute_fallback(s, catalog, config)


def _coerce_nullable_numeric(df: pd.DataFrame) -> pd.DataFrame:
    """Device frames render NULL numeric aggregates as None inside
    object columns; the interpreter's predicate evaluation (like pandas
    aggregation itself) expects float64 + NaN — normalize any
    all-numeric object column the way pandas would have produced it, so
    `WHERE m > 0` over a nullable max() keeps working (the "never an
    error" property, SURVEY.md §2 prop 2). Python bool is an int
    subclass, so booleans are EXCLUDED explicitly: a nullable BOOLEAN
    column must stay True/False/None, not silently coerce to 1.0/0.0
    float64 (which would survive comparisons but corrupt rendering and
    any downstream boolean logic)."""
    for c in df.columns:
        if df[c].dtype == object:
            vals = df[c][df[c].notna()]
            if len(vals) < len(df[c]) and len(vals) and all(
                    isinstance(v, (int, float, np.integer, np.floating))
                    and not isinstance(v, (bool, np.bool_))
                    for v in vals):
                df[c] = pd.to_numeric(df[c], errors="coerce")
    return df


def execute_fallback(stmt, catalog, config) -> pd.DataFrame:
    if isinstance(stmt, UnionStmt):
        return _execute_union(stmt, catalog, config)
    stmt = _resolve_subqueries(stmt, catalog, config)
    if stmt.derived is not None:
        # FROM (SELECT ...) alias: the derived result is the base frame.
        # Its scope is its own — reject outer-table qualifiers inside
        # the body (they would strip onto the inner frame silently).
        _check_uncorrelated(stmt.derived)
        with _obs_span("fallback-derived"):
            df = _run_inner_stmt(stmt.derived, catalog, config)
        time_col = None
    else:
        entry = catalog.get(stmt.table)
        if entry.parquet_paths and entry._frame is None and \
                (entry.parquet_rows or 0) > config.fallback_chunk_rows:
            # SF-scale parquet table: stream row-group chunks instead of
            # materializing one frame (SURVEY.md §2 property 2 at scale)
            with _obs_span("fallback-chunked"):
                return _execute_chunked(stmt, entry, catalog, config)
        df = entry.frame
        time_col = entry.time_column
        if any(isinstance(c, Lit) and c.value is False
               for c in _split_and(stmt.where)):
            # a statically-false WHERE conjunct (e.g. the decorrelator's
            # empty-input default probe): skip the full copy + time sort
            df = df.iloc[0:0].copy()
        elif time_col is not None and time_col in df.columns:
            # match the accelerated path's deterministic time-sorted row
            # order (segments are time-sorted, so unordered LIMIT picks
            # the same rows). Served from the entry's memoized sorted
            # frame — downstream operators never mutate it in place, so
            # no per-query defensive copy + O(n log n) re-sort.
            df = entry.time_sorted_frame()
        else:
            df = df.copy()

    with _obs_span("fallback-filter") as fsp:
        df = _join_and_filter(stmt, df, catalog, time_col, config)
        fsp.set(rows=len(df))

    out_names = []
    exprs = []
    for e, alias in stmt.projections:
        if isinstance(e, Col) and e.name == "*":
            for c in df.columns:
                out_names.append(c)
                exprs.append(Col(c))
            continue
        out_names.append(alias or _auto_name(e))
        exprs.append(e)

    has_agg = any(_contains_agg(e) for e in exprs)
    group_exprs = list(stmt.group_by)
    if stmt.distinct and not has_agg and not group_exprs:
        group_exprs = list(exprs)

    with _obs_span("fallback-agg"):
        if stmt.grouping_sets is not None:
            out = _grouping_sets_aggregate(df, exprs, out_names, stmt,
                                           time_col)
        elif group_exprs or has_agg:
            out = _aggregate(df, exprs, out_names, group_exprs, stmt,
                             time_col)
        else:
            out = pd.DataFrame(
                {n: _eval(e, df, time_col)
                 for n, e in zip(out_names, exprs)})
            out = out.reset_index(drop=True)

    if stmt.order_by and not (group_exprs or has_agg):
        keys, ascending = [], []
        for i, item in enumerate(stmt.order_by):
            name = _auto_name(item.expr)
            col = name if name in out.columns else None
            if col is None:
                col = f"__sort{i}"  # indexed: two computed keys coexist
                out[col] = _eval(item.expr, df, time_col).to_numpy()
            keys.append(col)
            ascending.append(not item.descending)
        out = _sort_order_items(out, keys, stmt.order_by,
                                default_low=False)
        out = out.drop(columns=[c for c in keys if c.startswith("__sort")])
    lo = stmt.offset
    hi = None if stmt.limit is None else lo + stmt.limit
    return out.iloc[lo:hi].reset_index(drop=True)


# ---------------------------------------------------------------------------
# Shapes outside the rewrite subset (UNION, derived tables, subqueries):
# the reference handed these to full Spark SQL (SURVEY.md §3.1); here the
# interpreter executes them compositionally.


def _execute_union(stmt: UnionStmt, catalog, config) -> pd.DataFrame:
    frames = [execute_fallback(p, catalog, config) for p in stmt.parts]
    cols = list(frames[0].columns)
    for f in frames[1:]:
        if len(f.columns) != len(cols):
            raise FallbackError(
                f"{stmt.op.upper()} branches have {len(cols)} vs "
                f"{len(f.columns)} columns")
    frames = [f.set_axis(cols, axis=1) for f in frames]
    if stmt.op == "union":
        out = pd.concat(frames, ignore_index=True)
        if not stmt.all:
            out = out.drop_duplicates(ignore_index=True)
    else:
        # INTERSECT / EXCEPT: set semantics (dedup first, like SQL)
        out = frames[0].drop_duplicates(ignore_index=True)
        for f in frames[1:]:
            keep = pd.MultiIndex.from_frame(out).isin(
                pd.MultiIndex.from_frame(f.drop_duplicates()))
            if stmt.op == "except":
                keep = ~keep
            out = out[keep].reset_index(drop=True)
    if stmt.order_by:
        keys, ascending = [], []
        for item in stmt.order_by:
            name = _auto_name(item.expr)
            if name not in cols:
                raise FallbackError(
                    f"UNION ORDER BY {name!r} is not an output column")
            keys.append(name)
            ascending.append(not item.descending)
        out = _sort_order_items(out, keys, stmt.order_by)
    lo = stmt.offset
    hi = None if stmt.limit is None else lo + stmt.limit
    return out.iloc[lo:hi].reset_index(drop=True)


def _norm_gcol(s: pd.Series) -> pd.Series:
    """Group-key column with numeric NaNs normalized to the string fill
    (matching _norm_key), so dict/merge/reindex keys line up."""
    if not (s.dtype == object
            or str(s.dtype).startswith(("str", "category"))):
        return s.astype(object).where(s.notna(), _FILL)
    return s


def _as_str_series(v, df, fn: str) -> pd.Series:
    """Coerce a string-function argument to a Series, with a legible
    error for non-string input (raw .str would raise AttributeError)."""
    s = v if isinstance(v, pd.Series) else pd.Series(v, index=df.index)
    if not (s.dtype == object or str(s.dtype).startswith(("str",
                                                          "category"))):
        raise FallbackError(
            f"{fn}() needs a string argument, got {s.dtype}")
    return s


def _check_uncorrelated(stmt):
    """Reject correlated subqueries LEGIBLY: a qualified column whose
    table prefix is not in the subquery's own FROM/JOIN scope references
    the outer query. Without this check the evaluator's qualifier
    stripping (name.split('.')[-1]) would silently resolve `outer.x`
    against the INNER frame and return wrong rows."""
    def scope_tables(s):
        if isinstance(s, UnionStmt):
            out = set()
            for p in s.parts:
                out |= scope_tables(p)
            return out
        return _scope_names(s)

    def walk_expr(e, tables):
        if e is None or isinstance(e, Lit):
            return
        if isinstance(e, Col):
            if "." in e.name:
                qual = e.name.rsplit(".", 1)[0]
                if qual not in tables:
                    raise FallbackError(
                        f"correlated subquery reference {e.name!r} is "
                        "not supported (rewrite as a join)")
            return
        if isinstance(e, Subquery):
            return  # nested scope checks itself when resolved
        if isinstance(e, BinOp):
            walk_expr(e.left, tables)
            walk_expr(e.right, tables)
        elif isinstance(e, WindowCall):
            for a in e.args:
                walk_expr(a, tables)
            for p in e.partition_by:
                walk_expr(p, tables)
            for oe, _ in e.order_by:
                walk_expr(oe, tables)
        elif isinstance(e, FuncCall):
            for a in e.args:
                walk_expr(a, tables)

    def walk_stmt(s):
        if isinstance(s, UnionStmt):
            for p in s.parts:
                walk_stmt(p)
            return
        tables = scope_tables(s)
        for e, _ in s.projections:
            walk_expr(e, tables)
        walk_expr(s.where, tables)
        walk_expr(s.having, tables)
        for e in s.group_by:
            walk_expr(e, tables)
        for item in s.order_by:
            walk_expr(item.expr, tables)
        for j in s.joins:
            walk_expr(j.on, tables)
            if j.derived is not None:
                walk_stmt(j.derived)
        if s.derived is not None:
            walk_stmt(s.derived)

    walk_stmt(stmt)
    return stmt


def _scalar_from(sub_df: pd.DataFrame):
    if sub_df.shape[1] != 1 or len(sub_df) > 1:
        raise FallbackError(
            f"scalar subquery returned shape {sub_df.shape}; need 1x1")
    if len(sub_df) == 0:
        return None
    v = sub_df.iloc[0, 0]
    if pd.isna(v):
        return None
    return v.item() if hasattr(v, "item") else v


def _scope_names(s) -> set:
    """Qualifier names resolvable in s's own FROM/JOIN scope. An alias
    HIDES the base table name (standard SQL): `FROM fact f2` makes
    `fact.x` an OUTER reference inside that scope."""
    names = {s.table_alias or s.table}
    names |= {j.alias or j.table for j in s.joins}
    return names


def _uncorrelated(stmt) -> bool:
    try:
        _check_uncorrelated(stmt)
        return True
    except FallbackError:
        return False


def _resolve_subqueries(stmt: SelectStmt, catalog, config,
                        run=None) -> SelectStmt:
    """Replace Subquery nodes (scalar) and in_subquery calls (IN lists)
    with literals by executing the nested statements, and LOOKUP(col,
    'name') references with their registered map inlined (the evaluator
    has no catalog access). Equality-correlated subqueries (the TPC-H
    class: scalar aggregates, EXISTS, IN) decorrelate into precomputed
    key->value maps evaluated per outer row; any other correlation shape
    keeps the legible rejection.

    `run` executes one nested statement -> DataFrame. The default is the
    pandas interpreter; the planner passes the engine's stmt executor so
    inner aggregates ride the device path (the reference's split: Spark
    ran the subquery, the rewritten outer query pushed to Druid —
    SURVEY.md §3.1)."""
    if run is None:
        run = lambda s: execute_fallback(s, catalog, config)  # noqa: E731
    hit = False
    outer_tables = _scope_names(stmt) if isinstance(stmt, SelectStmt) \
        else set()

    def walk(e):
        if e is None:
            return e
        from tpu_olap_torch.ir.expr import map_expr
        return map_expr(e, special)

    def special(e):
        """Subquery-bearing nodes resolve to replacements; None lets
        the shared walker rebuild from mapped children."""
        nonlocal hit
        if isinstance(e, FuncCall) and e.name == "exists":
            # EXISTS (SELECT ...): true iff the subquery returns any row
            # — one row is enough, so cap it
            hit = True
            import dataclasses as _dc
            s = e.args[0].stmt
            if not _uncorrelated(s):
                try:
                    return _decorrelate_exists(s, outer_tables, catalog,
                                               config, run)
                except FallbackError as err:
                    return _nested_loop_corr(
                        "exists", s, None, stmt, outer_tables, catalog,
                        config, run, err)
            inner = _dc.replace(s, limit=1, order_by=[])
            sub = run(inner)
            return Lit(len(sub) > 0)
        if isinstance(e, Subquery):
            hit = True
            if not _uncorrelated(e.stmt):
                try:
                    return _decorrelate_scalar(e.stmt, outer_tables,
                                               catalog, config, run)
                except FallbackError as err:
                    return _nested_loop_corr(
                        "scalar", e.stmt, None, stmt, outer_tables,
                        catalog, config, run, err)
            return Lit(_scalar_from(run(e.stmt)))
        if isinstance(e, FuncCall) and e.name == "in_subquery":
            hit = True
            lhs = walk(e.args[0])
            if not _uncorrelated(e.args[1].stmt):
                try:
                    return _decorrelate_in(lhs, e.args[1].stmt,
                                           outer_tables, catalog,
                                           config, run)
                except FallbackError as err:
                    return _nested_loop_corr(
                        "in", e.args[1].stmt, lhs, stmt, outer_tables,
                        catalog, config, run, err)
            sub = run(e.args[1].stmt)
            if sub.shape[1] != 1:
                raise FallbackError(
                    f"IN subquery returned {sub.shape[1]} columns")
            if len(sub) > config.fallback_scan_row_cap:
                raise FallbackError(
                    "IN subquery result exceeds fallback_scan_row_cap")
            # one packed Lit holding every value — per-value Lit nodes
            # would allocate millions of objects for big subqueries.
            # NULLs are DROPPED: `x IN (SELECT ...)` never matches on a
            # NULL member (SQL; and the same rule the correlated
            # decorrelation applies) — unlike a LITERAL in-list, where
            # an explicit NULL matches null rows (Druid's in filter)
            vals = tuple(v.item() if hasattr(v, "item") else v
                         for v in sub.iloc[:, 0] if not pd.isna(v))
            return FuncCall("in_list_packed", (lhs, Lit(vals)))
        if isinstance(e, FuncCall) and e.name == "lookup" \
                and len(e.args) == 2 and isinstance(e.args[1], Lit):
            hit = True
            mapping = catalog.lookups.get(e.args[1].value)
            if mapping is None:
                raise FallbackError(f"unknown lookup {e.args[1].value!r}")
            return FuncCall("lookup_map",
                            (walk(e.args[0]),
                             Lit(tuple(sorted(mapping.items())))))
        return None

    from tpu_olap_torch.planner.exprutil import map_stmt_exprs
    out = map_stmt_exprs(stmt, walk)
    return out if hit else stmt


# ---------------------------------------------------------------------------
def _outer_col_refs(s, outer_tables):
    """Every outer-scope Col referenced anywhere in the subquery (the
    nested-loop substitution targets), name-sorted for determinism.
    Refs inside doubly-nested Subquery nodes are not collected — after
    substitution those resolve (or fail legibly) at their own scope."""
    from tpu_olap_torch.ir.expr import map_expr
    inner_tables = _scope_names(s)
    found = {}

    def collect(x):
        if isinstance(x, Col) and "." in x.name:
            qual = x.name.rsplit(".", 1)[0]
            if qual not in inner_tables and qual in outer_tables:
                found.setdefault(x.name, x)
        return None

    map_stmt_exprs(s, lambda e: e if e is None else map_expr(e, collect))
    return [found[n] for n in sorted(found)]


def _nested_loop_corr(kind, s, lhs, outer_stmt, outer_tables, catalog,
                      config, run, reason):
    """Bounded nested-loop decorrelation — the escape hatch for
    correlation shapes the magic-set rewrite cannot serve (VERDICT r4
    missing #2; SURVEY.md §2 property 2: rewrite failure must mean slow,
    never an error). Enumerates the outer scope's distinct correlated-
    column tuples (probe: DISTINCT over the outer FROM/JOIN tree with
    WHERE dropped — a superset is correct, the subquery re-applies its
    own predicates), refuses legibly past corr_nested_loop_cap, runs the
    subquery once per tuple with outer refs substituted as literals, and
    folds the results into the same corr_*_map nodes the rewrite emits.
    `reason` is the rewrite's FallbackError, re-raised when this hatch
    cannot apply (UNION shapes, no collectable refs)."""
    import dataclasses as _dc
    from tpu_olap_torch.ir.expr import map_expr
    if not isinstance(s, SelectStmt) \
            or not isinstance(outer_stmt, SelectStmt):
        raise reason
    refs = _outer_col_refs(s, outer_tables)
    if not refs:
        raise reason
    cap = config.corr_nested_loop_cap
    probe = _dc.replace(
        outer_stmt,
        projections=[(c, f"__ok{i}") for i, c in enumerate(refs)],
        distinct=True, where=None, group_by=[], grouping_sets=None,
        having=None, order_by=[], limit=cap + 1, offset=0)
    outer_keys = run(probe)
    if len(outer_keys) > cap:
        raise FallbackError(
            f"correlated subquery did not decorrelate ({reason}); the "
            "nested-loop fallback is bounded at corr_nested_loop_cap="
            f"{cap} distinct outer key tuples and this outer scope "
            "has more")
    names = [c.name for c in refs]

    def substitute(kt):
        env = dict(zip(names, kt))

        def sub1(x):
            if isinstance(x, Col) and x.name in env:
                return Lit(env[x.name])
            return None

        return map_stmt_exprs(
            s, lambda e: e if e is None else map_expr(e, sub1))

    kcols = [outer_keys[f"__ok{i}"] for i in range(len(refs))]
    tuples = set(_key_rows(kcols))
    if kind == "scalar":
        items = [(kt, _plain(_scalar_from(run(substitute(kt)))))
                 for kt in tuples]
        return FuncCall("corr_scalar_map",
                        (Lit(tuple(items)), Lit(None)) + tuple(refs))
    if kind == "exists":
        keyset = {
            kt for kt in tuples
            if len(run(_dc.replace(substitute(kt), limit=1,
                                   order_by=[])))}
        return FuncCall("corr_exists_map",
                        (Lit(tuple(keyset)),) + tuple(refs))
    pairs = []
    for kt in tuples:
        res = run(substitute(kt))
        if res.shape[1] != 1:
            raise FallbackError(
                "IN subquery must project exactly one column")
        for v in res.iloc[:, 0]:
            pv = _plain(v)
            if pv is not None:  # NULL members never match
                pairs.append(kt + (pv,))
    return FuncCall("corr_in_map",
                    (Lit(tuple(pairs)), lhs) + tuple(refs))


# Decorrelation (SURVEY.md §3.1 margin the reference served via Spark SQL):
# an equality-correlated subquery  (... WHERE inner_expr = outer.col ...)
# becomes a pre-aggregated key->value map over the inner table, evaluated
# per outer row by corr_*_map — the classic magic-set rewrite of the
# TPC-H correlation class (Q2/Q4/Q17/Q21/Q22 shapes), without needing
# derived-frame join plumbing.


def _plain(v):
    """Frame cell -> hashable python scalar (None for SQL null)."""
    if v is None or (not isinstance(v, (str, bytes, tuple)) and pd.isna(v)):
        return None
    return v.item() if hasattr(v, "item") else v


def _key_rows(kser):
    """Row-major normalized key tuples from key Series — one .tolist()
    per column (C-level scalar conversion) instead of per-cell .iloc,
    since these maps evaluate on frames up to fallback_scan_row_cap."""
    cols = [[_plain(x) for x in s.tolist()] for s in kser]
    return zip(*cols)


def _and_all(conjs):
    out = None
    for c in conjs:
        out = c if out is None else BinOp("&&", out, c)
    return out


_CMP_FLIP = {">": "<", "<": ">", ">=": "<=", "<=": ">=", "!=": "!="}


def _corr_split(s, outer_tables, allow_cmp=False):
    """Split the subquery WHERE into correlation keys and residual:
    keys = [(inner_expr, outer Col)] from equality conjuncts referencing
    the outer scope; cmp_keys = [(inner_expr, op, outer Col)] from
    comparison conjuncts (collected only when allow_cmp — the EXISTS
    min/max reduction); residual = pure-inner conjuncts. Raises legibly
    for any other correlation shape (outer refs outside WHERE, refs to a
    scope that is neither inner nor the immediate outer)."""
    if isinstance(s, UnionStmt):
        raise FallbackError("correlated UNION subquery is not supported")
    inner_tables = _scope_names(s)

    def outer_col(x):
        return (isinstance(x, Col) and "." in x.name
                and x.name.rsplit(".", 1)[0] not in inner_tables)

    def refs_outer(x):
        if x is None or isinstance(x, (Lit, Subquery)):
            return False
        if isinstance(x, Col):
            return outer_col(x)
        if isinstance(x, BinOp):
            return refs_outer(x.left) or refs_outer(x.right)
        if isinstance(x, WindowCall):
            return (any(refs_outer(a) for a in x.args)
                    or any(refs_outer(p) for p in x.partition_by)
                    or any(refs_outer(oe) for oe, _ in x.order_by))
        if isinstance(x, FuncCall):
            return any(refs_outer(a) for a in x.args)
        return False

    keys, cmp_keys, residual = [], [], []
    for c in _split_and(s.where):
        if not refs_outer(c):
            residual.append(c)
            continue
        ok = False
        if isinstance(c, BinOp) and c.op == "==":
            for ie, oe in ((c.right, c.left), (c.left, c.right)):
                if outer_col(oe) and not refs_outer(ie):
                    qual = oe.name.rsplit(".", 1)[0]
                    if qual not in outer_tables:
                        raise FallbackError(
                            f"subquery reference {oe.name!r} names a "
                            "table in neither the subquery nor the "
                            "immediately enclosing query")
                    keys.append((ie, oe))
                    ok = True
                    break
        elif allow_cmp and isinstance(c, BinOp) and c.op in _CMP_FLIP:
            # normalize to inner_expr OP outer_col
            for ie, oe, op in ((c.left, c.right, c.op),
                               (c.right, c.left, _CMP_FLIP[c.op])):
                if outer_col(oe) and not refs_outer(ie):
                    qual = oe.name.rsplit(".", 1)[0]
                    if qual not in outer_tables:
                        raise FallbackError(
                            f"subquery reference {oe.name!r} names a "
                            "table in neither the subquery nor the "
                            "immediately enclosing query")
                    cmp_keys.append((ie, op, oe))
                    ok = True
                    break
        if not ok:
            raise FallbackError(
                "correlated subquery: only equality"
                + ("/comparison" if allow_cmp else "")
                + " correlation to an outer column is decorrelated "
                f"(got {_auto_name(c)!r})")
    if not keys and not cmp_keys:
        raise FallbackError(
            "correlated subquery reference outside WHERE is not "
            "supported (rewrite as a join)")
    for e, _ in s.projections:
        if refs_outer(e):
            raise FallbackError(
                "correlated subquery: outer references are only "
                "decorrelated inside WHERE equality conjuncts")
    for j in s.joins:
        if refs_outer(j.on):
            raise FallbackError(
                "correlated subquery: outer reference in a JOIN "
                "condition is not supported")
    for coll in (s.group_by, [i.expr for i in s.order_by]):
        for e in coll:
            if refs_outer(e):
                raise FallbackError(
                    "correlated subquery: outer references are only "
                    "decorrelated inside WHERE equality conjuncts")
    if s.having is not None and refs_outer(s.having):
        raise FallbackError(
            "correlated subquery: outer reference in HAVING is not "
            "supported")
    return keys, cmp_keys, residual


def _corr_shape_guard(s, what):
    if isinstance(s, UnionStmt):
        raise FallbackError(f"correlated {what}: UNION is not supported")
    if s.group_by or s.having is not None or s.derived is not None \
            or s.limit is not None or s.offset:
        raise FallbackError(
            f"correlated {what}: only a plain FROM/WHERE subquery is "
            "decorrelated (rewrite as a join)")


def _decorrelate_scalar(s, outer_tables, catalog, config, run):
    """(SELECT agg(...) FROM u WHERE u.k = t.k AND residual) -> a
    key->scalar map; outer rows with no matching key take the aggregate's
    empty-input value (NULL, or 0 for COUNT) computed by actually running
    the aggregate over zero rows."""
    import dataclasses as _dc
    _corr_shape_guard(s, "scalar subquery")
    if len(s.projections) != 1 or not _contains_agg(s.projections[0][0]):
        raise FallbackError(
            "correlated scalar subquery must project exactly one "
            "aggregate expression")
    keys, _cmp, residual = _corr_split(s, outer_tables)
    proj = s.projections[0][0]
    gproj = [(ie, f"__ck{i}") for i, (ie, _) in enumerate(keys)]
    inner = _dc.replace(
        s, projections=gproj + [(proj, "__sc")], distinct=False,
        group_by=[ie for ie, _ in keys], where=_and_all(residual),
        order_by=[], limit=None, offset=0)
    try:
        sub = run(inner)
        # empty-input probe: keep the pure-inner residual (comma joins
        # need their conditions) and conjoin a statically-false leaf
        empty = _dc.replace(s, where=_and_all(residual + [Lit(False)]),
                            order_by=[], limit=None, offset=0)
        default = _scalar_from(run(empty))
    except FallbackError as err:
        # e.g. an UNQUALIFIED outer reference in the SELECT list resolves
        # as an unknown inner column — surface it as the correlation
        # limit it is, not a phantom missing column
        raise FallbackError(
            f"correlated scalar subquery did not decorrelate: {err}")
    items = []
    kcols = [sub[f"__ck{j}"] for j in range(len(keys))]
    vals = [_plain(v) for v in sub["__sc"].tolist()]
    for kt, v in zip(_key_rows(kcols), vals):
        if any(k is None for k in kt):
            continue  # a NULL key never equals anything
        items.append((kt, v))
    return FuncCall("corr_scalar_map",
                    (Lit(tuple(items)), Lit(default))
                    + tuple(oe for _, oe in keys))


def _decorrelate_exists(s, outer_tables, catalog, config, run):
    """EXISTS (SELECT ... FROM u WHERE u.k = t.k AND residual) -> a
    membership set over the correlation keys (semi-join)."""
    import dataclasses as _dc
    _corr_shape_guard(s, "EXISTS")
    if any(_contains_agg(e) for e, _ in s.projections):
        # an ungrouped aggregate subquery yields exactly one row even
        # over zero input rows, so EXISTS is true for EVERY outer row
        # (group_by shapes never reach here: _corr_shape_guard rejects)
        return Lit(True)
    keys, cmp_keys, residual = _corr_split(s, outer_tables,
                                           allow_cmp=True)
    if cmp_keys:
        # min/max reduction: EXISTS(... inner_e OP t.col AND eq-keys)
        # <=> the per-eq-group extreme of inner_e satisfies OP against
        # the outer value. Sound only for ONE comparison conjunct —
        # two comparisons must hold on the SAME inner row, which
        # min/max cannot witness
        if len(cmp_keys) > 1:
            raise FallbackError(
                "correlated EXISTS: at most one comparison-correlation "
                "conjunct is decorrelated")
        ce, op, oe_cmp = cmp_keys[0]
        inner = _dc.replace(
            s, projections=[(ie, f"__ck{i}")
                            for i, (ie, _) in enumerate(keys)]
            + [(FuncCall("min", (ce,)), "__lo"),
               (FuncCall("max", (ce,)), "__hi")],
            distinct=False, group_by=[ie for ie, _ in keys],
            where=_and_all(residual), order_by=[], limit=None, offset=0)
        sub = run(inner)
        kcols = [sub[f"__ck{j}"] for j in range(len(keys))]
        items = []
        for kt, lo, hi in zip(
                _key_rows(kcols) if keys else ((),) * len(sub),
                (_plain(v) for v in sub["__lo"].tolist()),
                (_plain(v) for v in sub["__hi"].tolist())):
            if any(k is None for k in kt) or lo is None:
                continue  # NULL key never matches; all-NULL group: no
            items.append((kt, (lo, hi)))   # non-null value to witness
        return FuncCall(
            "corr_exists_cmp_map",
            (Lit(tuple(items)), Lit(op), oe_cmp)
            + tuple(oe for _, oe in keys))
    inner = _dc.replace(
        s, projections=[(ie, f"__ck{i}") for i, (ie, _) in enumerate(keys)],
        distinct=True, group_by=[], where=_and_all(residual),
        order_by=[], limit=None, offset=0)
    sub = run(inner)
    kcols = [sub[f"__ck{j}"] for j in range(len(keys))]
    keyset = {kt for kt in _key_rows(kcols)
              if not any(k is None for k in kt)}
    return FuncCall("corr_exists_map",
                    (Lit(tuple(keyset)),) + tuple(oe for _, oe in keys))


def _decorrelate_in(lhs, s, outer_tables, catalog, config, run):
    """x IN (SELECT y FROM u WHERE u.k = t.k AND residual) -> membership
    over (key..., y) tuples; NULL x or NULL y never match (the engine's
    comparisons-with-NULL-are-False rule)."""
    import dataclasses as _dc
    _corr_shape_guard(s, "IN subquery")
    if len(s.projections) != 1:
        raise FallbackError("IN subquery must project exactly one column")
    keys, _cmp, residual = _corr_split(s, outer_tables)
    ve = s.projections[0][0]
    inner = _dc.replace(
        s, projections=[(ie, f"__ck{i}")
                        for i, (ie, _) in enumerate(keys)] + [(ve, "__v")],
        distinct=True, group_by=[], where=_and_all(residual),
        order_by=[], limit=None, offset=0)
    sub = run(inner)
    if len(sub) > config.fallback_scan_row_cap:
        raise FallbackError(
            "IN subquery result exceeds fallback_scan_row_cap")
    kcols = [sub[f"__ck{j}"] for j in range(len(keys))] + [sub["__v"]]
    pairs = {kt for kt in _key_rows(kcols)
             if not any(k is None for k in kt)}
    return FuncCall("corr_in_map",
                    (Lit(tuple(pairs)), lhs) + tuple(oe for _, oe in keys))


_JOIN_HOW = {"inner": "inner", "left": "left", "right": "right",
             "full": "outer"}


def _merge_one(df, other, j, lcol, rcol, extras, time_col):
    """One join step. Extra ON conjuncts participate in the MATCH for
    outer kinds (SQL: an unmatched preserved row keeps NULLs — it is not
    re-filtered by the ON condition), so those kinds take an inner match
    + add-back-unmatched construction; a plain post-merge filter would
    silently turn LEFT JOIN ... ON a=b AND extra into an inner join."""
    sfx = ("", f"__{j.table}")
    if j.kind == "inner" or not extras:
        out = df.merge(other, left_on=lcol, right_on=rcol,
                       how=_JOIN_HOW[j.kind], suffixes=sfx)
        for c in extras:  # inner only: filtering == matching
            out = out[_eval_bool(c, out, time_col)]
        return out
    ldf = df.reset_index(drop=True).copy()
    ldf["__lid"] = np.arange(len(ldf))
    rdf = other.reset_index(drop=True).copy()
    rdf["__rid"] = np.arange(len(rdf))
    m = ldf.merge(rdf, left_on=lcol, right_on=rcol, how="inner",
                  suffixes=sfx)
    for c in extras:
        m = m[_eval_bool(c, m, time_col)]
    parts = [m]
    if j.kind in ("left", "full"):
        parts.append(ldf[~ldf["__lid"].isin(m["__lid"])])
    if j.kind in ("right", "full"):
        un = rdf[~rdf["__rid"].isin(m["__rid"])]
        collide = [c for c in un.columns if c in ldf.columns]
        # same-named join keys coalesce into ONE output column in the
        # merged frame; keep the unmatched right rows' key under that
        # coalesced name instead of suffixing it away (else every
        # preserved-but-unmatched row reads NULL for its own key)
        ren = {c: c + sfx[1] for c in collide
               if not (c == rcol and rcol == lcol)}
        parts.append(un.rename(columns=ren))
    out = pd.concat(parts, ignore_index=True)
    return out.drop(columns=[c for c in ("__lid", "__rid")
                             if c in out.columns])


def _join_and_filter(stmt, df, catalog, time_col, config,
                     derived_cache=None):
    """Apply the statement's joins (equi-joins; conditions from ON or
    WHERE) and residual WHERE conjuncts to one frame. Fixed point over
    the join list: a snowflake chain's parent may be listed after its
    child, and the link column only appears once the parent merges.
    RIGHT/FULL OUTER joins are order-sensitive, so their presence pins
    strict listed-order processing (no deferral). The chunked drivers
    pass a shared `derived_cache` so a derived-join subquery executes
    once per query, not once per chunk."""
    derived_frames = derived_cache if derived_cache is not None else {}

    def frame_of(j):
        if j.derived is not None:
            # JOIN (SELECT ...) alias / JOIN-position CTE: its scope is
            # its own — an outer-table qualifier inside the body would
            # be silently stripped onto the inner frame by the
            # evaluator, so reject correlation up front (non-LATERAL
            # derived tables cannot see the outer row in standard SQL)
            if id(j) not in derived_frames:
                _check_uncorrelated(j.derived)
                derived_frames[id(j)] = _run_inner_stmt(
                    j.derived, catalog, config)
            return derived_frames[id(j)]
        return catalog.get(j.table).frame

    if stmt.joins and (stmt.table_alias is not None
                       or stmt.derived is not None
                       or any(j.alias is not None or j.derived is not None
                              for j in stmt.joins)):
        # the evaluator resolves qualified refs by STRIPPING the
        # qualifier, which is only sound when every qualifier maps to
        # distinctly-named columns — in an aliased multi-table scope with
        # same-named columns (e.g. a self-join `t a JOIN t b`) a stripped
        # ref would silently read the wrong frame. Allow the scope when
        # column names are pairwise disjoint (USING keys coalesce, so
        # they are exempt); reject the ambiguous remainder legibly.
        seen = set(df.columns)
        clash = set()
        for j in stmt.joins:
            cols = set(frame_of(j).columns) - set(j.using or ())
            clash |= cols & seen
            seen |= cols
        if clash:
            raise FallbackError(
                "aliased multi-table FROM with same-named columns is not "
                "supported (qualified refs would not disambiguate "
                f"{sorted(clash)[:5]})")
    where_conjs = _split_and(stmt.where)
    pending = list(stmt.joins)
    strict = any(j.kind in ("right", "full") for j in pending)
    while pending:
        still = []
        for j in pending:
            other = frame_of(j)
            if j.kind == "cross":
                df = df.merge(other, how="cross",
                              suffixes=("", f"__{j.table}"))
                continue
            if j.using is not None:
                missing = [c for c in j.using
                           if c not in df.columns or c not in other.columns]
                if missing:
                    raise FallbackError(
                        f"USING column(s) {missing} not on both sides of "
                        f"the join with {j.table!r}")
                # merge on the full column list: pandas coalesces the
                # same-named keys, matching SQL USING output
                df = df.merge(other, on=list(j.using),
                              how=_JOIN_HOW[j.kind],
                              suffixes=("", f"__{j.table}"))
                continue
            conds = _split_and(j.on) if j.on is not None else where_conjs
            pair = None
            for c in conds:
                p = _equi_pair(c, df.columns, other.columns)
                if p:
                    pair = (c, p)
                    break
            if pair is None:
                if strict:
                    raise FallbackError(
                        f"no join condition for {j.table!r} at its "
                        "position (RIGHT/FULL joins run in listed order)")
                still.append(j)
                continue
            cond, (lcol, rcol) = pair
            if j.on is None:
                where_conjs.remove(cond)
            extras = [c for c in _split_and(j.on) if c is not cond] \
                if j.on is not None else []
            df = _merge_one(df, other, j, lcol, rcol, extras, time_col)
        if len(still) == len(pending):
            raise FallbackError(
                f"no join condition for {still[0].table!r}")
        pending = still

    for c in where_conjs:
        m = _eval_bool(c, df, time_col)
        if isinstance(m, bool):  # constant predicate, e.g. EXISTS(...)
            if not m:
                df = df.iloc[0:0]
            continue
        df = df[m]
    return df


def _gset_expr(e, gkeys, full_keys):
    """Projection expr for one grouping set: absent group keys become
    NULL literals, GROUPING(key) becomes 0/1. Shared by the fallback
    union below and the device-union leg builder (grouping_set_legs)."""
    if isinstance(e, FuncCall) and e.name == "grouping" \
            and len(e.args) == 1:
        return Lit(0 if _k(e.args[0]) in gkeys else 1)
    if _k(e) in full_keys and _k(e) not in gkeys:
        return Lit(None)
    if isinstance(e, BinOp):
        return BinOp(e.op, _gset_expr(e.left, gkeys, full_keys),
                     _gset_expr(e.right, gkeys, full_keys))
    if isinstance(e, FuncCall) and e.name not in AGG_FUNCS:
        return FuncCall(e.name, tuple(_gset_expr(a, gkeys, full_keys)
                                      for a in e.args))
    return e


def grouping_set_legs(stmt):
    """Decompose a GROUPING SETS/ROLLUP/CUBE statement into one ordinary
    GROUP BY statement per set, for the DEVICE union path (VERDICT r4
    missing #4: every leg is an already-device-eligible GROUP BY, so a
    union of cached-template dispatches serves the construct at device
    speed). Returns (out_names, legs); each leg is (leg_stmt, consts)
    where consts maps output columns this set does not compute (absent
    group keys -> None, GROUPING(k) -> 0/1) for post-hoc reattachment —
    keeping constant projections OUT of the leg SQL keeps every leg on
    the same compiled template family as its plain-GROUP BY twin.
    Output aliases are pinned from the ORIGINAL exprs so every leg
    yields the same column names. ORDER BY/LIMIT are stripped (the
    caller applies them over the union). HAVING is left untouched: a
    leg whose HAVING references columns outside its set simply fails
    rewrite and runs on the fallback, which evaluates it exactly as the
    whole-statement fallback would (_aggregate receives the same
    group_exprs + untransformed HAVING either way)."""
    import dataclasses as _dc
    if any(isinstance(e, Col) and e.name == "*"
           for e, _ in stmt.projections):
        raise FallbackError("SELECT * with GROUPING SETS is fallback-only")
    full_keys = {_k(g) for g in stmt.group_by}
    out_names = [a or _auto_name(e) for e, a in stmt.projections]
    legs = []
    for gset in stmt.grouping_sets:
        gkeys = {_k(g) for g in gset}
        projs, consts = [], {}
        for (e, _a), name in zip(stmt.projections, out_names):
            t = _gset_expr(e, gkeys, full_keys)
            if isinstance(t, Lit) and not isinstance(e, Lit):
                consts[name] = t.value
                continue
            projs.append((t, name))
        if not projs:
            # all projections folded to constants (pure-dimension set):
            # the leg must still yield one row PER GROUP of this set
            # (one row for the () set), so probe with a count the caller
            # reindexes away — without it the degenerate SELECT returns
            # zero rows and the set's rows vanish from the union
            projs.append((FuncCall("count", ()), "__gsrows"))
        legs.append((_dc.replace(
            stmt, projections=list(projs), group_by=list(gset),
            grouping_sets=None, order_by=[], limit=None, offset=0),
            consts))
    return out_names, legs


def union_order_keys(stmt, out_names):
    """ORDER BY key names over a grouping-set union: each item must
    reference an output column — by its spelled name or structurally
    (the parser resolves output aliases to their exprs, so ORDER BY s
    arrives as the sum(v) tree and must map back to 's'). None when an
    item references anything else (per-row exprs are meaningless over a
    union of differently-grouped rows)."""
    key_of = {_k(e): n
              for (e, _a), n in zip(stmt.projections, out_names)}
    keys = []
    for item in stmt.order_by:
        name = _auto_name(item.expr)
        if name not in out_names:
            name = key_of.get(_k(item.expr))
        if name is None:
            return None
        keys.append(name)
    return keys


def _grouping_sets_aggregate(df, exprs, out_names, stmt, time_col):
    """GROUP BY ROLLUP/CUBE/GROUPING SETS (the reference served these
    via full Spark SQL, SURVEY.md §3.1): one _aggregate pass per
    grouping set with the ABSENT group keys projected as NULL literals,
    results unioned, then ORDER BY/LIMIT over the union (applied here,
    not per set — standard SQL). HAVING filters inside each pass."""
    import dataclasses as _dc
    full_keys = {_k(g) for g in stmt.group_by}
    inner = _dc.replace(stmt, order_by=[], limit=None, offset=0)

    parts = []
    for gset in stmt.grouping_sets:
        gkeys = {_k(g) for g in gset}
        sub_exprs = [_gset_expr(e, gkeys, full_keys) for e in exprs]
        parts.append(_aggregate(df, sub_exprs, out_names, list(gset),
                                inner, time_col))
    out = pd.concat(parts, ignore_index=True) if parts \
        else pd.DataFrame(columns=out_names)
    if stmt.order_by:
        keys = union_order_keys(stmt, out_names)
        if keys is None:
            raise FallbackError(
                "ORDER BY over GROUPING SETS must reference output "
                "columns")
        out = _sort_order_items(out, keys, stmt.order_by)
    return out.reset_index(drop=True)


def _aggregate(df, exprs, out_names, group_exprs, stmt, time_col):
    gkeys = {}
    gname_of = {}
    for i, g in enumerate(group_exprs):
        name = f"__g{i}"
        gkeys[name] = _eval(g, df, time_col)
        gname_of[_k(g)] = name
    kdf = pd.DataFrame(gkeys) if gkeys else None

    def _filtered(sub, cond):
        m = _eval(cond, sub, time_col)
        m = pd.Series(m, index=sub.index).fillna(False).astype(bool)
        return sub[m]

    def agg_series(e, sub):
        if isinstance(e, FuncCall) and e.name in AGG_FUNCS:
            if e.name == "agg_filter":
                inner, cond = e.args
                return agg_series(inner, _filtered(sub, cond))
            if e.name == "count" and not e.args:
                return len(sub)
            if e.name == "count":
                return _eval_agg_input(e.args[0], sub, time_col) \
                    .notna().sum()
            if e.name in ("count_distinct", "approx_count_distinct",
                          "theta_sketch"):
                if e.name == "theta_sketch" and len(e.args) != 1:
                    # single-field, like the device aggregator
                    raise FallbackError("theta_sketch takes one column")
                vals = [_eval_agg_input(a, sub, time_col) for a in e.args]
                if len(vals) == 1:
                    return vals[0].dropna().nunique()
                tup = pd.concat(vals, axis=1).dropna()
                return len(tup.drop_duplicates())
            if e.name in ("sum_distinct", "avg_distinct"):
                v = _eval_agg_input(e.args[0], sub, time_col) \
                    .dropna().drop_duplicates()
                if e.name == "sum_distinct":
                    return v.sum() if len(v) else np.nan
                return v.sum() / len(v) if len(v) else np.nan
            v = _eval_agg_input(e.args[0], sub, time_col)
            if e.name == "sum":
                return v.sum()
            if e.name == "min":
                return v.min()
            if e.name == "max":
                return v.max()
            if e.name == "avg":
                return v.sum() / len(sub) if len(sub) else np.nan
            raise FallbackError(f"unknown aggregate {e.name!r}")
        if isinstance(e, FuncCall) and e.name in _THETA_SET_FNS:
            return float(len(_theta_set(e, sub)))
        if isinstance(e, FuncCall) and e.name == "theta_sketch_estimate" \
                and len(e.args) == 1:
            # _theta_set validates the argument IS a sketch (a plain
            # aggregate must error, not pass through as an "estimate")
            return float(len(_theta_set(e.args[0], sub)))
        if isinstance(e, BinOp):
            l_val = agg_series(e.left, sub)
            r_val = agg_series(e.right, sub)
            if e.op == "/":
                # NULL operand -> NULL (device: NaN propagates through
                # the post-agg); else ArithmeticPostAgg rule x/0 -> 0
                if pd.isna(l_val) or pd.isna(r_val):
                    return np.nan
                return float(l_val) / r_val if r_val else 0.0
            return _APPLY[e.op](l_val, r_val)
        if isinstance(e, Lit):
            return e.value
        raise FallbackError(f"non-aggregate projection {e!r} with GROUP BY")

    def _theta_set(e, sub) -> set:
        """Exact value set for a theta set-op tree (the fallback's exact
        analog of the device's KMV set operations)."""
        if isinstance(e, FuncCall) and e.name in _THETA_SET_FNS:
            if len(e.args) < 2:  # arity parity with the device rewrite
                raise FallbackError(
                    f"{e.name} takes at least two arguments")
            parts = [_theta_set(a, sub) for a in e.args]
            if e.name == "theta_sketch_union":
                return set().union(*parts)
            if e.name == "theta_sketch_intersect":
                out = parts[0]
                for p in parts[1:]:
                    out = out & p
                return out
            out = parts[0]
            for p in parts[1:]:
                out = out - p
            return out
        inner, sub2 = e, sub
        if isinstance(e, FuncCall) and e.name == "agg_filter":
            inner = e.args[0]
            sub2 = _filtered(sub, e.args[1])
        if not (isinstance(inner, FuncCall)
                and inner.name == "theta_sketch"):
            raise FallbackError(
                "theta sketch functions take theta_sketch(...) arguments "
                f"(optionally with FILTER), got {inner!r}")
        return set(_eval_agg_input(inner.args[0], sub2, time_col)
                   .dropna())

    rows = []
    if kdf is None:
        rec = {}
        for n, e in zip(out_names, exprs):
            rec[n] = agg_series(e, df)
        having = stmt.having
        if having is not None and not _having_ok(having, df, rec, time_col,
                                                 agg_series):
            return pd.DataFrame(columns=out_names)
        rows.append(rec)
        return pd.DataFrame(rows, columns=out_names)

    fill = "\0null"
    filled = kdf.copy()
    for c in filled.columns:
        if filled[c].dtype == object or str(filled[c].dtype).startswith(
                ("str", "category")):
            filled[c] = filled[c].fillna(fill)
    # pre-resolve ORDER BY items to either an output column or an
    # extra computed key evaluated per group
    order_cols, order_exprs, ascending = [], {}, []
    for i, item in enumerate(stmt.order_by):
        name = _auto_name(item.expr)
        if name in out_names:
            order_cols.append(name)
        else:
            col = f"__s{i}"
            order_cols.append(col)
            order_exprs[col] = item.expr
        ascending.append(not item.descending)

    grouped = df.groupby([filled[c] for c in filled.columns], sort=True,
                         dropna=False)
    for key, sub in grouped:
        if not isinstance(key, tuple):
            key = (key,)
        rec = {}
        for n, e in zip(out_names, exprs):
            gk = _k(e)
            if gk in gname_of:
                pos = list(kdf.columns).index(gname_of[gk])
                v = key[pos]
                rec[n] = None if (isinstance(v, str) and v == fill) else v
            else:
                rec[n] = agg_series(e, sub)
        if stmt.having is not None and not _having_ok(
                stmt.having, sub, rec, time_col, agg_series):
            continue
        for col, e in order_exprs.items():
            rec[col] = agg_series(e, sub) if _contains_agg(e) else \
                _eval(e, sub, time_col).iloc[0]
        rows.append(rec)
    out = pd.DataFrame(rows, columns=out_names + list(order_exprs))

    if order_cols:
        out = _sort_order_items(out, order_cols, stmt.order_by)
    return out[out_names].reset_index(drop=True)


# ---------------------------------------------------------------------------
# Chunked (streamed) fallback — bounded resident rows at SF scale.

_FILL = "\0null"


def _collect_agg_calls(e, into: dict):
    if isinstance(e, FuncCall) and e.name in AGG_FUNCS:
        into[_k(e)] = e
        return
    if isinstance(e, BinOp):
        _collect_agg_calls(e.left, into)
        _collect_agg_calls(e.right, into)
    elif isinstance(e, FuncCall):
        for a in e.args:
            _collect_agg_calls(a, into)


def _fill_strings(s: pd.Series) -> pd.Series:
    if s.dtype == object or str(s.dtype).startswith(("str", "category")):
        return s.fillna(_FILL)
    return s


def _execute_chunked(stmt: SelectStmt, entry, catalog, config):
    """Execute the fallback over streamed parquet row-group chunks:
    partial aggregation per chunk + pandas merge of decomposable partial
    states (sum/min/max/count as themselves, AVG as sum+rows, DISTINCT as
    deduplicated (group, value) pairs) — the host-side mirror of the
    device path's partial/final aggregate split (SURVEY.md §3.5 P2). A
    non-aggregate result larger than fallback_scan_row_cap refuses with a
    clear error instead of exhausting host RAM."""
    time_col = entry.time_column
    if stmt.grouping_sets is not None:
        raise FallbackError(
            "GROUPING SETS/ROLLUP/CUBE over a chunked-scale table is not "
            "supported yet; aggregate per set explicitly or reduce the "
            "table")
    if any(j.kind in ("right", "full") for j in stmt.joins):
        # per-chunk outer joins would re-emit every unmatched right row
        # once per chunk; correct chunked outer joins need global match
        # tracking, which the whole-frame path provides below the
        # chunking threshold
        raise FallbackError(
            "RIGHT/FULL OUTER join over a chunked-scale table is not "
            "supported; reduce the table or flip the join around the "
            "smaller side")
    batch = config.fallback_chunk_batch_rows
    chunks = entry.iter_chunks(batch)

    out_names, exprs = [], []
    star_expand = any(isinstance(e, Col) and e.name == "*"
                      for e, _ in stmt.projections)
    first = None
    dcache: dict = {}  # derived-join frames execute once per query,
    # shared across the schema probe and the chunk loops
    if star_expand:
        first = next(chunks, None)
        if first is None:
            return pd.DataFrame()
    for e, alias in stmt.projections:
        if isinstance(e, Col) and e.name == "*":
            base = _join_and_filter(stmt, first.iloc[:0], catalog,
                                    time_col, config,
                                    derived_cache=dcache)
            for c in base.columns:
                out_names.append(c)
                exprs.append(Col(c))
            continue
        out_names.append(alias or _auto_name(e))
        exprs.append(e)
    if first is not None:
        import itertools
        chunks = itertools.chain([first], chunks)

    has_agg = any(_contains_agg(e) for e in exprs)
    group_exprs = list(stmt.group_by)
    if stmt.distinct and not has_agg and not group_exprs:
        group_exprs = list(exprs)

    from tpu_olap_torch.planner.exprutil import contains_window

    if any(contains_window(x) for x in exprs) or \
            any(contains_window(o.expr) for o in stmt.order_by):
        # per-chunk window evaluation would silently restart partitions
        # at every chunk boundary; requiring the whole frame here would
        # be the OOM the chunked path exists to avoid
        raise FallbackError(
            "window functions need the whole partition resident; over a "
            "chunked-scale table, aggregate first in a derived table "
            "(FROM (SELECT ... GROUP BY ...)) and window over that")

    if group_exprs or has_agg:
        return _chunked_aggregate(stmt, chunks, exprs, out_names,
                                  group_exprs, catalog, time_col, config,
                                  pair_cap=config.fallback_scan_row_cap,
                                  derived_cache=dcache, entry=entry)
    return _chunked_scan(stmt, chunks, exprs, out_names, catalog,
                         time_col, config, derived_cache=dcache)


def _chunked_scan(stmt, chunks, exprs, out_names, catalog, time_col,
                  config, derived_cache=None):
    order_exprs = {}
    for i, item in enumerate(stmt.order_by):
        name = _auto_name(item.expr)
        if name not in out_names:
            order_exprs[f"__s{i}"] = item.expr
    need = None
    if stmt.limit is not None and not stmt.order_by:
        need = stmt.offset + stmt.limit
    # unordered LIMIT: SQL allows any rows, but keep determinism within
    # the streamed window by sorting it on time (the whole-frame path
    # sorts the WHOLE table on time — streaming the whole table to honor
    # that exactly would defeat the early stop, so the guarantee here is
    # "time-sorted within the first chunks that satisfy the limit")
    time_sort = need is not None and time_col is not None
    parts, total = [], 0
    dcache = derived_cache if derived_cache is not None else {}
    for chunk in chunks:
        df = _join_and_filter(stmt, chunk, catalog, time_col, config,
                              derived_cache=dcache)
        if not len(df):
            continue
        part = pd.DataFrame(
            {n: _eval(e, df, time_col) for n, e in zip(out_names, exprs)})
        for col, e in order_exprs.items():
            part[col] = _eval(e, df, time_col).to_numpy()
        if time_sort and time_col in df.columns:
            part["__t"] = df[time_col].to_numpy()
        parts.append(part.reset_index(drop=True))
        total += len(part)
        if need is not None and total >= need:
            break
        if total > config.fallback_scan_row_cap:
            raise FallbackError(
                f"chunked fallback result exceeds fallback_scan_row_cap="
                f"{config.fallback_scan_row_cap} rows; narrow the query "
                "or raise the cap")
    if not parts:
        return pd.DataFrame(columns=out_names)
    out = pd.concat(parts, ignore_index=True)
    if stmt.order_by:
        keys = [(_auto_name(i.expr) if _auto_name(i.expr) in out_names
                 else f"__s{j}") for j, i in enumerate(stmt.order_by)]
        out = _sort_order_items(out, keys, stmt.order_by,
                                default_low=False)
    elif time_sort and "__t" in out.columns:
        out = out.sort_values("__t", kind="stable")
    lo = stmt.offset
    hi = None if stmt.limit is None else lo + stmt.limit
    return out[out_names].iloc[lo:hi].reset_index(drop=True)


# Fork-inherited context for the parallel chunked fallback: the worker
# function must be module-level (Pool pickles it by reference), but the
# closures/frames it needs are NOT picklable — they are handed over via
# this global, which the fork()ed children inherit by memory snapshot.
# The lock serializes concurrent parallel fallbacks (the BI server is a
# ThreadingHTTPServer and the fallback path takes no device lock): the
# global must not be overwritten between set and fork, or query A's
# workers would compute with query B's closures.
_PFORK_CTX = None
_PFORK_LOCK = threading.Lock()


def _pair_cap_refuse(name: str, pair_cap: int):
    """A high-cardinality DISTINCT aggregate needs the full value set;
    refusing with a clear error beats an OOM (the "never an error"
    property is already forfeit either way — this makes the failure
    legible/bounded). Shared by the sequential compact() and the fork
    workers so both paths refuse identically."""
    remedy = (
        "use approx_count_distinct on the device path or raise the cap"
        if name in ("count_distinct", "approx_count_distinct",
                    "theta_sketch") else "raise the cap")
    raise FallbackError(
        f"chunked fallback {name} exceeds "
        f"fallback_scan_row_cap={pair_cap} distinct pairs; {remedy}")


def _compact_pairs(pairs, distinct_specs, pair_cap):
    """Dedup each key's accumulated pair frames down to one and enforce
    the pair cap. Returns total retained pair rows."""
    total = 0
    for k, fs in pairs.items():
        if len(fs) > 1:
            pairs[k] = [pd.concat(fs, ignore_index=True)
                        .drop_duplicates()]
        if pairs[k] and len(pairs[k][0]) > pair_cap:
            _pair_cap_refuse(distinct_specs[k], pair_cap)
        total += len(pairs[k][0]) if pairs[k] else 0
    return total


def _pfork_worker(units):
    """One worker: stream assigned (path, row-group) units via the
    entry's iter_chunks (single source of the parquet read conventions),
    join+filter each chunk, compute partial aggregates, locally compact,
    and return (partial frames, {agg key: distinct-pair frames}).
    Distinct pairs are compacted and cap-checked incrementally (same
    ~1M-NEW-row trigger as the sequential loop) so a high-cardinality
    DISTINCT refuses legibly from inside the worker instead of
    accumulating toward an OOM."""
    (entry, chunk_partial, join, batch, gcols,
     merge_ops, distinct_specs, pair_cap) = _PFORK_CTX
    partials, pairs = [], {}
    pending_pairs = 0
    for chunk in entry.iter_chunks(batch_rows=batch, units=units):
        df = join(chunk)
        if not len(df):
            continue
        part, dp = chunk_partial(df)
        partials.append(part)
        for k, p in dp.items():
            pairs.setdefault(k, []).append(p)
            pending_pairs += len(p)
        if pending_pairs > (1 << 20):
            _compact_pairs(pairs, distinct_specs, pair_cap)
            pending_pairs = 0  # counts NEW pairs since last compaction
    if len(partials) > 1:  # bound the IPC payload
        cat = pd.concat(partials, ignore_index=True)
        if gcols:
            partials = [cat.groupby(gcols, sort=False, dropna=False)
                           .agg(merge_ops).reset_index()]
        else:
            partials = [cat.agg(merge_ops).to_frame().T]
    _compact_pairs(pairs, distinct_specs, pair_cap)
    return partials, pairs


def _parallel_timeout_s(config, entry) -> float:
    """Bound on the fork pool's map (ADVICE round 5): a deadlocked child
    must trigger the safe sequential retry interactively (the 45 s
    default), not after 15 min — but a legitimately huge parallel
    aggregate must not be cut off either, so the bound scales with the
    estimated scan size once the table passes ~200M rows (the default
    then grows proportionally: 2B rows -> 450 s)."""
    t = float(config.fallback_parallel_timeout_s)
    rows = (getattr(entry, "parquet_rows", None) or 0) \
        if entry is not None else 0
    return max(t, t * rows / 200_000_000.0)


def _parallel_chunk_partials(stmt, entry, catalog, config, time_col,
                             chunk_partial, gcols, merge_ops,
                             distinct_specs, pair_cap, dcache):
    """Fan the chunk loop over a fork Pool of row-group readers (VERDICT
    r4 missing #3: the reference's slow path was distributed Spark; a
    single-core pandas loop at SF100 is minutes per query, and the chunk
    loop is embarrassingly parallel for decomposable partials). Returns
    (partials, pair_parts, empty_proto) or None when the parallel path
    does not apply (sequential caller takes over): no parquet paths,
    fewer than two row groups, one worker, or no fork on this platform.
    The derived-join cache is pre-populated by the 0-row schema probe
    BEFORE forking, so every worker inherits the executed derived frames
    instead of re-running them per process."""
    import multiprocessing as mp
    import os as _os

    global _PFORK_CTX
    paths = entry.parquet_paths if entry is not None else None
    if not paths:
        return None
    ds = getattr(entry, "delta_source", None)
    if ds is not None and ds()[1]:
        # appended delta rows (docs/INGEST.md) ride only the sequential
        # iter_chunks tail; per-worker row-group units would miss them
        # (or the leader would double-count) — take the sequential path
        return None
    workers = config.fallback_parallel_workers
    if workers == 0:
        workers = min(8, _os.cpu_count() or 1)
    try:
        ctx = mp.get_context("fork")
    except ValueError:
        return None
    import pyarrow.parquet as pq
    units = []  # (path, row-group index)
    for path in paths:
        pf = pq.ParquetFile(path)
        try:
            units.extend((path, rg)
                         for rg in range(pf.metadata.num_row_groups))
        finally:
            pf.close()
    workers = min(workers, len(units))
    if workers < 2:
        return None

    # 0-row schema probe: the real joined schema for the empty-result
    # path, and it executes any derived-table joins once into dcache
    empty_proto = _join_and_filter(stmt, entry.parquet_empty_frame(),
                                   catalog, time_col, config,
                                   derived_cache=dcache)

    def join(chunk):
        return _join_and_filter(stmt, chunk, catalog, time_col, config,
                                derived_cache=dcache)

    # interleave row groups across workers (adjacent groups tend to have
    # correlated sizes); group back into per-worker (path, [rgs]) lists
    per_worker = []
    for w in range(workers):
        mine = units[w::workers]
        by_path: dict = {}
        for path, rg in mine:
            by_path.setdefault(path, []).append(rg)
        per_worker.append(sorted(by_path.items()))

    # the lock covers only ctx-set -> fork: Pool() forks its workers at
    # construction, each child snapshotting _PFORK_CTX by fork memory
    # copy, so the global can be cleared (and the lock released) before
    # the map runs — concurrent queries' parallel fallbacks overlap
    # instead of serializing behind the slowest pool
    with _PFORK_LOCK:
        # each worker gets pair_cap // workers: the workers' in-flight
        # distinct-pair sets coexist, so per-worker caps must SUM to the
        # configured cap — with the full cap per worker, total in-flight
        # pairs could transiently reach workers x pair_cap before the
        # parent-side merge re-checks the real cap
        _PFORK_CTX = (entry, chunk_partial, join,
                      config.fallback_chunk_batch_rows,
                      gcols, merge_ops, distinct_specs,
                      max(1, pair_cap // workers))
        try:
            pool = ctx.Pool(workers)
        except Exception:  # noqa: BLE001 — sequential retry is sound
            return None
        finally:
            _PFORK_CTX = None
    try:
        # the parent process may hold a CUDA context and torch's thread
        # pools, so fork carries a lock-inheritance hazard (workers never
        # call torch or CUDA — a forked child cannot use the parent's
        # context — and pyarrow re-inits its pools atfork, but belt-and-
        # braces): any worker
        # failure OR a stuck pool degrades to the sequential loop — the
        # chunk generator is still unconsumed at this point, and the
        # bounded timeout keeps a deadlocked child from stalling the
        # query for more than fallback_parallel_timeout_s
        with pool:
            results = pool.map_async(_pfork_worker, per_worker) \
                .get(timeout=_parallel_timeout_s(config, entry))
    except FallbackError:
        # a worker's pair-cap refusal fired at the DIVIDED cap
        # (pair_cap // workers) — ambiguous about the real cap, because
        # interleaved row groups make each worker's distinct set nearly
        # duplicate the global universe rather than partition it. The
        # sequential loop enforces the configured cap exactly: it either
        # succeeds (the refusal was false) or refuses legibly at the
        # true cap.
        return None
    except Exception:  # noqa: BLE001 — sequential retry is sound
        return None
    partials = []
    pair_parts = {k: [] for k in distinct_specs}
    for parts, pairs in results:
        partials.extend(parts)
        for k, fs in pairs.items():
            pair_parts[k].extend(fs)
    return partials, pair_parts, empty_proto


def _chunked_aggregate(stmt, chunks, exprs, out_names, group_exprs,
                       catalog, time_col, config,
                       pair_cap=20_000_000, derived_cache=None,
                       entry=None):
    # every aggregate call reachable from projections / HAVING / ORDER BY
    agg_calls: dict = {}
    for e in exprs:
        _collect_agg_calls(e, agg_calls)
    if stmt.having is not None:
        _collect_agg_calls(stmt.having, agg_calls)
    for item in stmt.order_by:
        _collect_agg_calls(item.expr, agg_calls)
    specs = list(agg_calls.items())  # [(key, FuncCall)]

    gcols = [f"__g{i}" for i in range(len(group_exprs))]
    gname_of = {_k(g): n for g, n in zip(group_exprs, gcols)}
    merge_ops: dict = {"__rows": "sum"}

    def _unwrap(e):
        """agg_filter(inner, cond) -> (inner, cond); plain -> (e, None)."""
        if e.name == "agg_filter":
            return e.args[0], e.args[1]
        return e, None

    # every aggregate needing the full per-group distinct value set rides
    # the same deduped (group, value)-pairs accumulation across chunks
    distinct_specs = {k: _unwrap(e)[0].name for k, e in specs
                      if _unwrap(e)[0].name in (
                          "count_distinct", "approx_count_distinct",
                          "theta_sketch", "sum_distinct", "avg_distinct")}
    distinct_keys = list(distinct_specs)

    # merge_ops is complete BEFORE any chunk runs (mirrors the per-spec
    # branches of chunk_partial): the parallel path's parent process
    # merges worker partials without ever executing a chunk itself, and
    # an unsupported aggregate errors before any IO is spent
    for i, (k, e0) in enumerate(specs):
        e, cond = _unwrap(e0)
        if k in distinct_specs:
            continue
        if e.name == "count" and not e.args:
            if cond is not None:
                merge_ops[f"p{i}"] = "sum"
            continue
        if e.name == "count":
            merge_ops[f"p{i}"] = "sum"
        elif e.name in ("sum", "avg"):
            merge_ops[f"p{i}"] = "sum"
            if e.name == "avg" and cond is not None:
                merge_ops[f"p{i}n"] = "sum"
        elif e.name in ("min", "max"):
            merge_ops[f"p{i}"] = e.name
        else:
            raise FallbackError(
                f"aggregate {e.name!r} has no chunked fallback")

    def chunk_partial(df):
        """One chunk -> (partials frame, {agg key: distinct-pairs frame})."""
        work = {}
        for g, n in zip(group_exprs, gcols):
            work[n] = _fill_strings(_eval(g, df, time_col))
        work["__rows"] = np.ones(len(df), np.int64)
        dpairs = {}
        for i, (k, e) in enumerate(specs):
            e, cond = _unwrap(e)
            mask = None
            if cond is not None:
                mask = pd.Series(_eval(cond, df, time_col),
                                 index=df.index).fillna(False).astype(bool)
            if e.name in ("count_distinct", "approx_count_distinct",
                          "theta_sketch", "sum_distinct", "avg_distinct"):
                if e.name == "theta_sketch" and len(e.args) != 1:
                    raise FallbackError("theta_sketch takes one column")
                sub = df if mask is None else df[mask]
                gsub = {n: (work[n] if mask is None else work[n][mask])
                        for n in gcols}
                cols = dict(
                    gsub,
                    **{f"v{j}": _eval_agg_input(a, sub, time_col)
                       for j, a in enumerate(e.args)})
                p = pd.DataFrame(cols).dropna(
                    subset=[f"v{j}" for j in range(len(e.args))])
                dpairs[k] = p.drop_duplicates()
                continue
            # merge_ops is pre-computed above (single source of truth);
            # this function only materializes the matching work columns
            if e.name == "count" and not e.args:
                if mask is not None:  # filtered row count
                    work[f"p{i}"] = mask.astype(np.int64)
                continue  # unfiltered: __rows covers it
            v = _eval_agg_input(e.args[0], df, time_col)
            if mask is not None:
                v = v.where(mask)
            if e.name == "count":
                # v.where(mask) above already nulled masked-out rows
                work[f"p{i}"] = v.notna().astype(np.int64)
            elif e.name in ("sum", "avg"):
                work[f"p{i}"] = v
                if e.name == "avg" and mask is not None:
                    # filtered avg denominator: filtered row count
                    work[f"p{i}n"] = mask.astype(np.int64)
            elif e.name in ("min", "max"):
                work[f"p{i}"] = v
            else:
                raise FallbackError(
                    f"aggregate {e.name!r} has no chunked fallback")
        wf = pd.DataFrame(work, index=df.index)
        if gcols:
            return (wf.groupby(gcols, sort=False, dropna=False)
                      .agg(merge_ops).reset_index(), dpairs)
        return wf.agg(merge_ops).to_frame().T, dpairs

    partials: list = []
    pair_parts: dict = {k: [] for k in distinct_keys}

    def compact():
        nonlocal partials
        if len(partials) > 1:
            cat = pd.concat(partials, ignore_index=True)
            if gcols:
                partials = [cat.groupby(gcols, sort=False, dropna=False)
                               .agg(merge_ops).reset_index()]
            else:
                partials = [cat.agg(merge_ops).to_frame().T]
        _compact_pairs(pair_parts, distinct_specs, pair_cap)

    pending_rows = 0
    empty_proto = None   # 0-row joined frame with the real schema
    dcache = derived_cache if derived_cache is not None else {}
    par = _parallel_chunk_partials(stmt, entry, catalog, config, time_col,
                                   chunk_partial, gcols, merge_ops,
                                   distinct_specs, pair_cap, dcache)
    if par is not None:
        partials, pp, empty_proto = par
        for k, frames in pp.items():
            pair_parts[k].extend(frames)
        compact()
    else:
        for chunk in chunks:
            df = _join_and_filter(stmt, chunk, catalog, time_col, config,
                                  derived_cache=dcache)
            if empty_proto is None:
                empty_proto = df.iloc[0:0]
            if not len(df):
                continue
            part, dpairs = chunk_partial(df)
            partials.append(part)
            for k, p in dpairs.items():
                pair_parts[k].append(p)
            # distinct pairs count toward the compaction trigger too — a
            # high-cardinality DISTINCT grows pairs by up to a whole
            # chunk while adding one partial row, and the pair cap is
            # enforced inside compact()
            pending_rows += len(part) + sum(len(p) for p in dpairs.values())
            if pending_rows > (1 << 20):
                compact()
                pending_rows = 0
    if not partials:
        if gcols:
            return pd.DataFrame(columns=out_names)
        # global aggregate over zero matching rows: delegate to the
        # in-memory aggregator on a 0-row frame CARRYING THE REAL SCHEMA
        # so column references resolve (count->0, sum->0, min->NA)
        if empty_proto is None:
            empty_proto = pd.DataFrame(columns=out_names)
        return _aggregate(empty_proto, exprs, out_names, [], stmt,
                          time_col)
    compact()
    merged = partials[0]

    def _norm_key(t):
        """NaN group-key slots normalize to the string fill so dict
        lookups hit (nan != nan would always miss)."""
        return tuple(_FILL if (not isinstance(v, str) and pd.isna(v))
                     else v for v in t)

    # distinct counts per group: {agg key: {group tuple: count}};
    # sum/avg over distinct values: {agg key: {group tuple: (sum, n)}}
    dcounts: dict = {}
    dstats: dict = {}
    for k in distinct_keys:
        pairs = pair_parts[k][0] if pair_parts[k] else \
            pd.DataFrame(columns=gcols + ["v0"])
        if distinct_specs[k] in ("sum_distinct", "avg_distinct"):
            if gcols:
                grp = pairs.groupby(gcols, sort=False, dropna=False)["v0"]
                sizes = grp.size()
                dstats[k] = {
                    _norm_key(kk if isinstance(kk, tuple) else (kk,)):
                        (sv, int(nv))
                    for (kk, sv), nv in zip(grp.sum().items(), sizes)}
            else:
                v = pairs["v0"]
                dstats[k] = {(): (v.sum() if len(v) else np.nan, len(v))}
            continue
        if gcols:
            sizes = pairs.groupby(gcols, sort=False, dropna=False).size()
            dcounts[k] = {_norm_key(kk if isinstance(kk, tuple)
                                    else (kk,)): int(v)
                          for kk, v in sizes.items()}
        else:
            dcounts[k] = {(): len(pairs)}

    spec_col = {k: f"p{i}" for i, (k, _) in enumerate(specs)}

    # ---- theta set ops over the distinct-pair frames (SF-scale analog
    # of the in-memory exact sets): each sketch argument's (group, value)
    # pairs are already accumulated; set algebra is frame algebra.
    def _norm_pairs(f: pd.DataFrame) -> pd.DataFrame:
        # pandas merges do not match NaN keys: normalize numeric
        # group-key NaNs to the string fill (strings already carry it).
        # __v is object-typed so differently-typed sketches merge to the
        # empty set (like the in-memory path) instead of raising, and
        # only the FIRST value column counts (theta is single-field;
        # extra pair columns would explode the joins many-to-many).
        out = {c: _norm_gcol(f[c]) for c in gcols}
        out["__v"] = f[f.columns[len(gcols)]].astype(object)
        return pd.DataFrame(out).drop_duplicates(ignore_index=True)

    def _setop_frame(e) -> pd.DataFrame:
        if isinstance(e, FuncCall) and e.name in _THETA_SET_FNS:
            if len(e.args) < 2:
                raise FallbackError(
                    f"{e.name} takes at least two arguments")
            parts = [_setop_frame(a) for a in e.args]
            on = gcols + ["__v"]
            if e.name == "theta_sketch_union":
                return pd.concat(parts, ignore_index=True) \
                    .drop_duplicates(ignore_index=True)
            if e.name == "theta_sketch_intersect":
                out = parts[0]
                for p in parts[1:]:
                    out = out.merge(p, on=on)
                return out
            out = parts[0]
            for p in parts[1:]:
                m = out.merge(p, on=on, how="left", indicator=True)
                out = m[m["_merge"] == "left_only"].drop(columns="_merge")
            return out
        inner = e.args[0] if isinstance(e, FuncCall) \
            and e.name == "agg_filter" else e
        if not (isinstance(inner, FuncCall)
                and inner.name == "theta_sketch"):
            raise FallbackError(
                "theta sketch functions take theta_sketch(...) arguments "
                f"(optionally with FILTER), got {inner!r}")
        ka = _k(e)
        cached = norm_pairs_cache.get(ka)
        if cached is None:
            cached = _norm_pairs(pair_parts[ka][0]) if pair_parts.get(ka) \
                else pd.DataFrame(columns=gcols + ["__v"])
            norm_pairs_cache[ka] = cached
        return cached

    setop_counts: dict = {}
    norm_pairs_cache: dict = {}

    def _setop_count_dict(e) -> dict:
        k = _k(e)
        if k not in setop_counts:
            f = _setop_frame(e)
            if gcols:
                sizes = f.groupby(gcols, sort=False, dropna=False).size()
                setop_counts[k] = {
                    _norm_key(kk if isinstance(kk, tuple) else (kk,)):
                    int(v) for kk, v in sizes.items()}
            else:
                setop_counts[k] = {(): len(f)}
        return setop_counts[k]

    def _estimate_arg(e):
        """theta_sketch_estimate argument: a setop node, or a validated
        leaf sketch (a non-sketch aggregate must error, not pass
        through)."""
        a = e.args[0]
        if isinstance(a, FuncCall) and a.name in _THETA_SET_FNS:
            return a, True
        inner = a.args[0] if isinstance(a, FuncCall) \
            and a.name == "agg_filter" else a
        if not (isinstance(inner, FuncCall)
                and inner.name == "theta_sketch"):
            raise FallbackError(
                "theta sketch functions take theta_sketch(...) arguments "
                f"(optionally with FILTER), got {inner!r}")
        return a, False

    def merged_agg(e, row, gkey):
        k = _k(e)
        inner, cond = _unwrap(e)
        if inner.name in ("count_distinct", "approx_count_distinct",
                          "theta_sketch"):
            return dcounts[k].get(_norm_key(gkey), 0)
        if inner.name in ("sum_distinct", "avg_distinct"):
            s, c = dstats[k].get(_norm_key(gkey), (np.nan, 0))
            if not c:
                return np.nan
            return s if inner.name == "sum_distinct" else s / c
        if inner.name == "count" and not inner.args:
            return int(row[spec_col[k]] if cond is not None
                       else row["__rows"])
        if inner.name == "count":
            return int(row[spec_col[k]])
        if inner.name == "avg":
            r = int(row[spec_col[k] + "n"] if cond is not None
                    else row["__rows"])
            return row[spec_col[k]] / r if r else np.nan
        return row[spec_col[k]]

    def ev_merged(e, row, gkey):
        if isinstance(e, Lit):
            return e.value
        if isinstance(e, FuncCall) and e.name in _THETA_SET_FNS:
            return float(_setop_count_dict(e).get(_norm_key(gkey), 0))
        if isinstance(e, FuncCall) and e.name == "theta_sketch_estimate" \
                and len(e.args) == 1:
            a, is_setop = _estimate_arg(e)
            if is_setop:
                return float(_setop_count_dict(a).get(_norm_key(gkey), 0))
            return float(merged_agg(a, row, gkey))
        if isinstance(e, FuncCall) and e.name in AGG_FUNCS:
            return merged_agg(e, row, gkey)
        k = _k(e)
        if k in gname_of:
            v = row[gname_of[k]]
            return None if (isinstance(v, str) and v == _FILL) else v
        if isinstance(e, BinOp):
            l_val = ev_merged(e.left, row, gkey)
            r_val = ev_merged(e.right, row, gkey)
            if e.op == "/":
                # NULL operand -> NULL (device: NaN propagates through
                # the post-agg); else ArithmeticPostAgg rule x/0 -> 0
                if pd.isna(l_val) or pd.isna(r_val):
                    return np.nan
                return float(l_val) / r_val if r_val else 0.0
            return _APPLY[e.op](l_val, r_val)
        raise FallbackError(
            f"non-aggregate projection {e!r} with GROUP BY")

    order_cols, order_exprs, ascending = [], {}, []
    for i, item in enumerate(stmt.order_by):
        name = _auto_name(item.expr)
        if name in out_names:
            order_cols.append(name)
        else:
            col = f"__s{i}"
            order_cols.append(col)
            order_exprs[col] = item.expr
        ascending.append(not item.descending)

    def _vec_count_lookup(d: dict, fill=0, dtype="int64") -> pd.Series:
        """{group tuple: value} -> Series aligned to merged's rows:
        normalize NaN group-key slots to the string fill exactly like
        _norm_key, then reindex. fill/dtype support the float-valued
        sum_distinct lookups (absent group -> NaN)."""
        if not gcols:
            return pd.Series([d.get((), fill)] * len(merged),
                             index=merged.index)
        mi = pd.MultiIndex.from_frame(
            pd.DataFrame({c: _norm_gcol(merged[c]) for c in gcols}))
        if d:
            # dtype at construction: Int64 luts must not round-trip
            # through the float64 promotion reindex would otherwise do
            lut = pd.Series(list(d.values()), dtype=dtype,
                            index=pd.MultiIndex.from_tuples(d))
            vals = lut.reindex(mi)
            vals = vals.fillna(fill) if not pd.isna(fill) else vals
            vals = vals.astype(dtype)
        else:
            vals = pd.Series(fill, index=mi, dtype=dtype)
        if str(vals.dtype) == "Int64":
            # keep the extension array: to_numpy() would degrade Int64
            # to an object array of pd.NA-mixed Python ints
            return pd.Series(vals.array, index=merged.index)
        return pd.Series(vals.to_numpy(), index=merged.index)

    def vec_merged(e) -> pd.Series:
        """Vectorized ev_merged over the whole merged frame — the emit
        is O(groups) and a per-row Python loop dominates at-scale
        fallback time (200k groups ≈ seconds)."""
        if isinstance(e, Lit):
            return pd.Series([e.value] * len(merged), index=merged.index)
        if isinstance(e, FuncCall) and e.name in _THETA_SET_FNS:
            return _vec_count_lookup(_setop_count_dict(e)).astype(float)
        if isinstance(e, FuncCall) and e.name == "theta_sketch_estimate" \
                and len(e.args) == 1:
            a, is_setop = _estimate_arg(e)
            if is_setop:
                return _vec_count_lookup(_setop_count_dict(a)) \
                    .astype(float)
            return vec_merged(a).astype(float)
        if isinstance(e, FuncCall) and e.name in AGG_FUNCS:
            k = _k(e)
            inner, cond = _unwrap(e)
            if inner.name in ("count_distinct", "approx_count_distinct",
                              "theta_sketch"):
                return _vec_count_lookup(dcounts[k])
            if inner.name in ("sum_distinct", "avg_distinct"):
                vals = {g: v[0] for g, v in dstats[k].items()}
                # integer sums stay exact via the nullable Int64 dtype
                # (a float64 cast would round past 2^53, diverging from
                # the whole-frame path); floats keep NaN semantics
                int_exact = all(isinstance(x, (int, np.integer))
                                for x in vals.values())
                s = _vec_count_lookup(
                    vals, fill=pd.NA if int_exact else np.nan,
                    dtype="Int64" if int_exact else "float64")
                if inner.name == "sum_distinct":
                    return s
                n = _vec_count_lookup(
                    {g: v[1] for g, v in dstats[k].items()},
                    fill=np.nan, dtype="float64")
                return s.astype("float64") / n.where(n != 0, np.nan)
            if inner.name == "count" and not inner.args:
                s = merged[spec_col[k]] if cond is not None \
                    else merged["__rows"]
                return s.astype("int64")
            if inner.name == "count":
                return merged[spec_col[k]].astype("int64")
            if inner.name == "avg":
                r = (merged[spec_col[k] + "n"] if cond is not None
                     else merged["__rows"]).astype("float64")
                # r == 0 -> NaN, matching the scalar `if r else nan`
                return merged[spec_col[k]].astype("float64") / \
                    r.where(r != 0, np.nan)
            return merged[spec_col[k]]
        k = _k(e)
        if k in gname_of:
            s = merged[gname_of[k]]
            if s.dtype == object or \
                    str(s.dtype).startswith(("str", "category")):
                return s.where(s != _FILL, None)
            return s
        if isinstance(e, BinOp):
            l_val = vec_merged(e.left)
            r_val = vec_merged(e.right)
            if e.op == "/":
                lf = pd.to_numeric(l_val, errors="coerce") \
                    .astype("float64")
                rf = pd.to_numeric(r_val, errors="coerce") \
                    .astype("float64")
                out = (lf / rf.where(rf != 0, 1.0)).where(rf != 0, 0.0)
                return out.where(~(lf.isna() | rf.isna()), np.nan)
            return _APPLY[e.op](l_val, r_val)
        raise FallbackError(
            f"non-aggregate projection {e!r} with GROUP BY")

    if gcols:
        merged = merged.sort_values(gcols, kind="stable")
    if stmt.having is None:
        cols = {n: vec_merged(e) for n, e in zip(out_names, exprs)}
        for col, e in order_exprs.items():
            cols[col] = vec_merged(e)
        out = pd.DataFrame(cols).reset_index(drop=True)
    else:
        # HAVING keeps the scalar path: its NULL-comparison semantics
        # (_having_ok) are defined per row
        rows = []
        for _, row in merged.iterrows():
            gkey = tuple(row[c] for c in gcols)
            rec = {n: ev_merged(e, row, gkey)
                   for n, e in zip(out_names, exprs)}
            if not _having_ok(
                    stmt.having, None, rec, time_col,
                    lambda x, sub, _r=row, _g=gkey: ev_merged(x, _r, _g)):
                continue
            for col, e in order_exprs.items():
                rec[col] = ev_merged(e, row, gkey)
            rows.append(rec)
        out = pd.DataFrame(rows, columns=out_names + list(order_exprs))
    if order_cols:
        out = _sort_order_items(out, order_cols, stmt.order_by)
    out = out[out_names].reset_index(drop=True)
    lo = stmt.offset
    hi = None if stmt.limit is None else lo + stmt.limit
    return out.iloc[lo:hi].reset_index(drop=True)


def _sort_order_items(out: pd.DataFrame, cols: list, items: list,
                      default_low: bool = True) -> pd.DataFrame:
    """THE ORDER BY sorter for every fallback path: multi-key stable
    sort via successive stable single-key sorts (last key first),
    honoring per-key NULLS FIRST/LAST. A key without a spelling takes
    the site default: nulls-low (`default_low=True`, matching the device
    path's null placement) or pandas-plain (nulls last in both
    directions — the historical scan-path behavior). Keeping one helper
    prevents the per-site copies from drifting (a missed site silently
    ignored the spelling; split defaults flipped unspelled keys)."""
    for col, item in list(zip(cols, items))[::-1]:
        asc = not item.descending
        keyed = _null_low_key(out[col])
        out = out.loc[keyed.sort_values(ascending=asc,
                                        kind="stable").index]
        if item.nulls is not None:
            want_first = item.nulls == "first"
        elif default_low:
            want_first = asc       # nulls-low: already where they landed
        else:
            want_first = False     # pandas default: nulls last either way
        nulls_first_now = asc      # the nulls-low key put them here
        if want_first != nulls_first_now:
            m = pd.isna(out[col]).to_numpy()
            if m.any():
                parts = (out[m], out[~m]) if want_first \
                    else (out[~m], out[m])
                out = pd.concat(parts)
    return out


def _null_low_key(s: pd.Series) -> pd.Series:
    """Sort key matching the device path's null placement: null == ""
    for string dims (Druid's legacy null ordering) and -inf for numeric
    keys, i.e. nulls FIRST ascending — pandas defaults put them last.
    Aggregate outputs arrive as object dtype whenever a group's value is
    NULL, so object columns are re-typed by inspecting their values
    (stringifying numbers would sort them lexicographically)."""
    if pd.api.types.is_datetime64_any_dtype(s):
        return s.fillna(pd.Timestamp.min)
    if pd.api.types.is_extension_array_dtype(s.dtype) and \
            pd.api.types.is_numeric_dtype(s):
        return pd.Series(s.to_numpy(dtype=np.float64, na_value=-np.inf),
                         index=s.index)
    if s.dtype == object or str(s.dtype).startswith(("str", "category")):
        # explicit comprehensions, NOT Series.map: pandas 3 skips NA values
        # by default, which would leave nulls sorting last again
        non_null = [v for v in s if not pd.isna(v)]
        if non_null and all(
                isinstance(v, (int, float, np.integer, np.floating))
                and not isinstance(v, bool) for v in non_null):
            return pd.Series([-np.inf if pd.isna(v) else float(v)
                              for v in s], index=s.index)
        return pd.Series(["" if pd.isna(v) else str(v) for v in s],
                         index=s.index)
    if pd.api.types.is_float_dtype(s) and s.isna().any():
        return s.fillna(-np.inf)
    return s


_CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")


def _having_ok(having, sub, rec, time_col, agg_series) -> bool:
    """NULL-aggregate semantics match the device path (results.eval_having):
    NULL aggregates surface there as NaN in float64 arrays, so every
    comparison against them is False and NOT flips that to True. Here the
    NULL may be pd.NA instead of NaN, so comparisons collapse an NA operand
    to False explicitly; arithmetic propagates NA; a bare NA truth value at
    the top is False."""
    e = having

    def ev(x):
        if isinstance(x, Lit):
            return x.value
        if isinstance(x, BinOp) and (
                x.op in _CMP_OPS or x.op in ("&&", "||")):
            lv, rv = ev(x.left), ev(x.right)
            if x.op in _CMP_OPS and (pd.isna(lv) or pd.isna(rv)):
                return False
            if x.op in ("&&", "||"):
                lv = False if pd.isna(lv) else bool(lv)
                rv = False if pd.isna(rv) else bool(rv)
            return _APPLY[x.op](lv, rv)
        if isinstance(x, FuncCall) and x.name == "not":
            v = ev(x.args[0])
            return True if pd.isna(v) else not v
        if _contains_agg(x):
            return agg_series(x, sub)
        if isinstance(x, Col):
            return rec.get(x.name)
        if isinstance(x, BinOp):
            return _APPLY[x.op](ev(x.left), ev(x.right))
        raise FallbackError(f"cannot evaluate HAVING {x!r}")
    v = ev(e)
    return False if pd.isna(v) else bool(v)


# ---------------------------------------------------------------------------

_APPLY = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "&&": lambda a, b: a & b, "||": lambda a, b: a | b,
}


def _ts(series, time_col):
    if pd.api.types.is_datetime64_any_dtype(series):
        return series
    return pd.to_datetime(series, unit="ms")


def _eval(e, df, time_col):
    """Expression -> Series aligned with df (scalar for Lit)."""
    if isinstance(e, Lit):
        n = len(df)
        if not n:
            return pd.Series([], dtype=object)
        v = e.value
        # np.full instead of a python list: a literal operand over a
        # wide frame must not cost O(n) list construction + inference
        # (it dominated simple-WHERE fallback profiles). Exact-dtype
        # parity with the list path: bool stays bool, int64-range ints
        # stay int64, floats float64, everything else object.
        if type(v) is bool or type(v) is float:
            arr = np.full(n, v)
        elif type(v) is int and -(2 ** 63) <= v < 2 ** 63:
            arr = np.full(n, v, dtype=np.int64)
        elif isinstance(v, (list, tuple, set, dict)):
            return pd.Series([v] * n, index=df.index)
        else:
            arr = np.full(n, v, dtype=object)
        return pd.Series(arr, index=df.index)
    if isinstance(e, Col):
        name = e.name.split(".")[-1]
        if name not in df.columns:
            raise FallbackError(f"unknown column {name!r}")
        return df[name]
    if isinstance(e, BinOp):
        if e.op in ("==", "!=", "<", "<=", ">", ">=") and (
                (isinstance(e.left, Lit) and e.left.value is None)
                or (isinstance(e.right, Lit) and e.right.value is None)):
            # comparison against a NULL literal (e.g. an empty scalar
            # subquery inlined as Lit(None)) matches no rows — pandas
            # would raise a TypeError on `series > None`
            return pd.Series(np.zeros(len(df), bool), index=df.index)
        if e.op == "!=":
            # a <> b IS NOT(a = b) engine-wide (the planner lowers it
            # that way; NULL-operand rows match). Direct pandas `!=`
            # would depend on the dtype representation: float-NaN
            # comparisons yield True while nullable-dtype NA yields NA
            # -> fillna(False) — opposite answers for the same data.
            return ~_eval(BinOp("==", e.left, e.right), df, time_col)
        left = _eval(e.left, df, time_col)
        right = _eval(e.right, df, time_col)
        if e.op == "/":
            left = left.astype(float) if hasattr(left, "astype") else left
        out = _APPLY[e.op](left, right)
        if e.op in ("==", "!=", "<", "<=", ">", ">=", "&&", "||") and \
                hasattr(out, "fillna"):
            # filter-context semantics: a comparison with a NULL operand is
            # False at the leaf (matches the device's filtereval rule).
            # Aggregation inputs instead mask whole-expression nulls via
            # _expr_null_mask — matching kernels.exprs.virtual_null_mask.
            out = out.fillna(False).astype(bool)
        return out
    if isinstance(e, WindowCall):
        return _eval_window(e, df, time_col)
    if isinstance(e, FuncCall):
        fn = e.name
        if fn in _TIME_FUNCS:
            t = _ts(_eval(e.args[0], df, time_col), time_col)
            return getattr(t.dt, {"day": "day", "dayofmonth": "day"}
                           .get(fn, fn))
        if fn == "date_trunc":
            unit = str(e.args[0].value).lower()
            t = _ts(_eval(e.args[1], df, time_col), time_col)
            freq = {"second": "s", "minute": "min", "hour": "h", "day": "D",
                    "week": "W", "month": "MS", "quarter": "QS",
                    "year": "YS"}[unit]
            if unit in ("month", "quarter", "year", "week"):
                return t.dt.to_period(
                    {"month": "M", "quarter": "Q", "year": "Y",
                     "week": "W-SUN"}[unit]).dt.start_time
            return t.dt.floor(freq)
        if fn == "coalesce":
            out = None
            for a in e.args:
                v = _eval(a, df, time_col)
                if not isinstance(v, pd.Series):
                    v = pd.Series([v] * len(df), index=df.index)
                out = v if out is None else out.where(out.notna(), v)
            return out
        if fn == "nullif":
            a = _eval(e.args[0], df, time_col)
            b = _eval(e.args[1], df, time_col)
            if not isinstance(a, pd.Series):
                a = pd.Series([a] * len(df), index=df.index)
            return a.mask(pd.Series(a == b, index=a.index).fillna(False))
        if fn in ("length", "char_length"):
            s = _as_str_series(_eval(e.args[0], df, time_col), df, fn)
            return s.str.len()
        if fn == "replace":
            if not (len(e.args) == 3 and isinstance(e.args[1], Lit)
                    and isinstance(e.args[2], Lit)):
                raise FallbackError(
                    "replace() needs literal search/replacement strings")
            s = _as_str_series(_eval(e.args[0], df, time_col), df, fn)
            return s.str.replace(str(e.args[1].value),
                                 str(e.args[2].value), regex=False)
        if fn in ("upper", "lower", "trim"):
            s = _as_str_series(_eval(e.args[0], df, time_col), df, fn)
            if fn == "upper":
                return s.str.upper()
            if fn == "lower":
                return s.str.lower()
            # SQL/Druid TRIM strips space characters only by default
            return s.str.strip(" ")
        if fn == "concat":
            parts = [_eval(a, df, time_col) for a in e.args]
            out = None
            for p in parts:
                s = p.astype("string") if hasattr(p, "astype") else \
                    pd.Series(str(p), index=df.index, dtype="string")
                out = s if out is None else out + s
            return out
        if fn == "not":
            v = _eval(e.args[0], df, time_col)
            return (~v.astype(bool)) if hasattr(v, "astype") else (not v)
        if fn == "is_null":
            return _eval(e.args[0], df, time_col).isna()
        if fn in ("in_list", "in_list_packed"):
            v = _eval(e.args[0], df, time_col)
            vals = list(e.args[1].value) if fn == "in_list_packed" \
                else [a.value for a in e.args[1:]]
            has_null = any(x is None for x in vals)
            m = v.isin([x for x in vals if x is not None])
            if has_null:
                m = m | v.isna()
            return m
        if fn == "like":
            v = _eval(e.args[0], df, time_col)
            rx = re.compile(_like_to_regex(e.args[1].value))
            return v.map(lambda x: x is not None and not pd.isna(x)
                         and rx.fullmatch(str(x)) is not None)
        if fn == "abs":
            return _eval(e.args[0], df, time_col).abs()
        if fn == "if":
            c = _eval(e.args[0], df, time_col)
            if hasattr(c, "fillna"):
                c = c.fillna(False).astype(bool)
            a = _eval(e.args[1], df, time_col)
            b = _eval(e.args[2], df, time_col)
            if not hasattr(a, "where"):
                a = pd.Series([a] * len(df), index=df.index)
            return a.where(c, b)
        if fn == "cast_double":
            v = _eval(e.args[0], df, time_col)
            return pd.to_numeric(v, errors="raise").astype("Float64")
        if fn == "cast_long":
            v = pd.to_numeric(_eval(e.args[0], df, time_col),
                              errors="raise")
            arr = v.to_numpy(dtype="float64", na_value=np.nan)
            tr = np.trunc(arr)  # SQL casts truncate toward zero
            out = pd.array([pd.NA if np.isnan(x) else int(x) for x in tr],
                           dtype="Int64")
            return pd.Series(out, index=v.index)
        if fn == "cast_string":
            v = _eval(e.args[0], df, time_col)
            return v.map(lambda x: None if pd.isna(x) else str(x))
        if fn in ("substr", "substring"):
            v = _eval(e.args[0], df, time_col)
            start = int(e.args[1].value) - 1  # SQL 1-based
            ln = int(e.args[2].value) if len(e.args) == 3 else None
            end = None if ln is None else start + ln
            return v.map(lambda x: None if pd.isna(x)
                         else str(x)[start:end])
        if fn == "corr_scalar_map":
            items = dict(e.args[0].value)
            default = e.args[1].value
            kser = [_eval(a, df, time_col) for a in e.args[2:]]
            if not len(df):
                return pd.Series([], dtype=object)
            vals = [items.get(kt, default) for kt in _key_rows(kser)]
            return pd.Series([np.nan if v is None else v for v in vals],
                             index=df.index)
        if fn == "corr_exists_map":
            keyset = set(e.args[0].value)
            kser = [_eval(a, df, time_col) for a in e.args[1:]]
            if not len(df):
                return pd.Series([], dtype=bool)
            return pd.Series([kt in keyset for kt in _key_rows(kser)],
                             index=df.index)
        if fn == "corr_exists_cmp_map":
            items = dict(e.args[0].value)
            op = e.args[1].value
            vser = _eval(e.args[2], df, time_col)
            kser = [_eval(a, df, time_col) for a in e.args[3:]]
            if not len(df):
                return pd.Series([], dtype=bool)

            def hit(kt, v):
                rng = items.get(kt)
                if rng is None or v is None or pd.isna(v):
                    return False  # empty group / NULL comparand: UNKNOWN
                lo, hi = rng
                if op == ">":
                    return hi > v
                if op == ">=":
                    return hi >= v
                if op == "<":
                    return lo < v
                if op == "<=":
                    return lo <= v
                return lo != v or hi != v  # "!=": any differing value

            kt_rows = _key_rows(kser) if kser else ((),) * len(df)
            return pd.Series([hit(kt, v) for kt, v
                              in zip(kt_rows, vser.tolist())],
                             index=df.index)
        if fn == "corr_in_map":
            pairs = set(e.args[0].value)
            lhs = _eval(e.args[1], df, time_col)
            kser = [_eval(a, df, time_col) for a in e.args[2:]]
            if not len(df):
                return pd.Series([], dtype=bool)
            return pd.Series([kt in pairs
                              for kt in _key_rows(kser + [lhs])],
                             index=df.index)
        if fn == "lookup_map":
            v = _eval(e.args[0], df, time_col)
            m = dict(e.args[1].value)
            # Druid lookup semantics (retainMissingValue=false): values
            # absent from the map (and nulls) become null
            return v.map(lambda x: None if pd.isna(x)
                         else m.get(str(x)))
        if fn == "regexp_extract":
            v = _eval(e.args[0], df, time_col)
            rx = re.compile(str(e.args[1].value))

            def ex(x):
                if pd.isna(x):
                    return None
                m = rx.search(str(x))
                if m is None:
                    return None
                return m.group(1) if rx.groups else m.group(0)
            return v.map(ex)
        if fn in ("floor", "ceil", "sqrt", "log", "exp"):
            v = _eval(e.args[0], df, time_col)
            npf = {"floor": np.floor, "ceil": np.ceil, "sqrt": np.sqrt,
                   "log": np.log, "exp": np.exp}[fn]
            return pd.Series(npf(v.astype(float)), index=v.index)
        if fn == "pow":
            a = _eval(e.args[0], df, time_col)
            b = _eval(e.args[1], df, time_col)
            return a.astype(float) ** (b if not hasattr(b, "astype")
                                       else b.astype(float))
        if fn in ("min", "least", "max", "greatest"):
            a = _eval(e.args[0], df, time_col)
            b = _eval(e.args[1], df, time_col)
            f = np.minimum if fn in ("min", "least") else np.maximum
            return pd.Series(f(a, b), index=getattr(a, "index", df.index))
        raise FallbackError(f"unknown function {fn!r}")
    raise FallbackError(f"cannot evaluate {e!r}")


_RANK_FNS = {"row_number", "rank", "dense_rank"}
_WINDOW_AGGS = {"sum", "min", "max", "count", "avg"}
_SHIFT_FNS = {"lag", "lead"}


def _eval_window(e: WindowCall, df, time_col) -> pd.Series:
    """fn() OVER (PARTITION BY ... ORDER BY ...) -> Series aligned with
    df. Rank functions need ORDER BY; aggregates compute over the whole
    partition without it and as running (cumulative) aggregates with it
    (the standard's default RANGE UNBOUNDED PRECEDING frame, approximated
    row-wise)."""
    if e.name not in _RANK_FNS | _WINDOW_AGGS | _SHIFT_FNS:
        raise FallbackError(f"unsupported window function {e.name!r}")

    # NULL partition keys form their own partition: string keys fill
    # with the sentinel, non-string keys rely on dropna=False groupbys
    keys = [_fill_strings(_eval(p, df, time_col)) for p in e.partition_by]
    grouped_keys = keys if keys else [pd.Series(0, index=df.index)]

    def by(series):
        return series.groupby(grouped_keys, dropna=False)

    order_cols = []
    ascending = []
    work = pd.DataFrame(index=df.index)
    for i, (oe, desc) in enumerate(e.order_by):
        work[f"__o{i}"] = _eval(oe, df, time_col)
        order_cols.append(f"__o{i}")
        ascending.append(not desc)

    if e.name in _RANK_FNS:
        if not e.order_by:
            raise FallbackError(f"{e.name}() requires ORDER BY")
        # global sorted position handles any mix of directions; ties
        # collapse through the tuple of ORDER BY values
        order = work.sort_values(order_cols, ascending=ascending,
                                 kind="stable", key=_null_low_key).index
        pos = pd.Series(np.arange(len(df)), index=order).reindex(df.index)
        rn = by(pos).rank(method="first")
        if e.name == "row_number":
            return rn.astype(np.int64)
        tie = work[order_cols].apply(tuple, axis=1)
        min_rn = rn.groupby(grouped_keys + [tie],
                            dropna=False).transform("min")
        if e.name == "rank":
            return min_rn.astype(np.int64)
        return by(min_rn).rank(method="dense").astype(np.int64)

    if e.name in ("lag", "lead"):
        if not e.order_by:
            raise FallbackError(f"{e.name}() requires ORDER BY")
        v = _eval(e.args[0], df, time_col)

        def const_arg(i, what):
            if len(e.args) <= i:
                return None
            from tpu_olap_torch.planner.exprutil import simplify
            a = simplify(e.args[i])
            if not isinstance(a, Lit):
                raise FallbackError(
                    f"{e.name}() {what} must be a constant")
            return a.value

        off = const_arg(1, "offset")
        off = 1 if off is None else int(off)  # 0 is a valid offset
        default = const_arg(2, "default")
        order = work.sort_values(order_cols, ascending=ascending,
                                 kind="stable", key=_null_low_key).index
        vo = v.reindex(order)
        gk = [k.reindex(order) for k in grouped_keys]
        shift = off if e.name == "lag" else -off
        shifted = vo.groupby(gk, dropna=False).shift(shift)
        if default is not None:
            # the default applies only BEYOND the partition boundary,
            # not to genuine NULL data values that were shifted in
            marker = pd.Series(1, index=vo.index) \
                .groupby(gk, dropna=False).shift(shift)
            shifted = shifted.mask(marker.isna(), default)
        return shifted.reindex(df.index)

    v = _eval_agg_input(e.args[0], df, time_col) if e.args else \
        pd.Series(1, index=df.index)
    if e.frame is not None:
        # explicit ROWS BETWEEN frame: sliding aggregate over the sorted
        # partition. cumsum prefix differences serve sum/count/avg;
        # min/max slice per row (fallback tier — partitions are small)
        if not e.order_by:
            raise FallbackError("a ROWS frame requires a window ORDER BY")
        lo, hi = e.frame
        if lo is not None and hi is not None and lo > hi:
            raise FallbackError("empty ROWS frame (start after end)")
        order = work.sort_values(order_cols, ascending=ascending,
                                 kind="stable", key=_null_low_key).index
        vs = v.reindex(order)
        gk = [k.reindex(order) for k in grouped_keys]

        def slide(s):
            arr = s.to_numpy()
            m = len(arr)
            idx = np.arange(m)
            notna = ~pd.isna(arr)
            a = np.zeros(m, np.int64) if lo is None else \
                np.clip(idx + lo, 0, m)
            b = np.full(m, m, dtype=np.int64) if hi is None else \
                np.clip(idx + hi + 1, 0, m)
            b = np.maximum(a, b)
            cn = np.concatenate([[0], np.cumsum(notna.astype(np.int64))])
            cnt = cn[b] - cn[a]
            if e.name == "count":
                return pd.Series(cnt, index=s.index)
            if e.name in ("sum", "avg"):
                vals = np.where(notna, arr, 0).astype("float64")
                cs = np.concatenate([[0.0], np.cumsum(vals)])
                out = np.where(cnt > 0, cs[b] - cs[a], np.nan)
                if e.name == "avg":
                    out = out / np.where(cnt > 0, cnt, 1)
                return pd.Series(out, index=s.index)
            out = np.full(m, np.nan)
            for i in range(m):
                wv = arr[a[i]:b[i]]
                wv = wv[~pd.isna(wv)]
                if len(wv):
                    out[i] = wv.min() if e.name == "min" else wv.max()
            return pd.Series(out, index=s.index)

        res = vs.groupby(gk, dropna=False, group_keys=False).apply(slide)
        return res.reindex(df.index)
    if not e.order_by:
        g = by(v)
        if e.name == "count":
            out = g.transform("count") if e.args else \
                g.transform("size")
        elif e.name == "avg":
            out = g.transform("sum") / g.transform("count")
        else:
            out = g.transform(e.name)
        return out
    # running aggregates in ORDER BY order, mapped back to row order.
    # SQL frame semantics over NULL values: the frame aggregate skips
    # NULLs, so at a NULL-value row the running value CARRIES (it is the
    # aggregate of the prior frame), and it is NULL only while the frame
    # has seen no non-null value yet.
    order = work.sort_values(order_cols, ascending=ascending,
                             kind="stable", key=_null_low_key).index
    vs = v.reindex(order)
    gk = [k.reindex(order) for k in grouped_keys]

    def gby(s):
        return s.groupby(gk, dropna=False)

    nn_cum = gby(vs.notna().astype(np.int64)).cumsum()
    if e.name == "count":
        run = nn_cum if e.args else \
            gby(pd.Series(1, index=vs.index)).cumsum()
    elif e.name in ("sum", "avg"):
        s_run = gby(vs.fillna(0)).cumsum()
        run = s_run.where(nn_cum > 0)
        if e.name == "avg":
            run = run / nn_cum.where(nn_cum > 0)
    else:
        run = gby(vs).cummin() if e.name == "min" else gby(vs).cummax()
        run = gby(run).ffill()  # carry over NULL-value rows
    return run.reindex(df.index)


def _expr_null_mask(e, df, time_col):
    """SQL null propagation for an expression used as an AGGREGATION
    input: the value is null wherever any referenced column is null
    (the fallback mirror of kernels.exprs.virtual_null_mask)."""
    mask = None
    for col in e.columns():
        name = col.split(".")[-1]
        if name in df.columns:
            na = df[name].isna()
            mask = na if mask is None else (mask | na)
    return mask


def _eval_agg_input(e, df, time_col):
    """Evaluate an aggregation-input expression with whole-expression
    null masking (NULL if any referenced input is NULL)."""
    v = _eval(e, df, time_col)
    mask = _expr_null_mask(e, df, time_col)
    if mask is not None and hasattr(v, "mask") and mask.any():
        v = v.mask(mask)
    return v


def _eval_bool(e, df, time_col):
    v = _eval(e, df, time_col)
    if hasattr(v, "fillna"):
        return v.fillna(False).astype(bool)
    return bool(v)


def _equi_pair(c, left_cols, right_cols):
    if isinstance(c, BinOp) and c.op == "==" and \
            isinstance(c.left, Col) and isinstance(c.right, Col):
        a = c.left.name.split(".")[-1]
        b = c.right.name.split(".")[-1]
        if a in left_cols and b in right_cols:
            return (a, b)
        if b in left_cols and a in right_cols:
            return (b, a)
    return None



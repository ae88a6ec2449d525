"""Filter compilation: FilterSpec -> device mask function + constant pool.

The analog of Druid's filter evaluation over bitmap indexes (SURVEY.md
§3.7): no bitmaps — predicates become vectorized torch mask math over
dictionary codes / numeric values. Literals go into a ConstPool (host
numpy) and ride to the device once per plan as tensors (the runner's
`device_consts`). String predicates resolve on the host against the
dictionary into code sets or lookup tables, followed by one device
gather (`_take`).

Boolean semantics (not SQL 3VL): any comparison with a NULL operand is
False; NOT inverts the boolean result. The pandas fallback implements the
same rule so the parity harness compares like with like.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_olap_torch.ir import filters as F
from tpu_olap_torch.ir.dimensions import (CaseExtractionFn, LookupExtractionFn,
                                    RegexExtractionFn,
                                    SubstringExtractionFn,
                                    TimeFormatExtractionFn)
from tpu_olap_torch.kernels.exprs import eval_expr, widen_int_env
from tpu_olap_torch.segments.segment import ColumnType, TIME_COLUMN


class ConstPool:
    """Named host constants (numpy), shipped to the device once per plan.

    `tags` record literal-dependent *structural* choices made while
    compiling closures (e.g. "selector is-null", "IN list contains null",
    "unparseable literal -> match-nothing"): anything caching compiled
    work by template must key on them.
    """

    def __init__(self):
        self.consts: dict[str, np.ndarray] = {}
        self.tags: list[str] = []
        # (token, source_col, const_name) derived-stream requests from
        # filter compilation (columnComparison code translation): the
        # runner materializes consts[const_name][codes(source_col)] once
        # per content token as a device-resident "\0d:<token>" env column
        self.streams: list[tuple[str, str, str]] = []
        self._n = 0

    def add(self, value, dtype=None) -> str:
        name = f"c{self._n}"
        self._n += 1
        self.consts[name] = np.asarray(value, dtype=dtype)
        return name

    def tag(self, s: str) -> None:
        self.tags.append(s)

    def signature(self) -> tuple:
        """Structure-identifying key fragment: tags + const layout."""
        layout = tuple((k, v.shape, str(v.dtype))
                       for k, v in self.consts.items())
        return (tuple(self.tags), layout)


class UnsupportedFilter(Exception):
    """Raised when a filter can't lower to the device path; the planner
    treats this as 'not rewritable' and falls back (SURVEY.md §2 prop 2)."""


def compile_filter(spec, table, pool: ConstPool, virtual_exprs=None):
    """Compile a FilterSpec to fn(env, consts) -> bool mask.

    env: {"cols": {name: array}, "nulls": {name: bool array}}, where STRING
    columns hold dictionary codes and numeric columns hold values.
    virtual_exprs: name -> Expr for virtual columns referenced by filters.
    """
    virtual_exprs = virtual_exprs or {}

    def col_type(col):
        if col in virtual_exprs:
            return ColumnType.DOUBLE
        if col not in table.schema:
            raise UnsupportedFilter(f"unknown column {col!r}")
        return table.schema[col]

    def numeric_env(env):
        out = dict(env["cols"])
        for name, ex in virtual_exprs.items():
            out[name] = eval_expr(ex, widen_int_env(ex, out))
        return out

    def lower(s):
        if isinstance(s, F.SelectorFilter):
            return _selector(s, col_type(s.dimension))
        if isinstance(s, F.BoundFilter):
            return _bound(s, col_type(s.dimension))
        if isinstance(s, F.InFilter):
            return _in(s, col_type(s.dimension))
        if isinstance(s, F.RegexFilter):
            return _table_filter(s.dimension, col_type(s.dimension),
                                 lambda d: d.regex_table(s.pattern))
        if isinstance(s, F.LikeFilter):
            return _table_filter(s.dimension, col_type(s.dimension),
                                 lambda d: d.like_table(s.pattern))
        if isinstance(s, F.AndFilter):
            fns = [lower(f) for f in s.fields]
            return lambda env, c: _fold(fns, env, c, True)
        if isinstance(s, F.OrFilter):
            fns = [lower(f) for f in s.fields]
            return lambda env, c: _fold(fns, env, c, False)
        if isinstance(s, F.NotFilter):
            fn = lower(s.field)
            return lambda env, c: ~fn(env, c)
        if isinstance(s, F.ColumnComparisonFilter):
            if len(s.dimensions) < 2:
                raise UnsupportedFilter(
                    "columnComparison needs >= 2 dimensions")
            pairs = [_colcmp_pair(a, b)
                     for a, b in zip(s.dimensions, s.dimensions[1:])]
            return lambda env, c: _fold_direct(pairs, env, c)
        if isinstance(s, F.ExpressionFilter):
            expr = s.expression
            phys = set()
            for col in expr.columns():
                if col_type(col) is ColumnType.STRING:
                    raise UnsupportedFilter(
                        f"expression filter over string column {col!r}")
                phys |= (virtual_exprs[col].columns()
                         if col in virtual_exprs else {col})

            def fn(env, c):
                ne = numeric_env(env)
                m = eval_expr(expr, widen_int_env(expr, ne)) != 0
                # NULL in any referenced input -> no match (boolean, not 3VL)
                for col in phys:
                    m = m & ~_null_mask(env, col)
                return m
            return fn
        raise UnsupportedFilter(f"cannot lower filter {type(s).__name__}")

    # ---- leaf lowerers ---------------------------------------------------

    def _selector(s, typ):
        col = s.dimension
        if s.extraction_fn is not None:
            if typ is not ColumnType.STRING:
                raise UnsupportedFilter(
                    "extractionFn filter on non-string column "
                    f"{col!r} (use intervals/granularity for __time)")
            d = table.dictionaries[col]
            ex = _extraction_callable(s.extraction_fn)
            tbl = d.predicate_table(lambda v: ex(v) == s.value)
            cname = pool.add(tbl)
            return lambda env, c: _take(c[cname], env["cols"][col])
        if typ is ColumnType.STRING:
            d = table.dictionaries[col]
            cid = pool.add(d.id_of(s.value), np.int32)
            return lambda env, c: env["cols"][col] == c[cid]
        # numeric
        if s.value is None:
            pool.tag(f"sel-null:{col}")
            return lambda env, c: _null_mask(env, col)
        val = _parse_num(s.value, typ)
        if val is None:
            pool.tag(f"sel-never:{col}")
            return _never(col)  # Druid: unparseable literal matches nothing
        cval = pool.add(val)
        return lambda env, c: ((env["cols"][col] == c[cval])
                               & ~_null_mask(env, col))

    def _bound(s, typ):
        col = s.dimension
        if s.extraction_fn is not None:
            if typ is not ColumnType.STRING:
                raise UnsupportedFilter(
                    f"extractionFn bound on non-string column {col!r}")
            if s.ordering == "numeric":
                raise UnsupportedFilter(
                    "extractionFn bound supports lexicographic ordering "
                    "only (extracted values are strings)")
            for b in (s.lower, s.upper):
                if b is not None and not isinstance(b, str):
                    raise UnsupportedFilter(
                        f"extractionFn bound needs string bounds, got "
                        f"{b!r}")
            d = table.dictionaries[col]
            ex = _extraction_callable(s.extraction_fn)

            def in_range(v):
                e = ex(v)
                if e is None:
                    return False
                if s.lower is not None and (
                        e < s.lower or (s.lower_strict and e == s.lower)):
                    return False
                if s.upper is not None and (
                        e > s.upper or (s.upper_strict and e == s.upper)):
                    return False
                return True

            cname = pool.add(d.predicate_table(in_range))
            return lambda env, c: _take(c[cname], env["cols"][col])
        if s.ordering == "numeric" or typ is not ColumnType.STRING \
                or col == TIME_COLUMN:
            if typ is ColumnType.STRING:
                # numeric ordering over a string dim: parse dict host-side
                d = table.dictionaries[col]
                tbl = d.predicate_table(
                    lambda v: _numeric_in_bound(v, s))
                cname = pool.add(tbl)
                return lambda env, c: _take(c[cname], env["cols"][col])
            parts = []
            if s.lower is not None:
                lo = _parse_num(s.lower, typ)
                if lo is None:
                    raise UnsupportedFilter(
                        f"non-numeric bound literal {s.lower!r} on {col!r}")
                clo = pool.add(lo)
                if s.lower_strict:
                    parts.append(lambda env, c: env["cols"][col] > c[clo])
                else:
                    parts.append(lambda env, c: env["cols"][col] >= c[clo])
            if s.upper is not None:
                hi = _parse_num(s.upper, typ)
                if hi is None:
                    raise UnsupportedFilter(
                        f"non-numeric bound literal {s.upper!r} on {col!r}")
                chi = pool.add(hi)
                if s.upper_strict:
                    parts.append(lambda env, c: env["cols"][col] < c[chi])
                else:
                    parts.append(lambda env, c: env["cols"][col] <= c[chi])
            return lambda env, c: _fold_direct(parts, env, c) \
                & ~_null_mask(env, col)
        # lexicographic bound over dictionary codes
        d = table.dictionaries[col]
        if not getattr(d, "is_sorted", True):
            # append-extended dictionary (unsorted tail, docs/INGEST.md):
            # code order no longer tracks value order, so the bound
            # lowers as a predicate table instead of a code-range
            # compare — O(|dict|) host work, exact either way
            def _in_bound(v, _s=s):
                if _s.lower is not None and (
                        v < _s.lower
                        or (_s.lower_strict and v == _s.lower)):
                    return False
                if _s.upper is not None and (
                        v > _s.upper
                        or (_s.upper_strict and v == _s.upper)):
                    return False
                return True

            cname = pool.add(d.predicate_table(_in_bound))
            return lambda env, c: _take(c[cname], env["cols"][col])
        lo, hi = d.bound_code_range(s.lower, s.upper, s.lower_strict,
                                    s.upper_strict)
        clo = pool.add(lo, np.int32)
        chi = pool.add(hi, np.int32)
        return lambda env, c: ((env["cols"][col] >= c[clo])
                               & (env["cols"][col] <= c[chi]))

    def _in(s, typ):
        col = s.dimension
        if s.extraction_fn is not None:
            if typ is not ColumnType.STRING:
                raise UnsupportedFilter(
                    f"extractionFn in filter on non-string column {col!r}")
            d = table.dictionaries[col]
            ex = _extraction_callable(s.extraction_fn)
            vset = set(s.values)
            tbl = d.predicate_table(lambda v: ex(v) in vset)
            # null rows match iff the list carries null (ex(null) is
            # null, mirroring the fallback's `... | isna()` semantics)
            tbl[0] = None in vset
            cname = pool.add(tbl)
            return lambda env, c: _take(c[cname], env["cols"][col])
        if typ is ColumnType.STRING:
            d = table.dictionaries[col]
            cname = pool.add(d.in_table(s.values))
            return lambda env, c: _take(c[cname], env["cols"][col])
        parsed = [_parse_num(v, typ) for v in s.values if v is not None]
        parsed = [v for v in parsed if v is not None]
        any_float = any(isinstance(v, np.floating) for v in parsed)
        vals = pool.add(np.asarray(
            parsed, dtype=np.float64 if any_float or typ is ColumnType.DOUBLE
            else np.int64))
        has_null = any(v is None for v in s.values)
        if has_null:
            pool.tag(f"in-null:{col}")

        def fn(env, c):
            x = env["cols"][col]
            m = (x[..., None] == c[vals]).any(dim=-1) & ~_null_mask(env, col)
            if has_null:
                m = m | _null_mask(env, col)
            return m
        return fn

    colcmp_cache: dict = {}

    def _colcmp_pair(a, b):
        """One (a, b) equality leg of a columnComparison filter. NULL
        operands never match (module-docstring boolean rule; NotFilter
        inversion gives the null-matches semantics SQL `<>` needs).
        Memoized per pair: the same comparison in several conjuncts must
        not ship duplicate dictionary-sized consts."""
        hit = colcmp_cache.get((a, b))
        if hit is not None:
            return hit
        ta, tb = col_type(a), col_type(b)
        a_str = ta is ColumnType.STRING
        b_str = tb is ColumnType.STRING
        if a_str != b_str:
            raise UnsupportedFilter(
                f"columnComparison across string and numeric columns "
                f"({a!r}, {b!r})")
        if not a_str:
            # numeric (incl. __time / virtual): elementwise compare;
            # int-vs-float promotes. Virtuals are materialized into the
            # env (with their null masks) before any filter fn runs.
            fn = lambda env, c: ((env["cols"][a] == env["cols"][b])  # noqa: E731
                                 & ~_null_mask(env, a)
                                 & ~_null_mask(env, b))
            colcmp_cache[(a, b)] = fn
            return fn
        # string/string: translate a's codes into b's dictionary space.
        # xmap[0] = -1 (null never matches); values absent from b's
        # dictionary map to -1 (id_of). b's codes are 0 (null) or >= 1,
        # so `xmap[code_a] == code_b` alone is the non-null equality.
        da, db = table.dictionaries[a], table.dictionaries[b]
        xmap = np.full(da.size + 1, -1, np.int32)
        for i, v in enumerate(da.values):
            xmap[i + 1] = db.id_of(v)
        cname = pool.add(xmap, np.int32)
        token = _stream_token("cc", a, b, xmap)
        pool.streams.append((token, a, cname))
        pool.tag(f"cc:{token}")  # closure structure depends on the stream
        dname = "\0d:" + token

        def fn(env, c):
            hit = env["cols"].get(dname)
            ta_ids = hit if hit is not None else _take(c[cname],
                                                       env["cols"][a])
            return ta_ids == env["cols"][b]
        colcmp_cache[(a, b)] = fn
        return fn

    def _table_filter(col, typ, make_table):
        if typ is not ColumnType.STRING:
            raise UnsupportedFilter(
                f"regex/like over non-string column {col!r}")
        d = table.dictionaries[col]
        cname = pool.add(make_table(d))
        return lambda env, c: _take(c[cname], env["cols"][col])

    return lower(spec)


def compile_predicates(specs, table, pool: ConstPool, virtual_exprs=None):
    """Compile SEVERAL FilterSpecs against one shared ConstPool/env:
    every returned mask fn reads the same materialized column env, so N
    queries' predicates cost one read of the shared inputs plus N mask
    combines, not N column reads. The batch executor reaches the same
    contract through each leg's PhysicalPlan.front_half; this is the
    standalone spelling. None entries (unfiltered legs) pass through as
    None; raises UnsupportedFilter on the first spec that cannot
    lower. Nothing in the port calls it (nor does the JAX package's
    executor): it stays as the JAX package's public helper, held to the
    JAX one by tests/test_torch_batch.py."""
    virtual_exprs = virtual_exprs or {}
    return [None if s is None
            else compile_filter(s, table, pool, virtual_exprs)
            for s in specs]


def eval_predicates(fns, env, consts) -> list:
    """Evaluate compiled predicate fns over one shared env: a list of
    bool masks (None for unfiltered legs), all from the same pass.
    Uncalled in the port, as compile_predicates."""
    return [None if fn is None else fn(env, consts) for fn in fns]


# ---------------------------------------------------------------------------


def _stream_token(*parts) -> str:
    """Content hash over everything a filter-derived id stream depends on
    (mirrors executor.dimplan._dim_token)."""
    import hashlib
    h = hashlib.sha1()
    for p in parts:
        h.update(p.tobytes() if isinstance(p, np.ndarray)
                 else repr(p).encode())
        h.update(b"\x1f")
    return h.hexdigest()[:16]


def _parse_num(value, typ):
    """Literal -> numeric scalar in the column's natural width, widening to
    float64 for fractional literals on LONG columns (comparison promotes);
    None if the literal isn't numeric at all (Druid: matches nothing)."""
    if typ is ColumnType.DOUBLE:
        try:
            return np.float64(value)
        except (TypeError, ValueError):
            return None
    if isinstance(value, (float, np.floating)):
        return np.int64(value) if float(value).is_integer() \
            else np.float64(value)
    try:
        return np.int64(value)
    except (TypeError, ValueError, OverflowError):
        try:
            return np.float64(value)
        except (TypeError, ValueError):
            return None


def _take(table, idx):
    """Host-built lookup table gathered by per-row codes: one device
    gather. Codes are stored narrowed (int8/16/32), and torch indexes
    with int64."""
    return table[idx.long()]


def _never(col):
    def fn(env, c):
        x = env["cols"][col]
        return torch.zeros_like(x, dtype=torch.bool)
    return fn


def _null_mask(env, col):
    m = env["nulls"].get(col)
    if m is None:
        x = env["cols"][col]
        return torch.zeros_like(x, dtype=torch.bool)
    return m


def _fold(fns, env, c, is_and):
    out = None
    for fn in fns:
        m = fn(env, c)
        out = m if out is None else ((out & m) if is_and else (out | m))
    if out is None:
        raise UnsupportedFilter("empty and/or filter")
    return out


def _fold_direct(parts, env, c):
    out = None
    for fn in parts:
        m = fn(env, c)
        out = m if out is None else (out & m)
    if out is None:
        raise UnsupportedFilter("bound filter with no bounds")
    return out


def _numeric_in_bound(v: str, s) -> bool:
    try:
        x = float(v)
    except (TypeError, ValueError):
        return False
    if s.lower is not None:
        lo = float(s.lower)
        if x < lo or (s.lower_strict and x == lo):
            return False
    if s.upper is not None:
        hi = float(s.upper)
        if x > hi or (s.upper_strict and x == hi):
            return False
    return True


def _extraction_callable(ex):
    """Host-side string->string extraction for predicate-table building."""
    if isinstance(ex, SubstringExtractionFn):
        def f(v):
            end = None if ex.length is None else ex.index + ex.length
            return v[ex.index:end]
        return f
    if isinstance(ex, RegexExtractionFn):
        import re
        rx = re.compile(ex.expr)

        def f(v):
            m = rx.search(v)
            if not m:
                return ex.replace_missing_value
            return m.group(1) if m.groups() else m.group(0)
        return f
    if isinstance(ex, LookupExtractionFn):
        table = dict(ex.lookup)

        def f(v):
            if v in table:
                return table[v]
            return v if ex.retain_missing_value else ex.replace_missing_value
        return f
    if isinstance(ex, CaseExtractionFn):
        return str.upper if ex.mode == "upper" else str.lower
    if isinstance(ex, TimeFormatExtractionFn):
        raise UnsupportedFilter(
            "timeFormat extraction in filters: use intervals instead")
    raise UnsupportedFilter(f"unsupported extractionFn {type(ex).__name__}")


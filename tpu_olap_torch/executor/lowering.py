"""Query lowering: QuerySpec + TableSegments -> PhysicalPlan.

The analog of DruidStrategy's physical planning + Druid's per-query engine
setup (SURVEY.md §4.2): the lowered kernel closure reads literals from a
named ConstPool dict and runs as torch ops over the resident column
stacks. Anything the device path can't express raises Unsupported*.
This package lowers Timeseries / GroupBy / TopN over a dense group space,
a GroupBy past the dense budgets to the sort-based sparse group-by, and
Scan / Select to a row mask (the runner assembles the rows on the host;
Search runs its mask through a Scan plan).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_olap_torch.ir.interval import ETERNITY
from tpu_olap_torch.ir.query import (GroupByQuerySpec, ScanQuerySpec,
                                     SearchQuerySpec, SelectQuerySpec,
                                     TimeseriesQuerySpec, TopNQuerySpec)
from tpu_olap_torch.kernels import fused_reduce, row_mask
from tpu_olap_torch.kernels.exprs import materialize_virtuals
from tpu_olap_torch.kernels.filtereval import ConstPool, compile_filter
from tpu_olap_torch.kernels.groupby import (UnsupportedAggregation,
                                            build_group_key,
                                            compile_aggregations,
                                            group_reduce)
from tpu_olap_torch.kernels.hll import NUM_REGISTERS
from tpu_olap_torch.kernels.rowprog import RowProgramError
from tpu_olap_torch.kernels.sparse_groupby import (build_group_key64,
                                                   sparse_group_reduce)
from tpu_olap_torch.kernels.timebucket import compile_granularity
from tpu_olap_torch.executor.dimplan import compile_dimension
from tpu_olap_torch.segments.segment import ColumnType, TIME_COLUMN


@dataclass
class PhysicalPlan:
    query: object
    table: object
    kind: str                  # "agg" or "mask"
    pool: ConstPool = None
    kernel: object = None      # fn(env, valid, seg_mask, consts) -> partials
    #                            (None on the sparse path; the bool [S, R]
    #                            row mask on a mask plan)
    dim_plans: list = field(default_factory=list)
    bucket_plan: object = None
    agg_plans: list = field(default_factory=list)
    sizes: tuple = ()          # (n_buckets, dim sizes...) radix order
    total_groups: int = 1
    pruned_ids: list = field(default_factory=list)
    t_min: int = 0
    t_max: int = 0
    empty: bool = False        # intervals don't touch the table at all
    columns: tuple = ()        # physical columns the kernel reads
    null_cols: tuple = ()
    virtual_exprs: dict = field(default_factory=dict)
    # (token, source_col, const_name) derived streams the compiled
    # filters need (columnComparison code translation); the runner
    # materializes each once per content token (see dataset.derived)
    filter_streams: tuple = ()
    # fn(env, mask, consts) -> (key, mask, env): the row front half
    # (-> mask on a mask plan)
    front_half: object = None
    fused_reason: str | None = "not attempted"  # None = fused reduce active
    # mask plans: None = the row-mask kernel (kernels.row_mask) serves it,
    # else why the torch front half does
    mask_reason: str | None = None
    sparse: bool = False       # the sort-based sparse group-by serves it
    # cap -> fn(env, valid, seg_mask, consts) -> compact sparse partials
    make_sparse_kernel: object = None

    def fingerprint(self) -> tuple:
        """The plan's structure: table, query template (literals
        stripped) and the ConstPool's tags and layout. The batch
        executor orders a fused group's legs by it, so a repeated
        dashboard meets the same multi-leg kernel. Memoized: plans are
        cached across executions."""
        fp = getattr(self, "_fp", None)
        if fp is None:
            import json
            t = _template(self.query.to_json())
            fp = self._fp = (
                self.table.name, json.dumps(t, sort_keys=True, default=str),
                self.pool.signature() if self.pool is not None else ())
        return fp


_LITERAL_KEYS = {"value", "values", "lower", "upper", "pattern", "intervals"}


def _template(j):
    """Strip literal values from a query-JSON tree, keep structure.
    Expression subtrees (virtual columns, expression filters) stay
    verbatim, literals included: `sum(x*2)` and `sum(x*3)` are
    different structures."""
    if isinstance(j, dict):
        if j.get("type") == "expression":
            return j
        return {k: ("?" if k in _LITERAL_KEYS else _template(v))
                for k, v in j.items()}
    if isinstance(j, list):
        return [_template(x) for x in j]
    return j


def lower(query, table, config) -> PhysicalPlan:
    if isinstance(query, (TimeseriesQuerySpec, GroupByQuerySpec,
                          TopNQuerySpec)):
        return _lower_agg(query, table, config)
    if isinstance(query, (ScanQuerySpec, SelectQuerySpec)):
        return _lower_mask(query, table, config)
    if isinstance(query, SearchQuerySpec):
        raise AssertionError("search queries lower via runner._run_search")
    raise UnsupportedAggregation(
        f"no device lowering for {type(query).__name__}")


def _sparse_reject_reason(query, total) -> str | None:
    """None when the sort-based sparse path can serve this shape, else
    why not (GroupBy only: the timeseries/topN assemblers index the
    dense bucket space)."""
    if not isinstance(query, GroupByQuerySpec):
        return f"{query.query_type} has no sparse path"
    if total >= (1 << 62):
        return "the group space overflows the int64 sparse key"
    return None


def _radix(p) -> int:
    """Per-group state width of an aggregation plan: the HLL register
    file, the theta table, or 1 for a scalar accumulator."""
    if p.kind == "hll":
        return NUM_REGISTERS
    return p.theta_k if p.kind == "theta" else 1


def _time_range(query, table):
    intervals = query.intervals or (ETERNITY,)
    t0, t1 = table.time_boundary
    lo = max(t0, min(iv.start for iv in intervals))
    hi = min(t1, max(iv.end for iv in intervals) - 1)
    return intervals, lo, hi, hi < lo


def _interval_mask_fn(intervals, t0, t1, pool):
    """None if intervals cover the whole table; else fn(env,c)->mask."""
    covered = any(iv.start <= t0 and iv.end > t1 for iv in intervals)
    if covered:
        return None
    # one (start, end) pair of scalars per interval: row ops only, so the
    # fused reduce's row program takes the mask as it is
    edges = [(pool.add(iv.start, np.int64), pool.add(iv.end, np.int64))
             for iv in intervals]

    def fn(env, c):
        t = env["cols"][TIME_COLUMN]
        m = None
        for s, e in edges:
            x = (t >= c[s]) & (t < c[e])
            m = x if m is None else m | x
        return m
    return fn


def _filter_numeric_bounds(spec, table, vexprs=None) -> dict:
    """Per-column [lo, hi] requirements implied by top-level AND
    conjuncts of the filter, for manifest pruning (SURVEY.md §3.5 P4's
    numeric-bounds leg — the denormalized-dim analog of interval
    pruning: with time-partitioned ingest a selector like d_year = 1993
    sees tight per-segment min/max and drops whole partitions before
    dispatch). Conservative: plain LONG columns only, no extraction fns,
    numeric-ordered bounds; OR/NOT shapes contribute nothing; strict
    bounds prune with their inclusive envelope (a superset scan is
    always correct — the kernel's filter stays exact)."""
    from tpu_olap_torch.ir.filters import (AndFilter, BoundFilter, InFilter,
                                     SelectorFilter)

    def _num(v):
        try:
            return int(v)
        except (TypeError, ValueError):
            try:
                return float(v)
            except (TypeError, ValueError):
                return None

    out: dict = {}

    def add(col, lo, hi):
        # a virtual column shadows any same-named physical column in
        # filter evaluation — its values are an expression, so the
        # physical manifest's min/max say nothing about it
        if vexprs and col in vexprs:
            return
        if table.schema.get(col) is not ColumnType.LONG:
            return
        plo, phi = out.get(col, (None, None))
        if lo is not None:
            plo = lo if plo is None else max(plo, lo)
        if hi is not None:
            phi = hi if phi is None else min(phi, hi)
        out[col] = (plo, phi)

    def walk(f):
        if isinstance(f, AndFilter):
            for g in f.fields:
                walk(g)
        elif isinstance(f, SelectorFilter) and f.extraction_fn is None:
            v = _num(f.value)
            if v is not None:
                add(f.dimension, v, v)
        elif isinstance(f, InFilter) \
                and getattr(f, "extraction_fn", None) is None:
            vs = [_num(v) for v in f.values]
            if vs and all(v is not None for v in vs):
                add(f.dimension, min(vs), max(vs))
        elif isinstance(f, BoundFilter) and f.extraction_fn is None \
                and f.ordering == "numeric":
            add(f.dimension, _num(f.lower), _num(f.upper))

    if spec is not None:
        walk(spec)
    return out


def _elide_covered_imask(imask_fn, pruned_segs, intervals):
    """Residual interval-mask elision (SURVEY.md §3.5 P4 extended to row
    level): ingest globally time-sorts rows, so a scanned segment's
    [time_min, time_max] usually sits entirely inside one query interval
    — the row-level mask is then constant-true over every scanned block,
    and the kernel neither evaluates it nor reads __time for it (8
    bytes/row of device memory traffic, typically the single widest
    column a filtered aggregate touches). Segments straddling an
    interval edge keep the device mask. Pruning is static per plan, so
    the elision is decided at lowering."""
    if imask_fn is None or not pruned_segs:
        return imask_fn
    if all(any(iv.start <= s.meta.time_min and iv.end > s.meta.time_max
               for iv in intervals) for s in pruned_segs):
        return None
    return imask_fn


def _collect_columns(table, query, dim_plans, agg_plans, vexprs,
                     need_time: bool):
    cols: set[str] = set()
    if query.filter is not None:
        cols |= query.filter.columns()
    for p in agg_plans:
        cols |= set(p.fields)
    for dp in dim_plans:
        if dp.source_col:
            cols.add(dp.source_col)
    # expand virtual column references to their physical inputs
    phys: set[str] = set()
    for c in cols:
        if c in vexprs:
            phys |= vexprs[c].columns()
        else:
            phys.add(c)
    # filters on agg-inside filters already included via p.fields? filtered
    # agg filters reference columns through compile-time closures; collect
    for a in query.aggregations if hasattr(query, "aggregations") else ():
        from tpu_olap_torch.ir.aggregations import FilteredAggregation
        if isinstance(a, FilteredAggregation):
            for c in a.filter.columns():
                phys |= vexprs[c].columns() if c in vexprs else {c}
    if need_time:
        phys.add(TIME_COLUMN)
    unknown = [c for c in phys if c not in table.schema]
    if unknown:
        from tpu_olap_torch.kernels.filtereval import UnsupportedFilter
        raise UnsupportedFilter(f"unknown columns {unknown}")
    null_cols = tuple(sorted(
        c for c in phys if table.schema[c] is not ColumnType.STRING))
    return tuple(sorted(phys)), null_cols


def _filter_value_sets(filter_spec) -> dict:
    """Literal restrictions implied by top-level AND conjuncts:
    {column: allowed value set}. Plain selector / IN / OR-of-selectors
    only (no extraction fns) — the shapes whose passing rows provably
    carry one of the listed values in that column."""
    from tpu_olap_torch.ir import filters as F
    conjs = list(filter_spec.fields) \
        if isinstance(filter_spec, F.AndFilter) else [filter_spec]
    out: dict = {}
    for c in conjs:
        col = vs = None
        if isinstance(c, F.SelectorFilter) and c.extraction_fn is None \
                and c.value is not None:
            col, vs = c.dimension, {c.value}
        elif isinstance(c, F.InFilter) and c.extraction_fn is None:
            # extraction-IN values are post-extraction strings, NOT raw
            # column values — they must not restrict the dim domain
            col = c.dimension
            vs = {v for v in c.values if v is not None}
        elif isinstance(c, F.OrFilter):
            cols, vals, ok = set(), set(), True
            for f in c.fields:
                if isinstance(f, F.SelectorFilter) \
                        and f.extraction_fn is None \
                        and f.value is not None:
                    cols.add(f.dimension)
                    vals.add(f.value)
                else:
                    ok = False
                    break
            if ok and len(cols) == 1:
                col, vs = next(iter(cols)), vals
        if col is not None:
            out[col] = vs if col not in out else (out[col] & vs)
    return out


def _restrict_dims(dim_plans, filter_spec, table, pool):
    """Shrink grouped string dims whose domain a filter restricts to a
    literal set: the dense id space drops from |dictionary| to |set|+1
    via a code remap (rows outside the set are masked by the same filter
    anyway, so they may map to the null slot). Two restriction sources:

    - direct: the filter names the grouped column itself (Q3.3/Q3.4's
      city IN (...) — 113k-slot tables drop to single digits);
    - FD hop: the filter names a column the grouped one determines
      (declared star FD, SURVEY.md §3.4), e.g. s_nation='US' restricting
      grouped s_city to the cities observed with that nation — verified
      against the data (fd_code_map), never trusted blindly.
    """
    if filter_spec is None:
        return dim_plans
    sets = _filter_value_sets(filter_spec)
    if not sets:
        return dim_plans
    from tpu_olap_torch.executor.dimplan import DimPlan
    fds = table.star.functional_dependencies if table.star else ()
    out = []
    for dp in dim_plans:
        if dp.kind != "codes":
            out.append(dp)
            continue
        d = table.dictionaries[dp.source_col]
        allowed = None  # None = unrestricted; else set of codes (> 0)

        vs = sets.get(dp.source_col)
        if vs is not None:
            allowed = {c for v in vs if (c := d.id_of(v)) > 0}
        for fd in fds:
            if fd.determinant != dp.source_col:
                continue
            dvs = sets.get(fd.dependent)
            if dvs is None:
                continue
            m = table.fd_code_map(dp.source_col, fd.dependent)
            if m is None:
                continue
            dep_dict = table.dictionaries[fd.dependent]
            dep_codes = np.array(
                sorted(c for v in dvs if (c := dep_dict.id_of(v)) > 0),
                np.int64)
            codes = set(np.nonzero(np.isin(m, dep_codes))[0].tolist())
            codes.discard(0)
            allowed = codes if allowed is None else (allowed & codes)

        if allowed is None or len(allowed) + 1 >= dp.size:
            out.append(dp)
            continue
        codes = sorted(allowed)
        remap = np.zeros(dp.size, np.int32)
        labels = np.empty(len(codes) + 1, object)
        labels[0] = None
        for i, c in enumerate(codes):
            remap[c] = i + 1
            labels[i + 1] = d.values[c - 1]
        from tpu_olap_torch.executor.dimplan import _dim_token
        out.append(DimPlan(dp.name, len(codes) + 1, labels,
                           dp.source_col, "remap",
                           remap_name=pool.add(remap),
                           cache_token=_dim_token("rs", dp.source_col,
                                                  remap)))
    return out


def _lower_agg(query, table, config) -> PhysicalPlan:
    pool = ConstPool()
    intervals, t_min, t_max, empty = _time_range(query, table)
    vexprs = {v.name: v.expression for v in query.virtual_columns}

    bucket_plan = compile_granularity(query.granularity, t_min, t_max,
                                      pool, table.time_boundary)

    if isinstance(query, GroupByQuerySpec):
        dim_specs = query.dimensions
    elif isinstance(query, TopNQuerySpec):
        dim_specs = (query.dimension,)
    else:
        dim_specs = ()
    dim_plans = [compile_dimension(s, table, pool, t_min, t_max,
                                   numeric_dim_budget=config
                                   .numeric_dim_label_budget,
                                   vexprs=vexprs)
                 for s in dim_specs]
    dim_plans = _restrict_dims(dim_plans, query.filter, table, pool)

    agg_plans = compile_aggregations(
        query.aggregations, table, pool, vexprs,
        long_dtype=config.long_dtype, double_dtype=config.double_dtype,
        theta_k_cap=config.theta_k_cap)

    filter_fn = (compile_filter(query.filter, table, pool, vexprs)
                 if query.filter is not None else None)
    imask_fn = _interval_mask_fn(intervals, *table.time_boundary, pool)

    sizes = (bucket_plan.n_buckets,) + tuple(dp.size for dp in dim_plans)
    total = 1
    for s in sizes:
        total *= s
    # sketch aggregations keep [groups x radix] state each: at large K
    # their total dominates memory long before the group count passes the
    # dense budget. Over the state budget a GroupBy takes the sparse path
    # (clamped sketch width); shapes with no sparse path decline. One
    # device: no mesh factor on the theta state.
    state_radix = sum(_radix(p) for p in agg_plans if _radix(p) > 1)
    sketch_over = (state_radix > 0 and total * state_radix
                   > config.dense_sketch_state_budget)
    sparse = total > config.dense_group_budget
    if sketch_over and not sparse:
        reject = _sparse_reject_reason(query, total)
        if reject is not None:
            raise UnsupportedAggregation(
                f"per-group sketch state {total}×{state_radix} exceeds "
                f"dense_sketch_state_budget "
                f"{config.dense_sketch_state_budget} and {reject}")
        sparse = True
    if sparse:
        reject = _sparse_reject_reason(query, total)
        if reject is not None:
            raise UnsupportedAggregation(
                f"group space {total} exceeds dense budget "
                f"{config.dense_group_budget} and {reject}")
        # theta rides the sparse path with a clamped sketch width
        import dataclasses
        agg_plans = [dataclasses.replace(
            p, theta_k=min(p.theta_k, config.sparse_theta_k_cap))
            if p.kind == "theta" else p for p in agg_plans]

    pruned_segs = table.prune(
        intervals, _filter_numeric_bounds(query.filter, table, vexprs))
    imask_fn = _elide_covered_imask(imask_fn, pruned_segs, intervals)
    # __time (int64, the widest column) is read only when something
    # actually consumes raw timestamps on device: an un-elided interval
    # mask, or bucketing/timeformat WITHOUT a cached derived id stream
    need_time = ((bucket_plan.kind != "all"
                  and bucket_plan.cache_token is None)
                 or imask_fn is not None
                 or any(dp.kind == "timeformat" and dp.cache_token is None
                        for dp in dim_plans))
    columns, null_cols = _collect_columns(table, query, dim_plans, agg_plans,
                                          vexprs, need_time)
    pruned = [s.meta.segment_id for s in pruned_segs]

    def front_half(env, mask, consts, make_key=build_group_key):
        """The row front half every reduce shares: flat env {"cols",
        "nulls"} and base mask (validity ∧ segment) -> (key, mask, env
        with the virtual columns materialized). The generic and sparse
        reduces run it eagerly (the sparse one with the int64 key); the
        fused reduce traces it into its row program."""
        cols, nulls = dict(env["cols"]), dict(env["nulls"])
        materialize_virtuals(vexprs, cols, nulls)
        fenv = {"cols": cols, "nulls": nulls}
        if filter_fn is not None:
            mask = mask & filter_fn(fenv, consts)
        if imask_fn is not None:
            mask = mask & imask_fn(fenv, consts)
        ids, radix = [], []
        if bucket_plan.kind != "all":
            cached = cols.get(bucket_plan.derived_name) \
                if bucket_plan.cache_token else None
            ids.append(bucket_plan.ids_from_cached(cached, consts)
                       if cached is not None
                       else bucket_plan.ids(cols[TIME_COLUMN], consts))
            radix.append(sizes[0])
        for dp, size in zip(dim_plans, sizes[1:]):
            ids.append(dp.ids(fenv, consts))
            radix.append(size)
        if ids:
            key, _ = make_key(ids, radix)
        else:
            key = torch.zeros_like(mask, dtype=torch.int32)
        return key, mask, fenv

    def flat_env(env, valid, seg_mask):
        flat = {"cols": {c: a.reshape(-1) for c, a in env["cols"].items()},
                "nulls": {c: a.reshape(-1)
                          for c, a in env["nulls"].items()}}
        return flat, (valid & seg_mask[:, None]).reshape(-1)

    def kernel(env, valid, seg_mask, consts):
        flat, base = flat_env(env, valid, seg_mask)
        key, mask, fenv = front_half(flat, base, consts)
        return group_reduce(key, mask, fenv, agg_plans, total, consts)

    def make_sparse_kernel(cap):
        def sparse_kernel(env, valid, seg_mask, consts):
            flat, base = flat_env(env, valid, seg_mask)
            key, mask, fenv = front_half(flat, base, consts,
                                         build_group_key64)
            return sparse_group_reduce(key.to(torch.int64), mask, fenv,
                                       agg_plans, cap, consts)
        return sparse_kernel

    plan = PhysicalPlan(
        query=query, table=table, kind="agg", pool=pool,
        kernel=None if sparse else kernel,
        dim_plans=dim_plans, bucket_plan=bucket_plan,
        agg_plans=agg_plans, sizes=sizes, total_groups=total,
        pruned_ids=pruned, t_min=t_min, t_max=t_max, empty=empty,
        columns=columns, null_cols=null_cols, virtual_exprs=vexprs,
        filter_streams=_dedupe_streams(pool), front_half=front_half,
        sparse=sparse,
        make_sparse_kernel=make_sparse_kernel if sparse else None)
    if sparse:
        plan.fused_reason = "sparse group-by"
    else:
        _maybe_use_fused(plan, table, config)
    return plan


def _lower_mask(query, table, config) -> PhysicalPlan:
    """Scan/Select: the device computes the row mask; the runner
    assembles the rows on the host. The mask is the plan's front half
    (validity ∧ segment ∧ filter ∧ interval); the row-mask kernel
    (kernels.row_mask) runs it as one generated launch, and a front half
    that does not trace into a row program runs as torch ops, with the
    reason in plan.mask_reason."""
    pool = ConstPool()
    intervals, t_min, t_max, empty = _time_range(query, table)
    vexprs = {v.name: v.expression for v in query.virtual_columns}
    filter_fn = (compile_filter(query.filter, table, pool, vexprs)
                 if query.filter is not None else None)
    imask_fn = _interval_mask_fn(intervals, *table.time_boundary, pool)
    pruned_segs = table.prune(
        intervals, _filter_numeric_bounds(query.filter, table, vexprs))
    imask_fn = _elide_covered_imask(imask_fn, pruned_segs, intervals)

    cols: set[str] = set()
    if query.filter is not None:
        cols |= query.filter.columns()
    phys: set[str] = set()
    for c in cols:
        phys |= vexprs[c].columns() if c in vexprs else {c}
    if imask_fn is not None:
        phys.add(TIME_COLUMN)
    unknown = [c for c in phys if c not in table.schema]
    if unknown:
        from tpu_olap_torch.kernels.filtereval import UnsupportedFilter
        raise UnsupportedFilter(f"unknown columns {unknown}")
    null_cols = tuple(sorted(
        c for c in phys if table.schema[c] is not ColumnType.STRING))

    def front_half(env, mask, consts):
        """Flat env {"cols", "nulls"} and base mask (validity ∧ segment)
        -> the row mask."""
        cols, nulls = dict(env["cols"]), dict(env["nulls"])
        materialize_virtuals(vexprs, cols, nulls)
        fenv = {"cols": cols, "nulls": nulls}
        if filter_fn is not None:
            mask = mask & filter_fn(fenv, consts)
        if imask_fn is not None:
            mask = mask & imask_fn(fenv, consts)
        return mask

    def kernel(env, valid, seg_mask, consts):
        flat = {"cols": {c: a.reshape(-1) for c, a in env["cols"].items()},
                "nulls": {c: a.reshape(-1)
                          for c, a in env["nulls"].items()}}
        base = (valid & seg_mask[:, None]).reshape(-1)
        return front_half(flat, base, consts).reshape(valid.shape)

    plan = PhysicalPlan(
        query=query, table=table, kind="mask", pool=pool, kernel=kernel,
        pruned_ids=[s.meta.segment_id for s in pruned_segs], t_min=t_min,
        t_max=t_max, empty=empty, columns=tuple(sorted(phys)),
        null_cols=null_cols, virtual_exprs=vexprs,
        filter_streams=_dedupe_streams(pool), front_half=front_half)
    try:
        plan.kernel = row_mask.build_kernel(plan, table, config.device)
    except RowProgramError as e:
        plan.mask_reason = f"front half: {e}"
    return plan


def _maybe_use_fused(plan, table, config):
    """Swap the generic torch reduce for the fused reduce
    (kernels.fused_reduce) when the plan fits its envelope. "auto" takes
    it on cuda for every eligible plan; "force" also on cpu, where the
    wrapper runs the kernel's plain version (tests)."""
    mode = config.use_fused_reduce
    if mode not in ("auto", "force", "never"):
        raise ValueError(
            f"use_fused_reduce must be 'auto', 'force', or 'never'; got "
            f"{mode!r}")
    if mode == "never":
        plan.fused_reason = "never: use_fused_reduce='never'"
        return
    if mode == "auto" and torch.device(config.device).type != "cuda":
        plan.fused_reason = "auto: device is not cuda"
        return
    reason = fused_reduce.eligible(plan, table)
    if reason is not None:
        plan.fused_reason = reason
        return
    plan.kernel = fused_reduce.build_kernel(plan, table, config.device)
    plan.fused_reason = None


def _dedupe_streams(pool: ConstPool) -> tuple:
    """Unique filter-derived stream requests in first-seen order (the
    same column pair can appear in several conjuncts of one query)."""
    seen, out = set(), []
    for token, src, cname in pool.streams:
        if token not in seen:
            seen.add(token)
            out.append((token, src, cname))
    return tuple(out)

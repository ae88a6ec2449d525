"""Aggregate rewrite onto materialized rollup cubes.

Before a rewritten aggregate dispatches against the base table, this
pass asks whether a registered cube COVERS it — dims a subset of the
cube's dims, time grain a whole multiple of the cube grain, filters and
HAVING only over cube dims, every aggregation derivable from stored
partials, and the query's intervals decomposable into whole cube
buckets. A covered query is then served by folding a few thousand cube
rows on the host instead of scanning the base table on the device:

1.  the ORIGINAL query's lowered plan supplies the exact output layout
    (bucket grid, dense dim id spaces incl. filter-restricted remaps,
    agg plans) — reused verbatim, so assembly/HAVING/ORDER/LIMIT/topN
    semantics are the device path's own code, not a re-implementation;
2.  cube rows map into that layout (bucket ids from the plan's bucket
    grid, dim ids through the plan's own DimPlan.ids over base-code /
    value arrays the cube retained at build);
3.  stored partials merge with the same algebra the per-segment cache
    uses — counts/sums add, min/max fold, HLL registers max-merge,
    theta tables re-merge losslessly (k smallest of a union of per-part
    k-smallest sets IS the union's k smallest, so sketch results are
    bit-identical to the base path);
4.  `finalize_aggs` + `eval_post_aggs` + `QueryRunner._assemble_agg`
    finish exactly like a device execution.

Staleness: a cube is only consulted while its recorded base generation
matches the live table (the result cache's contract — stale state is
unservable at check time, before any maintenance runs). Every outcome
is counted (`cube_rewrite_total{result}` and `CubeRegistry.rewrites`)
and a serve's metrics carry `path="cube"` and route "cube".

The fold is host work, as in the JAX package: the port's own
compile_filter, DimPlan.ids, BucketPlan.ids and build_group_key run over
CPU tensors, and the merge in numpy. A serve launches nothing and copies
nothing for the sealed scope. Rows appended since the cube's sealed set
(the delta segments the query's pruning keeps) fold through the base
path: one launch of the segment-extended fused reduce over just those
segments (QueryRunner._run_seg_partials, the pass tier 1 trusts), under
its own admission slot, the breaker check and the retry layer, one copy
back, merged into the cube's fold before finalize. A serve leaves one
history record (route and path "cube") and runs under a `cube-rewrite`
span (attributes `served`, `cube`, `cube_rows_scanned`,
`delta_segments`, or `refused` with the reason), with `finalize`,
`post-agg` and `assemble` below it, as in the JAX package.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_olap_torch.cubes.spec import agg_signature, period_contains
from tpu_olap_torch.ir.granularity import AllGranularity, PeriodGranularity
from tpu_olap_torch.ir.query import (GroupByQuerySpec, TimeseriesQuerySpec,
                               TopNQuerySpec)
from tpu_olap_torch.executor.runner import _next_pow2
from tpu_olap_torch.kernels.groupby import (_ident, build_group_key,
                                            partials_radix, torch_dtype)
from tpu_olap_torch.kernels.hll import NUM_REGISTERS
from tpu_olap_torch.kernels.theta import EMPTY as THETA_EMPTY
from tpu_olap_torch.obs.trace import span as _span
from tpu_olap_torch.segments.segment import TIME_COLUMN

__all__ = ["try_serve_cube"]

_AGG_TYPES = (TimeseriesQuerySpec, GroupByQuerySpec, TopNQuerySpec)

# timeFormat formats a cube can reproduce from bucket starts, mapped to
# the calendar unit they demand: year('97) of every row in a month/day/
# hour bucket equals year(bucket start) because those grains nest inside
# years — kernels.timebucket's format ladder, restricted to formats with
# a well-defined containment unit
_FMT_UNIT = {"YYYY": "P1Y", "yyyy": "P1Y", "%Y": "P1Y",
             "Q": "P3M",
             "MM": "P1M", "%m": "P1M",
             "dd": "P1D", "DD": "P1D", "%d": "P1D",
             "HH": "PT1H", "hh": "PT1H", "%H": "PT1H",
             "mm": "PT1M", "%M": "PT1M",
             "ss": "PT1S", "%S": "PT1S"}


def _filter_has_column_comparison(f) -> bool:
    from tpu_olap_torch.ir import filters as F
    if isinstance(f, F.ColumnComparisonFilter):
        return True
    for sub in (getattr(f, "fields", None) or ()):
        if _filter_has_column_comparison(sub):
            return True
    inner = getattr(f, "field", None)
    return inner is not None and _filter_has_column_comparison(inner)


def _covering_reason(query, phys, spec, data, config) -> str | None:
    """None when the cube (spec + one build snapshot) covers this
    (query, plan); else why not."""
    cube_dims = set(spec.dimensions)
    period = spec.period

    if phys.kind != "agg":
        return "not an aggregation plan"
    if phys.sparse:
        return "sparse plan (dense layout needed for the cube fold)"
    if phys.empty:
        return "query intervals do not touch the table"

    # ---- time grain: query grain must be a whole multiple of the cube's
    qg = query.granularity
    if isinstance(qg, AllGranularity):
        pass  # any cube grain folds into one bucket
    elif isinstance(qg, PeriodGranularity):
        if qg.origin is not None:
            return "custom-origin granularity"
        if period is None:
            return (f"query grain {qg.period} finer than cube grain "
                    "'all'")
        if qg.time_zone != config.time_zone:
            return "granularity timezone differs from the cube's"
        if not period_contains(qg.period, period):
            return (f"query grain {qg.period} is not a multiple of "
                    f"cube grain {period}")
    else:
        return f"granularity {type(qg).__name__} not cube-servable"

    # ---- dimensions: subset of cube dims (or time-derived at >= grain)
    dim_specs = query.dimensions if isinstance(query, GroupByQuerySpec) \
        else ((query.dimension,) if isinstance(query, TopNQuerySpec)
              else ())
    for ds, dp in zip(dim_specs, phys.dim_plans):
        if dp.kind == "timeformat":
            fn = getattr(ds, "extraction_fn", None)
            fmt = getattr(fn, "format", None)
            unit = _FMT_UNIT.get(fmt)
            if unit is None:
                return f"timeFormat {fmt!r} has no containment unit"
            if period is None or not (unit == period
                                      or period_contains(unit, period)):
                return (f"timeFormat {fmt!r} needs grain <= {unit}, "
                        f"cube is {period or 'all'}")
            continue
        if dp.source_col not in cube_dims:
            return f"dimension {dp.source_col!r} not in the cube"
        if dp.kind not in ("codes", "remap", "numeric"):
            return f"dimension plan kind {dp.kind!r} not cube-servable"

    # ---- filter: only over cube dims, no cross-column comparison
    vexprs = {v.name: v.expression for v in query.virtual_columns}
    if query.filter is not None:
        if _filter_has_column_comparison(query.filter):
            return "columnComparison filter"
        for c in query.filter.columns():
            if c in vexprs:
                return f"filter over virtual column {c!r}"
            if c == TIME_COLUMN:
                return "row-level __time filter"
            if c not in cube_dims:
                return f"filter column {c!r} not a cube dimension"

    # ---- aggregations: every partial must be stored (+ wide-enough k)
    for a, p in zip(query.aggregations, phys.agg_plans):
        hit = data.aggs.get(agg_signature(a, vexprs))
        if hit is None:
            return f"aggregation {a.name!r} not materialized"
        sa = hit[0]
        if sa.kind != p.kind:
            return f"aggregation {a.name!r} kind mismatch"
        if p.kind == "theta" and sa.theta_k < p.theta_k:
            return (f"stored theta width {sa.theta_k} narrower than "
                    f"the query's {p.theta_k}")

    # ---- fold state budget (same shape as the segment-cache guard)
    radix = partials_radix(phys.agg_plans)
    if phys.total_groups * radix > config.cube_serve_state_budget:
        return (f"fold state {phys.total_groups}x{radix} exceeds "
                "cube_serve_state_budget")
    return None


# --------------------------------------------------------------- serving

def _interval_keep_mask(query, data):
    """Boolean keep-mask over cube rows for the query's intervals, or
    None when some cube bucket STRADDLES an interval edge (the bucket's
    rows can't be split, so the cube must refuse). Bucket ends clip at
    the base table's build-time max timestamp: an interval covering all
    real rows of the last, partially-filled calendar bucket still
    contains it."""
    intervals = query.intervals
    if not intervals:
        return np.ones(data.n_rows, bool)
    t, e = data.times, np.minimum(data.ends, data.base_tmax + 1)
    inside = np.zeros(data.n_rows, bool)
    touched = np.zeros(data.n_rows, bool)
    for iv in intervals:
        inside |= (t >= iv.start) & (e <= iv.end)
        touched |= (t < iv.end) & (e > iv.start)
    if bool((touched & ~inside).any()):
        return None
    return inside


def _host_consts(pool) -> dict:
    """A ConstPool's constants as CPU tensors, scalars as 1-element
    tensors (so that promotion matches numpy's, as the runner ships
    them)."""
    return {k: torch.as_tensor(np.atleast_1d(v))
            for k, v in pool.consts.items()}


def _dim_env(phys, data, keep):
    """Plan-space env over the KEPT cube rows, as CPU tensors: string
    dims as base-dictionary codes, numeric dims as values (+ null
    masks), plus the bucket-start timestamps for timeformat dims.
    DimPlan.ids() then produces exactly the dense ids the device kernel
    would."""
    cols = {TIME_COLUMN: torch.from_numpy(data.times[keep])}
    nulls: dict = {}
    for col, packed in data.dims.items():
        cols[col] = torch.from_numpy(packed[1][keep])
        if packed[0] != "codes" and packed[2] is not None:
            nulls[col] = torch.from_numpy(packed[2][keep])
    return {"cols": cols, "nulls": nulls}


def _filter_mask(query, phys, env, n_kept: int):
    """Row mask of the query's WHERE over kept cube rows, evaluated by
    the ordinary filter compiler against the BASE table (the cube keeps
    base-dictionary codes, so selector/IN/bound/LIKE/extraction filters
    compile to the same predicate tables the device path uses). `env`
    is the kept-row plan-space environment built once per serve."""
    if query.filter is None:
        return np.ones(n_kept, bool)
    from tpu_olap_torch.kernels.filtereval import ConstPool, compile_filter
    pool = ConstPool()
    fn = compile_filter(query.filter, phys.table, pool, {})
    return fn(env, _host_consts(pool)).numpy().astype(bool)


def _theta_fold(tables: np.ndarray, key: np.ndarray, total: int,
                k: int) -> np.ndarray:
    """Group-merge of per-row theta tables: k smallest DISTINCT unit
    hashes per group (kernels.theta.theta_merge's semantics, folded
    once over all rows of each group)."""
    n, ks = tables.shape
    g = np.repeat(key.astype(np.int64), ks)
    v = tables.reshape(-1)
    m = v < THETA_EMPTY
    g, v = g[m], v[m]
    out = np.full((total, k), THETA_EMPTY, np.float64)
    if len(g) == 0:
        return out
    order = np.lexsort((v, g))
    g, v = g[order], v[order]
    first = np.concatenate(
        [[True], (g[1:] != g[:-1]) | (v[1:] != v[:-1])])
    g, v = g[first], v[first]
    starts = np.searchsorted(g, np.arange(total))
    rank = np.arange(len(g)) - starts[g]
    ok = rank < k
    out[g[ok], rank[ok].astype(np.int64)] = v[ok]
    return out


def _fold_partials(query, phys, data, env, keep, fmask):
    """Kept+filtered cube rows -> dense partial arrays in the plan's
    [total_groups] layout — the same dict shape group_reduce emits.
    `data` is ONE build snapshot (registry.serveable) — never the live
    entry, whose data a concurrent refresh may swap; `env` is the
    kept-row plan-space environment shared with the filter pass."""
    consts = _host_consts(phys.pool)
    rows_idx = np.nonzero(fmask)[0]
    sel = torch.from_numpy(rows_idx)
    times = env["cols"][TIME_COLUMN][sel]

    ids, radix = [], []
    if phys.bucket_plan.kind != "all":
        ids.append(phys.bucket_plan.ids(times, consts))
        radix.append(phys.sizes[0])
    sub_env = {"cols": {c: a[sel] for c, a in env["cols"].items()},
               "nulls": {c: a[sel] for c, a in env["nulls"].items()}}
    for dp, size in zip(phys.dim_plans, phys.sizes[1:]):
        ids.append(dp.ids(sub_env, consts))
        radix.append(size)
    if ids:
        key, _ = build_group_key(ids, radix)
        key = key.numpy().astype(np.int64)
    else:
        key = np.zeros(len(rows_idx), np.int64)

    total = phys.total_groups
    kept_rows = np.nonzero(keep)[0][rows_idx]
    vexprs = {v.name: v.expression for v in query.virtual_columns}
    out: dict = {}
    rows_w = data.rows[kept_rows]
    acc = np.zeros(total, rows_w.dtype)
    np.add.at(acc, key, rows_w)
    out["_rows"] = acc
    for a, p in zip(query.aggregations, phys.agg_plans):
        if p.name in out:
            continue  # deduped spelling of an already-folded partial
        sa, vals, nn, sketch = data.aggs[agg_signature(a, vexprs)]
        if p.kind in ("count", "sum"):
            accv = np.zeros(total, p.acc_dtype)
            np.add.at(accv, key, vals[kept_rows].astype(p.acc_dtype))
            out[p.name] = accv
        elif p.kind in ("min", "max"):
            accv = np.full(total, _ident(torch_dtype(p.acc_dtype), p.kind),
                           p.acc_dtype)
            red = np.minimum if p.kind == "min" else np.maximum
            red.at(accv, key, vals[kept_rows].astype(p.acc_dtype))
            out[p.name] = accv
        elif p.kind == "hll":
            regs = np.zeros((total, NUM_REGISTERS), np.int32)
            np.maximum.at(regs, key,
                          sketch[kept_rows].astype(np.int32))
            out[p.name] = regs
        elif p.kind == "theta":
            out[p.name] = _theta_fold(sketch[kept_rows], key, total,
                                      p.theta_k)
        if nn is not None and p.kind in ("sum", "min", "max"):
            accn = np.zeros(total, np.int32)
            np.add.at(accn, key, nn[kept_rows].astype(np.int32))
            out[f"_nn_{p.name}"] = accn
    return out, len(rows_idx)


def _delta_fold_reason(phys, delta_ids, config) -> str | None:
    """None when the delta remainder can fold through the base path
    (QueryRunner._run_seg_partials), else why the cube must refuse —
    the same shape guards the tier-1 segment cache applies."""
    if phys.sparse or phys.kernel is None:
        return "delta fold needs a dense plan"
    radix = partials_radix(phys.agg_plans)
    # the window QueryRunner._run_seg_partials launches over
    W = min(_next_pow2(max(delta_ids) - min(delta_ids) + 1),
            len(phys.table.segments))
    if W * phys.total_groups * radix \
            > config.segment_cache_state_budget:
        return (f"delta fold state {W}x{phys.total_groups}x{radix} "
                "exceeds segment_cache_state_budget")
    if W * phys.total_groups >= (1 << 31):
        return "delta fold key space overflows int32"
    return None


def _merge_delta_partials(runner, phys, partials, delta_ids, table_name):
    """Compute the delta segments' partials on the device (one pass,
    per-segment keyed: QueryRunner._run_seg_partials, the machinery the
    tier-1 cache already trusts) and merge them into the cube's
    sealed-scope fold, as CPU tensors. Runs under its own admission slot
    and the breaker check: the cube serve never entered
    QueryRunner.execute, and background-vs-foreground fairness must hold
    for the delta dispatch too. dispatch_lock as the mode says: the
    pass's own enqueue section in pipelined mode, the whole dispatch in
    serialized mode. Returns (merged partials, delta rows scanned, the
    dispatch's metrics)."""
    import functools
    from contextlib import nullcontext

    from tpu_olap_torch.kernels.groupby import merge_partials

    dmet: dict = {"host_copies": 0}
    lock = nullcontext() if runner._pipelined else \
        runner._timed_dispatch_lock()
    with runner.admission.slot(runner.config.query_deadline_s), lock:
        runner.breaker.check()
        fresh = runner._dispatch(
            lambda: runner._run_seg_partials(phys, dmet, sorted(delta_ids)),
            dmet, table_name)
    dparts = functools.reduce(
        lambda a, b: merge_partials(a, b, phys.agg_plans), fresh.values())
    cube = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in partials.items()}
    for p in phys.agg_plans:
        nn = f"_nn_{p.name}"
        if nn in cube and nn not in dparts:
            # the fused reduce keeps no non-null count of a SUM (the base
            # path's answer has none either)
            cube.pop(nn)
        elif nn in dparts and nn not in cube:
            # the cube stored no null mask: every kept row is non-null
            cube[nn] = cube["_rows"].to(dparts[nn].dtype)
    return merge_partials(cube, dparts, phys.agg_plans), \
        int(dmet.get("rows_scanned") or 0), dmet


def try_serve_cube(engine, plan_result):
    """Serve `plan_result.query` from the smallest covering cube, or
    return None (the caller proceeds to the base-table device path).
    Never raises: any internal failure counts as `error` and falls
    through — cube serving must uphold the engine's structural
    'never an error' property."""
    registry = engine.cubes
    query = plan_result.query
    entry = plan_result.entry
    if not isinstance(query, _AGG_TYPES) or entry is None \
            or not entry.is_accelerated:
        return None
    from tpu_olap_torch.obs.workload import in_introspection
    if in_introspection():
        return None
    table = entry.segments
    # SEALED-scope generation: a cube is current as long as the sealed
    # set it was built from is
    candidates = registry.serveable(entry.name, table.sealed_generation)
    if not candidates:
        # distinguish "stale only" from "nothing registered" so that an
        # operator can see invalidation working
        if any(e.spec.datasource == entry.name and e.ready
               for e in map(registry.get, registry.names())
               if e is not None):
            registry.count_request("stale")
        else:
            registry.count_request("no_cube")
        return None
    t0 = time.perf_counter()
    runner = engine.runner
    try:
        from tpu_olap_torch.executor.resultcache import _config_sig
        with _span("cube-rewrite") as sp:
            # tier-2 first: an identical repeat is cheaper as a cache hit
            # than a re-fold
            hit = runner._serve_full_cache(query, table)
            if hit is not None:
                sp.set(served="result-cache")
                runner.last_metrics = hit.metrics
                return hit
            phys = runner._lower_cached(query, table)
            cfg_sig = _config_sig(engine.config)
            reason = "no candidate"
            for cube, data, cube_cfg in candidates:
                if cube_cfg != cfg_sig:
                    reason = "result-affecting config changed"
                    continue
                reason = _covering_reason(query, phys, cube.spec, data,
                                          engine.config)
                if reason is not None:
                    continue
                keep = _interval_keep_mask(query, data)
                if keep is None:
                    reason = "intervals straddle a cube bucket"
                    continue
                # serve-cost bailout: a cube that is not a clear
                # row-count win would slow down a query that manifest
                # pruning already made cheap; those stay on the base path
                kept_n = int(np.count_nonzero(keep))
                min_red = float(
                    engine.config.cube_serve_min_reduction or 0.0)
                if min_red > 1.0:
                    base_rows = sum(phys.table.segments[i].meta.n_valid
                                    for i in phys.pruned_ids)
                    if kept_n * min_red > base_rows:
                        reason = (f"{kept_n} cube rows are not a "
                                  f">={min_red:g}x reduction of the "
                                  f"{base_rows}-row base scan")
                        continue
                # delta remainder: rows appended since the sealed set
                # the cube covers fold through the BASE path — exact
                # per-segment partials in this plan's own layout
                # (interval and WHERE handled by the kernel, as tier 1
                # does for straddlers), merged with the cube's
                # sealed-scope fold before finalize. Zero stale serves
                # by construction: sealed rows come from the cube, delta
                # rows from the live snapshot, and the scopes are
                # disjoint.
                delta_ids = [sid for sid in phys.pruned_ids
                             if not table.segment_sealed(sid)]
                if delta_ids:
                    reason = _delta_fold_reason(phys, delta_ids,
                                                engine.config)
                    if reason is not None:
                        continue
                env = _dim_env(phys, data, keep)
                fmask = _filter_mask(query, phys, env, kept_n)
                partials, scanned = _fold_partials(query, phys, data,
                                                   env, keep, fmask)
                dmet: dict = {}
                if delta_ids:
                    partials, delta_scanned, dmet = \
                        _merge_delta_partials(runner, phys, partials,
                                              delta_ids, entry.name)
                    scanned += delta_scanned
                res = _finish(runner, query, phys, partials)
                sp.set(cube=cube.spec.name, cube_rows_scanned=scanned,
                       delta_segments=len(delta_ids))
                registry.note_serve(cube)
                registry.count_request("served")
                m = {"query_type": query.query_type,
                     "datasource": entry.name, "route": "cube",
                     "host_copies": dmet.get("host_copies", 0),
                     "cube": cube.spec.name,
                     "cube_rows": data.n_rows,
                     "rows_scanned": int(scanned),
                     "delta_segments": len(delta_ids),
                     "segments_scanned": len(delta_ids),
                     "segments_total": len(table.segments),
                     "cache_hit": False,
                     "rows_returned": len(res.rows),
                     "_wl": runner.fingerprint(query, entry.name),
                     "total_ms": (time.perf_counter() - t0) * 1000}
                fp = m["_wl"]
                res.metrics = m
                runner.last_metrics = runner.record(m)
                runner._store_full_cache(query, table, res, fp)
                return res
            sp.set(refused=reason)
            registry.count_request("refused")
            return None
    except Exception:  # noqa: BLE001 — the base path answers instead
        registry.count_request("error")
        return None


def _finish(runner, query, phys, partials):
    """Partials -> QueryResult through the device path's own tail."""
    from tpu_olap_torch.executor.results import (agg_specs_by_name,
                                                 eval_post_aggs,
                                                 finalize_aggs,
                                                 theta_raw_fields)
    specs = agg_specs_by_name(query.aggregations)
    keep_raw = theta_raw_fields(query.post_aggregations)
    with _span("finalize"):
        arrays = finalize_aggs(partials, phys.agg_plans, specs, keep_raw)
    with _span("post-agg"):
        eval_post_aggs(arrays, query.post_aggregations)
    with _span("assemble"):
        return runner._assemble_agg(query, phys, arrays)

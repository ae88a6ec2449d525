"""Host-side result finalization and assembly.

The analog of the reference's DruidQueryResultIterator + Spark-side final
aggregate (SURVEY.md §4.2's "JSON→row" hot loop) — except here the device
hands back small group tables, so assembly is O(groups), not O(rows):
finalize sketches, evaluate post-aggregations, apply having/limit, decode
dimension ids to values, and render Druid-wire-shaped records.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_olap_torch.ir import aggregations as A
from tpu_olap_torch.ir import having as H
from tpu_olap_torch.ir import postaggs as P
from tpu_olap_torch.kernels.hll import hll_estimate
from tpu_olap_torch.kernels.theta import EMPTY as THETA_EMPTY
from tpu_olap_torch.kernels.theta import theta_estimate
from tpu_olap_torch.utils import timeutil


def agg_specs_by_name(aggs) -> dict:
    out = {}
    for a in aggs:
        inner = a.aggregator if isinstance(a, A.FilteredAggregation) else a
        out[inner.name] = inner
    return out


def finalize_aggs(partials: dict, agg_plans, specs_by_name,
                  keep_raw=frozenset()) -> dict:
    """Host partials -> {name: np array [K]} of final values.

    Sketches are finalized to estimates here (Druid finalizes at the
    broker; this host step is the broker). min/max of empty groups
    become NaN (rendered as null); sums/counts of empty groups are 0.
    Theta aggregators named in `keep_raw` also keep their raw [K, k]
    tables (under "_theta_raw_<name>") for set-op post-aggregations.
    """
    out = {"_rows": np.asarray(partials["_rows"])}
    for p in agg_plans:
        v = np.asarray(partials[p.name])
        if p.kind in ("count", "sum"):
            out[p.name] = v
            if f"_nn_{p.name}" in partials:
                out[f"_nn_{p.name}"] = np.asarray(partials[f"_nn_{p.name}"])
            continue
        if p.kind in ("min", "max"):
            nn = np.asarray(partials[f"_nn_{p.name}"])
            fv = v.astype(np.float64)
            out[p.name] = np.where(nn > 0, fv, np.nan)
            continue
        if p.kind == "hll":
            est = hll_estimate(torch.tensor(v)).numpy()
            if getattr(specs_by_name.get(p.name), "round", True):
                est = np.round(est)
            out[p.name] = est
            continue
        if p.kind == "theta":
            if p.name in keep_raw:
                out[f"_theta_raw_{p.name}"] = v
            out[p.name] = theta_estimate(torch.tensor(v)).numpy()
            continue
        raise AssertionError(p.kind)
    return out


def theta_raw_fields(post_aggs) -> set:
    """Theta aggregator names whose RAW tables the post-aggregations need
    (referenced from a set-op tree). Non-empty: the query takes the
    unpacked path, which ships raw tables to the host (the packed path
    finalizes sketches on the device)."""
    out: set = set()

    def walk(pa):
        if isinstance(pa, P.ThetaSketchSetOpPostAgg):
            for f in pa.fields:
                if isinstance(f, P.ThetaSketchSetOpPostAgg):
                    walk(f)
                else:
                    out.add(f.field_name)
        elif isinstance(pa, P.ThetaSketchEstimatePostAgg) and \
                pa.field is not None:
            walk(pa.field)
        elif isinstance(pa, P.ArithmeticPostAgg):
            for f in pa.fields:
                walk(f)

    for pa in post_aggs:
        walk(pa)
    return out


def _row_member(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-row membership: mask[i, j] = a[i, j] in b[i, :]. Both are
    row-sorted ascending with 1.0 padding. One flat searchsorted in
    exact int64 space: unit hashes are multiples of 2^-32, so scaling by
    2^32 recovers the integer hash, and a 2^33 row stride keeps rows
    disjoint."""
    K = a.shape[0]
    ai = np.round(a * float(1 << 32)).astype(np.int64)
    bi = np.round(b * float(1 << 32)).astype(np.int64)
    off = np.arange(K, dtype=np.int64)[:, None] << 33
    bf = (bi + off).reshape(-1)
    af = (ai + off).reshape(-1)
    idx = np.minimum(np.searchsorted(bf, af), bf.size - 1)
    return (bf[idx] == af).reshape(a.shape)


def _theta_eval(pa, arrays):
    """Set-op tree -> (row-sorted table [K, k'], theta [K]). Leaves are
    raw theta tables; the theta of a leaf is its k-th smallest when
    full, else 1.0 (exact mode)."""
    if isinstance(pa, P.ThetaSketchSetOpPostAgg):
        parts = [_theta_eval(f, arrays) for f in pa.fields]
        tables = [t for t, _ in parts]
        theta = np.minimum.reduce([th for _, th in parts])
        a = tables[0]
        if pa.func == "UNION":
            merged = np.sort(np.concatenate(tables, axis=-1), axis=-1)
            dup = np.concatenate(
                [np.zeros_like(merged[..., :1], bool),
                 merged[..., 1:] == merged[..., :-1]], axis=-1)
            merged = np.where(dup, THETA_EMPTY, merged)
            return np.sort(merged, axis=-1), theta
        keep = np.ones(a.shape, bool)
        for b in tables[1:]:
            m = _row_member(a, b)
            keep &= m if pa.func == "INTERSECT" else ~m
        return np.sort(np.where(keep, a, THETA_EMPTY), axis=-1), theta
    # leaf: FieldAccess to a theta aggregator's raw table
    raw = arrays.get(f"_theta_raw_{pa.field_name}")
    if raw is None:
        raise ValueError(
            f"theta set op references {pa.field_name!r}, which is not a "
            "theta sketch aggregator of this query")
    t = np.asarray(raw, np.float64)
    full = (t < THETA_EMPTY).all(axis=-1)
    theta = np.where(full, t[..., -1], 1.0)
    return t, theta


def _theta_setop_estimate(pa, arrays) -> np.ndarray:
    table, theta = _theta_eval(pa, arrays)
    count = (table < theta[:, None]).sum(axis=-1)
    return count / np.maximum(theta, 1e-30)


def eval_post_aggs(arrays: dict, post_aggs) -> None:
    """Add post-aggregation outputs to `arrays` (in dependency order —
    Druid allows referencing earlier post-aggs)."""
    for pa in post_aggs:
        arrays[pa.name] = _eval_pa(pa, arrays)


def _eval_pa(pa, arrays):
    if isinstance(pa, P.FieldAccessPostAgg):
        return np.asarray(arrays[pa.field_name], np.float64)
    if isinstance(pa, P.ConstantPostAgg):
        return np.float64(pa.value)
    if isinstance(pa, P.ThetaSketchEstimatePostAgg) and pa.field is not None:
        return _theta_setop_estimate(pa.field, arrays)
    if isinstance(pa, P.ThetaSketchSetOpPostAgg):
        # referenced directly (no estimate wrapper): its estimate
        return _theta_setop_estimate(pa, arrays)
    if isinstance(pa, (P.HyperUniqueCardinalityPostAgg,
                       P.ThetaSketchEstimatePostAgg)):
        # sketches are already finalized to numbers in finalize_aggs
        return np.asarray(arrays[pa.field_name], np.float64)
    if isinstance(pa, P.ArithmeticPostAgg):
        vals = [_eval_pa(f, arrays) for f in pa.fields]
        out = np.asarray(vals[0], np.float64)
        for v in vals[1:]:
            if pa.fn == "quotient":
                # true floating division (Druid's "quotient"): zero
                # denominator -> NaN, rendered as SQL NULL — used by
                # filtered AVG so an empty filtered group is NULL, not 0
                with np.errstate(divide="ignore", invalid="ignore"):
                    out = np.where(v != 0, out / np.where(v != 0, v, 1),
                                   np.nan)
            elif pa.fn == "/":
                # Druid arithmetic division yields 0 on division by zero
                with np.errstate(divide="ignore", invalid="ignore"):
                    out = np.where(v != 0, out / np.where(v != 0, v, 1), 0.0)
            elif pa.fn == "+":
                out = out + v
            elif pa.fn == "-":
                out = out - v
            elif pa.fn == "*":
                out = out * v
            else:
                raise ValueError(f"unknown post-agg fn {pa.fn!r}")
        return out
    raise ValueError(f"unknown post-agg {type(pa).__name__}")


def eval_having(spec, arrays: dict, dim_values: dict) -> np.ndarray:
    """HavingSpec -> bool mask over groups. dim_values: name -> object
    array of decoded dimension values per group row."""
    if isinstance(spec, H.GreaterThanHaving):
        return np.asarray(arrays[spec.aggregation], np.float64) > spec.value
    if isinstance(spec, H.LessThanHaving):
        return np.asarray(arrays[spec.aggregation], np.float64) < spec.value
    if isinstance(spec, H.EqualToHaving):
        return np.asarray(arrays[spec.aggregation], np.float64) == spec.value
    if isinstance(spec, H.DimSelectorHaving):
        vals = dim_values[spec.dimension]
        return np.asarray([v == spec.value for v in vals])
    if isinstance(spec, H.AndHaving):
        out = None
        for h in spec.having_specs:
            m = eval_having(h, arrays, dim_values)
            out = m if out is None else out & m
        return out
    if isinstance(spec, H.OrHaving):
        out = None
        for h in spec.having_specs:
            m = eval_having(h, arrays, dim_values)
            out = m if out is None else out | m
        return out
    if isinstance(spec, H.NotHaving):
        return ~eval_having(spec.having_spec, arrays, dim_values)
    raise ValueError(f"unknown having {type(spec).__name__}")


def render_value(v):
    """numpy -> plain-JSON value; NaN -> None (SQL null)."""
    if v is None:
        return None
    if isinstance(v, (np.floating, float)):
        f = float(v)
        return None if np.isnan(f) else f
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return v


def iso(ms: int) -> str:
    return timeutil.millis_to_iso(int(ms))

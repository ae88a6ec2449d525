"""Dense group-by: mixed-radix key + torch segmented reduces.

The port of the JAX package's generic reduce (`groupby.group_reduce`,
whose `_seg_sum` is `jax.ops.segment_sum`): group keys are dense ids
(dictionary codes × time buckets), the group table is a static-shape [K]
array, and partial tables merge with add/min/max. Here the scatter is
`Tensor.index_add_` / `Tensor.scatter_reduce_` into int64 (or float64)
accumulators. It serves plans the fused reduce (kernels.fused_reduce)
does not take, and every plan under `use_fused_reduce="never"`.

Sketch aggregations keep per-group state: an HLL register file
[K, 2048] (kernels.hll) or a theta table [K, k] (kernels.theta), fed
by 32-bit hashes of the aggregated values (kernels.hashing). String
fields hash their dictionary VALUES through host-built tables, so hashes
agree across dictionaries, fields and the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_olap_torch.ir import aggregations as A
from tpu_olap_torch.kernels import hll as hll_mod
from tpu_olap_torch.kernels import theta as theta_mod
from tpu_olap_torch.kernels.filtereval import (UnsupportedFilter, _take,
                                               compile_filter)
from tpu_olap_torch.kernels.hashing import (hash32_int, hash_combine,
                                            wrap_int32)
from tpu_olap_torch.segments.segment import ColumnType


class UnsupportedAggregation(Exception):
    pass


@dataclass
class AggPlan:
    name: str
    kind: str            # sum | min | max | count | hll | theta
    fields: tuple        # input column/virtual names ((), for count)
    acc_dtype: object    # accumulator dtype (numpy)
    filter_fn: object = None   # compiled FilterSpec for filtered aggs
    theta_k: int = 0
    is_string_input: tuple = ()  # per field: True if dictionary codes
    by_row: bool = True  # multi-field HLL: distinct tuples (True) or the
    #                      union of per-field value sets (Druid byRow=False)
    hash_tables: tuple = ()  # per field: ConstPool name of the value-hash
    #                          table of a string field (None if numeric)


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype (the planner's and EngineConfig's currency) -> torch."""
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def compile_aggregations(aggs, table, pool, virtual_exprs=None,
                         long_dtype=np.int64, double_dtype=np.float64,
                         theta_k_cap=1 << 14):
    """AggregationSpec tuple -> list[AggPlan]. Raises Unsupported* for specs
    the device path can't run."""
    virtual_exprs = virtual_exprs or {}
    plans = []

    def field_type(f):
        if f in virtual_exprs:
            return ColumnType.DOUBLE
        if f not in table.schema:
            raise UnsupportedAggregation(f"unknown field {f!r}")
        return table.schema[f]

    def acc_dtype_for(spec):
        return long_dtype if spec.value_type == "long" else double_dtype

    def lower(spec, filter_fn=None):
        if isinstance(spec, A.FilteredAggregation):
            if filter_fn is not None:
                raise UnsupportedAggregation("nested filtered aggregator")
            try:
                ffn = compile_filter(spec.filter, table, pool, virtual_exprs)
            except UnsupportedFilter as e:
                raise UnsupportedAggregation(str(e)) from e
            return lower(spec.aggregator, ffn)
        if isinstance(spec, A.CountAggregation):
            return AggPlan(spec.name, "count", (), long_dtype, filter_fn)
        if isinstance(spec, (A.SumAggregation, A.MinAggregation,
                             A.MaxAggregation)):
            if field_type(spec.field_name) is ColumnType.STRING:
                raise UnsupportedAggregation(
                    f"numeric agg over string column {spec.field_name!r}")
            kind = {"SumAggregation": "sum", "MinAggregation": "min",
                    "MaxAggregation": "max"}[type(spec).__name__]
            return AggPlan(spec.name, kind, (spec.field_name,),
                           acc_dtype_for(spec), filter_fn)
        if isinstance(spec, (A.CardinalityAggregation,
                             A.HyperUniqueAggregation)):
            fields = tuple(spec.fields) \
                if isinstance(spec, A.CardinalityAggregation) \
                else (spec.field_name,)
            return AggPlan(spec.name, "hll", fields, np.int32, filter_fn,
                           is_string_input=tuple(
                               field_type(f) is ColumnType.STRING
                               for f in fields),
                           by_row=getattr(spec, "by_row", True),
                           hash_tables=_hash_tables(fields, table, pool,
                                                    field_type))
        if isinstance(spec, A.ThetaSketchAggregation):
            f = (spec.field_name,)
            return AggPlan(spec.name, "theta", f, np.float64, filter_fn,
                           theta_k=min(int(spec.size), theta_k_cap),
                           is_string_input=(field_type(spec.field_name)
                                            is ColumnType.STRING,),
                           hash_tables=_hash_tables(f, table, pool,
                                                    field_type))
        raise UnsupportedAggregation(
            f"cannot lower aggregation {type(spec).__name__}")

    for a in aggs:
        plans.append(lower(a))
    return plans


def _hash_tables(fields, table, pool, field_type):
    """Per-field value-hash const tables for string fields (None slots for
    numeric fields); slot 0 (null) is 0, and nulls are masked out anyway.
    The table depends only on the dictionary, so it is memoized there
    (an O(cardinality) host loop that must not run per query)."""
    out = []
    for f in fields:
        if field_type(f) is ColumnType.STRING:
            d = table.dictionaries[f]
            t = getattr(d, "_value_hash_table", None)
            if t is None:
                import zlib
                t = np.zeros(d.size + 1, np.int32)
                for i, v in enumerate(d.values):
                    t[i + 1] = np.int32(zlib.crc32(v.encode()) & 0x7FFFFFFF)
                d._value_hash_table = t
            out.append(pool.add(t))
        else:
            out.append(None)
    return tuple(out)


def build_group_key(ids, sizes):
    """Mixed-radix combine of dense id tensors into one int32 key.

    ids: list of tensors in [0, size_i); sizes: list of ints. The product
    must fit in int32 — callers enforce the dense-K budget.
    """
    total = 1
    for s in sizes:
        total *= int(s)
    if total > (1 << 31) - 1:
        raise UnsupportedAggregation(
            f"dense group space {total} overflows int32")
    key = None
    for i, s in zip(ids, sizes):
        i = i.to(torch.int32)
        key = i if key is None else key * int(s) + i
    return key, total


def group_reduce(key, mask, env, plans, num_groups, consts):
    """One segment batch -> per-group partial aggregates.

    key: [N] int32 dense group ids; mask: [N] bool (validity ∧ filter);
    env: {"cols", "nulls"} with numeric/virtual columns materialized.
    Returns dict: "_rows" -> [K] row counts, then one entry per plan —
    [K] for count/sum/min/max (plus "_nn_<name>" non-null counts for
    sum/min/max), [K, 2048] registers for hll, a [K, k] table for theta.
    All outputs merge across segments (merge_partials).

    A grouped reduce scatters only the selected rows, gathered first:
    sending the masked-out rows to a dummy group (the JAX package's
    rule, cheap under XLA) serializes the card's scatter atomics on one
    address. One group is a plain masked sum.
    """
    out = {}

    def reduce(m, x, acc, kind):
        """x (None: a count) over the rows where m is set, per group."""
        if x is not None and not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, device=m.device, dtype=torch.float64
                                if isinstance(x, float) else None)
            x = x.expand(m.shape)
        if num_groups == 1:
            if kind == "sum":
                v = m.to(acc) if x is None else torch.where(m, x, 0).to(acc)
                return v.sum(dim=0, dtype=acc).reshape(1)
            red = torch.amin if kind == "min" else torch.amax
            return red(torch.where(m, x.to(acc), _ident(acc, kind)),
                       dim=0).reshape(1)
        k = key[m].long()
        if kind == "sum" and x is None:
            # a histogram: per-block counts where the groups fit shared
            # memory, where index_add_ of ones serialises every row of a
            # group on one address
            return torch.bincount(k, minlength=num_groups).to(acc)
        if kind == "sum":
            return torch.zeros(num_groups, dtype=acc,
                               device=k.device).index_add_(0, k, x[m].to(acc))
        t = torch.full((num_groups,), _ident(acc, kind), dtype=acc,
                       device=k.device)
        return t.scatter_reduce_(0, k, x[m].to(acc),
                                 "amin" if kind == "min" else "amax")

    out["_rows"] = reduce(mask, None, torch.int64, "sum")
    for p in plans:
        acc = torch_dtype(p.acc_dtype)
        m = mask if p.filter_fn is None else (mask & p.filter_fn(env, consts))
        if p.kind == "count":
            # unfiltered COUNT(*) is the _rows reduce, already done
            out[p.name] = out["_rows"].to(acc) if p.filter_fn is None \
                else reduce(m, None, acc, "sum")
            continue
        if p.kind in ("sum", "min", "max"):
            x = _field_value(env, p.fields[0])
            nulls = env["nulls"].get(p.fields[0])
            mm = m & ~nulls if nulls is not None else m
            out[p.name] = reduce(mm, x, acc, p.kind)
            # per-plan non-null counts for null-correct finalize; with no
            # per-agg filter and no null bitmap they ARE _rows
            if p.filter_fn is None and nulls is None:
                out[f"_nn_{p.name}"] = out["_rows"]
            else:
                out[f"_nn_{p.name}"] = reduce(mm, None, torch.int32, "sum")
            continue
        if p.kind == "hll":
            if p.by_row or len(p.fields) <= 1:
                h, valid = _hash_fields(env, p, m, consts)
                out[p.name] = hll_mod.hll_update(h, valid, key, num_groups)
                continue
            # Druid byRow=False: distinct over the UNION of each field's
            # values: one update per field, max-merged
            regs = None
            for i, f in enumerate(p.fields):
                sub = AggPlan(p.name, "hll", (f,), p.acc_dtype,
                              is_string_input=(p.is_string_input[i],),
                              hash_tables=(p.hash_tables[i],))
                h, valid = _hash_fields(env, sub, m, consts)
                r = hll_mod.hll_update(h, valid, key, num_groups)
                regs = r if regs is None else torch.maximum(regs, r)
            out[p.name] = regs
            continue
        if p.kind == "theta":
            h, valid = _hash_fields(env, p, m, consts)
            out[p.name] = theta_mod.theta_update(h, valid, key, num_groups,
                                                 p.theta_k)
            continue
        raise UnsupportedAggregation(p.kind)
    return out


def group_reduce_batch(legs, consts_by_leg) -> list:
    """N query legs over ONE column env: legs is a list of (key, mask,
    env, plans, num_groups), each leg's key and mask computed from the
    same resident streams (executor.batch runs each leg's
    PhysicalPlan.front_half over the shared env). Returns N independent
    partials dicts, each what group_reduce gives for that leg alone. In
    a fused batch it serves the legs the multi-leg kernel does not take
    (sketch aggregations; every leg under use_fused_reduce="never")."""
    return [group_reduce(key, mask, env, plans, num_groups, consts)
            for (key, mask, env, plans, num_groups), consts
            in zip(legs, consts_by_leg)]


def partials_radix(plans) -> int:
    """Per-group state width (in scalar slots) of a partial-aggregate
    dict: 1 for _rows, then each aggregation's unfinalized form — the HLL
    register file, the theta table, or value + _nn."""
    radix = 1  # _rows
    for p in plans:
        if p.kind == "hll":
            radix += hll_mod.NUM_REGISTERS
        elif p.kind == "theta":
            radix += p.theta_k
        else:
            radix += 2  # value + _nn
    return radix


def merge_partials(a: dict, b: dict, plans) -> dict:
    """Merge two partial-aggregate dicts (across segment batches): sums
    and counts add, min/max and HLL registers take the extreme, theta
    tables re-select their k smallest."""
    out = {"_rows": a["_rows"] + b["_rows"]}
    for p in plans:
        if p.kind in ("count", "sum"):
            out[p.name] = a[p.name] + b[p.name]
        elif p.kind == "min":
            out[p.name] = torch.minimum(a[p.name], b[p.name])
        elif p.kind == "max":
            out[p.name] = torch.maximum(a[p.name], b[p.name])
        elif p.kind == "hll":
            out[p.name] = hll_mod.hll_merge(a[p.name], b[p.name])
        elif p.kind == "theta":
            out[p.name] = theta_mod.theta_merge(a[p.name], b[p.name])
        if f"_nn_{p.name}" in a:
            out[f"_nn_{p.name}"] = a[f"_nn_{p.name}"] + b[f"_nn_{p.name}"]
    return out


# ---------------------------------------------------------------------------


def _hash_fields(env, p: AggPlan, mask, consts):
    """Rows -> 32-bit hashes of the (possibly multi-)field value; `valid`
    excludes SQL-null inputs (nulls do not count toward COUNT DISTINCT).
    String fields hash their dictionary VALUES via host-built tables."""
    h = None
    valid = mask
    for f, is_code, tbl in zip(p.fields, p.is_string_input, p.hash_tables):
        x = env["cols"][f]
        if is_code:
            valid = valid & (x > 0)  # code 0 = null
            hx = hash32_int(_take(consts[tbl], x))
        else:
            nulls = env["nulls"].get(f)
            if nulls is not None:
                valid = valid & ~nulls
            if x.dtype.is_floating_point:
                xi = _float_bits(x)
            elif x.element_size() == 8:
                # fold all 64 bits before narrowing so values differing
                # only in high bits do not collide structurally
                xi = wrap_int32(x ^ (x >> 32))
            else:
                xi = x.to(torch.int32)
            hx = hash32_int(xi)
        h = hx if h is None else hash_combine(h, hx)
    return h, valid


def _float_bits(x):
    """float -> the bits of its float32 rounding, as int32."""
    return x.to(torch.float32).view(torch.int32)


def _field_value(env, field):
    if field in env["cols"]:
        return env["cols"][field]
    raise UnsupportedAggregation(f"field {field!r} not materialized")


def _ident(dtype: torch.dtype, kind):
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min

"""Sort-based sparse group-by: a GROUP BY past the dense budget.

The counterpart of the JAX package's `kernels/sparse_groupby.py`. The
dense path (kernels.groupby) materializes the whole mixed-radix group
space [K] and stops at the dense budget; past it the groups are found
by sorting:

  1. the mixed-radix key in int64 (the radix product may exceed int32);
  2. the rows that pass are compacted first, then one sort of their keys
     orders them, and every aggregate input is gathered by the same
     permutation (the JAX version carries them through one multi-operand
     sort and sends the rows that do not pass to a +inf sentinel tail,
     which it drops: the result is the same);
  3. group boundaries (key[i] != key[i-1]) -> cumsum -> dense ids in
     [0, n_unique), clipped to a `cap`-slot table plus one overflow slot
     that is dropped;
  4. segmented reduces into [cap] tensors: slot i holds the i-th smallest
     present key, so the result is compact and sorted;
  5. "_count" is the true number of groups; past `cap` the runner re-runs
     with the next power of two.

The merge of several devices' compact tables (`merge_sparse` in the JAX
package) belongs to the multi-GPU path, which is not ported yet.
"""

from __future__ import annotations

import torch

from tpu_olap_torch.kernels import hll as hll_mod
from tpu_olap_torch.kernels import theta as theta_mod
from tpu_olap_torch.kernels.groupby import (UnsupportedAggregation,
                                            _hash_fields, _ident,
                                            torch_dtype)

SENTINEL = (1 << 63) - 1  # int64 max: the key of an empty slot


def build_group_key64(ids, sizes):
    """Mixed-radix combine of dense id tensors into one int64 key.
    Raises when the product reaches 2^62."""
    total = 1
    for s in sizes:
        total *= int(s)
    if total >= (1 << 62):
        raise UnsupportedAggregation(
            f"group space {total} overflows the int64 key")
    key = None
    for i, s in zip(ids, sizes):
        i = i.to(torch.int64)
        key = i if key is None else key * int(s) + i
    return key, total


def _sorted_segments(skey, cap):
    """(gid, count) of sorted keys: gid clips into the dropped slot
    `cap`, count is the number of distinct non-sentinel keys (a 0-d int32
    tensor)."""
    boundary = torch.ones_like(skey, dtype=torch.bool)
    boundary[1:] = skey[1:] != skey[:-1]
    gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
    live = skey != SENTINEL
    count = (boundary & live).sum(dtype=torch.int32)
    gid = torch.where((gid < cap) & live, gid, cap)
    return gid, count


def _seg_sum(v, gid, cap):
    out = torch.zeros((cap + 1,) + tuple(v.shape[1:]), dtype=v.dtype,
                      device=v.device)
    return out.index_add_(0, gid, v)[:cap]


def _seg_ext(v, gid, cap, kind):
    out = torch.full((cap + 1,), _ident(v.dtype, kind), dtype=v.dtype,
                     device=v.device)
    return out.scatter_reduce_(0, gid, v, "amin" if kind == "min"
                               else "amax")[:cap]


def sparse_group_reduce(key, mask, env, plans, cap, consts):
    """[N] int64 keys + [N] bool mask -> compacted per-group partials:
    {"_keys": [cap] int64 (SENTINEL marks empty slots), "_count": 0-d
    int32 true group count, "_rows": [cap] int32, <agg name>: [cap] or
    [cap, m], "_nn_<name>": [cap] int32 for min/max}."""
    sel = mask.nonzero().squeeze(1)
    skey, perm = torch.sort(key[sel], stable=True)
    rows = sel[perm]  # the passing rows, in key order

    def take(x):
        return x[rows]

    gid, count = _sorted_segments(skey, cap)

    def seg_sum(v):
        return _seg_sum(v, gid, cap)

    def seg_ext(v, kind):
        return _seg_ext(v, gid, cap, kind)

    out = {"_count": count,
           "_rows": seg_sum(torch.ones_like(gid, dtype=torch.int32)),
           "_keys": seg_ext(skey, "min")}  # SENTINEL fills empty slots
    for p in plans:
        acc = torch_dtype(p.acc_dtype)
        m = None if p.filter_fn is None else take(p.filter_fn(env, consts))
        if p.kind == "count":
            # unfiltered COUNT(*) is the _rows reduction, already done
            out[p.name] = out["_rows"].to(acc) if m is None \
                else seg_sum(m.to(acc))
            continue
        if p.kind in ("sum", "min", "max"):
            x = take(env["cols"][p.fields[0]])
            nulls = env["nulls"].get(p.fields[0])
            mm = m
            if nulls is not None:
                nn = ~take(nulls)
                mm = nn if mm is None else (mm & nn)
            if p.kind == "sum":
                v = x.to(acc) if mm is None else torch.where(mm, x, 0).to(acc)
                out[p.name] = seg_sum(v)
                continue
            v = x.to(acc) if mm is None else \
                torch.where(mm, x.to(acc), _ident(acc, p.kind))
            out[p.name] = seg_ext(v, p.kind)
            # with no filter and no nulls the non-null count IS _rows
            out[f"_nn_{p.name}"] = out["_rows"] if mm is None \
                else seg_sum(mm.to(torch.int32))
            continue
        if p.kind in ("hll", "theta"):
            cols = {f: take(env["cols"][f]) for f in p.fields}
            nulls = {f: take(env["nulls"][f]) for f in p.fields
                     if f in env["nulls"]}
            base = torch.ones_like(gid, dtype=torch.bool) if m is None else m
            h, valid = _hash_fields({"cols": cols, "nulls": nulls}, p, base,
                                    consts)
            if p.kind == "hll":
                # gid == cap (overflow) rows land in the pad row, sliced off
                out[p.name] = hll_mod.hll_update(h, valid, gid,
                                                 cap + 1)[:cap]
            else:
                out[p.name] = theta_mod.theta_update(h, valid, gid, cap + 1,
                                                     p.theta_k)[:cap]
            continue
        raise UnsupportedAggregation(
            f"sparse group-by does not support {p.kind!r}")
    return out

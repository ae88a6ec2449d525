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

Under a mesh (executor.sharding) every device compacts its own rows,
and the compact tables merge by key (`merge_sparse`, the JAX package's,
on torch tensors): at the host broker (sparse_merge="gather"), or, under
"exchange", on owner devices: `exchange` hash-partitions each device's
compact entries to the owner `owner_of(key)` (a multiplicative hash mod
D), copies each part device to device and merges per owner. Each owner's
table is sized to what it received, so the present groups may reach
D x sparse_group_budget and a skewed key set only loads one owner.
"""

from __future__ import annotations

from contextlib import nullcontext

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


# ---------------------------------------------------------------------------
# Merging compact tables: the mesh's sparse merge


def merge_sparse(parts: list, plans, cap) -> dict:
    """Merge compact tables (one per device, or the parts an owner
    received): concatenate and re-reduce by key. Values are already
    partial aggregates, so sums and counts re-sum, min/max re-extremize,
    HLL registers re-max and theta tables re-merge. "_count" is the
    merged distinct count, or a part's own count when larger (a part
    whose table overflowed already dropped groups the merge cannot see;
    the runner then re-runs with a larger cap)."""
    keys = torch.cat([p["_keys"] for p in parts])
    skey, order = torch.sort(keys, stable=True)
    gid, count = _sorted_segments(skey, cap)
    for p in parts:
        if "_count" in p:
            count = torch.maximum(count, torch.as_tensor(
                p["_count"], device=count.device).to(torch.int32))

    def gathered(name):
        return torch.cat([p[name] for p in parts])[order]

    def seg_sum(v):
        return _seg_sum(v, gid, cap)

    def seg_ext(v, kind):
        return _seg_ext(v, gid, cap, kind)

    out = {"_count": count, "_rows": seg_sum(gathered("_rows"))}
    out["_keys"] = seg_ext(skey, "min")
    for p in plans:
        if p.kind in ("count", "sum"):
            out[p.name] = seg_sum(gathered(p.name))
        elif p.kind in ("min", "max"):
            out[p.name] = seg_ext(gathered(p.name), p.kind)
            out[f"_nn_{p.name}"] = seg_sum(gathered(f"_nn_{p.name}"))
        elif p.kind == "hll":
            out[p.name] = _seg_max_rows(gathered(p.name), gid, cap)
        elif p.kind == "theta":
            out[p.name] = _seg_theta_union(gathered(p.name), gid, cap,
                                           len(parts))
        else:
            raise UnsupportedAggregation(p.kind)
    return out


def _seg_max_rows(v, gid, cap):
    """Segmented elementwise max of [n, m] rows (HLL register files)."""
    out = torch.full((cap + 1,) + tuple(v.shape[1:]), _ident(v.dtype, "max"),
                     dtype=v.dtype, device=v.device)
    idx = gid.view(-1, *([1] * (v.dim() - 1))).expand_as(v)
    return out.scatter_reduce_(0, idx, v, "amax")[:cap]


def _seg_theta_union(rows, gid, cap, n_parts):
    """Segmented theta union: [n, k] row-sorted tables with group ids
    `gid` (sorted; cap = the dropped pad slot) -> [cap, k] merged tables
    of the k smallest distinct values per group. Each part contributes at
    most one row per key, so a row's rank within its group is below
    n_parts; rows rank-scatter into a [cap, n_parts * k] buffer that
    sorts, drops duplicates and truncates."""
    n, k = rows.shape
    dev = rows.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    boundary = torch.ones(n, dtype=torch.bool, device=dev)
    boundary[1:] = gid[1:] != gid[:-1]
    starts = torch.where(boundary, idx, 0)
    seg_start = torch.cummax(starts, 0).values if n else starts
    rank = torch.clamp(idx - seg_start, max=n_parts - 1)
    slot = gid.to(torch.int64) * n_parts + rank
    buf = torch.full(((cap + 1) * n_parts, k), theta_mod.EMPTY,
                     dtype=rows.dtype, device=dev)
    buf[slot] = rows
    wide = buf[:cap * n_parts].reshape(cap, n_parts * k)
    wide, _ = torch.sort(wide, dim=-1)
    dup = torch.zeros_like(wide, dtype=torch.bool)
    dup[:, 1:] = wide[:, 1:] == wide[:, :-1]
    wide, _ = torch.sort(torch.where(dup, theta_mod.EMPTY, wide), dim=-1)
    return wide[:, :k]


def owner_of(keys: torch.Tensor, n_devices: int) -> torch.Tensor:
    """The owner device of each int64 key under the exchange: the
    Fibonacci multiplicative hash's high bits, mod D."""
    h = keys * -7046029254386353131   # 2^64 / golden ratio, wrapped
    h = (h >> 33) & 0x7FFFFFFF
    return h % n_devices


def exchange(parts: list, counts: list, devices: list, plans,
             cap_limit: int):
    """The exchange merge: each device's compact table (`parts[c]` on
    `devices[c]`, its first `counts[c]` slots live, sorted by key) is
    split by owner device, each piece copied device to device to its
    owner, and every owner merges what it received (merge_sparse) into a
    table of the next power of two of its entries (at least 64), never
    past `cap_limit`. Returns (per-owner merged tables on their devices,
    per-owner caps). The split reads one [D] count vector per device back
    to the host: piece sizes are data."""
    D = len(devices)
    names = [n for n in parts[0] if n != "_count"]
    received: list = [[] for _ in range(D)]
    for c, (p, n) in enumerate(zip(parts, counts)):
        owner = owner_of(p["_keys"][:n], D)
        order = torch.argsort(owner, stable=True)
        sizes = torch.bincount(owner, minlength=D).tolist()
        lo = 0
        for o, sz in enumerate(sizes):
            if sz:
                sel = order[lo:lo + sz]
                received[o].append(
                    {name: p[name][:n][sel].to(devices[o], non_blocking=True)
                     for name in names})
            lo += sz
    merged, caps = [], []
    for o, dev in enumerate(devices):
        got = received[o]
        n_in = sum(int(g["_keys"].shape[0]) for g in got)
        cap = min(cap_limit, max(64, 1 << max(0, n_in - 1).bit_length()))
        if not got:  # an owner nothing hashed to: an empty table
            got = [{name: parts[0][name][:0].to(dev) for name in names}]
        with torch.cuda.device(dev) if dev.type == "cuda" \
                else nullcontext():
            merged.append(merge_sparse(got, plans, cap))
        caps.append(cap)
    return merged, caps

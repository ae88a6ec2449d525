"""Theta (KMV) sketch count-distinct per group, sort-based.

The counterpart of the JAX package's `kernels/theta.py` (the
datasketches theta aggregator's analog): per group keep the k smallest
distinct 32-bit hash values, as unit floats in a float64 [K, k] table
(1.0 = empty slot). Estimate: the count when the table is not full, else
(k - 1) / θ with θ the k-th smallest.

torch has no lexsort. `lexsort((u, g))` orders rows exactly as one sort
of the int64 key `g << 32 | h_u32` does, because u = h_u32 / 2^32 is
exact in float64. The rows that do not pass are dropped before the sort;
the JAX version sorts them to the tail and never keeps them.
"""

from __future__ import annotations

import torch

from tpu_olap_torch.kernels.hashing import to_unit_float

EMPTY = 1.0  # sentinel: empty slot (hashes are in [0, 1))


def theta_update(h, valid, key, num_groups, k):
    """h: [N] int32 hashes; valid: [N] bool; key: [N] group ids in
    [0, num_groups) -> [num_groups, k] row-sorted unit-hash table."""
    dev = h.device
    table = torch.full((num_groups * k,), EMPTY, dtype=torch.float64,
                       device=dev)
    sel = valid.nonzero().squeeze(1)
    if sel.numel():
        hu = h[sel].to(torch.int64) & 0xFFFFFFFF
        skey, _ = torch.sort((key[sel].to(torch.int64) << 32) | hu)
        gs, hs = skey >> 32, skey & 0xFFFFFFFF
        # duplicates of one (group, hash) pair keep their first row
        kept = torch.ones_like(skey, dtype=torch.bool)
        kept[1:] = skey[1:] != skey[:-1]
        # rank of each kept row within its group: the kept rows before it
        # less those before its group's first row (always kept). Only the
        # groups' first rows write their group's start: a scatter-min of
        # every row into [K] would serialise a group on one address.
        kk = kept.to(torch.int64)
        prefix = torch.cumsum(kk, 0) - kk
        first = torch.ones_like(kept)
        first[1:] = gs[1:] != gs[:-1]
        fi = first.nonzero().squeeze(1)
        start = torch.zeros(num_groups, dtype=torch.int64, device=dev)
        start[gs[fi]] = prefix[fi]
        rank = prefix - start[gs]
        ok = (kept & (rank < k)).nonzero().squeeze(1)
        table.scatter_reduce_(0, gs[ok] * k + rank[ok],
                              to_unit_float(hs[ok]), "amin")
    return table.reshape(num_groups, k)


def theta_merge(a, b):
    """[K, k] + [K, k] -> [K, k]: keep the k smallest distinct of the
    union."""
    k = a.shape[-1]
    both, _ = torch.sort(torch.cat([a, b], dim=-1), dim=-1)
    dup = torch.zeros_like(both, dtype=torch.bool)
    dup[..., 1:] = both[..., 1:] == both[..., :-1]
    both, _ = torch.sort(torch.where(dup, EMPTY, both), dim=-1)
    return both[..., :k]


def theta_estimate(table, float_dtype=torch.float64):
    """[K, k] row-sorted unit-hash table -> [K] estimates."""
    t = table.to(float_dtype)
    k = t.shape[-1]
    count = (t < EMPTY).sum(dim=-1)
    theta = t[..., -1]
    # a tensor numerator: `scalar / tensor` would round twice
    est_full = torch.full_like(theta, k - 1) / torch.clamp(theta, min=1e-30)
    return torch.where(count >= k, est_full, count.to(float_dtype))

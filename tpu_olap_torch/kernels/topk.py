"""Top-K group selection over a dense group table.

The JAX package's counterpart (`kernels/topk.py`) takes one `lax.top_k`
over the [K] metric array; its executor ranks TopN results on the host
(`runner._assemble_topn`) and calls neither, so this module is wired
into no query path either. Exact, like the JAX function: the dense group
table makes an exact top-K cheap, so Druid's approximate per-segment
topN has no counterpart here.
"""

from __future__ import annotations

import torch


def top_k_groups(metric: torch.Tensor, present: torch.Tensor,
                 threshold: int, inverted: bool):
    """metric: [K] values; present: [K] bool (group has rows).

    Returns (indices [k], valid [k]) with k = min(threshold, K): the
    group ids of the top `threshold` by metric (bottom if inverted),
    absent groups last, ties in group-id order (as the JAX function's
    stable sort and `lax.top_k` give them).

    torch.topk finds the k-th largest value; torch.topk does not promise
    which of several equal values it returns, so the groups strictly
    above that value are taken with the first of those equal to it, by
    group id, and ordered by (value descending, group id)."""
    k = min(int(threshold), metric.shape[-1])
    v = torch.where(present, -metric.double() if inverted
                    else metric.double(), -torch.inf)
    if k == 0:
        return (torch.zeros(0, dtype=torch.int64, device=v.device),
                torch.zeros(0, dtype=torch.bool, device=v.device))
    kth = torch.topk(v, k).values[-1]
    above = v > kth
    tie = v == kth
    take = above | (tie & (torch.cumsum(tie, 0)
                           <= k - above.sum()))
    ids = torch.nonzero(take).reshape(-1)          # ascending group ids
    order = ids[torch.sort(-v[ids], stable=True).indices]
    return order, v[order] > -torch.inf

"""The merges across processes of a multi-host mesh, as collectives.

The JAX package hands a multi-host mesh's programs to GSPMD with
replicated outputs, and the partitioner inserts the cross-process
collectives. Here each rank launches the port's kernels on its own
devices and merges locally (executor.sharding), and the merge across
ranks is spelled out with `torch.distributed` on the default process
group (or `group`), which the user opened on every rank:

- `gather_partials`: a rank's locally merged unfinalized partial dict,
  packed into one byte buffer, crosses in one `all_gather`; every rank
  unpacks the world's dicts and folds them with
  kernels.groupby.merge_partials IN RANK ORDER, so that every rank's
  float sums are bitwise equal.
- `gather_varlen`: compact sparse tables, whose lengths differ by rank:
  one `all_gather` of the lengths, then one of the tables padded to the
  longest, each trimmed back after.
- `gather_masks`: tensors of one shape on every rank (the per-device row
  masks: segments pad to a multiple of the global D, so every rank's
  masks have one shape; Search's code counts).
- `agree_max`: the largest of one integer over the ranks, so that every
  rank takes the same re-run decision (a sparse cap that overflowed on
  any rank).

The backend rule, decided by the group's backend and by nothing else:
under NCCL a collective moves tensors on this rank's current CUDA device
(the caller makes the mesh's first device current); under any other
backend (gloo) it moves host tensors, which the staged fetch has
already filled. Inputs are moved to that device (`wire_device`) and the
results come back on it.

Each all_gather counts once in `collectives`, and the bytes it delivers
to this rank (world x the buffer) in `collective_bytes`; with a metrics
dict, the statement's own `collectives` and `collective_bytes` count
them too. A peer that died surfaces as the group's error (its timeout,
or the closed connection) on the ranks that wait.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from tpu_olap_torch.kernels.groupby import merge_partials

collectives = 0          # all_gathers issued by this process
collective_bytes = 0     # bytes those all_gathers delivered here


def wire_device(group=None) -> torch.device:
    """Where the group's collectives move tensors: this rank's current
    CUDA device under NCCL, the host under every other backend."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(buf: torch.Tensor, group, metrics) -> list:
    """One all_gather of `buf` (the same shape and dtype on every rank):
    the world's buffers in rank order, counted."""
    global collectives, collective_bytes
    world = dist.get_world_size(group)
    out = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(out, buf, group=group)
    nbytes = world * buf.numel() * buf.element_size()
    collectives += 1
    collective_bytes += nbytes
    if metrics is not None:
        metrics["collectives"] = metrics.get("collectives", 0) + 1
        metrics["collective_bytes"] = \
            metrics.get("collective_bytes", 0) + nbytes
    return out


# ---------------------------------------------------------------------------
# Byte packing of a dict of tensors


def layout(parts: dict) -> list:
    """[(name, dtype, shape)] of a dict of tensors, in name order: the
    same on every rank for one plan's partials."""
    return [(n, parts[n].dtype, tuple(parts[n].shape)) for n in sorted(parts)]


def _padded(nbytes: int) -> int:
    return -(-nbytes // 8) * 8   # every field starts 8-byte aligned


def pack(parts: dict) -> torch.Tensor:
    """A dict of tensors, all on one device, as one uint8 buffer there,
    in `layout` order, each field padded to 8 bytes."""
    flat = []
    for name, _, _ in layout(parts):
        b = parts[name].contiguous().reshape(-1).view(torch.uint8)
        flat += [b, b.new_zeros(_padded(b.numel()) - b.numel())]
    return torch.cat(flat) if flat else torch.empty(0, dtype=torch.uint8)


def unpack(buf: torch.Tensor, lay: list) -> dict:
    """`pack`'s buffer back to {name: tensor} (views of `buf`)."""
    out, off = {}, 0
    for name, dtype, shape in lay:
        n = int(np.prod(shape, dtype=np.int64)) \
            * torch.empty(0, dtype=dtype).element_size()
        out[name] = buf[off:off + n].view(dtype).reshape(shape)
        off += _padded(n)
    return out


def fold_in_rank_order(bufs: list, lay: list, agg_plans) -> dict:
    """The world's packed partial dicts folded left to right, rank 0
    first, with merge_partials: the same order on every rank, so the
    same bits."""
    return functools.reduce(lambda a, b: merge_partials(a, b, agg_plans),
                            [unpack(b, lay) for b in bufs])


def gather_partials(parts: dict, agg_plans, group=None,
                    metrics=None) -> dict:
    """This rank's locally merged unfinalized partial dict {name: [K,
    ...]} -> the dict merged over every rank, on the wire device: one
    all_gather of the packed bytes, then the rank-order fold."""
    dev = wire_device(group)
    parts = {n: torch.as_tensor(v).to(dev) for n, v in parts.items()}
    buf = pack(parts)
    return fold_in_rank_order(_all_gather(buf, group, metrics),
                              layout(parts), agg_plans)


def gather_varlen(table: dict, n: int, group=None, metrics=None) -> list:
    """A compact sparse table whose first `n` rows are live ({name:
    [cap, ...]}, "_count" a scalar) -> every rank's table in rank order,
    each cut to its live rows with "_count" its row count, on the wire
    device: an all_gather of the lengths, then one of the tables padded
    to the longest."""
    dev = wire_device(group)
    lengths = _all_gather(torch.tensor([int(n)], dtype=torch.int64,
                                       device=dev), group, metrics)
    lengths = [int(x.item()) for x in lengths]
    longest = max(lengths)
    rows = {}
    for name, v in table.items():
        if name == "_count":
            continue
        t = torch.as_tensor(v)[:n].to(dev)
        pad = t.new_zeros((longest - t.shape[0],) + tuple(t.shape[1:]))
        rows[name] = torch.cat([t, pad])
    lay = layout(rows)
    out = []
    for r, b in enumerate(_all_gather(pack(rows), group, metrics)):
        t = {name: v[:lengths[r]] for name, v in unpack(b, lay).items()}
        t["_count"] = torch.tensor(lengths[r], dtype=torch.int32,
                                   device=dev)
        out.append(t)
    return out


def gather_masks(mask, group=None, metrics=None) -> list:
    """A tensor (or array) of one shape and dtype on every rank -> the
    world's, in rank order, on the wire device."""
    return _all_gather(torch.as_tensor(mask).to(wire_device(group))
                       .contiguous(), group, metrics)


def agree_max(value: int, group=None, metrics=None) -> int:
    """The largest `value` over the ranks."""
    got = gather_masks(torch.tensor([int(value)], dtype=torch.int64),
                       group, metrics)
    return max(int(t.item()) for t in got)

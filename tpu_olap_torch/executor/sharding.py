"""The mesh: the segment axis split over D devices in one process.

The counterpart of the JAX package's `executor/sharding.py`, which
places the column stacks with `NamedSharding` and hands whole programs
to `jax.jit` (GSPMD inserts the cross-chip collectives). Here every
device runs the port's own kernels over its own stacks, one launch per
device per statement, and the merges are spelled out:

- Placement. Segments pad to a multiple of D with fully invalid
  segments, and logical segment i lives on device i mod D at local index
  i // D (`placement`, interleaved as a Druid coordinator balances an
  interval's segments over historicals). A stack is a `Sharded` list:
  shard c, on mesh device c, holds device c's segments in local order.
  Under interleaving a contiguous time range [lo, hi) of logical
  segments is the local range [lo // D, ceil(hi / D)) on every device,
  so one (lo, W) window (`local_window`) prunes every device's share.
- Aggregates: the plan's kernel (B1 on the card) once per device, over
  that device's window (`device_args`, `launch_per_device`). The cost
  model (planner.cost) picks the merge: "historicals" copies every
  device's unfinalized partial table to the host, where `broker_merge`
  folds them with the segment cache's algebra
  (kernels.groupby.merge_partials); "broker" copies them device to
  device onto the mesh's first device and folds them there with the
  same algebra (`device_fold`), then one table goes to the host — the
  counterpart of GSPMD's inserted collectives.
- The sparse group-by compacts per device and merges at the host
  (`sparse_merge="gather"`) or exchanges its compact entries between
  devices (kernels.sparse_groupby.exchange, `"exchange"`).

`chip_extended_key` of the JAX package has no counterpart: it exists
because one GSPMD program covers every chip and must keep their groups
apart; with one launch per device each device's table is its own.

On the CPU the mesh is D entries of the CPU device (the counterpart of
the JAX package's 8 virtual CPU devices); on cards, D <= the cards, or
up to `utils.platform.force_virtual_devices(n)` logical devices laid
over the cards round-robin.

Across processes (`make_multihost_mesh`, the counterpart of the JAX
package's mesh after `jax.distributed.initialize`): the user opens the
default process group (`torch.distributed.init_process_group`) on every
rank and gives the engine `num_shards` = world x L. Global device g
belongs to rank g // L, so rank 0's devices come first, as in
`jax.devices()`; placement stays interleaved over the global D, so
logical segment i lives on rank (i mod D) // L. A `Mesh` holds only its
rank's L devices (`devices`, global ids `local_ids`) beside `rank` and
`world`; `size` is the global D. Every rank registers the same table,
uploads only its own shards (`shard_host`) and runs the same statements
in the same order; the cross-process merges are collectives
(executor.collective), so every rank assembles the same answer.
`is_multihost` is true when the mesh spans processes.
"""

from __future__ import annotations

import functools
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from tpu_olap_torch.kernels.groupby import merge_partials
from tpu_olap_torch.utils.platform import virtual_devices


@dataclass(frozen=True)
class Mesh:
    """This process's L logical devices, in mesh order, and its place
    among the processes: local device c is global device rank·L + c,
    which holds the segments i with i mod D == rank·L + c. One process:
    rank 0 of world 1, and the devices are all D."""
    devices: tuple
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        """The global device count D."""
        return self.world * len(self.devices)

    @property
    def local_ids(self) -> range:
        """Global ids of this process's devices, in local order."""
        n = len(self.devices)
        return range(self.rank * n, (self.rank + 1) * n)


def make_mesh(num_shards: int, device: str = "cuda") -> Mesh:
    """The mesh of `num_shards` logical devices on `device`'s type in
    one process. On cuda, more devices than cards raise ValueError
    unless force_virtual_devices allowed them."""
    if int(num_shards) < 1:
        raise ValueError(f"num_shards must be >= 1; got {num_shards}")
    return rank_mesh(0, 1, int(num_shards), device)


def make_multihost_mesh(num_shards: int | None = None,
                        device: str = "cuda") -> Mesh:
    """The mesh over every process's devices: call it after
    torch.distributed.init_process_group on every rank (without an
    initialized group it is the one-process mesh of rank 0). Rank r
    holds global devices [r·L, (r+1)·L), L = num_shards / world;
    `num_shards` defaults to every device of every rank, and past them
    it raises ValueError, as the JAX package's does."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return rank_mesh(dist.get_rank(), dist.get_world_size(),
                         num_shards, device)
    return rank_mesh(0, 1, num_shards, device)


def rank_mesh(rank: int, world: int, num_shards: int | None = None,
              device: str = "cuda") -> Mesh:
    """Rank `rank`'s mesh among `world` processes. On the CPU its L
    devices are entries of the CPU device (one by default). On cuda the
    ranks of a host split its cards (rank r takes the cards_per_rank
    cards from (r x cards_per_rank) mod cards, one card shared when
    there are fewer cards than ranks) and its L devices are laid over
    its cards round-robin; more devices than its cards take
    force_virtual_devices. One process (rank 0 of 1) takes every card."""

    kind = torch.device(device).type
    if kind == "cpu":
        own, cap, base = 1, None, 0
    else:
        cards = torch.cuda.device_count()
        own = max(1, cards // world)
        cap = max(own, virtual_devices()) if cards else 0
        base = (rank * own) % cards if cards else 0
    total = None if cap is None else world * cap
    n = int(num_shards or total or world)
    if n < 1:
        raise ValueError(f"num_shards must be >= 1; got {num_shards}")
    if total is not None and n > total:
        raise ValueError(f"num_shards={n} exceeds {total} devices")
    if n % world:
        raise ValueError(f"num_shards={n} does not split over {world} "
                         f"processes")
    L = n // world
    if kind == "cpu":
        devs = tuple(torch.device("cpu") for _ in range(L))
    else:
        devs = tuple(torch.device("cuda", base + c % own) for c in range(L))
    return Mesh(devs, rank, world)


def is_multihost(mesh: Mesh) -> bool:
    """True when the mesh spans processes: the other ranks' shards are
    not addressable here, so every merge across them is a collective."""
    return mesh.world > 1


def pad_segments(n_segments: int, num_shards: int) -> int:
    """Segments must split evenly across devices; padded segments are
    fully invalid rows (valid mask False), so results are unaffected."""
    return -(-n_segments // num_shards) * num_shards


def placement(n_segments: int, num_shards: int):
    """(to_place, to_logical) permutations for the interleaved
    segment->device assignment over a PADDED segment count.

    Logical segment i belongs to device i mod D at local index i // D;
    the placed order is device-major, so device c's block
    [c·S/D, (c+1)·S/D) holds exactly its interleaved segments.
    to_place[i] = placed position of logical i; to_logical[p] = logical
    id at placed position p."""
    per_chip = n_segments // num_shards
    logical = np.arange(n_segments, dtype=np.int64)
    to_place = (logical % num_shards) * per_chip + logical // num_shards
    to_logical = np.empty(n_segments, np.int64)
    to_logical[to_place] = logical
    return to_place.astype(np.int32), to_logical.astype(np.int32)


def chip_of(segment_id: int, num_shards: int) -> int:
    """Owning device of a logical segment under interleaved placement."""
    return segment_id % num_shards


def local_window(pruned_ids, num_shards: int, per_chip: int):
    """(lo_local, W_local) covering every pruned segment's LOCAL index
    on its device, or None when windowing would not save >= 25% of the
    per-device working set. Interleaved placement makes the local ranges
    near-identical across devices, so ONE (lo, W) serves all of them.
    W is a power of two and lo a launch argument, so a sliding interval
    of the same width compiles nothing new."""
    if not pruned_ids:
        return None
    lo = min(pruned_ids) // num_shards
    hi = max(pruned_ids) // num_shards + 1
    W = _next_pow2(hi - lo)
    W = min(W, per_chip)
    if 4 * W >= 3 * per_chip:
        return None
    return min(lo, per_chip - W), W


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


# ---------------------------------------------------------------------------
# Per-device stacks and launches


class Sharded(list):
    """One [S, ...] stack split over the mesh: shard c, on mesh device c,
    is [S / D, ...] in local order (logical segments c, c + D, ...)."""

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def on_device(dev: torch.device):
    """The context a launch on `dev` runs in: its CUDA device current
    (so that its current stream and its kernels' context are the
    device's), nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return nullcontext()


def shard_host(arr: np.ndarray, mesh: Mesh) -> Sharded:
    """A host [S_pad, ...] array in LOGICAL order -> this process's
    shards, each uploaded to its device (global device g takes rows
    g, g + D, ...; the other ranks' rows are not uploaded here)."""
    D = mesh.size
    return Sharded(torch.from_numpy(np.ascontiguousarray(arr[g::D]))
                   .to(dev) for g, dev in zip(mesh.local_ids, mesh.devices))


def map_shards(mesh: Mesh, fn, *args) -> Sharded:
    """fn(shard args...) per device under its device context; each
    argument is Sharded or a per-device list."""
    out = Sharded()
    for c, dev in enumerate(mesh.devices):
        with on_device(dev):
            out.append(fn(*(a[c] for a in args)))
    return out


def device_args(env, valid, seg_mask, consts, win=None) -> list:
    """Per-device (env, valid, seg_mask, consts) argument tuples of a
    launch from the Sharded stacks and the per-device constant pools,
    each cut to the local window (lo, W) when one is given (every piece
    is already on its device: nothing is copied)."""
    sl = slice(None) if win is None else slice(win[0], win[0] + win[1])
    out = []
    for c in range(len(valid)):
        e = {kind: {n: a[c][sl] for n, a in env[kind].items()}
             for kind in ("cols", "nulls")}
        out.append((e, valid[c][sl], seg_mask[c][sl], consts[c]))
    return out


def launch_per_device(mesh: Mesh, fn, args: list) -> list:
    """fn(*args[c]) once per device, under that device's context, in
    mesh order; the launches queue on each device's current stream."""
    return map_shards(mesh, lambda a: fn(*a), args)


def broker_merge(parts: list, agg_plans) -> dict:
    """Host-side broker step: the D per-device unfinalized partial dicts
    ({name: [K, ...]} numpy arrays or CPU tensors) -> one merged [K, ...]
    partials dict of CPU tensors, folded with the merge algebra the
    segment cache and the cube folds share (sums add, min/max fold, HLL
    registers max-merge, theta tables re-merge losslessly)."""
    ts = [{n: torch.as_tensor(v) for n, v in p.items()} for p in parts]
    return functools.reduce(lambda a, b: merge_partials(a, b, agg_plans),
                            ts)


def device_fold(outs: list, agg_plans, device: torch.device) -> dict:
    """The "broker" merge on the device: every device's partial dict is
    copied device to device onto `device` (the mesh's first) and folded
    there with broker_merge's algebra; the caller copies the one folded
    table to the host."""
    with on_device(device):
        moved = [{n: t.to(device, non_blocking=True) for n, t in o.items()}
                 for o in outs]
        return functools.reduce(
            lambda a, b: merge_partials(a, b, agg_plans), moved)

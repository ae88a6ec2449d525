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
over the cards round-robin. One process only: `is_multihost` is always
false (the multi-host mesh needs torch.distributed across processes).
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
    """D logical devices, in mesh order (logical device c holds the
    segments i with i mod D == c)."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(num_shards: int, device: str = "cuda") -> Mesh:
    """The mesh of `num_shards` logical devices on `device`'s type. On
    cuda, more devices than cards raise ValueError unless
    force_virtual_devices allowed them."""
    d = int(num_shards)
    if d < 1:
        raise ValueError(f"num_shards must be >= 1; got {num_shards}")
    kind = torch.device(device).type
    if kind == "cpu":
        return Mesh(tuple(torch.device("cpu") for _ in range(d)))
    cards = torch.cuda.device_count()
    if d > max(cards, virtual_devices()) or cards == 0:
        raise ValueError(f"num_shards={d} exceeds {cards} devices")
    return Mesh(tuple(torch.device("cuda", c % cards) for c in range(d)))


def is_multihost(mesh: Mesh) -> bool:
    """Always False: the mesh lives in one process."""
    return False


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
    """A host [S_pad, ...] array in LOGICAL order -> its shards, each
    uploaded to its device (device c takes rows c, c + D, ...)."""
    D = mesh.size
    return Sharded(torch.from_numpy(np.ascontiguousarray(arr[c::D]))
                   .to(dev) for c, dev in enumerate(mesh.devices))


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

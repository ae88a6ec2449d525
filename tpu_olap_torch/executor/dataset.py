"""Device-resident column cache: stacked [n_segments, block_rows] tensors.

The analog of Druid historicals' memory-mapped segments (SURVEY.md §2 L1):
columns are uploaded to the device once per table (lazily, per column) and
reused across queries. Interval pruning is applied as a per-segment mask
(columns stay resident; masked segments cost compute but no transfer).

Every table's stacks are accounted in one `HbmLedger` that the runner
owns: past `EngineConfig.hbm_budget_bytes` the least-recently-used
unpinned stacks evict (an evicted stack rebuilds on its next use).

Under a mesh (executor.sharding) the segment axis pads to a multiple of
D with fully invalid segments and every stack is `Sharded`: shard c, on
mesh device c, holds the segments i with i mod D == c at local index
i // D (the interleaved placement; `to_place`/`to_logical` map logical
ids to placed positions and back). The segment mask is sharded the same
way, and the ledger splits each stack's bytes evenly over the mesh's
devices, which is exact: every shard has the same shape. Across
processes a stack holds only this rank's shards (global devices
rank·L .. rank·L + L - 1), and the ledger counts only them.

Snapshot swaps (real-time appends, incremental compaction) hand the
superseded dataset in as `prev`, and each resident stack REBASES on the
device instead of re-uploading: the rows of segments whose uid the old
snapshot shares are copied device to device from the old stack
(index_select / index_copy_), and only the changed segments' rows
upload (the tail block an append rewrote, and any new blocks). A stack
whose dtype changed (a narrowed LONG column widened, a code column
promoted) re-stacks whole. The rebase runs on CPU tensors the same way.
Under a mesh it follows the placement: a segment keeps its device and
local index (i mod D, i // D) as the table grows, so each shard rebases
on its own device; an append that adds a segment can add a local row to
every shard (new padding) and moves placed positions, never a kept
segment's rows.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from tpu_olap_torch.executor.sharding import (Mesh, Sharded, pad_segments,
                                             placement, shard_host)
from tpu_olap_torch.segments.ingest import _int_dtype_for
from tpu_olap_torch.segments.segment import (ColumnType, TableSegments,
                                             TIME_COLUMN)


def narrow_dtype(table: TableSegments, name: str):
    """Smallest int dtype (int8/int16/int32/int64) holding every value of
    a LONG column per the segment manifest's column min/max — less
    residency and scan bandwidth; sums still widen to the accumulator
    dtype on device. Usually a no-op cast: ingest already stores the
    narrowed dtype. None for other columns (__time stays int64 epoch
    millis; codes and doubles keep their stored dtype)."""
    if name == TIME_COLUMN or table.schema.get(name) is not ColumnType.LONG:
        return None
    lo = hi = None
    for s in table.segments:
        mlo = s.meta.column_min.get(name)
        mhi = s.meta.column_max.get(name)
        if mlo is None:
            continue  # empty/all-null segment stores zero fill
        lo = mlo if lo is None else min(lo, mlo)
        hi = mhi if hi is None else max(hi, mhi)
    if lo is None:
        return np.dtype(np.int8)
    return _int_dtype_for(lo, hi)


def resident_dtype(table: TableSegments, name: str) -> torch.dtype:
    """The dtype of column `name`'s resident stack (DeviceDataset.col)."""
    dt = narrow_dtype(table, name)
    if dt is None:
        dts = [s.columns[name].dtype for s in table.segments]
        dt = np.result_type(*dts) if dts else np.dtype(np.int32)
    return torch.from_numpy(np.zeros(0, dt)).dtype


def has_nulls(table: TableSegments, name: str) -> bool:
    """Whether any segment carries a null mask for `name` (else the
    dataset holds none for it)."""
    return any(name in s.null_masks for s in table.segments)


class HbmLedger:
    """LRU accounting of the device-resident stacks of every table the
    runner serves. When an add would pass the budget, the
    least-recently-used unpinned stacks evict first; the stacks the
    in-flight query needs are pinned while its env builds. A single
    over-budget stack still uploads (the query must run): the budget
    bounds the cache, not one query's working set.

    Evicting drops the dataset's reference only: the memory returns to
    torch's caching allocator once no env holds the tensor any more, so
    the witness of the budget is torch.cuda.memory_allocated(), not
    memory_reserved(). `pin_inflight` counts a dispatch's not-yet-copied
    output bytes toward the budget without making them evictable.

    Attribution by owner class, as in the JAX package: `breakdown()`
    gives {(chip, owner): bytes} over `table_columns` (column, null,
    validity and derived stacks), `cube_tables` (the stacks of a cube's
    storage table, `__cube_<name>`) and `inflight` (pinned outputs),
    which sum exactly to `bytes_in_use`, plus what external reporters
    say (`register_external`: the tier-1 cache's `cache_pins`).
    Under a mesh of D devices (`set_num_chips`, called when the runner
    builds the mesh) every entry splits evenly over the devices, the
    remainder to the lowest ones, so that the per-device sums equal
    bytes_in_use exactly: every ledgered stack is sharded 1/D per device
    (the dataset pads the segment axis to a multiple of D)."""

    def __init__(self, budget_bytes: int | None):
        self.budget = budget_bytes
        self._entries: OrderedDict[tuple, tuple[int, object]] = \
            OrderedDict()  # key -> (nbytes, evict_fn)
        self._inflight: dict[tuple, int] = {}
        self._mu = threading.RLock()
        self.bytes_in_use = 0
        self.evictions = 0
        self.high_watermark = 0
        self.num_chips = 1
        self._chip_bytes = [0] * self.num_chips
        self._chip_hwm = [0] * self.num_chips
        self._by_chip_owner: dict[tuple, int] = {}
        self._external: dict = {}  # owner -> fn(num_chips) -> {chip: b}

    @staticmethod
    def _owner_for(key) -> str:
        """Owner class of a ledger key: in-flight output pins, a cube's
        storage table (catalog name `__cube_<name>`), or ordinary table
        stacks."""
        head = str(key[0]) if key else ""
        if head == "__inflight__":
            return "inflight"
        if head.startswith("__cube"):
            return "cube_tables"
        return "table_columns"

    def _shares(self, nbytes: int) -> list:
        q, r = divmod(int(nbytes), self.num_chips)
        return [q + (1 if c < r else 0) for c in range(self.num_chips)]

    def _account(self, key, nbytes: int, sign: int, total: bool = True):
        """bytes_in_use (unless `total` is False), the per-(chip, owner)
        split and the high-watermarks; the caller holds _mu."""
        if total:
            self.bytes_in_use += sign * nbytes
        owner = self._owner_for(key)
        for c, share in enumerate(self._shares(nbytes)):
            self._chip_bytes[c] += sign * share
            k = (c, owner)
            nb = self._by_chip_owner.get(k, 0) + sign * share
            if nb:
                self._by_chip_owner[k] = nb
            else:
                self._by_chip_owner.pop(k, None)
            if self._chip_bytes[c] > self._chip_hwm[c]:
                self._chip_hwm[c] = self._chip_bytes[c]
        if self.bytes_in_use > self.high_watermark:
            self.high_watermark = self.bytes_in_use

    def set_num_chips(self, num_chips: int):
        """Adopt the mesh's device count (the runner learns it when it
        builds the mesh, after the ledger exists) and re-attribute every
        live entry under the new split. The per-device watermarks reset
        to the current bytes: a watermark against another device count
        does not compare."""
        d = max(1, int(num_chips))
        with self._mu:
            if d == self.num_chips:
                return
            self.num_chips = d
            self._chip_bytes = [0] * d
            self._chip_hwm = [0] * d
            self._by_chip_owner = {}
            for k, (nbytes, _fn) in self._entries.items():
                self._account(k, nbytes, +1, total=False)
            for k, nbytes in self._inflight.items():
                self._account(k, nbytes, +1, total=False)
            self._chip_hwm = list(self._chip_bytes)

    def register_external(self, owner: str, fn):
        """Register a live byte reporter folded into breakdown() under
        `owner` (tier-1 cache pins: the ResultCache owns those buffers
        and their eviction, so the ledger reports rather than manages
        them). fn(num_chips) -> {chip: bytes}."""
        with self._mu:
            self._external[owner] = fn

    def breakdown(self) -> dict:
        """{(chip, owner-class): bytes}: the ledger-managed classes
        (table_columns, cube_tables, inflight), which sum exactly to
        bytes_in_use, plus the external reporters (cache_pins)."""
        with self._mu:
            out = dict(self._by_chip_owner)
            external = dict(self._external)
            d = self.num_chips
        for owner, fn in external.items():
            try:
                per_chip = fn(d) or {}
            except Exception:  # noqa: BLE001 — accounting, not serving
                continue
            for c, nbytes in per_chip.items():
                if nbytes:
                    k = (int(c), owner)
                    out[k] = out.get(k, 0) + int(nbytes)
        return out

    def total_bytes(self) -> int:
        """bytes_in_use plus the external (cache-pin) bytes: what
        breakdown() sums to."""
        snap = self.breakdown()
        with self._mu:
            core = self.bytes_in_use
            external = set(self._external)
        return core + sum(b for (_c, o), b in snap.items()
                          if o in external)

    def watermarks(self) -> dict:
        """Ledger-managed high-watermarks, total and per chip."""
        with self._mu:
            return {"total": self.high_watermark,
                    "per_chip": list(self._chip_hwm)}

    @property
    def inflight_bytes(self) -> int:
        with self._mu:
            return sum(self._inflight.values())

    def touch(self, key):
        with self._mu:
            if key in self._entries:
                self._entries.move_to_end(key)

    def add(self, key, nbytes: int, evict_fn, pinned=frozenset()):
        with self._mu:
            if self.budget is not None:
                for k in list(self._entries):
                    if self.bytes_in_use + nbytes <= self.budget:
                        break
                    if k in pinned:
                        continue
                    n, fn = self._entries.pop(k)
                    self._account(k, n, -1)
                    self.evictions += 1
                    fn()
            self._entries[key] = (nbytes, evict_fn)
            self._account(key, nbytes, +1)

    def pin_inflight(self, key, nbytes: int):
        """Account a dispatch's not-yet-copied output buffers: counted in
        bytes_in_use (so later adds evict stacks to stay within budget)
        but never evictable."""
        with self._mu:
            self._inflight[key] = int(nbytes)
            self._account(key, int(nbytes), +1)

    def unpin_inflight(self, key):
        with self._mu:
            n = self._inflight.pop(key, None)
            if n is not None:
                self._account(key, n, -1)

    def remove(self, key):
        with self._mu:
            e = self._entries.pop(key, None)
            if e is not None:
                self._account(key, e[0], -1)

    def remove_table(self, table_name: str):
        with self._mu:
            for k in [k for k in self._entries if k[0] == table_name]:
                self.remove(k)


class DeviceDataset:
    """Lazy per-column stacks for one table on one device, or Sharded
    over a mesh, accounted in the runner's HbmLedger (None:
    unaccounted).

    `prev`, the superseded snapshot's dataset, seeds a rebase: its
    resident column, null and validity stacks are kept as rebase
    sources, and the first use of each stack here builds it from its
    source (`_rebase_stack`). The sources drop at the first dispatch's
    validity mask, the last stack its working set builds (as in the JAX
    package): the columns that dispatch reads rebase, and a column first
    read by a later query re-stacks whole. The runner evicts `prev` once
    this dataset holds its sources, so that until they drop, the sources
    are out of the ledger.
    Derived streams (dim ids, bucket ids, filter translations) never
    carry over: their rows change with the tail block. Rebases are
    counted in `rebased_cols` and `rebase_rows_uploaded` (rows uploaded
    per rebased stack, summed); `h2d_bytes` counts every byte put on the
    device (stacks, rebase uploads, segment masks)."""

    def __init__(self, table: TableSegments, device: torch.device,
                 ledger: HbmLedger | None = None, prev=None,
                 mesh: Mesh | None = None):
        self.table = table
        self.device = torch.device(device)
        self.ledger = ledger
        self.mesh = mesh
        self._cols: dict[str, torch.Tensor] = {}
        self._nulls: dict[str, torch.Tensor | None] = {}
        self._derived: dict[str, torch.Tensor] = {}
        self._valid = None
        n_seg = len(table.segments)
        self.to_place = self.to_logical = None
        if mesh is not None:
            n_seg = pad_segments(max(n_seg, 1), mesh.size)
            self.to_place, self.to_logical = placement(n_seg, mesh.size)
        self.shape = (n_seg, table.block_rows)
        self._rebase = None
        self.rebased_cols = 0
        self.rebase_rows_uploaded = 0
        self.h2d_bytes = 0      # host-to-device bytes this dataset put
        if (prev is not None and prev.table is not table
                and prev.device == self.device and prev.mesh == mesh
                and prev.table.block_rows == table.block_rows):
            old_segs = prev.table.segments
            # uid equality, not object identity: incremental compaction
            # re-wraps untouched partitions in fresh Segment shells
            # around the same column arrays, carrying the uid over
            changed = [i for i, s in enumerate(table.segments)
                       if i >= len(old_segs) or s.uid != old_segs[i].uid]
            # only worth the device copy when most rows carry over
            if changed and len(changed) * 2 <= len(table.segments):
                self._rebase = {"changed": changed, "old_n": len(old_segs),
                                "cols": dict(prev._cols),
                                "nulls": dict(prev._nulls),
                                "valid": prev._valid}

    @property
    def per_chip(self) -> int:
        """Segments per mesh device (all of them without a mesh)."""
        return self.shape[0] // (self.mesh.size if self.mesh else 1)

    def _rebase_stack(self, old, per_segment, dtype: torch.dtype):
        """A new stack from the old snapshot's resident one: unchanged
        segments' rows copied on the device, changed segments' rows
        uploaded. None when there is no source or its dtype differs
        from the new stack's (the caller re-stacks whole). Under a mesh
        each shard rebases on its own device: a logical segment i stays
        at (device i mod D, local i // D) as the table grows, and new
        local rows (padding) are zeros, fully invalid."""
        if old is None:
            return None
        first = old[0] if isinstance(old, Sharded) else old
        if first.dtype != dtype:
            return None
        rb = self._rebase
        changed = rb["changed"]
        cset = set(changed)
        n_new = len(self.table.segments)
        keep = [i for i in range(min(n_new, rb["old_n"])) if i not in cset]
        if self.mesh is None:
            shards, devs, gids, D = [old], [self.device], [0], 1
            new_rows = [n_new]
        else:
            shards, devs, gids, D = list(old), list(self.mesh.devices), \
                list(self.mesh.local_ids), self.mesh.size
            new_rows = [self.per_chip] * len(devs)
        out = Sharded() if self.mesh is not None else None
        for src, dev, c, rows in zip(shards, devs, gids, new_rows):
            # a fresh shard: zeros (padding is fully invalid)
            dst = torch.zeros((rows,) + tuple(src.shape[1:]),
                              dtype=dtype, device=dev)
            mine = [i for i in keep if i % D == c]
            if mine:
                idx = torch.tensor([i // D for i in mine],
                                   dtype=torch.int64, device=dev)
                dst.index_copy_(0, idx, src.index_select(0, idx))
            fresh_ids = [i for i in changed if i % D == c]
            if fresh_ids:
                fresh = np.stack([per_segment(self.table.segments[i])
                                  for i in fresh_ids])
                idx = torch.tensor([i // D for i in fresh_ids],
                                   dtype=torch.int64, device=dev)
                dst.index_copy_(0, idx, self._put_one(fresh, dev).to(dtype))
            if out is None:
                out = dst
            else:
                out.append(dst)
        self.rebased_cols += 1
        self.rebase_rows_uploaded += len(changed) * self.table.block_rows
        return out

    def _build(self, kind: str, name: str, per_segment, dtype: torch.dtype,
               np_dtype=None):
        """One stack: rebased from its source when there is one, else
        stacked and uploaded whole."""
        rb, old = self._rebase, None
        if rb is not None:
            old = rb["valid"] if kind == "valid" \
                else rb[kind + "s"].pop(name, None)
        t = self._rebase_stack(old, per_segment, dtype)
        if t is None:
            t = self._put(self._stack(per_segment, np_dtype))
        return t

    def _put_one(self, arr: np.ndarray, device) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        self.h2d_bytes += arr.nbytes
        return torch.from_numpy(arr).to(device)

    def _put(self, arr: np.ndarray):
        """A host [S, ...] array in logical order on the device, or
        Sharded over the mesh."""
        if self.mesh is None:
            return self._put_one(arr, self.device)
        out = shard_host(arr, self.mesh)
        self.h2d_bytes += out.nbytes
        return out

    def _stack(self, per_segment, dtype=None) -> np.ndarray:
        """[S, R] of every segment in logical order, padded with zero
        segments to the mesh's multiple."""
        rows = [per_segment(s) for s in self.table.segments]
        fill = self.shape[0] - len(rows)
        if fill > 0:
            proto = rows[0] if rows else \
                np.zeros(self.table.block_rows, dtype or np.int32)
            rows = rows + [np.zeros_like(proto)] * fill
        if not rows:
            return np.zeros((0, self.table.block_rows), dtype or np.int32)
        return np.stack(rows)

    def _account(self, kind: str, name: str, t, store, pinned):
        """Enter a new stack in the ledger; evicting it pops it from
        `store` (a dict, or None for the validity mask)."""
        if self.ledger is None:
            return
        if store is None:
            def drop():
                self._valid = None
        else:
            def drop():
                store.pop(name, None)
        self.ledger.add((self.table.name, kind, name), _nbytes(t), drop,
                        pinned)

    def _touch(self, kind: str, name: str):
        if self.ledger is not None:
            self.ledger.touch((self.table.name, kind, name))

    def col(self, name: str, pinned=frozenset()):
        t = self._cols.get(name)
        if t is None:
            dt = narrow_dtype(self.table, name)
            get = (lambda s: s.columns[name]) if dt is None else \
                (lambda s: s.columns[name].astype(dt, copy=False))
            t = self._cols[name] = self._build(
                "col", name, get, resident_dtype(self.table, name), dt)
            self._account("col", name, t, self._cols, pinned)
        else:
            self._touch("col", name)
        return t

    def null_mask(self, name: str, pinned=frozenset()):
        """None if the column has no nulls anywhere."""
        if name not in self._nulls:
            t = None
            if has_nulls(self.table, name):
                zero = np.zeros(self.table.block_rows, bool)
                t = self._build("null", name,
                                lambda s: s.null_masks.get(name, zero),
                                torch.bool)
            self._nulls[name] = t
            if t is not None:
                self._account("null", name, t, self._nulls, pinned)
            return t
        t = self._nulls[name]
        if t is not None:
            self._touch("null", name)
        return t

    def derived(self, token: str, build, pinned=frozenset()):
        """Device-resident derived int32 stream [S, R] (precomputed dim
        ids, bucket ids, filter translations; Sharded under a mesh),
        computed ONCE per content token and reused across queries — a
        resident stream costs one read like any column instead of a
        gather per dispatch. Evictable; an evicted stream rebuilds.
        `pinned` must hold the in-flight query's working set, so that
        this add cannot evict what the same query is about to read."""
        t = self._derived.get(token)
        if t is None:
            t = self._derived[token] = build()
            self._account("derived", token, t, self._derived, pinned)
        else:
            self._touch("derived", token)
        return t

    def valid(self, pinned=frozenset()):
        """[S, R] row-validity (padding rows and segments are False)."""
        t = self._valid
        if t is None:
            r = np.arange(self.table.block_rows)
            t = self._valid = self._build(
                "valid", "", lambda s: r < s.meta.n_valid, torch.bool, bool)
            self._account("valid", "", t, None, pinned)
        else:
            self._touch("valid", "")
        # the last stack of a dispatch's working set: the rebase ends
        self._rebase = None
        return t

    def segment_mask(self, kept_ids):
        """[S] bool on the device from the pruned LOGICAL segment ids
        (Sharded like the stacks under a mesh)."""
        m = np.zeros(self.shape[0], bool)
        m[list(kept_ids)] = True
        return self._put(m)

    def pins(self, columns, null_cols, tokens=()) -> frozenset:
        """Ledger keys of a working set: its columns, null masks, derived
        streams and the validity mask."""
        n = self.table.name
        return frozenset([(n, "col", c) for c in columns]
                         + [(n, "null", c) for c in null_cols]
                         + [(n, "derived", t) for t in tokens]
                         + [(n, "valid", "")])

    def env(self, columns, null_cols, pinned=None) -> dict:
        """The kernel env for the requested columns. The working set is
        pinned while it builds, so that budget eviction cannot drop a
        stack this same query is about to use."""
        if pinned is None:
            pinned = self.pins(columns, null_cols)
        return {
            "cols": {c: self.col(c, pinned) for c in columns},
            "nulls": {c: m for c in null_cols
                      if (m := self.null_mask(c, pinned)) is not None},
        }

    def resident_bytes(self) -> int:
        """Device bytes this dataset holds: column, null and derived
        stacks plus the validity mask."""
        total = 0
        for store in (self._cols, self._nulls, self._derived):
            for t in list(store.values()):
                if t is not None:
                    total += _nbytes(t)
        if self._valid is not None:
            total += _nbytes(self._valid)
        return total

    def evict(self):
        """Drop every stack and its ledger entries."""
        self._cols.clear()
        self._nulls.clear()
        self._derived.clear()
        self._valid = None
        self._rebase = None
        if self.ledger is not None:
            self.ledger.remove_table(self.table.name)


def _nbytes(t) -> int:
    """Bytes of a stack: one tensor, or every shard of a Sharded one."""
    if isinstance(t, Sharded):
        return t.nbytes
    return t.numel() * t.element_size()

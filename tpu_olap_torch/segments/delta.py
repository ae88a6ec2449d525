"""Real-time ingest: mutable delta segments, WAL durability, and the
backpressured background compactor (docs/INGEST.md).

The Druid half of the reference system served queries over *realtime
nodes* — freshly-arrived rows answered immediately from mutable
in-memory state while batch segments compacted behind them. This module
is that path for the in-process engine:

- `Engine.append(table, rows)` lands rows in the table's DELTA: frozen
  append blocks swapped in as a fresh `TableSegments` snapshot (sealed
  segment objects, dictionaries, and earlier delta blocks are shared;
  only the partially-filled tail block is rebuilt copy-on-write), so a
  query that grabbed the previous snapshot keeps an immutable,
  generation-consistent view while the next query sees the new rows —
  through the SAME lowering/kernels/caches as batch data, no separate
  read path.
- Every accepted append is first framed into the table's write-ahead
  log (`segments.wal`); acknowledgment follows durability, and a
  crash/SIGKILL replays the log to the exact acknowledged state at the
  next registration.
- A background compactor seals the delta: all rows re-emit through the
  batch `StreamIngestor` (time-sorted, time-partitioned, dictionary
  re-sorted, dtypes re-narrowed) into a fresh sealed set, while
  appends that raced the compaction are carried over as rebased delta
  blocks — the write path never blocks the compactor and vice versa
  beyond a short swap section ("Partial Partial Aggregates",
  PAPERS.md 2603.26698; contention model PAPERS.md 1311.0059).
- A bounded delta (`ingest_max_delta_rows`) drives write backpressure:
  `IngestBackpressure` -> HTTP 429 + Retry-After, never a silent drop.

Generation contract (the robustness headline): append snapshots take a
fresh overall `generation` (tier-2 full-result cache entries and cube
full-serve keys go stale at key level) but carry the predecessor's
`sealed_generation`, so per-sealed-segment tier-1 cache partials and
generation-current cubes SURVIVE delta-only appends — cube serves clip
at the sealed scope and fold the delta remainder through the base path
(planner.cuberewrite), zero stale serves by construction.

The port keeps the JAX package's logic, WAL format, store format, fault
sites and observability as they are: the metrics (`ingest_rows_total`,
`delta_rows`, `wal_bytes`, `compactions_total`, `checkpoints_total`,
`store_bytes`, ...), the `ingest`, `compact`, `checkpoint`,
`wal_replay`, `store_load` and `store_fallback` events, the
`checkpoint` span, `store_rows()` behind sys.checkpoints and
`snapshot()` behind GET /debug/ingest. `TableIngestState` also keeps
the compactor's errors and the last store load's fallbacks.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from tpu_olap_torch.obs.trace import span as _span
from tpu_olap_torch.resilience.errors import (IngestBackpressure, QueryShed,
                                        UserError)
from tpu_olap_torch.resilience.faults import maybe_inject
from tpu_olap_torch.segments.segment import (ColumnType, Segment, SegmentMeta,
                                       TableSegments, TIME_COLUMN,
                                       _scalar)
from tpu_olap_torch.segments.wal import WriteAheadLog, replay_wal, wal_path

__all__ = ["IngestManager", "canonicalize_rows", "encode_rows",
           "extend_snapshot", "compact_table"]


# --------------------------------------------------------------------------
# row canonicalization (the WAL wire format IS the append input format)

def _to_ms(v):
    """Any reasonable time spelling -> epoch millis int (None stays
    None for the caller's null check)."""
    if v is None:
        return None
    if isinstance(v, bool):
        raise UserError(f"cannot use boolean {v!r} as a timestamp")
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        if np.isnan(v):
            return None
        return int(v)
    import pandas as pd
    ts = pd.Timestamp(v)
    if ts is pd.NaT:
        return None
    return int(ts.value // 1_000_000)


def _canon_scalar(v):
    """JSON-native canonical value: what the WAL stores and the encoder
    consumes, so a replayed batch is bit-identical to the live one."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        f = float(v)
        return None if np.isnan(f) else f
    if isinstance(v, np.bool_):
        return bool(v)
    try:
        import pandas as pd
        if pd.isna(v):
            return None
    except (TypeError, ValueError):
        pass
    return str(v)


def canonicalize_rows(rows, time_column: str | None) -> list:
    """list[dict] / DataFrame -> canonical rows: JSON-native scalars
    only, the time value (accepted under the table's registered time
    column name or ``__time``) normalized to epoch-millis under
    ``__time``. This is exactly what the WAL frames, so replay feeds
    the same dicts back through the same encoder. A DataFrame is read
    a column at a time (`_frame_columns`) into the rows the per-row
    path gives for `df.to_dict("records")`."""
    import pandas as pd
    if isinstance(rows, pd.DataFrame):
        return _rows_of(_frame_columns(rows, time_column))
    out = []
    for r in rows:
        if not isinstance(r, dict):
            raise UserError(
                f"append rows must be dicts, got {type(r).__name__}")
        cr = {}
        for k, v in r.items():
            k = str(k)
            if k == TIME_COLUMN or (time_column is not None
                                    and k == time_column):
                cr[TIME_COLUMN] = _to_ms(v)
            else:
                cr[k] = _canon_scalar(v)
        out.append(cr)
    return out


def _frame_columns(df, time_column: str | None) -> dict:
    """The canonical rows of a DataFrame as {key: values}, a column at a
    time: the same values, key order and scalar types as the per-row
    path gives for `df.to_dict("records")` (so the same WAL bytes),
    without a Python call per value on numeric, boolean, datetime and
    string columns."""
    import pandas as pd
    out = {}
    for k in df.columns:
        s = df[k]
        k = str(k)
        is_time = k == TIME_COLUMN or (time_column is not None
                                       and k == time_column)
        dt = s.dtype
        if is_time and pd.api.types.is_datetime64_dtype(dt) \
                and getattr(dt, "tz", None) is None:
            ns = s.to_numpy("datetime64[ns]")
            ms = (ns.view(np.int64) // 1_000_000).tolist()
            nat = np.isnat(ns)
            vals = [None if n else v for v, n in zip(ms, nat)] \
                if nat.any() else ms
        elif isinstance(dt, np.dtype) and (
                dt.kind in ("iu" if is_time else "iufb")):
            # to_dict's Python scalars, which the per-row path keeps
            # as they are (a float NaN included)
            vals = s.to_numpy().tolist()
        elif not is_time and isinstance(dt, pd.StringDtype) \
                and dt.na_value is np.nan:
            # str values and float NaN, both kept as they are
            vals = s.tolist()
        else:
            conv = _to_ms if is_time else _canon_scalar
            vals = [conv(v) for v in s.tolist()]
        out[TIME_COLUMN if is_time else k] = vals
    return out


def _rows_of(columns: dict) -> list:
    """{key: values} -> row dicts in key order."""
    keys = list(columns)
    return [dict(zip(keys, r)) for r in zip(*columns.values())]


# --------------------------------------------------------------------------
# encoding: canonical rows -> column arrays against a live snapshot

class EncodedBatch:
    __slots__ = ("n", "cols", "nulls", "new_dict_values")

    def __init__(self, n, cols, nulls, new_dict_values):
        self.n = n
        self.cols = cols                    # col -> ndarray[n]
        self.nulls = nulls                  # col -> bool[n] (any() true)
        self.new_dict_values = new_dict_values  # col -> [unseen values]


def _numeric_column(table, c, values, mask, dtype, kind):
    """Object values + null mask -> dtype array (nulls zero-filled).
    `astype` on an object array converts element-wise in C — the
    vectorized replacement for the old per-row int()/float() loop
    (ROADMAP 4d: the Python loop capped ingest at ~13k rows/s while WAL
    replay ran 535k rows/s)."""
    filled = values.copy()
    filled[mask] = 0
    try:
        return filled.astype(dtype)
    except (TypeError, ValueError):
        # error path only: find the offending value for the message
        for v in values[~mask]:
            try:
                dtype.type(v)
            except (TypeError, ValueError):
                raise UserError(
                    f"append to {table.name!r}: column {c!r} is "
                    f"{kind}, got {v!r}") from None
        raise


def encode_rows(table: TableSegments, rows: list,
                require_time: bool) -> EncodedBatch:
    """Validate + encode canonical rows against the snapshot's schema
    and dictionaries. Unseen string values take tail codes past the
    current dictionary (the `Dictionary.extended` contract: existing
    codes never move), in first-appearance order — the same codes the
    original per-append sequence assigned, so a batched WAL replay is
    block-identical. Raises UserError before ANY state changes, so a
    bad batch is rejected whole — never half-applied.

    Columns batch-convert through numpy (one object array + one astype
    per column) instead of a per-row Python loop; string codes resolve
    per UNIQUE value, not per row."""
    schema = table.schema
    n = len(rows)
    unknown = set().union(*(r.keys() for r in rows)) - set(schema) \
        if rows else set()
    if unknown:
        raise UserError(
            f"append to {table.name!r}: unknown column(s) "
            f"{sorted(unknown)} (schema: {sorted(schema)})")
    cols: dict = {}
    nulls: dict = {}
    new_vals: dict = {}
    for c, typ in schema.items():
        # one Python pass per column: extract + null-mask fused. The
        # null test is exactly `is None` — NOT pd.isna: a Python float
        # NaN survives canonicalize_rows, and its per-type fate must
        # match the old per-row loop (DOUBLE -> NULL via the isnan
        # fold below, LONG -> UserError like int(nan) always raised,
        # STRING -> the literal "nan")
        values = np.empty(n, dtype=object)
        mask = np.zeros(n, dtype=bool)
        for i, r in enumerate(rows):
            v = r.get(c)
            if v is None:
                mask[i] = True
            else:
                values[i] = v
        if c == TIME_COLUMN:
            if require_time and mask.any():
                raise UserError(
                    f"append to {table.name!r}: a non-null time "
                    "value is required per row (like Druid's __time)")
            cols[c] = _numeric_column(table, c, values, mask,
                                      np.dtype(np.int64), "LONG")
            continue
        if typ is ColumnType.STRING:
            d = table.dictionaries.get(c)
            base = d.cardinality if d is not None else 0
            codes = np.zeros(n, np.int32)
            if not mask.all():
                real = values[~mask].astype(str)
                uniq, first, inv = np.unique(
                    real, return_index=True, return_inverse=True)
                ucodes = np.array(
                    [d.id_of(v) if d is not None else -1 for v in uniq],
                    dtype=np.int64)
                unseen = np.flatnonzero(ucodes <= 0)
                if len(unseen):
                    # tail codes in FIRST-APPEARANCE row order
                    order = unseen[np.argsort(first[unseen],
                                              kind="stable")]
                    news = [str(uniq[j]) for j in order]
                    ucodes[order] = base + 1 + np.arange(len(order))
                    new_vals[c] = news
                codes[~mask] = ucodes[inv].astype(np.int32)
            cols[c] = codes
            continue
        if typ is ColumnType.LONG:
            arr = _numeric_column(table, c, values, mask,
                                  np.dtype(np.int64), "LONG")
        else:
            arr = _numeric_column(table, c, values, mask,
                                  np.dtype(np.float64), "DOUBLE")
            nan = np.isnan(arr)
            if nan.any():
                mask = mask | nan
                arr = np.where(nan, 0.0, arr)
        cols[c] = arr
        if mask.any():
            nulls[c] = mask
    return EncodedBatch(n, cols, nulls, new_vals)


# --------------------------------------------------------------------------
# delta block emission + snapshot extension

def _emit_blocks(schema: dict, block_rows: int, cols: dict, nulls: dict,
                 start_sid: int) -> list:
    """Row arrays -> padded fixed-size Segment blocks with exact metas
    (the same manifest StreamIngestor._emit_block writes, so interval
    and numeric-bound pruning treat delta blocks like sealed ones).
    Rows keep ARRIVAL order — Druid realtime segments are not
    row-sorted either; per-block time_min/max stay exact."""
    n = len(cols[TIME_COLUMN])
    out = []
    for lo in range(0, n, block_rows):
        hi = min(lo + block_rows, n)
        nv = hi - lo
        bcols, bmasks = {}, {}
        for c, v in cols.items():
            block = np.zeros(block_rows, dtype=v.dtype)
            block[:nv] = v[lo:hi]
            bcols[c] = block
        for c, m in nulls.items():
            mm = m[lo:hi]
            if not mm.any():
                continue
            block = np.zeros(block_rows, dtype=bool)
            block[:nv] = mm
            bmasks[c] = block
        t = bcols[TIME_COLUMN][:nv]
        meta = SegmentMeta(
            segment_id=start_sid + len(out), n_valid=nv,
            time_min=int(t.min()) if nv else 0,
            time_max=int(t.max()) if nv else 0)
        for c, typ in schema.items():
            if typ is not ColumnType.STRING and nv:
                cv = bcols[c][:nv]
                nm = bmasks.get(c)
                if nm is not None:
                    if nm[:nv].all():
                        continue
                    cv = cv[~nm[:nv]]
                meta.column_min[c] = _scalar(cv.min())
                meta.column_max[c] = _scalar(cv.max())
        out.append(Segment(meta, bcols, bmasks))
    return out


def extend_snapshot(table: TableSegments,
                    enc: EncodedBatch) -> TableSegments:
    """New snapshot = sealed segments (shared) + delta blocks (shared,
    except a partially-filled tail rebuilt copy-on-write to absorb the
    batch) + extended dictionaries. Takes a fresh overall generation;
    carries the sealed generation (docs/INGEST.md)."""
    sealed = table.segments[:table.sealed_count]
    delta = list(table.segments[table.sealed_count:])
    dicts = dict(table.dictionaries)
    for c, vals in enc.new_dict_values.items():
        dicts[c] = dicts[c].extended(vals)
    cols, nulls = enc.cols, dict(enc.nulls)
    if delta and delta[-1].meta.n_valid < table.block_rows:
        # absorb into the tail block: copy its valid rows in front of
        # the batch (the OLD tail object stays untouched — snapshots
        # that hold it keep serving it)
        tail = delta.pop()
        tv = tail.meta.n_valid
        cols = {c: np.concatenate([np.asarray(tail.columns[c][:tv]), v])
                for c, v in cols.items()}
        merged: dict = {}
        for c in set(tail.null_masks) | set(nulls):
            a = tail.null_masks[c][:tv] if c in tail.null_masks \
                else np.zeros(tv, bool)
            b = nulls.get(c)
            if b is None:
                b = np.zeros(enc.n, bool)
            m = np.concatenate([a, b])
            if m.any():
                merged[c] = m
        nulls = merged
    sid = table.sealed_count + len(delta)
    blocks = _emit_blocks(table.schema, table.block_rows, cols, nulls,
                          sid)
    out = TableSegments(table.name, table.schema, dicts,
                        sealed + delta + blocks, table.block_rows,
                        sealed_count=table.sealed_count,
                        sealed_generation=table.sealed_generation)
    out.time_partition = table.time_partition
    out.star = table.star
    return out


# --------------------------------------------------------------------------
# compaction

def compact_table(table: TableSegments) -> TableSegments:
    """Seal the snapshot: EVERY row (sealed + delta) re-emitted through
    the batch StreamIngestor — globally re-time-sorted into the table's
    calendar partitions, dictionary re-sorted (restoring the code-range
    fast path for lexicographic bounds), dtypes re-narrowed. Returns a
    pure sealed TableSegments (fresh sealed generation); the caller
    rebases any delta blocks that raced in."""
    from tpu_olap_torch.segments.ingest import (DictBuilder, StreamIngestor,
                                          resolve_time_partition)
    t_lo, t_hi = table.time_boundary
    tp = table.time_partition
    if tp is None:
        tp = resolve_time_partition("auto", t_lo or None, t_hi or None,
                                    table.num_rows, table.block_rows)
    ing = StreamIngestor(table.name, None, table.block_rows, tp)
    ing.schema = dict(table.schema)
    for c, d in table.dictionaries.items():
        # seed the builder with the live dictionary: value -> current
        # code, so stored codes ARE valid temp codes and finalize()'s
        # sort+remap handles the unsorted append tail for free
        b = DictBuilder()
        b._map = {str(v): i + 1 for i, v in enumerate(d.values)}
        ing._dicts[c] = b
    for s in table.segments:
        nv = s.meta.n_valid
        if not nv:
            continue
        ing._pending.append(
            {c: np.asarray(v[:nv]) for c, v in s.columns.items()})
        ing._pending_nulls.append(
            {c: np.asarray(m[:nv]) for c, m in s.null_masks.items()})
        ing._pending_rows += nv
    out = ing.finalize()
    out.star = table.star
    return out


def _compact_incremental(table: TableSegments):
    """Incremental compaction (ROADMAP 4b): rewrite ONLY the calendar
    partitions the delta touched; untouched sealed segments are reused
    as shared objects (their spill memos ride along, so the next
    checkpoint reuses their chunk files too). Eligible when the table
    is calendar-partitioned, every sealed segment sits inside one
    partition, and every dictionary is still sorted (an out-of-order
    tail extension needs the full rebuild's re-sort). Returns
    (sealed TableSegments, info) or None when ineligible — the caller
    falls back to the full `compact_table`."""
    from tpu_olap_torch.segments.ingest import (DictBuilder, StreamIngestor,
                                          _partition_ids)
    tp = table.time_partition
    if tp is None or not table.sealed_count:
        return None
    if any(not d.is_sorted for d in table.dictionaries.values()):
        return None
    delta = [s for s in table.segments[table.sealed_count:]
             if s.meta.n_valid]
    if not delta:
        return None
    delta_pids = set()
    for s in delta:
        t = np.asarray(s.columns[TIME_COLUMN][:s.meta.n_valid],
                       np.int64)
        delta_pids.update(int(p) for p in
                          np.unique(_partition_ids(t, tp)))
    untouched, touched = [], []
    for s in table.segments[:table.sealed_count]:
        if not s.meta.n_valid:
            continue  # degenerate empty block: drop it in the rebuild
        lo = int(_partition_ids(np.array([s.meta.time_min],
                                         np.int64), tp)[0])
        hi = int(_partition_ids(np.array([s.meta.time_max],
                                         np.int64), tp)[0])
        if lo != hi:
            return None  # segment straddles partitions: full rebuild
        (touched if lo in delta_pids else untouched).append(s)
    if not untouched:
        return None  # nothing to reuse — the full path costs the same
    ing = StreamIngestor(table.name, None, table.block_rows, tp)
    ing.schema = dict(table.schema)
    for c, d in table.dictionaries.items():
        # seed value -> live code; the dict is sorted, so finalize()'s
        # sort+remap is the identity and stored codes stay valid in
        # BOTH the reused and the rewritten segments
        b = DictBuilder()
        b._map = {str(v): i + 1 for i, v in enumerate(d.values)}
        ing._dicts[c] = b
    for s in touched + delta:
        nv = s.meta.n_valid
        ing._pending.append(
            {c: np.asarray(v[:nv]) for c, v in s.columns.items()})
        ing._pending_nulls.append(
            {c: np.asarray(m[:nv]) for c, m in s.null_masks.items()})
        ing._pending_rows += nv
    rebuilt = ing.finalize()
    merged = []
    for s in untouched:
        # fresh meta with the merged id; column arrays, the spill memo
        # AND the identity uid are shared — the live snapshot's segment
        # objects must never be mutated (queries hold them), while the
        # carried uid keeps tier-1 cache entries and device-resident
        # rows valid for the untouched partition (segment_cache_token /
        # DeviceDataset rebase both key on it)
        ns = Segment(SegmentMeta(
            segment_id=0, n_valid=s.meta.n_valid,
            time_min=s.meta.time_min, time_max=s.meta.time_max,
            column_min=dict(s.meta.column_min),
            column_max=dict(s.meta.column_max)),
            s.columns, s.null_masks, uid=s.uid)
        memo = getattr(s, "_spill_memo", None)
        if memo is not None:
            ns._spill_memo = memo
        merged.append(ns)
    merged.extend(s for s in rebuilt.segments if s.meta.n_valid)
    merged.sort(key=lambda s: (s.meta.time_min, s.meta.segment_id))
    for i, s in enumerate(merged):
        s.meta.segment_id = i
    out = TableSegments(table.name, dict(table.schema),
                        rebuilt.dictionaries, merged, table.block_rows,
                        sealed_count=len(merged))
    out.time_partition = tp
    out.star = table.star
    return out, {"mode": "incremental",
                 "partitions_rewritten": len(delta_pids),
                 "segments_reused": len(untouched),
                 "segments_rewritten": len(merged) - len(untouched)}


def compact_table_auto(table: TableSegments):
    """(sealed TableSegments, info): incremental when the delta's
    partition footprint allows it, else the full O(table) rebuild."""
    inc = _compact_incremental(table)
    if inc is not None:
        return inc
    out = compact_table(table)
    return out, {"mode": "full",
                 "partitions_rewritten": None,
                 "segments_reused": 0,
                 "segments_rewritten": len(out.segments)}


def _remap_codes(live_dict, merged_dict) -> np.ndarray:
    """[live code] -> merged code (0 stays null)."""
    r = np.zeros(live_dict.cardinality + 1, np.int64)
    for i, v in enumerate(live_dict.values):
        r[i + 1] = merged_dict.id_of(v)
    return r


def _gather_delta_rows(table: TableSegments, skip: int):
    """Valid delta rows in append order, minus the first `skip` (the
    rows a compaction snapshot already covered)."""
    delta = table.segments[table.sealed_count:]
    cols = {}
    for c in table.schema:
        cols[c] = np.concatenate(
            [np.asarray(s.columns[c][:s.meta.n_valid]) for s in delta]
        )[skip:] if delta else np.zeros(0, np.int64)
    nulls = {}
    mask_cols = set().union(*(s.null_masks.keys() for s in delta)) \
        if delta else set()
    for c in mask_cols:
        m = np.concatenate(
            [np.asarray(s.null_masks[c][:s.meta.n_valid])
             if c in s.null_masks else np.zeros(s.meta.n_valid, bool)
             for s in delta])[skip:]
        if m.any():
            nulls[c] = m
    return cols, nulls


# --------------------------------------------------------------------------
# the engine-side coordinator

class TableIngestState:
    """Per-table mutable ingest state. `lock` serializes append
    snapshot swaps, WAL writes, and the compactor's swap section —
    never held across the compaction rebuild itself."""

    def __init__(self, name: str):
        self.name = name
        self.lock = threading.RLock()
        self.wal: WriteAheadLog | None = None
        self.frames: list = []   # delta-resident pandas frames (fallback)
        self.frames_version = 0  # bumped on EVERY frames mutation: the
        #                          TableEntry._frame_aug memo key (frame
        #                          count alone could collide after a
        #                          compaction trims the list)
        self.appended_rows = 0
        self.acked_seq = 0
        self.replayed_rows = 0
        self.compactions = 0
        self.last_compact_ms = 0.0
        self.compacting = False
        # durable-checkpoint bookkeeping (segments/store.py): the
        # highest WAL seq whose rows are folded into the SEALED scope
        # (advanced by the compaction swap; a checkpoint records it as
        # the manifest watermark), and the last checkpoint's info
        self.sealed_through_seq = 0
        self.checkpointing = False
        self.checkpoints = 0
        self.last_checkpoint: dict | None = None
        # background compactions that raised (retried next tick) and
        # the recovery-ladder rungs the last store load stepped over
        # (the JAX package counts both in its metrics registry)
        self.compact_errors = 0
        self.last_compact_error: str | None = None
        self.store_fallbacks: list = []
        # EWMA of compactor drain rate (rows sealed per second): the
        # measured basis for backpressure Retry-After instead of the
        # fixed ingest_retry_after_s constant
        self.drain_rps: float | None = None

    def delta_source(self):
        """(version, frames) provider TableEntry.frame concatenates —
        the interpreter/fallback path's view of appended rows. Reads
        under the ingest lock so the pair stays consistent with a
        racing compaction's trim."""
        with self.lock:
            return self.frames_version, list(self.frames)


class IngestManager:
    """All real-time ingest state of one Engine: per-table delta
    states, WAL lifecycles, replay-on-register, the backpressure gate,
    and the background compactor thread (docs/INGEST.md)."""

    def __init__(self, engine):
        self.engine = engine
        self.config = engine.config
        self._lock = threading.Lock()
        self._states: dict[str, TableIngestState] = {}
        # the compactor is a scheduler-managed background stage graph
        # (executor.stages.register_periodic), not a bespoke daemon
        # thread — this is its PeriodicHandle
        self._compact_handle = None
        self._stopped = False
        m = engine.metrics
        self._m_rows = m.counter(
            "ingest_rows_total",
            "Rows appended through the real-time ingest path "
            "(Engine.append / POST /ingest / INSERT INTO).", ("table",))
        self._m_backpressure = m.counter(
            "ingest_backpressure_total",
            "Appends rejected with 429 because the delta hit "
            "ingest_max_delta_rows.", ("table",))
        self._m_delta = m.gauge(
            "delta_rows",
            "Rows currently resident in the mutable delta scope.",
            ("table",))
        self._m_wal = m.gauge(
            "wal_bytes", "Bytes in the table's write-ahead log.",
            ("table",))
        self._m_compact = m.counter(
            "compactions_total",
            "Delta-to-sealed compactions completed.", ("table",))
        self._m_compact_err = m.counter(
            "compact_errors_total",
            "Background compactions that raised (retried next tick).",
            ("table",))
        self._m_checkpoint = m.counter(
            "checkpoints_total",
            "Durable sealed-segment checkpoints committed "
            "(segments/store.py; docs/DURABILITY.md).", ("table",))
        self._m_checkpoint_err = m.counter(
            "checkpoint_errors_total",
            "Checkpoints that failed before the manifest swap (the "
            "previous checkpoint stays authoritative).", ("table",))
        self._m_store_bytes = m.gauge(
            "store_bytes",
            "Bytes of spilled sealed-segment chunks referenced by the "
            "table's newest checkpoint manifest.", ("table",))
        self._m_store_fallback = m.counter(
            "store_load_fallbacks_total",
            "Recovery-ladder rungs stepped over (corrupt/missing "
            "chunk or torn manifest) while loading a checkpoint.",
            ("table",))
        # durable sealed-segment store (docs/DURABILITY.md): None when
        # ingest_store_dir is unset — recovery then replays the whole
        # WAL, the pre-checkpoint behavior
        from tpu_olap_torch.segments.store import SegmentStore
        self.store = SegmentStore(
            self.config.ingest_store_dir,
            self.config.ingest_store_keep_manifests,
            config=self.config) \
            if self.config.ingest_store_dir else None

    # ----------------------------------------------------------- helpers

    def _state(self, name: str) -> TableIngestState:
        with self._lock:
            st = self._states.get(name)
            if st is None:
                st = self._states[name] = TableIngestState(name)
            return st

    def _wal_for(self, st: TableIngestState) -> WriteAheadLog | None:
        cfg = self.config
        if not cfg.ingest_wal_dir:
            return None
        if st.wal is not None and st.wal.tainted:
            # taint is sticky across close(): never silently reopen a
            # log whose tail may hold an unacknowledged frame
            raise RuntimeError(
                f"WAL {st.wal.path} failed a write that could not be "
                "rolled back; re-register the table to reset it")
        if st.wal is None or st.wal._closed:
            st.wal = WriteAheadLog(
                wal_path(cfg.ingest_wal_dir, st.name),
                fsync=cfg.ingest_wal_fsync,
                flush_interval_s=cfg.ingest_wal_flush_interval_s,
                start_seq=st.acked_seq,
                # interval fsync rides the stage scheduler's background
                # pool as a `wal-flush:<table>` periodic graph instead
                # of one daemon thread per log
                flush_scheduler=self.engine.runner.stages
                .register_periodic)
        return st.wal

    # EWMA weight for the measured compactor drain rate; clamp bounds
    # for the derived Retry-After (a cold estimate must neither hammer
    # the server nor park a client for minutes)
    _DRAIN_EWMA_ALPHA = 0.3
    _RETRY_AFTER_BOUNDS = (0.05, 60.0)

    def _retry_after(self, st: TableIngestState, need_rows: int) -> float:
        """Backpressure Retry-After from the MEASURED compactor drain
        rate (EWMA of rows sealed per second) — `need_rows` is how many
        delta rows must drain before the shed batch fits. Falls back to
        the fixed `ingest_retry_after_s` until a compaction has been
        observed."""
        rps = st.drain_rps
        if not rps or rps <= 0:
            return float(self.config.ingest_retry_after_s)
        lo, hi = self._RETRY_AFTER_BOUNDS
        return float(min(hi, max(lo, need_rows / rps)))

    def _observe_drain(self, st: TableIngestState, rows: int,
                       ms: float) -> None:
        if rows <= 0 or ms <= 0:
            return
        rps = rows / (ms / 1000.0)
        a = self._DRAIN_EWMA_ALPHA
        st.drain_rps = rps if st.drain_rps is None \
            else a * rps + (1 - a) * st.drain_rps

    @staticmethod
    def _delta_frame(entry, canon_rows):
        """Canonical rows -> a fallback-path frame matching the base
        frame's visible schema (time re-materialized as datetime under
        the registered time column name)."""
        import pandas as pd
        df = pd.DataFrame(canon_rows)
        if TIME_COLUMN in df.columns:
            ts = pd.to_datetime(df[TIME_COLUMN], unit="ms")
            df = df.drop(columns=[TIME_COLUMN])
            df[entry.time_column or TIME_COLUMN] = ts
        return df

    # ------------------------------------------------------------ append

    def append(self, name: str, rows) -> dict:
        """The Engine.append implementation: validate -> backpressure
        gate -> WAL frame (durability precedes acknowledgment) ->
        snapshot swap -> cache invalidation scoped to what actually
        changed (tier-2 only; sealed tier-1 partials and cubes
        survive)."""
        eng = self.engine
        cfg = self.config
        entry = eng.catalog.get(name)
        if not entry.is_accelerated:
            raise UserError(
                f"table {name!r} is not accelerated; append needs a "
                "segment-backed datasource")
        if name.startswith("__cube_"):
            raise UserError(
                "cube storage tables are rebuilt from their base "
                "table; append to the base instead")
        canon = canonicalize_rows(rows, entry.time_column)
        if not canon:
            table = entry.segments
            return {"table": name, "rows": 0,
                    "generation": table.generation,
                    "sealed_generation": table.sealed_generation,
                    "delta_rows": table.delta_rows,
                    "watermark": table.watermark, "wal_seq": None}
        maybe_inject(cfg, "append", 0)
        st = self._state(name)
        with st.lock:
            table = entry.segments
            cap = int(cfg.ingest_max_delta_rows or 0)
            if cap and table.delta_rows + len(canon) > cap:
                self._m_backpressure.inc(table=name)
                self._ensure_compactor(wake=True)
                need = table.delta_rows + len(canon) - cap
                raise IngestBackpressure(
                    f"delta for {name!r} holds {table.delta_rows} rows;"
                    f" +{len(canon)} would exceed ingest_max_delta_rows"
                    f"={cap} — retry after compaction",
                    retry_after_s=self._retry_after(st, need))
            # validation/encoding BEFORE the WAL write: a rejected
            # batch must never reach the durable log. The fallback
            # frame too — pd.to_datetime bounds are narrower than the
            # raw epoch-ms range the encoder accepts, and a failure
            # after the WAL ack would leave the batch durable+device-
            # visible but absent from the interpreter's view
            enc = encode_rows(table, canon,
                              require_time=entry.time_column is not None)
            delta_frame = self._delta_frame(entry, canon)
            seq = wal_bytes = None
            wal = self._wal_for(st)
            if wal is not None:
                maybe_inject(cfg, "wal-write", 0)
                seq, wal_bytes = wal.append(canon)
                st.acked_seq = seq
            new_table = extend_snapshot(table, enc)
            entry.segments = new_table
            st.frames.append(delta_frame)
            st.frames_version += 1
            st.appended_rows += len(canon)
            entry.delta_source = st.delta_source
            entry._frame_aug = None
        runner = eng.runner
        # scoped invalidation (the result cache's contract, split per
        # scope):
        # whole-result state is stale (keys carry the moved overall
        # generation; purge eagerly), sealed-segment partials are NOT
        # (their scope generation did not move) — docs/INGEST.md
        runner.result_cache.invalidate_full(name)
        self._m_rows.inc(len(canon), table=name)
        self._m_delta.set(new_table.delta_rows, table=name)
        if wal_bytes is not None:
            self._m_wal.set(wal_bytes, table=name)
        runner.events.emit(
            "ingest", table=name, kind="append", rows=len(canon),
            generation=new_table.generation,
            sealed_generation=new_table.sealed_generation,
            delta_rows=new_table.delta_rows, wal_seq=seq)
        if cfg.ingest_auto_compact and \
                new_table.delta_rows >= int(cfg.ingest_compact_rows):
            self._ensure_compactor(wake=True)
        return {"table": name, "rows": len(canon),
                "generation": new_table.generation,
                "sealed_generation": new_table.sealed_generation,
                "delta_rows": new_table.delta_rows,
                "watermark": new_table.watermark, "wal_seq": seq}

    # ------------------------------------------------- register / replay

    def on_register(self, entry):
        """register_table hook. A table already live in THIS engine is
        being REPLACED: its logged appends belonged to the old data —
        reset the log AND drop its checkpoint store. A first
        registration with an existing log/store is crash RECOVERY: load
        the newest verifiable checkpoint (segments/store.py), then
        replay only the WAL tail past its watermark
        (cfg.ingest_wal_replay gates both)."""
        cfg = self.config
        name = entry.name
        with self._lock:
            st_prev = self._states.pop(name, None)
        if st_prev is not None:
            self._m_delta.set(0, table=name)
            if self.store is not None:
                # the spilled checkpoints covered the replaced data
                self.store.delete_table(name)
                self._m_store_bytes.set(0, table=name)
            wal = st_prev.wal
            if wal is not None and not wal._closed and not wal.tainted:
                wal.reset()
                wal.close()
                self._m_wal.set(0, table=name)
            elif cfg.ingest_wal_dir:
                # no live handle to reset through (never appended, or
                # closed by Engine.close, or tainted by a failed
                # write): drop the file itself — the next append
                # recreates it from seq 0
                if wal is not None:
                    wal.close(final_sync=False)
                try:
                    os.unlink(wal_path(cfg.ingest_wal_dir, name))
                except OSError:
                    pass
                self._m_wal.set(0, table=name)
            return
        if not entry.is_accelerated or name.startswith("__cube_") \
                or not cfg.ingest_wal_dir or not cfg.ingest_wal_replay:
            return
        watermark = self._restore_from_store(entry) \
            if self.store is not None else 0
        records = replay_wal(wal_path(cfg.ingest_wal_dir, name))
        if records and records[0][0] > watermark + 1:
            # coverage gap: the surviving log starts PAST what the
            # loaded checkpoint covers — frames below it were
            # truncated on the strength of a checkpoint that now
            # fails verification (or no longer matches the schema).
            # Proceeding would silently serve a table missing
            # acknowledged rows; refuse instead (never a wrong
            # answer). Operator remedies: restore the store files,
            # or delete the table's WAL + store to accept base-only.
            # The entry is DEREGISTERED too: the catalog add ran
            # before this hook, and a caller catching the error must
            # not be left with a live base-only table (nor may a
            # later append restart seq 1 under a log whose surviving
            # frames sit far past it).
            with self._lock:
                self._states.pop(name, None)
            self.engine.catalog.drop(name)
            raise RuntimeError(
                f"recovery for table {name!r} refused: WAL frames "
                f"{watermark + 1}..{records[0][0] - 1} were truncated "
                "by a checkpoint, but no checkpoint covering them "
                "verifies (see store_fallback events) — acknowledged "
                "rows would be silently lost (docs/DURABILITY.md)")
        if watermark:
            # frames at or below the checkpoint watermark are already
            # folded into the restored sealed scope
            records = [(s, r) for s, r in records if s > watermark]
        if records:
            self._replay(entry, records)

    def _restore_from_store(self, entry) -> int:
        """Recovery rung 1: replace the freshly-ingested base with the
        newest verifiable checkpoint's sealed scope (which includes
        every compacted append) and return its WAL watermark. 0 when no
        checkpoint verifies or the schema no longer matches — the
        caller then replays whatever WAL remains over the base, the
        pre-store behavior. The fallback-path frame becomes a lazy
        reconstruction from the stored segments: the registration data
        no longer covers the compacted appends."""
        eng = self.engine
        name = entry.name
        # "store-load" fault site: a raised fault here is a crash in
        # the middle of recovery — registration fails whole (the engine
        # never half-recovers) and a retry loads the store again
        maybe_inject(self.config, "store-load", 0)
        loaded = self.store.load(name)
        if loaded is None:
            return 0
        self._state(name).store_fallbacks = list(loaded.fallbacks)
        for mfile, reason in loaded.fallbacks:
            self._m_store_fallback.inc(table=name)
            eng.runner.events.emit(
                "store_fallback", table=name, manifest=mfile,
                reason=reason[:300])
        if loaded.segments is None:
            return 0
        if loaded.segments.schema != entry.segments.schema:
            eng.runner.events.emit(
                "store_fallback", table=name,
                manifest="(schema)",
                reason="checkpoint schema does not match the "
                       "registered base; ignoring the store")
            return 0
        sealed = loaded.segments
        sealed.star = entry.star
        entry.segments = sealed
        from tpu_olap_torch.segments.store import segments_to_frame
        entry.frame_source = (
            lambda _ts=sealed, _tc=entry.time_column:
            segments_to_frame(_ts, _tc))
        entry._frame = None
        entry._frame_aug = None
        # parquet provenance is stale too: the chunked/parallel
        # fallback would stream base-only rows and miss the compacted
        # appends the sealed scope now carries
        entry.parquet_paths = ()
        entry.parquet_read_cols = None
        entry.parquet_column_map = None
        entry.parquet_rows = None
        st = self._state(name)
        st.acked_seq = loaded.wal_seq
        st.sealed_through_seq = loaded.wal_seq
        stats = self.store.table_stats(name) or {}
        st.last_checkpoint = {"status": "loaded", **stats}
        self._m_store_bytes.set(int(stats.get("bytes", 0)), table=name)
        eng.runner.events.emit(
            "store_load", table=name,
            checkpoint_id=loaded.manifest["checkpoint_id"],
            wal_seq=loaded.wal_seq, segments=len(sealed.segments),
            rows=sealed.num_rows,
            fallbacks=len(loaded.fallbacks))
        return loaded.wal_seq

    def _replay(self, entry, records):
        """Apply replayed WAL records as ONE batched extension (the
        per-append tail-rebuild fill is deterministic, so the batched
        result is block-identical to the original append sequence).
        Failure mid-replay restores the clean base snapshot — the
        table is registered base-only, never half-recovered; a retry
        (re-registration) replays again."""
        eng = self.engine
        cfg = self.config
        name = entry.name
        st = self._state(name)
        base_snapshot = entry.segments
        t0 = time.perf_counter()
        try:
            with st.lock:
                all_rows: list = []
                for seq, rows in records:
                    maybe_inject(cfg, "wal-replay", 0)
                    all_rows.extend(rows)
                enc = encode_rows(
                    entry.segments, all_rows,
                    require_time=entry.time_column is not None)
                entry.segments = extend_snapshot(entry.segments, enc)
                if all_rows:
                    st.frames.append(self._delta_frame(entry, all_rows))
                    st.frames_version += 1
                st.appended_rows += len(all_rows)
                st.replayed_rows = len(all_rows)
                st.acked_seq = records[-1][0]
                entry.delta_source = st.delta_source
        except Exception:
            with st.lock:
                entry.segments = base_snapshot
                entry.delta_source = None
            with self._lock:
                self._states.pop(name, None)
            raise
        ms = (time.perf_counter() - t0) * 1000
        self._m_rows.inc(len(all_rows), table=name)
        self._m_delta.set(entry.segments.delta_rows, table=name)
        eng.runner.events.emit(
            "wal_replay", table=name, records=len(records),
            rows=len(all_rows), ms=round(ms, 3),
            generation=entry.segments.generation)
        if cfg.ingest_auto_compact and entry.segments.delta_rows \
                >= int(cfg.ingest_compact_rows):
            self._ensure_compactor(wake=True)

    def on_drop(self, name: str):
        with self._lock:
            st = self._states.pop(name, None)
        if self.store is not None:
            self.store.delete_table(name)
            self._m_store_bytes.set(0, table=name)
        if st is not None:
            self._m_delta.set(0, table=name)
            if st.wal is not None:
                st.wal.delete()
                self._m_wal.set(0, table=name)

    # ---------------------------------------------------------- compactor

    def _ensure_compactor(self, wake: bool = False):
        """Register the `compact` background graph on the stage
        scheduler (lazily; re-registers after Engine.close cancelled
        it). `wake=True` also requests an immediate pass — ingest
        backpressure needs the compactor NOW, not at the next tick."""
        if self._stopped or not self.config.ingest_auto_compact:
            return
        with self._lock:
            h = self._compact_handle
            if h is None or h.cancelled:
                h = self._compact_handle = \
                    self.engine.runner.stages.register_periodic(
                        "compact",
                        lambda: self.config.ingest_compact_interval_s,
                        self._compact_pass)
        if wake:
            h.wake()

    def _compact_pass(self):
        """One background-graph tick: seal every delta past the row
        threshold. Runs on the scheduler's background stage pool every
        ingest_compact_interval_s (or on an append wake); compact_now
        takes an admission slot and honors the breaker, so background
        sealing queues/sheds WITH foreground traffic."""
        cfg = self.config
        with self._lock:
            names = list(self._states)
        for name in names:
            if self._stopped:
                return
            try:
                entry = self.engine.catalog.maybe(name)
                if entry is None or not entry.is_accelerated:
                    continue
                if entry.segments.delta_rows \
                        >= int(cfg.ingest_compact_rows):
                    self.compact_now(name)
            except QueryShed:
                pass     # admission saturated: retry next tick
            except Exception as e:  # noqa: BLE001 — retried, but
                # never silently: a persistently failing compaction
                # means the delta grows until every append sheds,
                # and the operator needs a visible cause
                self._m_compact_err.inc(table=name)
                with self._lock:
                    st = self._states.get(name)
                if st is not None:
                    st.compact_errors += 1
                    st.last_compact_error = f"{type(e).__name__}: {e}"
                try:
                    self.engine.runner.events.emit(
                        "compact_error", table=name,
                        error=f"{type(e).__name__}: {e}")
                except Exception:  # noqa: BLE001
                    pass

    def compact_now(self, name: str) -> dict | None:
        """Seal the table's delta (sync spelling; the compactor loop
        calls this too). The rebuild runs OUTSIDE the ingest lock from
        an immutable snapshot; appends that race in are carried over
        as rebased delta blocks in the short swap section. Runs under
        an admission slot and skips while the breaker is open, so
        background sealing queues/sheds with foreground traffic
        instead of around it."""
        eng = self.engine
        runner = eng.runner
        entry = eng.catalog.maybe(name)
        if entry is None or not entry.is_accelerated:
            return None
        st = self._state(name)
        with st.lock:
            if st.compacting:
                return {"table": name, "status": "busy"}
            snapshot = entry.segments
            if snapshot.delta_rows == 0:
                return None
            # the WAL watermark this seal will cover: appends hold the
            # same lock across WAL write + snapshot swap, so every
            # frame <= acked_seq is in `snapshot` and every later one
            # will be carried over as rebased delta in the swap section
            seq_snap = st.acked_seq
            st.compacting = True
        t0 = time.perf_counter()
        try:
            if runner.breaker.state == "open":
                # device sick: don't churn its caches now
                return {"table": name, "status": "breaker-open"}
            with runner.admission.slot(None):
                maybe_inject(self.config, "compact", 0)
                compacted, cinfo = compact_table_auto(snapshot)
            d_snap = snapshot.delta_rows
            with st.lock:
                live = entry.segments
                d_live = live.delta_rows
                dicts = dict(compacted.dictionaries)
                blocks: list = []
                if d_live > d_snap:
                    # appends raced the rebuild: carry the uncovered
                    # tail rows over, remapping string codes into the
                    # compacted (re-sorted, possibly extended) dicts
                    for c, ld in live.dictionaries.items():
                        missing = [v for v in ld.values
                                   if dicts[c].id_of(v) <= 0]
                        if missing:
                            dicts[c] = dicts[c].extended(missing)
                    cols, nulls = _gather_delta_rows(live, d_snap)
                    for c, typ in live.schema.items():
                        if typ is ColumnType.STRING:
                            r = _remap_codes(live.dictionaries[c],
                                             dicts[c])
                            cols[c] = r[np.asarray(cols[c], np.int64)] \
                                .astype(np.int32)
                    blocks = _emit_blocks(
                        live.schema, live.block_rows, cols, nulls,
                        len(compacted.segments))
                merged = TableSegments(
                    name, live.schema, dicts,
                    compacted.segments + blocks, live.block_rows,
                    sealed_count=len(compacted.segments))
                merged.time_partition = compacted.time_partition
                merged.star = snapshot.star
                entry.segments = merged
                st.compactions += 1
                st.sealed_through_seq = seq_snap
                st.last_compact_ms = (time.perf_counter() - t0) * 1000
                entry._frame_aug = None
                # consolidate the fallback frames this compaction
                # sealed into ONE frame (the carried tail stays
                # per-append): appended rows remain host-resident in
                # frame form — the fallback path needs them, exactly
                # as _frame duplicates base rows — but per-append
                # fragmentation no longer accumulates, so a long
                # append history costs one frame, not thousands
                carried = int(d_live - d_snap)
                keep, acc = [], 0
                for f in reversed(st.frames):
                    if acc >= carried:
                        break
                    keep.append(f)
                    acc += len(f)
                keep.reverse()
                folded = st.frames[:len(st.frames) - len(keep)]
                if len(folded) > 1:
                    import pandas as pd
                    folded = [pd.concat(folded, ignore_index=True)]
                st.frames = folded + keep
                st.frames_version += 1
            # the sealed set changed: tier 2 is stale at key level
            # (purged eagerly), but tier-1 entries of UNTOUCHED
            # partitions stay live — incremental compaction carries
            # their Segment uids, so only delta-touched partitions'
            # entries drop (executor.resultcache.invalidate_compacted);
            # cubes over the table are stale, the maintainer rebuilds
            live = {merged.segment_cache_token(i)
                    for i in range(len(merged.segments))}
            runner.result_cache.invalidate_compacted(name, live)
            self._m_compact.inc(table=name)
            self._m_delta.set(merged.delta_rows, table=name)
            self._observe_drain(st, d_snap, st.last_compact_ms)
            runner.events.emit(
                "compact", table=name,
                rows_sealed=compacted.num_rows,
                delta_rows_folded=d_snap,
                delta_rows_carried=int(d_live - d_snap),
                segments=len(compacted.segments),
                mode=cinfo["mode"],
                segments_reused=cinfo["segments_reused"],
                ms=round(st.last_compact_ms, 3),
                generation=merged.generation,
                sealed_generation=merged.sealed_generation)
            eng.cubes.on_table_registered(name)
            # durability hook (docs/DURABILITY.md): the sealed set just
            # changed — spill it, advance the manifest, truncate the
            # WAL. A checkpoint failure never fails the compaction (the
            # previous checkpoint stays authoritative; recovery replays
            # a longer tail).
            checkpoint = None
            if self.store is not None and \
                    self.config.ingest_store_checkpoint_on_compact:
                try:
                    checkpoint = self._checkpoint_sealed(name, entry, st)
                except Exception as e:  # noqa: BLE001 — surfaced, never
                    # silently: durability lag is operator-visible
                    self._m_checkpoint_err.inc(table=name)
                    runner.events.emit(
                        "checkpoint_error", table=name,
                        error=f"{type(e).__name__}: {e}")
                    checkpoint = {"status": "error",
                                  "error": f"{type(e).__name__}: {e}"}
            return {"table": name, "status": "compacted",
                    "rows_sealed": compacted.num_rows,
                    "delta_rows_folded": d_snap,
                    "delta_rows_carried": int(d_live - d_snap),
                    "mode": cinfo["mode"],
                    "segments_reused": cinfo["segments_reused"],
                    "ms": st.last_compact_ms,
                    "generation": merged.generation,
                    "sealed_generation": merged.sealed_generation,
                    **({"checkpoint": checkpoint} if checkpoint else {})}
        finally:
            with st.lock:
                st.compacting = False

    def compact_all(self) -> dict:
        """Compact every table with a non-empty delta (tests, shutdown
        hygiene). Returns {table: result}."""
        out = {}
        with self._lock:
            names = list(self._states)
        for name in names:
            r = self.compact_now(name)
            if r is not None and r.get("status") == "compacted":
                out[name] = r
        return out

    # ---------------------------------------------------------- checkpoint

    def checkpoint_now(self, name: str) -> dict:
        """Durably checkpoint one table (the `CHECKPOINT DRUID TABLE`
        spelling; docs/DURABILITY.md): seal the delta first (so the
        appends enter the sealed scope), then spill + manifest advance
        + WAL truncation. A compaction skip (busy/breaker-open) still
        checkpoints the CURRENT sealed scope — the delta stays covered
        by the WAL tail either way."""
        entry = self.engine.catalog.maybe(name)
        if entry is None or not entry.is_accelerated:
            raise UserError(
                f"table {name!r} is not an accelerated datasource")
        if self.store is None:
            return {"table": name, "status": "no-store",
                    "detail": "set EngineConfig.ingest_store_dir"}
        st = self._state(name)
        if entry.segments.delta_rows:
            res = self.compact_now(name)
            ck = (res or {}).get("checkpoint")
            if ck is not None and ck.get("status") in (
                    "checkpointed", "noop"):
                return {"table": name, **ck}
        return {"table": name, **self._checkpoint_sealed(name, entry,
                                                         st)}

    def checkpoint_all(self) -> dict:
        out = {}
        with self._lock:
            names = list(self._states)
        for name in names:
            entry = self.engine.catalog.maybe(name)
            if entry is None or not entry.is_accelerated:
                continue
            out[name] = self.checkpoint_now(name)
        return out

    def _checkpoint_sealed(self, name: str, entry, st) -> dict:
        """Checkpoint rides the stage graph too: chained after a
        compaction it re-enters the background stage section for free
        (same thread); invoked sync (the CHECKPOINT verb) it takes one
        slot — either way the spill shows up as a `checkpoint` span
        under background-stage occupancy accounting."""
        with self.engine.runner.stages.stage("background"), \
                _span("checkpoint"):
            return self._checkpoint_commit(name, entry, st)

    def _checkpoint_commit(self, name: str, entry, st) -> dict:
        """Spill the sealed scope + advance the manifest + truncate the
        WAL through the lag-one watermark. Serialized per table; a
        second caller while one runs reports "busy" (the compactor's
        auto-hook and an operator verb must not interleave spills).

        The whole commit runs under the store's per-table lock and
        re-checks that `st` is still the table's live ingest state
        before keeping anything: a re-registration/drop that raced in
        mid-spill has already deleted (or will, blocked on this lock,
        delete) the store — a checkpoint of the REPLACED data must not
        survive it, and above all must not truncate the NEW table's
        WAL with the old watermark (recovery would then silently drop
        every newly acknowledged row)."""
        with st.lock:
            if st.checkpointing:
                return {"status": "busy"}
            st.checkpointing = True
            sealed = entry.segments.sealed_view()
            wal_seq = st.sealed_through_seq
        t0 = time.perf_counter()
        try:
            with self.store.table_lock(name):
                info = self.store.checkpoint(name, sealed, wal_seq)
                with self._lock:
                    stale = self._states.get(name) is not st
                if stale:
                    self.store.delete_table(name)
                    return {"status": "stale"}
                truncated = 0
                if info["status"] in ("checkpointed", "noop"):
                    # truncate on noop too: a crash in the
                    # wal-truncate window would otherwise leave the
                    # covered prefix on disk forever (every later
                    # checkpoint of the unchanged sealed set is a
                    # noop)
                    truncated = self._truncate_wal(
                        st, name,
                        int(info.get("truncate_through") or 0))
                if info["status"] == "checkpointed":
                    st.checkpoints += 1
                    self._m_checkpoint.inc(table=name)
            self._m_store_bytes.set(int(info.get("bytes", 0)),
                                    table=name)
            ms = (time.perf_counter() - t0) * 1000
            info = {**info, "wal_seq": wal_seq,
                    "wal_frames_truncated": truncated,
                    "ms": round(ms, 3)}
            with st.lock:
                st.last_checkpoint = info
            if info["status"] == "checkpointed":
                self.engine.runner.events.emit(
                    "checkpoint", table=name,
                    checkpoint_id=info["checkpoint_id"],
                    segments=info["segments"],
                    files_written=info["files_written"],
                    chunks_reused=info["chunks_reused"],
                    bytes=info["bytes"], wal_seq=wal_seq,
                    truncate_through=info["truncate_through"],
                    wal_frames_truncated=truncated,
                    ms=info["ms"])
            return info
        finally:
            with st.lock:
                st.checkpointing = False

    def _truncate_wal(self, st, name: str, through_seq: int) -> int:
        """Drop WAL frames a (lag-one) durable checkpoint covers. The
        "wal-truncate" fault site sits between the manifest swap and
        the rewrite: a crash here leaves pre-checkpoint frames in the
        log, and recovery filters them by the manifest watermark.
        Runs under st.lock: appends hold it across their lazy WAL open
        + frame write, so the no-handle rewrite below can never rename
        the log out from under a handle a racing append just opened
        (an acked frame written to an unlinked inode would be LOST)."""
        if through_seq <= 0:
            return 0
        maybe_inject(self.config, "wal-truncate", 0)
        from tpu_olap_torch.segments.wal import truncate_file_through
        with st.lock:
            wal = st.wal
            if wal is not None and not wal._closed and not wal.tainted:
                dropped = wal.truncate_through(through_seq)
                self._m_wal.set(wal.bytes_written, table=name)
                return dropped
            if self.config.ingest_wal_dir:
                return truncate_file_through(
                    wal_path(self.config.ingest_wal_dir, name),
                    through_seq)
            return 0

    # ------------------------------------------------------------- admin

    def snapshot(self) -> dict:
        """GET /debug/ingest payload: per-table delta sizes, WAL lag and
        compactor state."""
        cfg = self.config
        eng = self.engine
        tables = {}
        with self._lock:
            states = dict(self._states)
        for name, st in sorted(states.items()):
            entry = eng.catalog.maybe(name)
            if entry is None or not entry.is_accelerated:
                continue
            ts = entry.segments
            wal = None
            if st.wal is not None:
                wal = {"path": st.wal.path,
                       "bytes": st.wal.bytes_written,
                       "last_seq": st.wal.last_seq,
                       "synced_seq": st.wal.synced_seq,
                       "lag_records": st.wal.last_seq
                       - st.wal.synced_seq}
            store = None
            if self.store is not None:
                store = {"checkpoints": st.checkpoints,
                         "sealed_through_seq": st.sealed_through_seq,
                         "last": st.last_checkpoint,
                         **(self.store.table_stats(name) or {})}
            tables[name] = {
                "delta_rows": ts.delta_rows,
                "delta_segments": len(ts.segments) - ts.sealed_count,
                "sealed_segments": ts.sealed_count,
                "watermark": ts.watermark,
                "generation": ts.generation,
                "sealed_generation": ts.sealed_generation,
                "appended_rows": st.appended_rows,
                "replayed_rows": st.replayed_rows,
                "acked_seq": st.acked_seq,
                "compacting": st.compacting,
                "compactions": st.compactions,
                "last_compact_ms": round(st.last_compact_ms, 3),
                # backpressure pacing (docs/INGEST.md): the measured
                # compactor drain rate a 429's Retry-After derives from
                "drain_rows_per_s": round(st.drain_rps, 1)
                if st.drain_rps else None,
                "wal": wal,
                "store": store,
            }
        h = self._compact_handle
        return {
            "tables": tables,
            "compactor": {
                "running": h is not None and not h.cancelled,
                "graph": h.snapshot() if h is not None else None,
                "auto": bool(cfg.ingest_auto_compact),
                "compact_rows": int(cfg.ingest_compact_rows),
                "interval_s": float(cfg.ingest_compact_interval_s),
                "max_delta_rows": int(cfg.ingest_max_delta_rows or 0),
            },
            "wal": {"dir": cfg.ingest_wal_dir,
                    "fsync": cfg.ingest_wal_fsync,
                    "replay_on_register": bool(cfg.ingest_wal_replay)},
            "store": {"dir": cfg.ingest_store_dir,
                      "keep_manifests":
                          int(cfg.ingest_store_keep_manifests),
                      "checkpoint_on_compact":
                          bool(cfg.ingest_store_checkpoint_on_compact)},
        }

    def store_rows(self) -> list:
        """sys.checkpoints rows (catalog.systables): one per table with
        durable-checkpoint state — manifest id, WAL watermark, spilled
        bytes/files, and how much of the log the checkpoint let the
        engine truncate away."""
        rows = []
        with self._lock:
            states = dict(self._states)
        for name, st in sorted(states.items()):
            entry = self.engine.catalog.maybe(name)
            if entry is None or not entry.is_accelerated:
                continue
            stats = (self.store.table_stats(name) or {}) \
                if self.store is not None else {}
            last = st.last_checkpoint or {}
            rows.append({
                "table": name,
                "checkpoint_id": stats.get("checkpoint_id"),
                "wal_watermark": stats.get("wal_seq"),
                "sealed_through_seq": st.sealed_through_seq,
                "acked_seq": st.acked_seq,
                "checkpoints": st.checkpoints,
                "segments": stats.get("segments"),
                "bytes": stats.get("bytes"),
                "chunks_reused": last.get("chunks_reused"),
                "manifests_retained": stats.get("manifests_retained"),
                "last_status": last.get("status"),
            })
        return rows

    def stop(self):
        """Deterministically cancel the compactor graph (joining an
        in-progress pass) and close every WAL (Engine.close). Appends
        afterwards reopen WALs lazily; the compactor graph re-registers
        on the next append that wants it."""
        self._stopped = True
        h = self._compact_handle
        joined = True
        if h is not None:
            h.cancel(join_timeout=10.0)
            joined = not h.running
            if joined:
                self._compact_handle = None
        with self._lock:
            states = list(self._states.values())
        for st in states:
            if st.wal is not None:
                st.wal.close()
        if joined:
            # re-arm: a later append may re-register the graph cleanly.
            # A join timeout (compaction wedged mid-rebuild) keeps the
            # stop flag set so the straggler exits at its next check
            # instead of being revived as a zombie.
            self._stopped = False

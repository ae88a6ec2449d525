"""Parquet/Arrow/pandas -> TableSegments.

The analog of the reference's L0→L1 data path: the raw fact table Druid
would have indexed is ingested into device-ready columnar blocks
(BASELINE.json:5 "streams Parquet→HBM"). Two entry shapes:

- In-memory (`ingest_arrow` / `ingest_pandas`): whole table at once,
  globally time-sorted (best interval pruning).
- Streaming (`ingest_parquet` / `ingest_parquet_stream`): row-group
  batches from one or many parquet files under bounded host memory —
  the SF10/SF100-shaped path (SURVEY.md §8.4 #4). Only one batch of
  decoded Arrow data is transient at a time; strings are dictionary-
  encoded to int32 temp codes immediately (the raw strings are dropped
  per batch) and remapped to the final *sorted* dictionary in a finalize
  pass, so lexicographic bound filters stay pure code-range compares.

Numeric storage narrows to the smallest int dtype the observed value
range allows (int8/int16/int32/int64; dictionary codes narrow by
cardinality) — at SF100 this is the difference between fitting in host
RAM + device memory or not. Kernels widen to accumulator dtypes on device
(kernels.exprs.widen_int_env), so narrowing is invisible to results.
"""

from __future__ import annotations

import numpy as np

from tpu_olap_torch.segments.dictionary import Dictionary
from tpu_olap_torch.segments.segment import (ColumnType, Segment, SegmentMeta,
                                             TableSegments, TIME_COLUMN, _scalar)

DEFAULT_BLOCK_ROWS = 1 << 16

_NARROW_INTS = (np.int8, np.int16, np.int32)


def _int_dtype_for(lo: int, hi: int):
    """Smallest signed int dtype holding [lo, hi]. The most negative
    value of each dtype is excluded (kept free as a sentinel, matching
    executor.dataset's convention)."""
    for dt in _NARROW_INTS:
        info = np.iinfo(dt)
        if lo >= info.min + 1 and hi <= info.max:
            return np.dtype(dt)
    return np.dtype(np.int64)


def _code_dtype_for(cardinality: int):
    """Dtype for dictionary codes 0..cardinality (0 = null slot)."""
    return _int_dtype_for(0, cardinality)


class DictBuilder:
    """Incremental string dictionary: values get insertion-order temp
    codes (1-based; 0 = null) during streaming; finalize() sorts and
    returns the remap so stored codes become sorted-order codes."""

    def __init__(self):
        self._map: dict[str, int] = {}

    def encode(self, arr) -> np.ndarray:
        """object array (None/NaN = null) -> int32 temp codes."""
        import pandas as pd
        a = np.asarray(arr, dtype=object)
        null = np.asarray(pd.isna(a), dtype=bool)
        codes = np.zeros(len(a), dtype=np.int32)
        if null.all():
            return codes
        real = a[~null].astype(str)
        uniq, inv = np.unique(real, return_inverse=True)
        codes[~null] = self._ids_for(uniq)[inv]
        return codes

    def encode_indices(self, indices: np.ndarray, values,
                       null_mask: np.ndarray) -> np.ndarray:
        """Arrow-dictionary fast path: `values` (the batch's dictionary,
        small) map through the builder once; row codes are a gather on
        `indices` — no per-row string sort (parquet already
        dictionary-encodes strings, re-deriving that with np.unique was
        ~70% of ingest time)."""
        ids = self._ids_for(np.asarray(values, dtype=object))
        if len(ids) == 0:  # all-null batch: empty dictionary
            return np.zeros(len(indices), dtype=np.int32)
        idx = np.where(null_mask, 0, indices).astype(np.int64)
        codes = ids[idx].astype(np.int32, copy=False)
        codes[null_mask] = 0
        return codes

    def _ids_for(self, uniq) -> np.ndarray:
        ids = np.empty(len(uniq), dtype=np.int32)
        m = self._map
        for i, v in enumerate(uniq):
            v = str(v)
            code = m.get(v)
            if code is None:
                code = len(m) + 1
                m[v] = code
            ids[i] = code
        return ids

    def finalize(self) -> tuple[Dictionary, np.ndarray]:
        """(sorted Dictionary, remap) with remap[temp_code] = final code."""
        values = np.array(sorted(self._map), dtype=str)
        remap = np.zeros(len(self._map) + 1, dtype=np.int32)
        for final_idx, v in enumerate(values):
            remap[self._map[v]] = final_idx + 1
        return Dictionary(values), remap


# --------------------------------------------------------------------------
# Arrow column conversion (shared by in-memory and streaming paths)

def _convert_time(tcol, n: int):
    import pyarrow as pa
    import pyarrow.compute as pc
    if tcol is None:
        return np.zeros(n, dtype=np.int64)
    if tcol.null_count:
        raise ValueError(
            "time column contains nulls; a non-null time value is "
            "required per row (like Druid's __time)")
    t = tcol.type
    if pa.types.is_timestamp(t):
        # Druid's __time is millisecond-grained: sub-ms precision FLOORS
        # via numpy's datetime64 unit conversion (uniform across the
        # epoch — an unsafe Arrow cast would truncate pre-1970 values
        # toward zero, i.e. 1 ms late) instead of raising ArrowInvalid
        v = tcol.combine_chunks().to_numpy(zero_copy_only=False)
        return v.astype("datetime64[ms]").astype(np.int64)
    if pa.types.is_date(t):
        return (tcol.combine_chunks().to_numpy(zero_copy_only=False)
                .astype("datetime64[ms]").astype(np.int64))
    return tcol.combine_chunks().to_numpy(zero_copy_only=False) \
        .astype(np.int64)


def _convert_column(arr, n: int):
    """Arrow array -> (ColumnType, values ndarray, null_mask | None).
    STRING returns the raw object array (encoding is the caller's job)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    arr = arr.combine_chunks() if hasattr(arr, "combine_chunks") else arr
    t = arr.type
    if pa.types.is_dictionary(t):
        arr = pc.cast(arr, t.value_type)
        t = t.value_type
    null_mask = np.asarray(arr.is_null())
    if pa.types.is_null(t):  # all-null column: treat as all-null STRING
        return ColumnType.STRING, np.full(n, None, dtype=object), None
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return (ColumnType.STRING,
                arr.to_pandas().to_numpy(dtype=object), None)
    if pa.types.is_floating(t):
        v = arr.to_numpy(zero_copy_only=False).astype(np.float64)
        # genuine NaN values (valid Arrow values) fold into the null
        # mask, matching SQL NULL semantics and keeping kernels NaN-free;
        # +/-inf are preserved as real values
        null_mask = null_mask | np.isnan(v)
        return (ColumnType.DOUBLE, np.where(null_mask, 0.0, v),
                null_mask if null_mask.any() else None)
    if pa.types.is_integer(t) or pa.types.is_boolean(t):
        v = arr.to_numpy(zero_copy_only=False)
        if null_mask.any():
            return (ColumnType.LONG,
                    np.where(null_mask, 0, v).astype(np.int64), null_mask)
        return ColumnType.LONG, v.astype(np.int64), None
    if pa.types.is_timestamp(t) or pa.types.is_date(t):
        # numpy unit conversion floors uniformly (see time-column note)
        v = (arr.to_numpy(zero_copy_only=False)
             .astype("datetime64[ms]").astype(np.int64))
        return ColumnType.LONG, v, null_mask if null_mask.any() else None
    if pa.types.is_decimal(t):
        v = np.array([float(x) if x is not None else 0.0
                      for x in arr.to_pylist()], dtype=np.float64)
        return ColumnType.DOUBLE, v, null_mask if null_mask.any() else None
    raise TypeError(f"unsupported column type {t}")


# --------------------------------------------------------------------------
# Streaming ingestor

_PARTITION_UNIT = {"day": "D", "month": "M", "year": "Y"}


def _partition_ids(t_ms: np.ndarray, granularity: str) -> np.ndarray:
    """Calendar partition index per row (UTC, like Druid's default
    segmentGranularity bucketing) from epoch-millis int64."""
    return t_ms.astype("datetime64[ms]") \
        .astype(f"datetime64[{_PARTITION_UNIT[granularity]}]") \
        .astype(np.int64)


MAX_AUTO_PARTITIONS = 128


def resolve_time_partition(spec, t_min, t_max, total_rows: int,
                           block_rows: int):
    """Resolve "auto" to the finest calendar granularity whose expected
    partition count stays ≤ min(total_blocks/4, MAX_AUTO_PARTITIONS) —
    ≥ ~4 full blocks per partition bounds the finalize padding (≤ one
    partial block per partition) at roughly 12%, and the absolute cap
    bounds the streaming ingestor's per-partition remainder buffers
    (≤ one block each) so the bounded-host-memory invariant of
    SURVEY.md §8.4 #4 holds at any scale. Falls back to None (no
    partitioning) for tables too small to amortize even yearly
    partitions."""
    if spec != "auto":
        return spec
    if t_min is None or t_max is None or t_max <= t_min or not total_rows:
        return None
    budget = min(max(1, total_rows // block_rows) / 4,
                 MAX_AUTO_PARTITIONS)
    span_ms = t_max - t_min
    for g, unit_ms in (("day", 86_400_000),
                       ("month", 2_629_800_000),
                       ("year", 31_557_600_000)):
        if span_ms / unit_ms <= budget:
            return g
    return None


class StreamIngestor:
    """Accumulates converted batches into fixed-size segment blocks.

    Memory profile: the final encoded segment store (narrow ints + codes)
    plus one in-flight batch of decoded Arrow data; raw strings never
    outlive their batch. Rows are time-sorted within each flush chunk
    (not globally — per-segment time_min/max stay exact for pruning, like
    Druid segments, which are interval-partitioned but not row-sorted).

    `time_partition` ("day"/"month"/"year") is the Druid
    segmentGranularity analog: rows bucket into disjoint calendar
    partitions, each accumulating its own blocks, so segment time ranges
    never straddle a partition boundary. That is what makes interval
    pruning drop whole segments on time-filtered queries over streamed
    (unsorted) sources, and what lets the lowering elide the residual
    row-level interval mask — and with it the 8-bytes/row __time scan
    traffic — when every scanned segment sits inside one query interval
    (executor/lowering.py::_elide_covered_imask). Cost: up to one
    padded partial block per partition, emitted at finalize."""

    def __init__(self, name: str, time_column: str | None = None,
                 block_rows: int = DEFAULT_BLOCK_ROWS,
                 time_partition: str | None = None):
        if time_partition is not None \
                and time_partition not in _PARTITION_UNIT:
            raise ValueError(
                f"time_partition must be one of {sorted(_PARTITION_UNIT)}"
                " or None")
        self.name = name
        self.time_column = time_column
        self.block_rows = block_rows
        self.time_partition = time_partition
        self.schema: dict | None = None
        self._dicts: dict[str, DictBuilder] = {}
        self._segments: list[Segment] = []
        self._pending: list[dict] = []      # per-batch {col: values}
        self._pending_nulls: list[dict] = []
        self._pending_rows = 0
        # per-partition accumulators (time_partition only)
        self._pbuf: dict[int, list[dict]] = {}
        self._pbuf_nulls: dict[int, list[dict]] = {}
        self._pbuf_rows: dict[int, int] = {}
        self._finalized = False

    # ---- batch intake ----------------------------------------------------

    def add_arrow(self, table) -> None:
        """Add a pyarrow Table/RecordBatch worth of rows."""
        import pyarrow as pa
        if isinstance(table, pa.RecordBatch):
            table = pa.Table.from_batches([table])
        n = table.num_rows
        if n == 0 and self.schema is not None:
            return  # zero-row batches still establish the schema once
        tc = self.time_column
        if tc is None and self.schema is None \
                and TIME_COLUMN in table.schema.names:
            # a Druid-exported table carries its own __time column
            self.time_column = tc = TIME_COLUMN

        cols: dict = {}
        nulls: dict = {}
        cols[TIME_COLUMN] = _convert_time(
            table.column(tc) if tc is not None else None, n)
        schema = {TIME_COLUMN: ColumnType.LONG}
        import pyarrow.compute as pc
        for fld in table.schema:
            c = fld.name
            if c == tc or c == TIME_COLUMN:
                continue
            ftype = fld.type
            arr = None
            if pa.types.is_string(ftype) or pa.types.is_large_string(ftype):
                # flat strings (in-memory ingest): hash-encode in C++
                # so they ride the same dictionary fast path as parquet
                arr = pc.dictionary_encode(
                    table.column(c).combine_chunks())
                ftype = arr.type
            if pa.types.is_dictionary(ftype) and (
                    pa.types.is_string(ftype.value_type)
                    or pa.types.is_large_string(ftype.value_type)):
                # arrow-dictionary fast path: remap small dictionaries,
                # gather row indices (see DictBuilder.encode_indices)
                if arr is None:
                    arr = table.column(c).combine_chunks()
                null = np.asarray(arr.is_null())
                idx = pc.fill_null(arr.indices, 0).to_numpy(
                    zero_copy_only=False)
                vals = arr.dictionary.to_pylist()
                schema[c] = ColumnType.STRING
                cols[c] = self._dicts.setdefault(
                    c, DictBuilder()).encode_indices(idx, vals, null)
                continue
            try:
                typ, v, nm = _convert_column(table.column(c), n)
            except (TypeError, ValueError) as e:
                raise type(e)(f"column {c!r}: {e}") from None
            schema[c] = typ
            if typ is ColumnType.STRING:
                v = self._dicts.setdefault(c, DictBuilder()).encode(v)
            cols[c] = v
            if nm is not None:
                nulls[c] = nm

        if self.schema is None:
            self.schema = schema
        elif schema != self.schema:
            missing = set(self.schema) ^ set(schema)
            raise ValueError(
                f"batch schema mismatch for table {self.name!r}"
                + (f" (columns differ: {sorted(missing)})" if missing
                   else " (column types differ)"))
        self._pending.append(cols)
        self._pending_nulls.append(nulls)
        self._pending_rows += n
        if self._pending_rows >= self.block_rows:
            # emit every full block in one pass (one concatenate, not one
            # per block — an in-memory whole-table add stays O(N))
            self._flush(self._pending_rows
                        - self._pending_rows % self.block_rows)

    # ---- block emission --------------------------------------------------

    @staticmethod
    def _cat_pieces(pieces, npieces):
        """Concatenate buffered column pieces + zero-backfilled null
        masks (a piece that predates a column's first null has no mask
        entry). Shared by the pending drain and partition emission."""
        cat = {c: np.concatenate([p[c] for p in pieces])
               for c in pieces[0]}
        nset = set().union(*(n.keys() for n in npieces)) \
            if npieces else set()
        cat_nulls = {}
        for c in nset:
            cat_nulls[c] = np.concatenate([
                n.get(c, np.zeros(len(p[TIME_COLUMN]), bool))
                for p, n in zip(pieces, npieces)])
        return cat, cat_nulls

    def _cat_pending(self):
        return self._cat_pieces(self._pending, self._pending_nulls)

    def _flush(self, rows: int) -> None:
        """Emit full blocks from the first `rows` pending rows (the chunk
        is time-sorted first); the remainder is carried forward. With
        time_partition set, ALL pending rows instead drain into their
        calendar partition's accumulator, and each partition emits its
        own full blocks (remainders live in the partition buffers until
        finalize)."""
        if self.time_partition is not None:
            cat, cat_nulls = self._cat_pending()
            self._pending, self._pending_nulls = [], []
            self._pending_rows = 0
            order = np.argsort(cat[TIME_COLUMN], kind="stable")
            pids = _partition_ids(cat[TIME_COLUMN][order],
                                  self.time_partition)
            cuts = np.flatnonzero(np.diff(pids)) + 1
            bounds = np.concatenate([[0], cuts, [len(pids)]])
            for s, e in zip(bounds[:-1], bounds[1:]):
                if s == e:
                    continue
                pid = int(pids[s])
                idx = order[s:e]
                self._pbuf.setdefault(pid, []).append(
                    {c: v[idx] for c, v in cat.items()})
                self._pbuf_nulls.setdefault(pid, []).append(
                    {c: m[idx] for c, m in cat_nulls.items()})
                self._pbuf_rows[pid] = self._pbuf_rows.get(pid, 0) \
                    + (e - s)
                if self._pbuf_rows[pid] >= self.block_rows:
                    self._emit_partition(pid, final=False)
            # hard cap on total buffered remainders (bounded host
            # memory even under an explicitly fine granularity on a
            # huge span): force-emit the largest buffers as padded
            # partials — a little block padding, never an OOM
            budget = MAX_AUTO_PARTITIONS * self.block_rows
            while sum(self._pbuf_rows.values()) > budget:
                pid = max(self._pbuf_rows, key=self._pbuf_rows.get)
                self._emit_partition(pid, final=True)
            return
        cat, cat_nulls = self._cat_pending()

        order = np.argsort(cat[TIME_COLUMN][:rows], kind="stable")
        n_blocks = rows // self.block_rows if rows >= self.block_rows else 1
        emit = n_blocks * self.block_rows if rows >= self.block_rows else rows
        for b in range(n_blocks):
            lo = b * self.block_rows
            hi = min((b + 1) * self.block_rows, emit)
            idx = order[lo:hi]
            self._emit_block(
                {c: v[idx] for c, v in cat.items()},
                {c: m[idx] for c, m in cat_nulls.items()}, hi - lo)

        if emit < self._pending_rows:
            rest = np.arange(emit, self._pending_rows)
            self._pending = [{c: v[rest] for c, v in cat.items()}]
            self._pending_nulls = [
                {c: m[rest] for c, m in cat_nulls.items()}]
        else:
            self._pending = []
            self._pending_nulls = []
        self._pending_rows -= emit

    def _emit_partition(self, pid: int, final: bool) -> None:
        """Emit this partition's full blocks (all rows incl. a padded
        partial when final); the remainder rows stay buffered. Rows are
        re-time-sorted across the buffered pieces so blocks inside a
        partition stay locally sorted."""
        cat, cat_nulls = self._cat_pieces(self._pbuf[pid],
                                          self._pbuf_nulls[pid])
        rows = self._pbuf_rows[pid]
        emit = rows if final else rows - rows % self.block_rows
        order = np.argsort(cat[TIME_COLUMN], kind="stable")
        pos = 0
        while pos < emit:
            hi = min(pos + self.block_rows, emit)
            idx = order[pos:hi]
            self._emit_block({c: v[idx] for c, v in cat.items()},
                             {c: m[idx] for c, m in cat_nulls.items()},
                             hi - pos)
            pos = hi
        if final or emit == rows:
            del self._pbuf[pid], self._pbuf_nulls[pid], \
                self._pbuf_rows[pid]
        else:
            rest = order[emit:]
            self._pbuf[pid] = [{c: v[rest] for c, v in cat.items()}]
            self._pbuf_nulls[pid] = [{c: m[rest]
                                      for c, m in cat_nulls.items()}]
            self._pbuf_rows[pid] = rows - emit

    def _emit_block(self, vals: dict, nulls: dict, nv: int) -> None:
        cols, masks = {}, {}
        for c, v in vals.items():
            # per-block narrow storage (promoted to the global dtype at
            # finalize; global range ⊇ block range so promotion is safe)
            if v.dtype.kind == "i" and c != TIME_COLUMN and \
                    self.schema[c] is ColumnType.LONG and nv:
                v = v.astype(_int_dtype_for(int(v[:nv].min()),
                                            int(v[:nv].max())))
            block = np.zeros(self.block_rows, dtype=v.dtype)
            block[:nv] = v
            cols[c] = block
        for c, m in nulls.items():
            block = np.zeros(self.block_rows, dtype=bool)
            block[:nv] = m
            masks[c] = block
        t = cols[TIME_COLUMN][:nv]
        meta = SegmentMeta(
            segment_id=len(self._segments), n_valid=nv,
            time_min=int(t.min()) if nv else 0,
            time_max=int(t.max()) if nv else 0,
        )
        for c, typ in self.schema.items():
            if typ is not ColumnType.STRING and nv:
                cv = cols[c][:nv]
                nm = masks.get(c)
                if nm is not None and nm[:nv].all():
                    continue
                if nm is not None and nm[:nv].any():
                    cv = cv[~nm[:nv]]
                meta.column_min[c] = _scalar(cv.min())
                meta.column_max[c] = _scalar(cv.max())
        self._segments.append(Segment(meta, cols, masks))

    # ---- finalize --------------------------------------------------------

    def finalize(self) -> TableSegments:
        assert not self._finalized, "finalize() called twice"
        self._finalized = True
        if self._pending_rows:
            self._flush(self._pending_rows)
        for pid in sorted(self._pbuf):  # partition remainders, padded
            self._emit_partition(pid, final=True)
        if self.time_partition is not None and len(self._segments) > 1:
            # partition-contiguous id order: arrival-order emission and
            # the finalize partials interleave partitions, but each
            # segment lies inside ONE partition, so sorting by time_min
            # makes every partition a contiguous id run — which is what
            # lets the dispatcher's segment-window slice (runner.
            # _segment_window) cover a pruned interval with a tight
            # window instead of the whole store
            self._segments.sort(
                key=lambda s: (s.meta.time_min, s.meta.segment_id))
            for i, s in enumerate(self._segments):
                s.meta.segment_id = i
        if not self._segments:
            # empty table: one empty segment keeps shapes non-degenerate
            if self.schema is None:
                self.schema = {TIME_COLUMN: ColumnType.LONG}
            self._emit_block(
                {c: np.zeros(0, np.int64 if t is not ColumnType.DOUBLE
                             else np.float64)
                 for c, t in self.schema.items()}, {}, 0)

        # sorted-dictionary remap for stored temp codes
        dictionaries: dict = {}
        remaps: dict = {}
        for c, b in self._dicts.items():
            dictionaries[c], remaps[c] = b.finalize()
        for c, typ in self.schema.items():  # zero-batch STRING edge
            if typ is ColumnType.STRING and c not in dictionaries:
                dictionaries[c] = Dictionary(np.array([], dtype=str))

        # global dtype per column: codes narrow by cardinality, LONGs by
        # the manifest's min/max envelope
        target: dict = {}
        for c, typ in self.schema.items():
            if typ is ColumnType.STRING:
                d = dictionaries.get(c)
                target[c] = _code_dtype_for(d.cardinality if d else 0)
            elif typ is ColumnType.LONG and c != TIME_COLUMN:
                lo = hi = None
                for s in self._segments:
                    mlo = s.meta.column_min.get(c)
                    if mlo is None:
                        continue
                    mhi = s.meta.column_max.get(c)
                    lo = mlo if lo is None else min(lo, mlo)
                    hi = mhi if hi is None else max(hi, mhi)
                target[c] = _int_dtype_for(lo, hi) if lo is not None \
                    else np.dtype(np.int8)
        for s in self._segments:
            for c, dt in target.items():
                v = s.columns[c]
                r = remaps.get(c)
                if r is not None:
                    v = r[v]
                s.columns[c] = v.astype(dt, copy=False)

        out = TableSegments(self.name, self.schema, dictionaries,
                            self._segments, self.block_rows)
        # recorded so delta compaction re-partitions the same way
        # (segments/delta.py; docs/INGEST.md)
        out.time_partition = self.time_partition
        return out


# --------------------------------------------------------------------------
# Entry points

def ingest_arrow(name: str, table, time_column: str | None = None,
                 block_rows: int = DEFAULT_BLOCK_ROWS,
                 time_partition="auto") -> TableSegments:
    """In-memory ingest: globally time-sorted segments, partition-
    aligned per the resolved time_partition (segmentGranularity)."""
    if time_column is None and TIME_COLUMN in table.schema.names:
        time_column = TIME_COLUMN
    tvals = None
    if time_column is not None and table.num_rows:
        tvals = _convert_time(table.column(time_column), table.num_rows)
        order = np.argsort(tvals, kind="stable")
        if not np.array_equal(order, np.arange(table.num_rows)):
            table = table.take(order)
            tvals = tvals[order]
    tp = resolve_time_partition(
        time_partition,
        int(tvals[0]) if tvals is not None and len(tvals) else None,
        int(tvals[-1]) if tvals is not None and len(tvals) else None,
        table.num_rows, block_rows)
    ing = StreamIngestor(name, time_column, block_rows, tp)
    ing.add_arrow(table)
    return ing.finalize()


def ingest_pandas(name: str, df, time_column: str | None = None,
                  block_rows: int = DEFAULT_BLOCK_ROWS,
                  time_partition="auto") -> TableSegments:
    import pyarrow as pa
    return ingest_arrow(name, pa.Table.from_pandas(df, preserve_index=False),
                        time_column, block_rows, time_partition)


def ingest_parquet(name: str, path, time_column: str | None = None,
                   block_rows: int = DEFAULT_BLOCK_ROWS,
                   columns=None, column_map: dict | None = None,
                   batch_rows: int | None = None,
                   time_partition="auto") -> TableSegments:
    """Streaming parquet ingest; `path` may be one path or a list."""
    return ingest_parquet_stream(name, path, time_column, block_rows,
                                 columns, column_map, batch_rows,
                                 time_partition)


def _parquet_time_stats(paths, time_col):
    """(t_min_ms, t_max_ms, total_rows) from parquet row-group footer
    statistics — metadata only, no data read. (None, None, rows) when
    any row group lacks stats for the time column."""
    import pyarrow.parquet as pq
    lo = hi = None
    rows = 0
    for path in paths:
        md = pq.ParquetFile(path).metadata
        rows += md.num_rows
        try:
            sidx = md.schema.names.index(time_col)
        except ValueError:
            return None, None, rows
        for rg in range(md.num_row_groups):
            st = md.row_group(rg).column(sidx).statistics
            if st is None or not st.has_min_max:
                return None, None, rows
            mn, mx = st.min, st.max
            if hasattr(mn, "timestamp"):
                mn = int(mn.timestamp() * 1000)
                mx = int(mx.timestamp() * 1000)
            elif not isinstance(mn, (int, np.integer)):
                return None, None, rows
            lo = mn if lo is None else min(lo, mn)
            hi = mx if hi is None else max(hi, mx)
    return lo, hi, rows


def ingest_parquet_stream(name: str, paths, time_column: str | None = None,
                          block_rows: int = DEFAULT_BLOCK_ROWS,
                          columns=None, column_map: dict | None = None,
                          batch_rows: int | None = None,
                          time_partition="auto") -> TableSegments:
    """Row-group streaming ingest over one or many parquet files under
    bounded host memory (SURVEY.md §8.4 #4 / BASELINE.json:5 "streams
    Parquet→HBM"). `columns` / `column_map` use POST-rename names, like
    Engine.register_table. time_partition="auto" resolves the Druid
    segmentGranularity analog from the footer's time statistics."""
    import pyarrow.parquet as pq

    if isinstance(paths, str):
        paths = [paths]
    column_map = dict(column_map) if column_map else None
    inverse = {v: k for k, v in (column_map or {}).items()}
    read_cols = [inverse.get(c, c) for c in columns] if columns else None

    if time_partition == "auto" and time_column is not None:
        src_time = inverse.get(time_column, time_column)
        t_lo, t_hi, n_rows = _parquet_time_stats(paths, src_time)
        time_partition = resolve_time_partition(
            "auto", t_lo, t_hi, n_rows, block_rows)
    elif time_partition == "auto":
        time_partition = None

    ing = StreamIngestor(name, time_column, block_rows, time_partition)
    bs = batch_rows or block_rows
    dict_cols = None   # string columns read as arrow dictionaries
    for path in paths:
        if dict_cols is None:
            import pyarrow as pa
            schema = pq.read_schema(path)
            dict_cols = [
                f.name for f in schema
                if (pa.types.is_string(f.type)
                    or pa.types.is_large_string(f.type))
                and (read_cols is None or f.name in read_cols)]
        pf = pq.ParquetFile(path, read_dictionary=dict_cols)
        try:
            for batch in pf.iter_batches(batch_size=bs, columns=read_cols):
                if column_map:
                    batch = batch.rename_columns(
                        [column_map.get(c, c) for c in batch.schema.names])
                ing.add_arrow(batch)
        finally:
            pf.close()
    return ing.finalize()

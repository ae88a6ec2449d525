"""Durable sealed-segment store: checkpointed spill files + an
atomically-swapped manifest (docs/DURABILITY.md).

The reference system's durability story is deep storage of immutable
sealed segments with the real-time log kept short (Druid's
segment/handoff model); the LSM literature ("bLSM", PAPERS.md) makes
the same point — logs are for the tail, checkpoints bound recovery.
This module is that half for the in-process engine: without it the WAL
is the sole durable copy of every appended row and recovery replays the
entire ingest history (O(total appends)); with it, recovery loads the
newest *verifiable* checkpoint and replays only the WAL tail past its
watermark (O(tail)).

On-disk layout (`EngineConfig.ingest_store_dir`), one directory per
table:

    <root>/<table>/seg-<sha16>.chunk      one sealed segment, columnar
    <root>/<table>/dict-<sha16>.chunk     the table's dictionaries
    <root>/<table>/manifest-<id>.json     checkpoint manifests

Chunk files are length+CRC32-framed per column::

    [u32 len][u32 crc32(payload)][payload] ...

frame 0 is canonical JSON metadata (schema-ordered column list, dtypes,
segment meta); the remaining frames are raw little-endian column bytes
(valid rows only — padding is reconstructed at load) followed by null
masks. The layout is *canonical* — sorted keys, no timestamps, content
purely a function of the segment — so a re-spill of unchanged data is
byte-identical and the content-addressed filename (`sha256[:16]` of the
file bytes) dedupes it: a checkpoint after incremental compaction
rewrites only the chunks of partitions the delta touched and reuses the
rest by name.

The manifest is the atomic commit point: canonical JSON wrapped with
its own CRC32, written temp -> fsync -> rename (+ directory fsync), so
a checkpoint is either fully visible or invisible. It records the chunk
files with per-file size+CRC32, the dictionary file, the sealed
generation's shape (schema/block_rows/time_partition), and the WAL
watermark seq the sealed scope covers.

Recovery ladder (`SegmentStore.load`): manifests newest-first; the
first whose manifest CRC, chunk checksums, and frame CRCs ALL verify
wins — a corrupt/missing chunk or torn manifest falls back to the
previous manifest, and past the ladder to base-only + full WAL replay.
Never a wrong answer: corruption is detected, surfaced (`fallbacks` on
the result), and stepped over. The WAL truncation policy in
segments/delta.py is lag-one (truncate only through the OLDEST retained
manifest's watermark), so falling back one checkpoint always finds the
covering WAL tail still on disk — a single corrupt chunk or manifest
loses nothing.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import zlib

import numpy as np

from tpu_olap_torch.resilience.faults import maybe_inject
from tpu_olap_torch.segments.dictionary import Dictionary
from tpu_olap_torch.segments.segment import (ColumnType, Segment, SegmentMeta,
                                       TableSegments, TIME_COLUMN)
from tpu_olap_torch.segments.wal import _fsync_dir

_HEADER = struct.Struct("<II")  # payload length, crc32(payload)

# a corrupt length field must not make the reader allocate gigabytes
# before the CRC check can fail (same bound as the WAL)
MAX_FRAME_BYTES = 1 << 31

STORE_FORMAT = 1

__all__ = ["SegmentStore", "StoreCorrupt", "LoadedCheckpoint",
           "segments_to_frame"]


class StoreCorrupt(Exception):
    """A chunk or manifest failed verification (size/CRC/structure).
    Load treats it as a rung failure and falls down the ladder."""


# --------------------------------------------------------------------------
# framing

def _pack_frame(payload: bytes) -> bytes:
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def _iter_frames(data: bytes):
    pos, n = 0, len(data)
    while pos < n:
        if n - pos < _HEADER.size:
            raise StoreCorrupt("truncated frame header")
        length, crc = _HEADER.unpack_from(data, pos)
        pos += _HEADER.size
        if length > MAX_FRAME_BYTES or n - pos < length:
            raise StoreCorrupt("truncated frame payload")
        payload = data[pos:pos + length]
        if zlib.crc32(payload) != crc:
            raise StoreCorrupt("frame CRC mismatch")
        pos += length
        yield payload


def _canon_json(obj) -> bytes:
    """Canonical JSON bytes: sorted keys, compact separators — the
    byte-identity contract for content addressing."""
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def _py(v):
    """numpy scalar -> JSON-native Python scalar (segment metas carry
    np.int64/np.float64 mins/maxes; canonical JSON must not depend on
    which path built them)."""
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


# --------------------------------------------------------------------------
# segment <-> chunk bytes

def encode_segment(seg: Segment) -> bytes:
    """One sealed segment -> canonical chunk bytes. Only valid rows are
    stored (padding reconstructs at load); columns and masks in sorted
    name order; segment_id is EXCLUDED (it lives in the manifest) so an
    identical segment re-numbered by compaction hashes identically."""
    nv = seg.meta.n_valid
    cols = sorted(seg.columns)
    masks = sorted(c for c, m in seg.null_masks.items()
                   if bool(np.asarray(m[:nv]).any()))
    meta = {
        "n_valid": int(nv),
        "time_min": int(seg.meta.time_min),
        "time_max": int(seg.meta.time_max),
        "column_min": {c: _py(seg.meta.column_min[c])
                       for c in sorted(seg.meta.column_min)},
        "column_max": {c: _py(seg.meta.column_max[c])
                       for c in sorted(seg.meta.column_max)},
        "columns": [{"name": c,
                     "dtype": np.asarray(seg.columns[c]).dtype.str}
                    for c in cols],
        "masks": masks,
    }
    parts = [_pack_frame(_canon_json(meta))]
    for c in cols:
        arr = np.ascontiguousarray(np.asarray(seg.columns[c])[:nv])
        parts.append(_pack_frame(arr.tobytes()))
    for c in masks:
        m = np.ascontiguousarray(
            np.asarray(seg.null_masks[c])[:nv].astype(bool))
        parts.append(_pack_frame(m.tobytes()))
    return b"".join(parts)


def decode_segment(data: bytes, block_rows: int,
                   segment_id: int) -> Segment:
    frames = _iter_frames(data)
    try:
        meta = json.loads(next(frames).decode("utf-8"))
    except (StopIteration, ValueError) as e:
        raise StoreCorrupt(f"bad chunk meta: {e}") from None
    nv = int(meta["n_valid"])
    cols: dict = {}
    for spec in meta["columns"]:
        payload = next(frames, None)
        if payload is None:
            raise StoreCorrupt("chunk missing column frame")
        dt = np.dtype(spec["dtype"])
        v = np.frombuffer(payload, dtype=dt)
        if len(v) != nv:
            raise StoreCorrupt(
                f"column {spec['name']!r}: {len(v)} rows, meta says {nv}")
        block = np.zeros(block_rows, dtype=dt)
        block[:nv] = v
        cols[spec["name"]] = block
    nulls: dict = {}
    for c in meta["masks"]:
        payload = next(frames, None)
        if payload is None:
            raise StoreCorrupt("chunk missing mask frame")
        m = np.frombuffer(payload, dtype=bool)
        if len(m) != nv:
            raise StoreCorrupt(f"mask {c!r}: {len(m)} rows")
        block = np.zeros(block_rows, dtype=bool)
        block[:nv] = m
        nulls[c] = block
    sm = SegmentMeta(
        segment_id=segment_id, n_valid=nv,
        time_min=int(meta["time_min"]), time_max=int(meta["time_max"]),
        column_min=dict(meta["column_min"]),
        column_max=dict(meta["column_max"]))
    return Segment(sm, cols, nulls)


def encode_dictionaries(dicts: dict) -> bytes:
    names = sorted(dicts)
    meta = {"columns": names,
            "is_sorted": {c: bool(dicts[c].is_sorted) for c in names}}
    parts = [_pack_frame(_canon_json(meta))]
    for c in names:
        vals = [str(v) for v in dicts[c].values]
        parts.append(_pack_frame(_canon_json(vals)))
    return b"".join(parts)


def decode_dictionaries(data: bytes) -> dict:
    frames = _iter_frames(data)
    try:
        meta = json.loads(next(frames).decode("utf-8"))
    except (StopIteration, ValueError) as e:
        raise StoreCorrupt(f"bad dictionary meta: {e}") from None
    out: dict = {}
    for c in meta["columns"]:
        payload = next(frames, None)
        if payload is None:
            raise StoreCorrupt("dictionary file missing a column frame")
        vals = json.loads(payload.decode("utf-8"))
        out[c] = Dictionary(
            np.array(vals, dtype=str) if vals
            else np.array([], dtype=str),
            is_sorted=bool(meta["is_sorted"].get(c, True)))
    return out


def segments_to_frame(ts: TableSegments, time_column: str | None):
    """Reconstruct the fallback-path DataFrame from stored segments —
    the recovered table's base frame (the original registration data no
    longer covers compacted appends). STRING columns decode through the
    dictionary; LONG columns with nulls take pandas' float64+NaN
    convention (what a round trip through DataFrame would produce);
    __time re-materializes as datetimes under the registered time
    column name, matching IngestManager._delta_frame."""
    import pandas as pd
    cols: dict = {}
    for c, typ in ts.schema.items():
        pieces = []
        for s in ts.segments:
            nv = s.meta.n_valid
            if not nv:
                continue
            v = np.asarray(s.columns[c][:nv])
            if typ is ColumnType.STRING:
                pieces.append(ts.dictionaries[c].decode(
                    v.astype(np.int64)))
                continue
            m = s.null_masks.get(c)
            if m is not None and np.asarray(m[:nv]).any():
                fv = v.astype(np.float64)
                fv[np.asarray(m[:nv])] = np.nan
                pieces.append(fv)
            else:
                pieces.append(v)
        if pieces:
            cols[c] = np.concatenate(
                [np.asarray(p, dtype=object) for p in pieces]) \
                if typ is ColumnType.STRING else np.concatenate(
                    [p.astype(np.float64) for p in pieces]) \
                if any(p.dtype.kind == "f" for p in pieces) \
                else np.concatenate([p.astype(np.int64) for p in pieces])
        else:
            cols[c] = np.zeros(
                0, np.float64 if typ is ColumnType.DOUBLE else np.int64) \
                if typ is not ColumnType.STRING \
                else np.array([], dtype=object)
    t = cols.pop(TIME_COLUMN)
    df = pd.DataFrame(cols)
    df[time_column or TIME_COLUMN] = pd.to_datetime(
        np.asarray(t, dtype=np.int64), unit="ms")
    return df


# --------------------------------------------------------------------------
# the store

class LoadedCheckpoint:
    """`SegmentStore.load` result: the recovered sealed TableSegments
    (None when no manifest verified), the winning manifest payload, and
    the (file, reason) rungs the ladder stepped over."""

    __slots__ = ("segments", "manifest", "fallbacks")

    def __init__(self, segments, manifest, fallbacks):
        self.segments = segments
        self.manifest = manifest
        self.fallbacks = fallbacks

    @property
    def wal_seq(self) -> int:
        return int(self.manifest["wal_seq"]) if self.manifest else 0


def _manifest_name(checkpoint_id: int) -> str:
    return f"manifest-{checkpoint_id:08d}.json"


def _manifest_id(fname: str) -> int:
    return int(fname[len("manifest-"):-len(".json")])


class SegmentStore:
    """Per-table checkpoint store rooted at `ingest_store_dir`. One
    instance per engine; per-table locks serialize checkpoints (loads
    happen at registration, already serialized by the caller)."""

    def __init__(self, root: str, keep_manifests: int = 2,
                 config=None):
        self.root = root
        self.keep = max(2, int(keep_manifests))
        self.config = config  # fault-injection sites only
        self._lock = threading.Lock()
        # RLocks: IngestManager._checkpoint_sealed holds a table's
        # lock across checkpoint + currency check + WAL truncation so
        # a concurrent delete_table (re-registration/drop) serializes
        # behind the whole commit instead of interleaving with it
        self._table_locks: dict[str, threading.RLock] = {}
        # per-table last checkpoint/load stats (GET /debug/ingest,
        # sys.checkpoints)
        self.stats: dict[str, dict] = {}

    def table_dir(self, name: str) -> str:
        return os.path.join(self.root, name)

    def _tlock(self, name: str) -> threading.RLock:
        with self._lock:
            lk = self._table_locks.get(name)
            if lk is None:
                lk = self._table_locks[name] = threading.RLock()
            return lk

    def table_lock(self, name: str) -> threading.RLock:
        """The per-table commit lock, for callers that need to bind a
        checkpoint to surrounding state checks (see
        IngestManager._checkpoint_sealed). Reentrant: checkpoint()/
        delete_table() re-acquire it safely."""
        return self._tlock(name)

    # -------------------------------------------------------- checkpoint

    def _list_manifests(self, d: str) -> list:
        try:
            names = os.listdir(d)
        except OSError:
            return []
        out = []
        for n in names:
            if n.startswith("manifest-") and n.endswith(".json"):
                try:
                    _manifest_id(n)
                except ValueError:
                    continue
                out.append(n)
        return sorted(out, key=_manifest_id)

    def _read_manifest(self, path: str) -> dict:
        try:
            with open(path, "rb") as f:
                wrapper = json.loads(f.read().decode("utf-8"))
            payload = wrapper["payload"]
            crc = int(wrapper["crc32"])
        except (OSError, ValueError, KeyError, TypeError) as e:
            raise StoreCorrupt(f"unreadable manifest: {e}") from None
        if zlib.crc32(_canon_json(payload)) != crc:
            raise StoreCorrupt("manifest CRC mismatch")
        if payload.get("format") != STORE_FORMAT:
            raise StoreCorrupt(
                f"unknown store format {payload.get('format')!r}")
        return payload

    def _write_blob(self, d: str, prefix: str, blob: bytes,
                    written: list) -> dict:
        """Content-addressed write: skip when the file already exists
        (the canonical layout guarantees identical content). Returns
        the manifest entry; appends to `written` when a file was
        actually created."""
        fname = f"{prefix}-{hashlib.sha256(blob).hexdigest()[:16]}.chunk"
        path = os.path.join(d, fname)
        entry = {"file": fname, "bytes": len(blob),
                 "crc32": zlib.crc32(blob)}
        if not os.path.exists(path):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, path)
            written.append(fname)
        return entry

    def checkpoint(self, name: str, sealed: TableSegments,
                   wal_seq: int) -> dict:
        """Spill the sealed scope and advance the manifest. `sealed`
        must be an immutable sealed-only view (TableSegments.
        sealed_view()); `wal_seq` is the highest WAL seq whose rows the
        sealed scope covers. Idempotent: an unchanged sealed set +
        watermark returns status "noop" without writing. Returns
        {status, checkpoint_id, segments, files_written, chunks_reused,
        bytes, truncate_through} — truncate_through is the lag-one
        watermark the caller may truncate the WAL through."""
        with self._tlock(name):
            d = self.table_dir(name)
            os.makedirs(d, exist_ok=True)
            manifests = self._list_manifests(d)
            prev_payload = None
            if manifests:
                try:
                    prev_payload = self._read_manifest(
                        os.path.join(d, manifests[-1]))
                except StoreCorrupt:
                    prev_payload = None
            maybe_inject(self.config, "spill-write", 0)
            written: list = []
            seg_entries = []
            reused = 0
            total_bytes = 0
            for s in sealed.segments:
                memo = getattr(s, "_spill_memo", None)
                if memo is not None and os.path.exists(
                        os.path.join(d, memo["file"])):
                    entry = dict(memo)
                    reused += 1
                else:
                    blob = encode_segment(s)
                    pre = len(written)
                    entry = self._write_blob(d, "seg", blob, written)
                    if len(written) == pre:
                        reused += 1
                    s._spill_memo = dict(entry)
                entry["segment_id"] = int(s.meta.segment_id)
                seg_entries.append(entry)
                total_bytes += entry["bytes"]
            dict_entry = self._write_blob(
                d, "dict", encode_dictionaries(sealed.dictionaries),
                written)
            total_bytes += dict_entry["bytes"]
            payload = {
                "format": STORE_FORMAT,
                "table": name,
                "checkpoint_id": (int(prev_payload["checkpoint_id"]) + 1
                                  if prev_payload else
                                  (_manifest_id(manifests[-1]) + 1
                                   if manifests else 1)),
                "wal_seq": int(wal_seq),
                "schema": {c: t.value for c, t in sealed.schema.items()},
                "block_rows": int(sealed.block_rows),
                "time_partition": sealed.time_partition,
                "num_rows": int(sealed.num_rows),
                "segments": seg_entries,
                "dictionary": dict_entry,
            }
            if prev_payload is not None and \
                    prev_payload["segments"] == seg_entries and \
                    prev_payload["dictionary"] == dict_entry and \
                    prev_payload["wal_seq"] == payload["wal_seq"]:
                info = {"status": "noop",
                        "checkpoint_id": prev_payload["checkpoint_id"],
                        "segments": len(seg_entries),
                        "files_written": 0, "chunks_reused": reused,
                        "bytes": total_bytes,
                        "truncate_through": self._truncate_watermark(d)}
                self._note(name, info, payload)
                return info
            _fsync_dir(d)  # chunk files durable before the commit point
            maybe_inject(self.config, "manifest-swap", 0)
            mpath = os.path.join(d, _manifest_name(
                payload["checkpoint_id"]))
            wrapper = {"payload": payload,
                       "crc32": zlib.crc32(_canon_json(payload))}
            tmp = mpath + ".tmp"
            with open(tmp, "wb") as f:
                f.write(json.dumps(wrapper, sort_keys=True,
                                   indent=1).encode("utf-8"))
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, mpath)
            _fsync_dir(d)
            self._gc(d)
            info = {"status": "checkpointed",
                    "checkpoint_id": payload["checkpoint_id"],
                    "segments": len(seg_entries),
                    "files_written": len(written),
                    "chunks_reused": reused,
                    "bytes": total_bytes,
                    "truncate_through": self._truncate_watermark(d)}
            self._note(name, info, payload)
            return info

    def _truncate_watermark(self, d: str) -> int:
        """Lag-one truncation bound: the wal_seq of the OLDEST retained
        manifest. Every frame at or below it is covered by ALL retained
        checkpoints, so even falling back the full ladder keeps the
        covering tail. One manifest retained -> 0 (no truncation yet)."""
        manifests = self._list_manifests(d)
        if len(manifests) < 2:
            return 0
        try:
            return int(self._read_manifest(
                os.path.join(d, manifests[0]))["wal_seq"])
        except StoreCorrupt:
            return 0

    def _gc(self, d: str) -> None:
        """Drop manifests beyond the retention window and chunks no
        retained manifest references. Best-effort: a GC failure never
        fails the checkpoint."""
        try:
            manifests = self._list_manifests(d)
            for m in manifests[:-self.keep]:
                try:
                    os.unlink(os.path.join(d, m))
                except OSError:
                    pass
            live: set = set()
            for m in self._list_manifests(d):
                try:
                    p = self._read_manifest(os.path.join(d, m))
                except StoreCorrupt:
                    continue
                live.update(e["file"] for e in p["segments"])
                live.add(p["dictionary"]["file"])
            for fname in os.listdir(d):
                if fname.endswith(".chunk") and fname not in live:
                    try:
                        os.unlink(os.path.join(d, fname))
                    except OSError:
                        pass
                elif fname.endswith(".tmp"):
                    try:
                        os.unlink(os.path.join(d, fname))
                    except OSError:
                        pass
        except OSError:
            pass

    def _note(self, name: str, info: dict, payload: dict) -> None:
        self.stats[name] = {
            "checkpoint_id": info["checkpoint_id"],
            "wal_seq": int(payload["wal_seq"]),
            "segments": info["segments"],
            "bytes": info["bytes"],
            "files_written": info.get("files_written", 0),
            "chunks_reused": info.get("chunks_reused", 0),
            "manifests_retained": len(
                self._list_manifests(self.table_dir(name))),
        }

    # -------------------------------------------------------------- load

    def _load_manifest(self, d: str, mfile: str, name: str):
        payload = self._read_manifest(os.path.join(d, mfile))
        if payload["table"] != name:
            raise StoreCorrupt(
                f"manifest names table {payload['table']!r}")
        block_rows = int(payload["block_rows"])

        def read_verified(entry) -> bytes:
            path = os.path.join(d, entry["file"])
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError as e:
                raise StoreCorrupt(
                    f"missing chunk {entry['file']}: {e}") from None
            if len(data) != int(entry["bytes"]) or \
                    zlib.crc32(data) != int(entry["crc32"]):
                raise StoreCorrupt(
                    f"chunk {entry['file']} failed checksum")
            return data

        dicts = decode_dictionaries(read_verified(payload["dictionary"]))
        segments = []
        for e in payload["segments"]:
            seg = decode_segment(read_verified(e), block_rows,
                                 int(e["segment_id"]))
            seg._spill_memo = {"file": e["file"], "bytes": e["bytes"],
                               "crc32": e["crc32"]}
            segments.append(seg)
        segments.sort(key=lambda s: s.meta.segment_id)
        schema = {c: ColumnType(t) for c, t in payload["schema"].items()}
        ts = TableSegments(name, schema, dicts, segments, block_rows,
                           sealed_count=len(segments))
        ts.time_partition = payload["time_partition"]
        return ts, payload

    def load(self, name: str) -> LoadedCheckpoint | None:
        """Recovery ladder: newest manifest whose every checksum
        verifies wins; corrupt rungs are recorded and stepped over.
        None when the table has no store directory or no manifests at
        all (nothing was ever checkpointed)."""
        d = self.table_dir(name)
        manifests = self._list_manifests(d)
        if not manifests:
            return None
        fallbacks = []
        for mfile in reversed(manifests):
            try:
                ts, payload = self._load_manifest(d, mfile, name)
            except (StoreCorrupt, OSError, ValueError, KeyError,
                    TypeError) as e:
                fallbacks.append((mfile, f"{type(e).__name__}: {e}"))
                continue
            self._note(name, {"checkpoint_id": payload["checkpoint_id"],
                              "segments": len(payload["segments"]),
                              "bytes": sum(int(e["bytes"]) for e in
                                           payload["segments"])
                              + int(payload["dictionary"]["bytes"])},
                       payload)
            return LoadedCheckpoint(ts, payload, fallbacks)
        return LoadedCheckpoint(None, None, fallbacks)

    # ------------------------------------------------------------- admin

    def delete_table(self, name: str) -> None:
        """Drop the table's whole store (DROP TABLE, or a live
        re-registration replacing the data the checkpoints covered).
        Takes the table lock so it serializes behind an in-flight
        checkpoint commit instead of racing its file writes."""
        import shutil
        with self._tlock(name):
            self.stats.pop(name, None)
            shutil.rmtree(self.table_dir(name), ignore_errors=True)

    def table_stats(self, name: str) -> dict | None:
        return self.stats.get(name)

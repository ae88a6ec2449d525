"""Per-table write-ahead log for real-time ingest (docs/INGEST.md).

Durability contract: `Engine.append` acknowledges a batch only after
its rows are framed into the table's log (and, under the default
`ingest_wal_fsync="always"` policy, fsync'd) — a crash/SIGKILL at any
later point replays the log back to the exact acknowledged state at
the next registration of the table. Frames are atomic units:

    [u32 length][u32 crc32(payload)][payload]

where payload is the canonical JSON `{"seq": N, "rows": [...]}` the
append path already normalized (JSON-native scalars only, timestamps
as epoch-millis under ``__time``), so a replayed batch re-encodes to
bit-identical delta state. A torn tail — a partial frame from a crash
mid-write, or trailing garbage — fails the length/CRC check; `replay`
stops at the last intact frame and truncates the file there, so an
UNacknowledged append is either fully applied (it reached the disk
before the crash) or fully absent — never half-applied.

fsync policy (`EngineConfig.ingest_wal_fsync`):

  "always"    fsync before acknowledging every append (default; the
              durability contract above holds against power loss)
  "interval"  a `wal-flush:<table>` background stage graph
              (executor/stages.py) fsyncs every
              `ingest_wal_flush_interval_s`; appends acknowledge after
              the buffered OS write — process crashes lose nothing,
              power loss may lose the last interval (`synced_seq` in
              `GET /debug/ingest` shows the lag)
  "never"     no fsync (tests/benchmarks; OS-crash durability only)

With the durable sealed-segment store disabled (no
`EngineConfig.ingest_store_dir`) the log is the SOLE durable copy of
appended rows, so recovery cost grows with total appended rows until
the table is re-registered with fresh data — which resets the log
(`WriteAheadLog.reset`). With the store enabled (segments/store.py;
docs/DURABILITY.md), a checkpoint spills the sealed scope and then
`truncate_through(seq)` drops the frames the checkpoint covers, so the
log keeps only the post-checkpoint tail and recovery is O(tail):
replay loads the newest verifiable manifest and applies only frames
past its watermark.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib

_HEADER = struct.Struct("<II")  # payload length, crc32(payload)

# single-frame sanity bound for replay: a corrupt length field must not
# make the reader allocate gigabytes before the CRC check can fail
MAX_FRAME_BYTES = 256 << 20

__all__ = ["WriteAheadLog", "replay_wal", "truncate_file_through",
           "wal_path"]


def wal_path(wal_dir: str, table: str) -> str:
    return os.path.join(wal_dir, f"{table}.wal")


def replay_wal(path: str):
    """Read every intact frame of `path` as a list of (seq, rows)
    records, truncating the file at the first torn/corrupt frame (crash
    mid-write). Missing file -> []."""
    if not os.path.exists(path):
        return []
    out = []
    good_end = 0
    with open(path, "rb") as f:
        while True:
            head = f.read(_HEADER.size)
            if len(head) < _HEADER.size:
                break
            length, crc = _HEADER.unpack(head)
            if length > MAX_FRAME_BYTES:
                break
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                break
            try:
                rec = json.loads(payload.decode("utf-8"))
                rows = rec["rows"]
                seq = int(rec.get("seq", len(out) + 1))
            except Exception:  # noqa: BLE001 — corrupt frame = torn tail
                break
            if out and seq <= out[-1][0]:
                # seq must be strictly increasing: a regression means
                # the tail holds a frame from a failed, rolled-back
                # write that survived anyway — never acknowledged, so
                # cut the log before it like any other torn tail
                break
            out.append((seq, rows))
            good_end = f.tell()
    size = os.path.getsize(path)
    if good_end < size:
        # torn tail: cut it off so the next append doesn't interleave a
        # fresh frame behind garbage the next replay would stop at
        with open(path, "r+b") as f:
            f.truncate(good_end)
    return out


def _split_frames(path: str, through_seq: int) -> tuple[bytes, int]:
    """Raw bytes of every intact frame with seq > `through_seq`, plus
    the count of intact frames dropped. Kept frames are copied verbatim
    (headers + payloads untouched) so their CRCs stay valid; parsing
    stops at the first torn/corrupt frame like `replay_wal` and the
    garbage tail is dropped with the covered prefix."""
    kept = bytearray()
    dropped = 0
    with open(path, "rb") as f:
        while True:
            head = f.read(_HEADER.size)
            if len(head) < _HEADER.size:
                break
            length, crc = _HEADER.unpack(head)
            if length > MAX_FRAME_BYTES:
                break
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                break
            try:
                seq = int(json.loads(payload.decode("utf-8"))["seq"])
            except Exception:  # noqa: BLE001 — corrupt frame = torn tail
                break
            if seq > through_seq:
                kept += head + payload
            else:
                dropped += 1
    return bytes(kept), dropped


def _fsync_dir(path: str) -> None:
    """fsync the directory so a rename inside it is durable (best
    effort: some filesystems refuse directory fds)."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_rewrite(path: str, kept: bytes, do_fsync: bool) -> None:
    """The crash-safe truncation rewrite both truncation paths share:
    kept tail -> temp file -> (fsync) -> rename over the log ->
    directory fsync. A crash at any point leaves either the old or
    the new file, both of which replay correctly against the
    checkpoint watermark."""
    tmp = path + ".trunc"
    with open(tmp, "wb") as f:
        f.write(kept)
        f.flush()
        if do_fsync:
            os.fsync(f.fileno())
    os.rename(tmp, path)
    _fsync_dir(os.path.dirname(path))


def truncate_file_through(path: str, through_seq: int) -> int:
    """Atomically drop frames with seq <= `through_seq` from a log file
    with NO live handle (recovery housekeeping, closed engines).
    Returns the number of frames dropped; missing file -> 0."""
    if through_seq <= 0 or not os.path.exists(path):
        return 0
    kept, dropped = _split_frames(path, through_seq)
    if dropped == 0:
        return 0
    _atomic_rewrite(path, kept, do_fsync=True)
    return dropped


class WriteAheadLog:
    """Append-only framed log for ONE table. Thread-safe; the engine's
    per-table ingest lock already serializes appends, the internal lock
    just keeps the interval-flush graph and close() honest."""

    def __init__(self, path: str, fsync: str = "always",
                 flush_interval_s: float = 0.05,
                 start_seq: int = 0, flush_scheduler=None):
        self.path = path
        self.fsync_mode = str(fsync)
        self.flush_interval_s = max(0.005, float(flush_interval_s))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "ab")
        self._seq = int(start_seq)
        self._synced_seq = int(start_seq)
        self._closed = False
        # a write failure that could not be rolled back: the file may
        # hold an unacknowledged frame, so no further append can be
        # honestly acknowledged until the log is reset
        self.tainted = False
        self.bytes_written = os.path.getsize(path)
        # interval fsync runs as a periodic background stage graph:
        # `flush_scheduler` is StageScheduler.register_periodic (wired
        # by IngestManager._wal_for) instead of one daemon thread per
        # log. With no scheduler, interval mode degrades to fsync on
        # append — strictly MORE durable, never silently lagging.
        self._flush_handle = None
        if self.fsync_mode == "interval" and flush_scheduler is not None:
            self._flush_handle = flush_scheduler(
                f"wal-flush:{os.path.basename(path)}",
                lambda: self.flush_interval_s,
                self._flush_once)

    # ------------------------------------------------------------- write

    @property
    def last_seq(self) -> int:
        return self._seq

    @property
    def synced_seq(self) -> int:
        return self._synced_seq

    def append(self, rows: list) -> tuple[int, int]:
        """Frame + write one batch; returns (seq, total log bytes).
        Under fsync "always" the frame is durable on return."""
        with self._lock:
            if self._closed:
                raise RuntimeError(f"WAL {self.path} is closed")
            if self.tainted:
                raise RuntimeError(
                    f"WAL {self.path} failed a write that could not be "
                    "rolled back; re-register the table to reset it")
            seq = self._seq + 1
            payload = json.dumps({"seq": seq, "rows": rows},
                                 separators=(",", ":")).encode("utf-8")
            frame = _HEADER.pack(len(payload),
                                 zlib.crc32(payload)) + payload
            try:
                self._f.write(frame)
                self._f.flush()
                if self.fsync_mode == "always" or (
                        self.fsync_mode == "interval"
                        and self._flush_handle is None):
                    os.fsync(self._f.fileno())
                    self._synced_seq = seq
            except Exception:
                # the frame may be partially — or fully — on disk but
                # will never be acknowledged: roll the file back to the
                # last acked frame so recovery cannot resurrect it and
                # a later append cannot reuse its seq slot. Close first
                # so buffered residue can't land after the truncate.
                try:
                    try:
                        self._f.close()
                    except (OSError, ValueError):
                        pass
                    os.truncate(self.path, self.bytes_written)
                    self._f = open(self.path, "ab")
                except (OSError, ValueError):
                    self.tainted = True
                raise
            self._seq = seq
            self.bytes_written += len(frame)
        h = self._flush_handle
        if h is not None:
            h.wake()
        return seq, self.bytes_written

    def sync(self):
        """Explicit fsync (close / deterministic tests)."""
        with self._lock:
            if self._closed or self.tainted:
                return
            self._f.flush()
            os.fsync(self._f.fileno())
            self._synced_seq = self._seq

    def _flush_once(self):
        """One interval-fsync tick (the `wal-flush:<table>` background
        graph's body): fsync iff frames landed since the last sync."""
        with self._lock:
            if self._closed:
                return
            if self._synced_seq != self._seq:
                try:
                    self._f.flush()
                    os.fsync(self._f.fileno())
                    self._synced_seq = self._seq
                except (OSError, ValueError):
                    pass  # retried next tick; synced_seq shows lag

    def truncate_through(self, through_seq: int) -> int:
        """Atomically drop frames with seq <= `through_seq` — they are
        covered by a durable sealed-segment checkpoint (the caller
        advances the manifest FIRST; docs/DURABILITY.md). The rewrite
        is temp-write -> fsync -> rename, so a crash mid-truncate
        leaves either the full or the truncated log; both replay
        correctly because recovery filters frames by the checkpoint
        watermark. Returns the number of frames dropped. seq counters
        (`last_seq`/`synced_seq`) are untouched: truncation never
        un-acknowledges anything."""
        if through_seq <= 0:
            return 0
        with self._lock:
            if self._closed:
                raise RuntimeError(f"WAL {self.path} is closed")
            if self.tainted:
                raise RuntimeError(
                    f"WAL {self.path} is tainted; re-register the "
                    "table to reset it")
            self._f.flush()
            kept, dropped = _split_frames(self.path, through_seq)
            if dropped == 0:
                return 0
            # close the append handle BEFORE the rename so no buffered
            # residue can land in the replaced file afterwards
            self._f.close()
            _atomic_rewrite(self.path, kept,
                            do_fsync=self.fsync_mode != "never")
            self._f = open(self.path, "ab")
            self.bytes_written = len(kept)
            return dropped

    # ------------------------------------------------------------- admin

    def reset(self):
        """Truncate to empty (fresh registration over a live table: the
        logged appends belonged to the data being replaced)."""
        with self._lock:
            if self._closed:
                raise RuntimeError(f"WAL {self.path} is closed")
            self._f.truncate(0)
            self._f.seek(0)
            self._f.flush()
            if self.fsync_mode != "never":
                os.fsync(self._f.fileno())
            self._seq = 0
            self._synced_seq = 0
            self.bytes_written = 0
            self.tainted = False

    def close(self, final_sync: bool = True):
        """Flush, fsync, cancel the flush graph, close the file.
        Idempotent; joins an in-progress flush tick so Engine.close()
        is deterministic."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._f.flush()
                if final_sync:
                    os.fsync(self._f.fileno())
                    self._synced_seq = self._seq
            except (OSError, ValueError):
                pass
            self._f.close()
        h = self._flush_handle
        if h is not None:
            h.cancel(join_timeout=5.0)
            self._flush_handle = None

    def delete(self):
        """close + unlink (DROP TABLE cascade)."""
        self.close(final_sync=False)
        try:
            os.unlink(self.path)
        except OSError:
            pass

"""Structured event log: the package's first logging layer.

One JSON object per engine-level occurrence, emitted at the existing
chokepoints (QueryRunner.record, breaker transitions, admission sheds,
cache clears, ingest) — the machine-greppable narrative a latency
histogram cannot tell ("the p99 spike at 14:02 was a breaker trip
followed by 40 sheds"). Two sinks:

- a bounded in-memory ring (`EngineConfig.event_log_limit`), served
  newest-first by `GET /debug/events` — flat memory for a long-running
  server, same contract as the trace rings;
- an optional append-only JSON-lines file (`EngineConfig.
  event_log_path`) for durable shipping into whatever log pipeline the
  deployment runs. File writes happen on a dedicated daemon writer
  thread behind a bounded queue, so a sink that HANGS (dead NFS, full
  blocking pipe) — not just one that raises — can never stall the
  serving threads that emit; write failures back off and retry
  (`_SINK_RETRY_S`), and drops (queue overflow, failed writes) are
  counted in `sink_errors`, surfaced by `GET /debug/events`.

Event shape: `{"ts": epoch-seconds, "seq": N, "event": kind, ...}` with
every field sanitized to JSON-native scalars (via the span-attribute
sanitizer: exceptions and numpy scalars become short strings/numbers),
so the ring and the file always serialize. `emit()` never raises — the
event log observes the query path, it must not be able to fail it.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque

from tpu_olap_torch.obs.trace import _attr_value


def _clean(v, _depth: int = 0):
    """Event-field sanitizer: shallow containers recurse, scalars go
    through the span-attribute sanitizer (one shared implementation:
    JSON-native passthrough, non-finite floats -> None, numpy scalar
    coercion, bounded-string fallback)."""
    if _depth < 3:
        if isinstance(v, (list, tuple)):
            return [_clean(x, _depth + 1) for x in v]
        if isinstance(v, dict):
            return {str(k): _clean(x, _depth + 1) for k, x in v.items()}
    return _attr_value(v)


class EventLog:
    """Thread-safe bounded event ring + optional async JSONL file sink."""

    # seconds to back off after a sink write failure: a transient full
    # disk recovers (the stream resumes, dropped events counted in
    # sink_errors) instead of one EIO silently killing the sink forever
    _SINK_RETRY_S = 30.0
    # pending-write bound: a stalled sink drops (and counts) events past
    # this depth instead of growing host memory without limit
    _SINK_QUEUE_MAX = 4096

    def __init__(self, limit: int = 2048, path: str | None = None,
                 max_bytes: int = 0, rotate_keep: int = 3):
        self.limit = max(1, int(limit))
        self.path = path
        # size-based sink rotation: past max_bytes
        # the file rotates to path.1 (shifting .1 -> .2 ..., keeping
        # `rotate_keep` rotated files) and a sink_rotate event records
        # the roll. 0 = unbounded (the pre-rotation behavior).
        self.max_bytes = max(0, int(max_bytes or 0))
        self.rotate_keep = max(1, int(rotate_keep))
        self.rotations = 0
        self._file_bytes = 0
        self._ring: deque = deque(maxlen=self.limit)
        self._lock = threading.Lock()  # ring only
        self._seq = itertools.count(1)
        self.sink_errors = 0
        # writer-thread state, all under _wcv: emitters enqueue and
        # return; only the daemon writer touches the file
        self._wcv = threading.Condition()
        self._wq: deque = deque()
        self._writer_started = False
        self._writing = False
        self._closed = False
        self._file = None
        self._file_fail_until = 0.0  # monotonic backoff deadline

    # ------------------------------------------------------------- emit

    def emit(self, event: str, **fields) -> dict:
        """Append one event. Never raises, never blocks on the sink."""
        rec = {"ts": round(time.time(), 3), "seq": next(self._seq),
               "event": str(event)}
        for k, v in fields.items():
            rec[k] = _clean(v)
        with self._lock:
            self._ring.append(rec)
        if self.path is not None:
            self._enqueue(rec)
        return rec

    def snapshot(self, n: int | None = None) -> list:
        """Newest-first copy of the ring (bounded by `n`)."""
        with self._lock:
            out = list(self._ring)
        out.reverse()
        return out if n is None else out[: max(0, int(n))]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -------------------------------------------------------- file sink

    def _enqueue(self, rec: dict):
        with self._wcv:
            if self._closed:
                return
            if not self._writer_started:
                self._writer_started = True
                threading.Thread(target=self._drain, daemon=True,
                                 name="tpu-olap-event-sink").start()
            if len(self._wq) >= self._SINK_QUEUE_MAX:
                self.sink_errors += 1  # stalled sink: drop, count, go on
                return
            self._wq.append(rec)
            self._wcv.notify_all()

    def _drain(self):
        """Writer thread: the ONLY place file I/O happens. Two racing
        writers can't exist, so writes need no lock and a hang costs
        this daemon thread alone — emitters just see the queue fill."""
        while True:
            with self._wcv:
                while not self._wq and not self._closed:
                    self._wcv.wait(1.0)
                if not self._wq and self._closed:
                    return
                rec = self._wq.popleft()
                self._writing = True
            try:
                self._write_rec(rec)
            finally:
                with self._wcv:
                    self._writing = False
                    self._wcv.notify_all()

    def _write_rec(self, rec: dict):
        if time.monotonic() < self._file_fail_until:
            with self._wcv:
                self.sink_errors += 1
            return
        try:
            if self._file is None:
                self._file = open(self.path, "a", buffering=1)
                import os
                try:
                    self._file_bytes = os.path.getsize(self.path)
                except OSError:
                    self._file_bytes = 0
            line = json.dumps(rec, default=str) + "\n"
            self._file.write(line)
            self._file_bytes += len(line)
            if self.max_bytes and self._file_bytes >= self.max_bytes:
                self._rotate()
        except Exception:  # noqa: BLE001 — sink failure ≠ query failure
            with self._wcv:
                self.sink_errors += 1
            self._file_fail_until = time.monotonic() + self._SINK_RETRY_S
            if self._file is not None:
                try:
                    self._file.close()
                except Exception:  # noqa: BLE001
                    pass
                self._file = None

    def _rotate(self):
        """Size-based roll, on the writer thread (the only file-I/O
        site, so no locking): path -> path.1, shifting existing .N up
        and dropping past rotate_keep. The sink_rotate event lands in
        the ring AND (via the queue) as the fresh file's first lines."""
        import os
        try:
            self._file.close()
        except Exception:  # noqa: BLE001
            pass
        self._file = None
        rotated_bytes = self._file_bytes
        self._file_bytes = 0
        try:
            drop = f"{self.path}.{self.rotate_keep}"
            if os.path.exists(drop):
                os.unlink(drop)
            for i in range(self.rotate_keep - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            os.replace(self.path, f"{self.path}.1")
        except OSError:
            with self._wcv:
                self.sink_errors += 1
            return
        self.rotations += 1
        self.emit("sink_rotate", path=self.path,
                  rotated_bytes=rotated_bytes, keep=self.rotate_keep,
                  rotations=self.rotations)

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until queued sink writes drain (tests, shutdown).
        False if the sink did not catch up within `timeout`."""
        if self.path is None:
            return True
        deadline = time.monotonic() + timeout
        with self._wcv:
            while self._wq or self._writing:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._wcv.wait(min(remaining, 0.1))
        return True

    def close(self):
        with self._wcv:
            self._closed = True
            self._wcv.notify_all()
        self.flush(1.0)
        if self._file is not None:
            try:
                self._file.close()
            except Exception:  # noqa: BLE001
                pass
            self._file = None

"""Device-side profiling: Chrome-trace export and on-demand torch.profiler
capture, the counterpart of the JAX package's obs/profile.py.

Two complementary views of where a query's time goes:

1. **Span-tree timelines** (`chrome_trace`): the host-side span trees
   obs.trace already records, exported in the Chrome Trace Event format
   (the JSON flavor Perfetto / chrome://tracing load natively). Spans
   become complete (`"ph": "X"`) events positioned by the trace root's
   wall-clock `started_at` plus each span's monotonic `start_ms` offset,
   so concurrent queries — and the legs of a fused shared-scan batch —
   lay out side by side on one timeline. Served by `GET /debug/profile`.

2. **torch.profiler capture** (`capture_device_profile`, `POST
   /debug/profile?ms=N`, and per statement under
   `EngineConfig.profile_dir`, `profile_query`): a torch.profiler session
   over CPU and, where the card is visible, CUDA activity, written with
   `export_chrome_trace` as `trace.json` in its directory; a CUDA
   session opens with SESSION_PRIMERS tiny kernels, the first the
   profiler may drop. While a session is live, QueryRunner._dispatch runs each dispatch under
   `annotate_dispatch(query_id)`: a `torch.profiler.record_function`
   range named by the query id, and a record of every generated-kernel
   launch the dispatch makes (`note_launch`, called by
   kernels.cuda_build). torch.profiler keeps record_function ranges of
   the thread that started the session only, while CUPTI sees the
   launches of every thread (checked on an H100 with torch 2.11: a
   range opened on another thread is absent from the trace, that
   thread's `cuLaunchKernel` events and their kernels are there, under
   the absolute value of the thread's pthread id cast to a signed
   32-bit integer, where the session's own thread shows its native
   id). So when the session ends,
   `annotate_trace` ties each recorded launch to its host
   `cuLaunchKernel` event (the launching thread's launches, in order)
   and, through the event's correlation id, to its device kernel, and
   writes the query id into both events' args (`"query_id"`). A capture
   started on an HTTP handler thread thereby shows each kernel of the
   query that launched it, whichever thread that was.

`prepare()` opens the process's first session on the thread that starts
the server (see its docstring). One torch.profiler session runs in the
process at a time (a second one would stop the first's): a capture that meets another capture degrades
with "capture already in progress", one that meets a profiled statement
degrades with the start failure, and a profiled statement that meets any
session raises RuntimeError — the JAX package's behaviour with
jax.profiler. The annotation costs one module-flag probe while no
session is live.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time

# ----------------------------------------------------- chrome-trace export

# one pid for the whole engine process; tids are assigned per trace so
# concurrent queries stack as separate rows under one process group
_PID = os.getpid()


def _span_events(trace, tid: int) -> list:
    """One trace -> complete events. Every span of a trace shares the
    trace's tid (a query is one logical timeline): batch legs therefore
    land on the same row as their shared-scan parent, nested by ts/dur
    containment — exactly how Perfetto renders sub-slices."""
    base_us = trace.started_at * 1e6
    events = []
    for depth, s in trace.walk():
        if s.start_ms is None or s.duration_ms is None:
            continue  # never entered / still open: not placeable
        args = dict(s.attrs)
        if depth == 0:
            args.setdefault("query_id", trace.query_id)
        events.append({
            "name": s.name,
            "ph": "X",
            "cat": "query",
            "ts": base_us + s.start_ms * 1000.0,
            "dur": max(0.0, s.duration_ms * 1000.0),
            "pid": _PID,
            "tid": tid,
            **({"args": args} if args else {}),
        })
    return events


def chrome_trace(traces) -> dict:
    """Export completed Trace objects (obs.trace.Tracer rings) as a
    Chrome Trace Event JSON object: {"traceEvents": [...]} with `ts` /
    `dur` in microseconds — loads directly in Perfetto. Traces get one
    tid each, named by query_id via thread_name metadata events."""
    events = []
    for i, t in enumerate(traces):
        tid = i + 1
        events.append({
            "name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
            "args": {"name": f"query {getattr(t, 'query_id', tid)}"},
        })
        events.extend(_span_events(t, tid))
    return {
        "traceEvents": [{
            "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
            "args": {"name": "tpu_olap"},
        }] + events,
        "displayTimeUnit": "ms",
    }


# ----------------------------------------------- torch.profiler sessions

# one capture_device_profile at a time, and one torch.profiler session
# of any kind (capture or profiled statement) in the process
_capture_lock = threading.Lock()
_session_lock = threading.Lock()
_capture_active = False
# while a session is live: ((native thread id, |pthread id as int32|),
# query id, kernel name) of every generated-kernel launch, in launch
# order
_launch_log: list | None = None
_launch_mu = threading.Lock()
_tls = threading.local()    # the query id of this thread's dispatch

# bounds for POST /debug/profile?ms=N — a capture blocks one handler
# thread and profiler buffers grow with the window
CAPTURE_MS_DEFAULT = 1000
CAPTURE_MS_MAX = 60_000
TRACE_FILE = "trace.json"
# tiny kernels (torch.cuda._sleep) that open each CUDA session: on an
# H100 with torch 2.11, late in a long process, a session lost its first
# kernels (24 of them, once), so these are the ones it loses
SESSION_PRIMERS = 64
# the JAX package's message when a second jax.profiler trace starts
ALREADY_STARTED = ("Profile has already been started. Only one profile "
                   "may be run at a time.")


def capture_active() -> bool:
    return _capture_active


# one shared no-op context: nullcontext is stateless/re-enterable, so
# every non-captured dispatch reuses this instance allocation-free
_NULL_CM = contextlib.nullcontext()


class _Annotation:
    """One dispatch inside a live session: a record_function range named
    by the query id, and the query id on this thread for note_launch."""

    def __init__(self, query_id: str):
        self.query_id = query_id
        self._range = None
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "query_id", None)
        _tls.query_id = self.query_id
        try:
            import torch
            self._range = torch.profiler.record_function(self.query_id)
            self._range.__enter__()
        except Exception:  # noqa: BLE001 — annotation is best-effort
            self._range = None
        return self

    def __exit__(self, *exc):
        try:
            if self._range is not None:
                self._range.__exit__(*exc)
        finally:
            _tls.query_id = self._prev
        return False


def annotate_dispatch(query_id: str | None):
    """Context manager wrapping one device dispatch. While a
    torch.profiler session is live, the dispatch's launches are tied to
    `query_id` (see the module docstring); otherwise (the perpetual
    common case) it is a no-op that costs one module-flag probe."""
    if not _capture_active or query_id is None:
        return _NULL_CM
    return _Annotation(str(query_id))


def note_launch(kernel: str):
    """Record one generated-kernel launch on this thread (called by
    kernels.cuda_build while a session is live)."""
    log = _launch_log
    if log is None:
        return
    ident = threading.get_ident() & 0xFFFFFFFF
    ids = (threading.get_native_id(),
           (1 << 32) - ident if ident >= 1 << 31 else ident)
    with _launch_mu:
        log.append((ids, getattr(_tls, "query_id", None), kernel))


def annotate_trace(path: str, launches: list) -> int:
    """Write each recorded launch's query id into the exported trace at
    `path`: the launching thread's host `cuLaunchKernel` events whose
    device kernel (same correlation id) has a recorded kernel name are
    paired, in order, with that thread's recorded launches (from the
    newest back, should the profiler have lost early ones), and both
    the host event and the kernel get args["query_id"]. A thread is the
    trace's tid that equals its native id, else the absolute value of
    its pthread id as a signed 32-bit integer (threads that reuse a
    finished thread's pthread id share its tid, and their launches
    follow each other in time). Returns the number of kernels
    annotated."""
    if not any(qid for _tid, qid, _k in launches):
        return 0
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", [])
    names = {k for _t, _q, k in launches}
    kernels = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel" \
                and e.get("name") in names:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                kernels[corr] = e
    host: dict = {}
    for e in events:
        if e.get("ph") != "X" or not str(e.get("name", "")) \
                .startswith("cuLaunchKernel"):
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr in kernels:
            host.setdefault(e.get("tid"), []).append(e)
    by_tid: dict = {}
    for (native, ident), qid, kernel in launches:
        tid = native if native in host else ident
        by_tid.setdefault(tid, []).append((qid, kernel))
    n = 0
    for tid, recorded in by_tid.items():
        calls = sorted(host.get(tid, ()), key=lambda e: e["ts"])
        for (qid, kernel), call in zip(reversed(recorded),
                                       reversed(calls)):
            kern = kernels[call["args"]["correlation"]]
            if qid is None or kern.get("name") != kernel:
                continue
            call["args"]["query_id"] = qid
            kern.setdefault("args", {})["query_id"] = qid
            n += 1
    with open(path, "w") as f:
        json.dump(doc, f)
    return n


class _Session:
    """One torch.profiler session writing `trace_dir/trace.json`."""

    def __init__(self, trace_dir: str, cuda: bool):
        self.trace_dir = trace_dir
        self.cuda = cuda
        self.prof = None

    def start(self):
        global _capture_active, _launch_log
        if not _session_lock.acquire(blocking=False):
            raise RuntimeError(ALREADY_STARTED)
        try:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            _launch_log = []
            self.prof.__enter__()
            if self.cuda:
                import torch
                for _ in range(SESSION_PRIMERS):
                    torch.cuda._sleep(100)
            _capture_active = True
        except BaseException:
            _launch_log = None
            _session_lock.release()
            raise

    def stop(self) -> int:
        """End the session (after the card has run what was launched in
        it), export the trace and annotate it; the number of kernels
        annotated with a query id."""
        global _capture_active, _launch_log
        try:
            if self.cuda:
                import torch
                torch.cuda.synchronize()
        finally:
            _capture_active = False
            try:
                self.prof.__exit__(None, None, None)
            finally:
                launches, _launch_log = _launch_log or [], None
                _session_lock.release()
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir, TRACE_FILE)
        self.prof.export_chrome_trace(path)
        return annotate_trace(path, launches)


def prepare():
    """One empty CPU and CUDA torch.profiler session on the calling
    thread, where the card is visible; QueryServer.start calls it. On
    an H100 with torch 2.11, a process whose first session started on
    an HTTP handler thread recorded no event at all in it (Kineto
    printed "External init callback must run in same thread as
    registerClient"), while its later sessions were whole; with this
    session first, on the thread that starts the server, the first
    capture was whole too."""
    try:
        import torch
        if not torch.cuda.is_available():
            return
        from torch.profiler import ProfilerActivity, profile
    except Exception:  # noqa: BLE001 — no profiler: captures degrade
        return
    with _session_lock:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            pass


@contextlib.contextmanager
def profile_query(trace_dir: str, cuda: bool):
    """One statement under its own session (EngineConfig.profile_dir).
    Raises RuntimeError when another session is live."""
    sess = _Session(trace_dir, cuda)
    sess.start()
    try:
        yield sess
    finally:
        sess.stop()


def capture_device_profile(ms: float, trace_dir: str | None = None) -> dict:
    """Run a torch.profiler capture for `ms` milliseconds and return a
    structured result:

        {"ok": true, "trace_dir": ..., "ms": N}            on success
        {"ok": false, "reason": ...}                       degraded

    The capture is synchronous (the caller's thread sleeps out the
    window) but the engine keeps serving — launches inside the window
    carry their query_id into the trace (annotate_dispatch). CUDA
    activity is recorded where torch sees the card. Exactly one capture
    runs at a time; a second request while one is live degrades with
    "capture already in progress" instead of stopping the first."""
    ms = max(1.0, min(float(ms), float(CAPTURE_MS_MAX)))
    try:
        import torch
        import torch.profiler  # noqa: F401
    except Exception as e:  # noqa: BLE001 — torch absent/broken: degrade
        return {"ok": False, "reason": f"torch.profiler unavailable: {e}"}
    if not _capture_lock.acquire(blocking=False):
        return {"ok": False, "reason": "capture already in progress"}
    try:
        if trace_dir is None:
            trace_dir = tempfile.mkdtemp(prefix="tpu_olap_profile_")
        sess = _Session(trace_dir, cuda=torch.cuda.is_available())
        try:
            sess.start()
        except Exception as e:  # noqa: BLE001 — session refused: degrade
            return {"ok": False,
                    "reason": f"torch.profiler start failed: {e}"}
        try:
            time.sleep(ms / 1000.0)
        finally:
            stopped, err = True, None
            try:
                sess.stop()
            except Exception as e:  # noqa: BLE001 — partial capture
                stopped, err = False, e
        if not stopped:
            return {"ok": False, "trace_dir": trace_dir,
                    "reason": f"torch.profiler stop failed: {err}"}
        return {"ok": True, "trace_dir": trace_dir, "ms": ms}
    finally:
        _capture_lock.release()

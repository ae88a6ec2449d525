"""Lightweight span tree tracing for the query path (SURVEY.md §6).

A `Trace` is a per-query root span carrying a `query_id`; stages open
child spans through the context-manager API:

    with tracer.trace("sql", sql=text) as root:
        with root.span("parse"):
            ...
        with span("plan") as sp:          # module-level: child of current
            sp.set("rewritten", True)

Propagation is via `contextvars`, so nested layers (engine → runner →
kernels) need no plumbing: `span(name)` attaches to whatever span is
current, and returns the no-op `NULL_SPAN` when no trace is active —
tracing costs two perf_counter() calls per stage when on, one dict probe
when off. Cross-thread dispatch (the deadline watchdog runs the device
call on a fresh thread, executor.runner._join_abandoning) propagates by
running the work inside a `contextvars.copy_context()` snapshot.

Clocks are monotonic (`time.perf_counter`); wall timestamps are recorded
once per trace root for display only. Completed traces land in the
tracer's bounded recent-ring, and traces slower than `slow_ms` also land
in the slow-query ring, both served by `GET /debug/queries`
(api.server).

A copy of the JAX package's obs/trace.py: the same span names, the same
contextvars, so that a port trace reads like a reference trace.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time

_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "tpu_olap_current_span", default=None)
_current_qid: contextvars.ContextVar = contextvars.ContextVar(
    "tpu_olap_current_query_id", default=None)
_nested_exec: contextvars.ContextVar = contextvars.ContextVar(
    "tpu_olap_nested_exec", default=False)
_traceparent: contextvars.ContextVar = contextvars.ContextVar(
    "tpu_olap_traceparent", default=None)

# attribute values are clipped at record time so a span tree is always
# JSON-small (an exception repr or a full SQL text must not bloat the
# debug ring)
_ATTR_MAX_CHARS = 300


def short_str(value, limit: int = _ATTR_MAX_CHARS) -> str:
    """Exception-safe short rendering: any value -> a bounded str."""
    if isinstance(value, BaseException):
        value = f"{type(value).__name__}: {value}"
    s = value if isinstance(value, str) else str(value)
    return s if len(s) <= limit else s[: limit - 1] + "…"


def _attr_value(value):
    """Span-attribute sanitizer: JSON-native scalars pass through,
    everything else (exceptions, numpy scalars, specs) becomes a short
    string — the span tree must always serialize."""
    if value is None or isinstance(value, (bool, int)):
        return value
    if isinstance(value, float):
        return value if value == value and abs(value) != float("inf") \
            else None
    try:  # numpy scalars quack like their python cousins
        import numpy as np
        if isinstance(value, np.bool_):
            return bool(value)
        if isinstance(value, np.integer):
            return int(value)
        if isinstance(value, np.floating):
            return _attr_value(float(value))
    except Exception:  # noqa: BLE001 — numpy absent or exotic scalar
        pass
    return short_str(value)


class Span:
    """One timed stage. Children append in call order; duration is set on
    context exit (monotonic). Thread-compatible: each span is entered and
    exited on one thread; concurrent siblings guard the children list
    with the owning trace's lock."""

    __slots__ = ("name", "attrs", "children", "t0", "start_ms",
                 "duration_ms", "_token", "_trace")

    def __init__(self, name: str, trace: "Trace | None" = None):
        self.name = name
        self.attrs: dict = {}
        self.children: list = []
        self.t0: float | None = None
        self.start_ms: float | None = None  # offset from the trace root
        self.duration_ms: float | None = None
        self._token = None
        self._trace = trace

    # ------------------------------------------------------------- build

    def span(self, name: str, **attrs) -> "Span":
        child = Span(name, self._trace)
        if attrs:
            child.set(**attrs)
        tr = self._trace
        if tr is not None:
            with tr._lock:
                self.children.append(child)
        else:
            self.children.append(child)
        return child

    def set(self, **attrs) -> "Span":
        for k, v in attrs.items():
            self.attrs[k] = _attr_value(v)
        return self

    # --------------------------------------------------------- lifecycle

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        # start position on the trace timeline: offset from the root's
        # monotonic t0 (perf_counter is one clock across threads, so
        # cross-thread dispatch spans position correctly). Without it a
        # tree has durations but no layout — concurrent legs could not
        # be placed on a timeline (obs.profile's Chrome-trace export).
        tr = self._trace
        self.start_ms = 0.0 if tr is self or tr is None or tr.t0 is None \
            else (self.t0 - tr.t0) * 1000
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.duration_ms = (time.perf_counter() - self.t0) * 1000
        if exc is not None:
            self.set(error=exc)
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None
        return False

    # ------------------------------------------------------------ export

    def to_json(self) -> dict:
        out = {"name": self.name,
               "start_ms": None if self.start_ms is None
               else round(self.start_ms, 3),
               "duration_ms": None if self.duration_ms is None
               else round(self.duration_ms, 3)}
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.children:
            out["children"] = [c.to_json() for c in self.children]
        return out

    def walk(self, depth: int = 0):
        yield depth, self
        for c in self.children:
            yield from c.walk(depth + 1)


class _NullSpan:
    """Tracing off / no active trace: every operation is a no-op, so call
    sites never branch on enablement."""

    __slots__ = ()

    def span(self, name: str, **attrs) -> "_NullSpan":
        return self

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def to_json(self) -> dict:
        return {}


NULL_SPAN = _NullSpan()


def current_span():
    """The active Span of this context, or NULL_SPAN."""
    cur = _current_span.get()
    return cur if cur is not None else NULL_SPAN


def current_query_id() -> str | None:
    """query_id of the active trace, or None."""
    return _current_qid.get()


def span(name: str, **attrs):
    """Open a child of the current span (context manager). No active
    trace -> NULL_SPAN, so instrumented layers pay one contextvar probe
    when tracing is off."""
    cur = _current_span.get()
    if cur is None:
        return NULL_SPAN
    return cur.span(name, **attrs)


class nested_execution:
    """Marks statements executed INSIDE another statement (grouping-sets
    legs, planner subqueries, fallback derived tables). Their records
    keep history/metrics behavior, but QueryRunner.record() excludes
    them from the SLO and the `query` event stream — one served
    response must yield exactly one event + one SLO observation, not
    one per internal leg."""

    __slots__ = ("_token",)

    def __enter__(self):
        self._token = _nested_exec.set(True)
        return self

    def __exit__(self, exc_type, exc, tb):
        _nested_exec.reset(self._token)
        return False


def in_nested_execution() -> bool:
    return _nested_exec.get()


# ------------------------------------------------- W3C trace context

# traceparent per the W3C Trace Context spec (version 00):
#   00-<32 hex trace-id>-<16 hex parent-id>-<2 hex flags>
# The engine is a participant, not an originator: a valid incoming
# header is stamped on the root span and every query record, so the
# fleet router (ROADMAP item 2) can join one distributed trace across
# replicas. Invalid headers are dropped silently per the spec.
import re as _re

_TRACEPARENT_RE = _re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def parse_traceparent(value) -> dict | None:
    """{'traceparent', 'trace_id', 'parent_id', 'flags'} for a valid
    W3C traceparent header, else None. All-zero trace/parent ids are
    invalid per the spec; future versions (>00) are accepted as long
    as they carry the version-00 prefix fields."""
    if not isinstance(value, str):
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    version, trace_id, parent_id, flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or parent_id == "0" * 16:
        return None
    return {"traceparent": m.group(0), "trace_id": trace_id,
            "parent_id": parent_id, "flags": flags}


class use_traceparent:
    """Propagate an incoming (already-validated) traceparent header for
    a scope, so QueryRunner.record() can stamp it onto every query
    record the scope produces. `None` is a no-op scope."""

    __slots__ = ("value", "_token")

    def __init__(self, value: str | None):
        self.value = value
        self._token = None

    def __enter__(self):
        if self.value is not None:
            self._token = _traceparent.set(self.value)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _traceparent.reset(self._token)
            self._token = None
        return False


def current_traceparent() -> str | None:
    return _traceparent.get()


class detached_trace:
    """Detach the span/query-id context for a scope: instrumented code
    inside sees no active trace, so its spans are NULL_SPAN no-ops.
    Used by sys.* introspection statements running INSIDE another
    live trace (a /sql/batch submission) — their fallback spans must
    not leak into the submitting trace's ring/Perfetto export
    (introspection appears nowhere in its own stats)."""

    __slots__ = ("_t_span", "_t_qid")

    def __enter__(self):
        self._t_span = _current_span.set(None)
        self._t_qid = _current_qid.set(None)
        return self

    def __exit__(self, exc_type, exc, tb):
        _current_span.reset(self._t_span)
        _current_qid.reset(self._t_qid)
        return False


class use_query_id:
    """Override the propagated query_id for a scope WITHOUT re-rooting
    the span tree — Engine.sql_batch runs each non-fused statement
    inside the one sql_batch trace, but every statement's history
    records must carry that statement's own id."""

    def __init__(self, query_id: str | None):
        self.query_id = query_id
        self._token = None

    def __enter__(self):
        if self.query_id is not None:
            self._token = _current_qid.set(self.query_id)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _current_qid.reset(self._token)
            self._token = None
        return False


class Trace(Span):
    """Root span of one query. Carries the query_id (propagated through
    a second contextvar so flat metric records can stamp it without a
    parent pointer walk) and hands itself to the tracer's rings on
    exit."""

    __slots__ = ("query_id", "started_at", "_qid_token", "_lock",
                 "_tracer")

    def __init__(self, name: str, query_id: str, tracer: "Tracer"):
        super().__init__(name, trace=None)
        self._trace = self  # children funnel through this trace's lock
        self._lock = threading.Lock()
        self.query_id = query_id
        self.started_at = time.time()  # display only; durations are mono
        self._qid_token = None
        self._tracer = tracer

    def __enter__(self) -> "Trace":
        self._qid_token = _current_qid.set(self.query_id)
        return super().__enter__()

    def __exit__(self, exc_type, exc, tb):
        super().__exit__(exc_type, exc, tb)
        _current_qid.reset(self._qid_token)
        self._tracer._finished(self)
        return False

    def to_json(self) -> dict:
        out = super().to_json()
        out["query_id"] = self.query_id
        out["started_at"] = round(self.started_at, 3)
        # flat per-stage summary of the graph's `stage:<name>` spans
        # (executor/stages.py), so GET /debug/queries readers get the
        # stage walk without re-walking the span tree
        stages = [{"stage": s.name[6:],
                   "run_ms": round(s.duration_ms, 3),
                   "wait_ms": s.attrs.get("queue_wait_ms", 0.0)}
                  for _, s in self.walk()
                  if s.name.startswith("stage:")
                  and s.duration_ms is not None]
        if stages:
            out["stages"] = stages
        return out


class Tracer:
    """Engine-level trace factory + bounded retention.

    `recent` keeps the last `ring_limit` completed traces; `slow` keeps
    the last `slow_limit` traces whose root duration met `slow_ms`
    (the slow-query log, GET /debug/queries?). Both are plain ring
    lists under one lock — appends are O(1) amortized and the rings are
    small by construction, so a long-running server's memory is flat."""

    def __init__(self, enabled: bool = True, ring_limit: int = 128,
                 slow_ms: float = 250.0, slow_limit: int = 64):
        self.enabled = enabled
        self.ring_limit = max(1, int(ring_limit))
        self.slow_ms = float(slow_ms)
        self.slow_limit = max(1, int(slow_limit))
        self.recent: list = []
        self.slow: list = []
        self.last: Trace | None = None
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        # distinct engines in one process must not collide on query_ids
        self._stamp = f"{os.getpid() & 0xffff:04x}{id(self) & 0xfff:03x}"

    def new_query_id(self) -> str:
        return f"q{self._stamp}-{next(self._seq):06d}"

    def trace(self, name: str, query_id: str | None = None, **attrs):
        """Start a root span (context manager). Disabled -> NULL_SPAN."""
        if not self.enabled:
            return NULL_SPAN
        t = Trace(name, query_id or self.new_query_id(), self)
        if attrs:
            t.set(**attrs)
        return t

    def _finished(self, trace: Trace):
        with self._lock:
            self.last = trace
            self.recent.append(trace)
            if len(self.recent) > self.ring_limit:
                del self.recent[0]
            if (trace.duration_ms or 0.0) >= self.slow_ms:
                self.slow.append(trace)
                if len(self.slow) > self.slow_limit:
                    del self.slow[0]

    def recent_traces(self, limit: int | None = None) -> list:
        """Completed Trace OBJECTS from the recent ring (oldest first),
        for exporters that need spans rather than the JSON snapshot
        (obs.profile.chrome_trace)."""
        with self._lock:
            recent = list(self.recent)
        if limit is None:
            return recent
        return recent[-limit:] if limit > 0 else []

    def snapshot(self, limit: int | None = None) -> dict:
        """JSON view for GET /debug/queries: recent span trees (newest
        first) + the slow-query ring."""
        with self._lock:
            recent = list(self.recent)
            slow = list(self.slow)
        if limit is not None:
            # -0 would slice the WHOLE list: n=0 must mean "none"
            recent = recent[-limit:] if limit > 0 else []
            slow = slow[-limit:] if limit > 0 else []
        return {
            "slow_query_ms": self.slow_ms,
            "recent": [t.to_json() for t in reversed(recent)],
            "slow": [t.to_json() for t in reversed(slow)],
        }


def phase_totals(root: Span) -> dict:
    """Per-phase SELF time (duration minus timed children), summed by
    name over the whole tree — the per-phase summary bench.py banks
    (`--span-summary`). Self time makes phases additive: container spans
    (execute, dispatch-with-host-transfer, shared-scan) contribute only
    their own overhead, so the phases sum to within the root's total
    instead of double-counting every nesting level."""
    out: dict = {}
    for depth, s in root.walk():
        if depth == 0 or s.duration_ms is None:
            continue
        self_ms = s.duration_ms - sum(
            c.duration_ms for c in s.children
            if c.duration_ms is not None)
        out[s.name] = out.get(s.name, 0.0) + max(0.0, self_ms)
    return out

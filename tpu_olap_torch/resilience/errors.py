"""Structured error taxonomy for the query path (docs/RESILIENCE.md).

Every QueryError carries a stable machine-readable `code`, a `retriable`
hint (may the client retry the same request later?), and the
`http_status` a server maps it to — so clients can tell "retry later"
(429/503/504) from "your SQL is wrong" (400) without parsing message
text. The fallback interpreter's refusal (planner.fallback.FallbackError)
subclasses it, the cube DDL's refusals raise `UserError`, admission
sheds `QueryShed`, the open breaker refuses with `BreakerOpen`, a full
delta sheds appends with `IngestBackpressure`; `DeviceFailure` and
`InternalError` complete the JAX package's tree. The per-query
deadline's `QueryDeadlineExceeded` is defined where the JAX package
defines it, in executor.runner, and exported by the package
(resilience.QueryDeadlineExceeded).
"""

from __future__ import annotations


class QueryError(Exception):
    """Base of the taxonomy. `code` is stable and machine-readable;
    `retriable` means the same request may succeed later (transient
    overload / sick device), not that the client should hammer;
    `http_status` is what a server maps the error to."""

    code = "internal"
    retriable = False
    http_status = 500

    def to_json(self) -> dict:
        return {"error": str(self), "code": self.code,
                "retriable": self.retriable}


class UserError(QueryError, ValueError):
    """The request itself is wrong (bad SQL, unknown table, malformed
    query JSON or cube spec): retrying the same request can never
    succeed."""

    code = "user_error"
    retriable = False
    http_status = 400


class QueryShed(QueryError):
    """Admission control rejected the query: the dispatch queue is full,
    or the query's remaining deadline budget cannot cover the expected
    queue wait (shedding now beats timing out later). Transient by
    definition — retry with backoff."""

    code = "shed"
    retriable = True
    http_status = 429

    def __init__(self, msg: str, reason: str = "queue_full"):
        super().__init__(msg)
        self.reason = reason


class BreakerOpen(QueryError):
    """The device circuit breaker is open: consecutive failures tripped
    it and the healer has not yet closed it. `retry_after_s` is the
    cooldown remaining — the server sends it as Retry-After."""

    code = "breaker_open"
    retriable = True
    http_status = 503

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = max(0.0, float(retry_after_s))


class IngestBackpressure(QueryError):
    """Real-time append rejected: the table's in-memory delta is at
    `ingest_max_delta_rows` and accepting more would grow host memory
    unboundedly ahead of the compactor. Explicit 429 + Retry-After —
    never a silent drop; retry after the compactor drains the delta
    (docs/INGEST.md)."""

    code = "ingest_backpressure"
    retriable = True
    http_status = 429

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = max(0.0, float(retry_after_s))


class DeviceFailure(QueryError):
    """Device dispatch failed after retries exhausted and no fallback
    was available (fallback_on_device_failure=False, or a raw-IR
    passthrough with no interpreter equivalent)."""

    code = "device_failure"
    retriable = True
    http_status = 500


class InternalError(QueryError, RuntimeError):
    """Engine-internal invariant violation (e.g. a batch leader exiting
    without producing a result). A bug, not a client problem."""

    code = "internal"
    retriable = False
    http_status = 500

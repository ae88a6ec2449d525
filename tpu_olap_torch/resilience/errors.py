"""Structured error taxonomy for the query path (docs/RESILIENCE.md).

Every QueryError carries a stable machine-readable `code`, a `retriable`
hint (may the client retry the same request later?), and the
`http_status` a server maps it to — so clients can tell "retry later"
(429/503/504) from "your SQL is wrong" (400) without parsing message
text. The fallback interpreter's refusal (planner.fallback.FallbackError)
subclasses it, and the cube DDL's refusals raise `UserError`. The JAX
package's other members (shed, breaker, ingest backpressure, device
failure) belong to subsystems this package does not have yet.
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

"""Resilience layer: structured errors, admission control, the circuit
breaker and generalized fault injection, as in the JAX package.

- errors:    the QueryError taxonomy (code / retriable / http_status):
             QueryShed, BreakerOpen, IngestBackpressure, DeviceFailure,
             InternalError and UserError
- admission: the bounded device-dispatch queue (max inflight + max
             queued, deadline-aware shedding)
- breaker:   the circuit breaker on consecutive device failures, with a
             background healer thread that half-opens through the
             runner's device probe (a stream synchronize on the card)
             while fallback-capable statements are served by the
             interpreter (path "fallback_breaker")
- faults:    the EngineConfig.fault_injector sites (dispatch /
             host-transfer / reprobe / ingest / batch-leg / append /
             wal-write / wal-replay / compact / spill-write /
             manifest-swap / store-load / wal-truncate / stage-*)

`QueryDeadlineExceeded` (the per-query deadline's error, code
"deadline_exceeded", HTTP 504) lives in executor.runner, as in the JAX
package, and is exported here too (loaded on first use: the runner
imports this package). The admission controller and the breaker report
into the runner's metrics registry and event log.
"""

from tpu_olap_torch.resilience.admission import AdmissionController
from tpu_olap_torch.resilience.breaker import CircuitBreaker
from tpu_olap_torch.resilience.errors import (BreakerOpen, DeviceFailure,
                                              IngestBackpressure,
                                              InternalError, QueryError,
                                              QueryShed, UserError)
from tpu_olap_torch.resilience.faults import FaultInjector, maybe_inject

__all__ = [
    "AdmissionController", "BreakerOpen", "CircuitBreaker",
    "DeviceFailure", "FaultInjector", "IngestBackpressure",
    "InternalError", "QueryDeadlineExceeded", "QueryError", "QueryShed",
    "UserError", "maybe_inject",
]


def __getattr__(name):
    if name == "QueryDeadlineExceeded":
        from tpu_olap_torch.executor.runner import QueryDeadlineExceeded
        return QueryDeadlineExceeded
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

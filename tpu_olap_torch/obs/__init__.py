"""Observability, as in the JAX package: `trace` yields a per-query span
tree (parse → plan → lower → prepare → dispatch → host-transfer →
finalize → post-agg → assemble, with batch legs nested under their
shared-scan span), `metrics` keeps incrementally updated counters,
gauges and histograms rendered in the Prometheus text format (the same
`tpu_olap` namespace and metric names as the JAX package), `events` is
the structured JSON-lines event log, `slo` tracks the latency objective
with a burn-rate gauge, and `workload` is the query-template profiler
behind the cube advisor. The runner feeds all of them through
`QueryRunner.record`.

`obs/profile` (torch.profiler in place of the JAX profiler),
`obs/timeseries` and `obs/sentinel` come with the rest of ROADMAP queue
A item 14.
"""

from tpu_olap_torch.obs.events import EventLog  # noqa: F401
from tpu_olap_torch.obs.metrics import (Counter, Gauge,  # noqa: F401
                                        Histogram, LATENCY_BUCKETS_MS,
                                        MetricsRegistry)
from tpu_olap_torch.obs.slo import SloTracker  # noqa: F401
from tpu_olap_torch.obs.trace import (NULL_SPAN, Span, Trace,  # noqa: F401
                                      Tracer, current_query_id,
                                      current_span, span)
from tpu_olap_torch.obs.workload import (Fingerprint,  # noqa: F401
                                         WorkloadProfiler, fingerprint_ir,
                                         fingerprint_sql, in_introspection,
                                         introspection_execution,
                                         recommend_rollups)

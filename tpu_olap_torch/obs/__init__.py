"""Observability, as in the JAX package: `trace` yields a per-query span
tree (parse → plan → lower → prepare → dispatch → host-transfer →
finalize → post-agg → assemble, with batch legs nested under their
shared-scan span), `metrics` keeps incrementally updated counters,
gauges and histograms rendered in the Prometheus text format (the same
`tpu_olap` namespace and metric names as the JAX package), `events` is
the structured JSON-lines event log, `slo` tracks the latency objective
with a burn-rate gauge, and `workload` is the query-template profiler
behind the cube advisor and sys.query_templates. The runner feeds all
of them through `QueryRunner.record`. `profile` exports span trees as
Chrome traces and runs torch.profiler captures whose kernel launches
carry their query ids, `timeseries` keeps each metric series' recent
history, and `sentinel` raises stage-attributed drift and resource
alerts.
"""

from tpu_olap_torch.obs.events import EventLog  # noqa: F401
from tpu_olap_torch.obs.metrics import (Counter, Gauge,  # noqa: F401
                                        Histogram, LATENCY_BUCKETS_MS,
                                        MetricsRegistry)
from tpu_olap_torch.obs.profile import (annotate_dispatch,  # noqa: F401
                                        capture_device_profile,
                                        chrome_trace)
from tpu_olap_torch.obs.sentinel import RegressionSentinel  # noqa: F401
from tpu_olap_torch.obs.slo import SloTracker  # noqa: F401
from tpu_olap_torch.obs.timeseries import TimeseriesSampler  # noqa: F401
from tpu_olap_torch.obs.trace import (NULL_SPAN, Span, Trace,  # noqa: F401
                                      Tracer, current_query_id,
                                      current_span, span)
from tpu_olap_torch.obs.workload import (Fingerprint,  # noqa: F401
                                         WorkloadProfiler, fingerprint_ir,
                                         fingerprint_sql, in_introspection,
                                         introspection_execution,
                                         recommend_rollups)

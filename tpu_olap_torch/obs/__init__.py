"""Observability: the workload profiler (obs.workload). Tracing, events,
metrics and SLOs come with ROADMAP queue A item 14."""

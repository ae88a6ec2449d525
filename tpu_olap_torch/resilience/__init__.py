"""Error taxonomy of the query path. Only `QueryError`, the base the
fallback interpreter's `FallbackError` needs, is ported; admission, the
breaker and the other resilience types wait for ROADMAP queue A item 12."""

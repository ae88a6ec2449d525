"""Error taxonomy of the query path. `QueryError` (the base the fallback
interpreter's `FallbackError` needs) and `UserError` (the cube DDL's
refusals) are ported; admission, the breaker and the other resilience
types wait for ROADMAP queue A item 12."""

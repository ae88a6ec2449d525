"""HTTP query server — the BI-connectivity analog of the reference's
ThriftServer wrapper (SURVEY.md §3.1: "Lets Tableau/BI tools hit
accelerated tables over JDBC/ODBC").

A copy of the JAX package's api/server.py: the same endpoints, bodies,
headers and status codes. Start it over an engine with
`QueryServer(engine, port=8080).start()`; every statement it serves
runs on the engine's device (the card by default) exactly as through
`Engine.sql`, in the pipelined mode.

JDBC/ODBC is JVM plumbing with no accelerator-native counterpart; the idiomatic
equivalent is a JSON-over-HTTP surface (stdlib only, no new deps):

  POST /sql          {"query": "SELECT ..."}      -> {columns, rows}
                     (statement verbs work too: CLEAR DRUID CACHE,
                     EXPLAIN ANALYZE, ...; the response carries an
                     X-Query-Id header correlating it with
                     /debug/queries, sys.queries, and Perfetto traces —
                     /sql/batch returns a comma-separated id list)
  POST /druid/v2     native Druid query JSON      -> Druid-wire results
                     (the raw-IR passthrough, SURVEY.md §4.5 — lets
                     existing Druid clients talk to the engine)
  POST /ingest       {"table": t, "rows": [{...}, ...]} -> real-time
                     append (Engine.append): rows are
                     queryable immediately, WAL-durable before the 200,
                     and a full delta sheds with 429 + Retry-After
  GET  /debug/ingest real-time ingest state: per-table delta sizes,
                     watermarks, WAL bytes/lag, compactor state, the
                     measured drain rate behind 429 Retry-After, and
                     durable-checkpoint store stats (manifest id, WAL
                     watermark, spilled bytes; the SQL spelling is
                     SELECT * FROM sys.checkpoints)
  GET  /status       engine + per-table summary + counters
  GET  /status/metadata/<table>  column metadata (segmentMetadata shape)
  GET  /metrics      Prometheus text exposition (obs.metrics:
                     latency histograms by query_type/path, scan/cache/
                     retry counters, HBM ledger gauges, resilience
                     gauges/counters, pipelined-execution series —
                     dispatch_lock_wait_ms, pipeline_inflight,
                     inflight_transfers)
  GET  /debug/queries  recent span trees + the slow-query log ring
                     (EngineConfig.slow_query_ms)
  GET  /debug/events   the structured event log ring, newest first
                     (query/breaker/shed/cache_clear/ingest events;
                     ?n= bounds the count)
  GET  /debug/profile  recent traces exported as Chrome-trace JSON —
                     loads directly in Perfetto (?n= bounds traces)
  GET  /debug/cache  semantic result-cache state: per-tier entries/
                     bytes/hits/misses/evictions + per-table ingest
                     generations
  GET  /debug/cubes  materialized rollup cubes (cubes/):
                     per cube dims/grain/rows, base-vs-cube generation,
                     last refresh, build cost, and rewrite serve counts
                     — the SQL spelling is SELECT * FROM sys.cubes
  GET  /debug/devices  num_shards and the serving state of each device
                     (one row per mesh device): segments, resident
                     bytes, dispatches, tier-1 cache entries,
                     per-owner-class device bytes — the SQL spelling is
                     SELECT * FROM sys.devices
  GET  /debug/workload  the query-template profiler (obs.workload):
                     top templates with latency percentiles and cache
                     hit-rates, plus ranked rollup-cube recommendations
                     — the SQL spelling is SELECT ... FROM
                     sys.query_templates
  POST /debug/profile?ms=N
                     on-demand torch.profiler capture for N ms
                     (capped; CPU and, on a CUDA engine, CUDA
                     activity), written as a Chrome trace; each kernel
                     launch inside the window is annotated with its
                     query_id. Degrades to {"ok": false, ...} where
                     the profiler is unavailable.
  GET  /healthz      liveness: 200 while the process serves requests
  GET  /readyz       readiness: 503 while the device circuit breaker is
                     open or the device is wedged — tells a load
                     balancer to stop ROUTING to a sick replica instead
                     of queueing onto it

Error contract: failures carry the structured
taxonomy (resilience.errors) — the body is {"error", "code",
"retriable"} and the status distinguishes retry-later from
your-request-is-wrong:

  400  user error (bad SQL / unknown path / unsupported statement)
  429  admission shed (dispatch queue full or deadline budget < wait)
  503  circuit breaker open (Retry-After: cooldown remaining)
  504  query deadline exceeded with no fallback available
  500  internal / unclassified

Concurrency: requests run on ThreadingHTTPServer threads; device
dispatch admission is bounded (EngineConfig.max_inflight_dispatches /
admission_queue_limit) so a traffic spike sheds with 429 instead of
piling unboundedly onto the device lock. stop() drains gracefully:
stops accepting, waits for in-flight handlers up to a bounded timeout,
then force-closes.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pandas as pd

from tpu_olap_torch.resilience.errors import QueryError, UserError


def _parse_query(path: str) -> dict:
    """Query-string dict of a request path ({} when none)."""
    if "?" not in path:
        return {}
    from urllib.parse import parse_qs
    return parse_qs(path.split("?", 1)[1])


def _int_param(qs: dict, names, cap: int | None = None,
               default: int | None = None) -> int | None:
    """Validated integer query param shared by the /debug endpoints
   : first present name wins, non-integers and
    negatives are rejected with a 400 UserError (not a 500 traceback),
    and values are capped (at the serving ring's size) so a client
    cannot request an unbounded response."""
    for nm in names:
        vals = qs.get(nm)
        if not vals:
            continue
        raw = vals[0]
        try:
            v = int(raw)
        except (TypeError, ValueError):
            raise UserError(
                f"query param {nm}={raw!r}: must be an integer")
        if v < 0:
            raise UserError(
                f"query param {nm}={raw!r}: must be >= 0")
        return v if cap is None else min(v, cap)
    return default


def _jsonable(x):
    """Strict-JSON sanitizer: NaN/inf and SQL nulls that surface as pandas
    scalars (NaT, pd.NA) -> JSON null; BI clients reject bare NaN/Infinity
    literals and would otherwise receive the strings "NaT"/"<NA>" via
    default=str."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if x is None or isinstance(x, (str, int, bool)):
        return x
    try:
        if pd.isna(x):
            return None
    except (TypeError, ValueError):
        pass
    return x


class QueryServer:
    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0):
        self.engine = engine
        server = self
        # graceful-drain bookkeeping: handlers register in/out so stop()
        # can wait for mid-flight responses instead of severing them
        self._inflight = 0
        self._inflight_cond = threading.Condition()

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: a BI client (or the concurrency
            # bench) reuses one connection per thread instead of a TCP
            # handshake + accept-loop round trip per request — under
            # high client churn the single accept thread was the p99
            # tail, not the engine. Safe because every response path
            # (_send/_send_text) sets an exact Content-Length.
            protocol_version = "HTTP/1.1"
            # TCP_NODELAY: a response goes out as two writes (headers,
            # then body), and with Nagle's algorithm the body waits for
            # the client's delayed ACK of the headers — about 40 ms per
            # request on a kept-alive connection (44 ms against 0.6 ms
            # for GET /healthz on the CPU). The JAX package's server
            # leaves Nagle on; nothing else differs.
            disable_nagle_algorithm = True

            def log_message(self, *a):  # quiet; engine.history observes
                pass

            def _send(self, code: int, payload, headers=()):
                body = json.dumps(_jsonable(payload), default=str,
                                  allow_nan=False).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _send_query_error(self, e: QueryError):
                """Structured taxonomy mapping: status from the error,
                machine-readable body, Retry-After while the breaker
                cools down."""
                headers = []
                retry_after = getattr(e, "retry_after_s", None)
                if retry_after is not None:
                    headers.append(
                        ("Retry-After",
                         str(max(1, int(math.ceil(retry_after))))))
                self._send(e.http_status, e.to_json(), headers)

            def _body(self):
                n = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(n).decode()

            def _send_text(self, code: int, text: str, content_type: str):
                body = text.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                server._enter()
                try:
                    if self.path == "/metrics":
                        # Prometheus exposition is a text format, not
                        # JSON — version 0.0.4 per the scrape protocol
                        self._send_text(
                            200, server._get_metrics(),
                            "text/plain; version=0.0.4; charset=utf-8")
                        return
                    if self.path == "/healthz":
                        self._send(200, {"status": "ok"})
                        return
                    if self.path == "/readyz":
                        ready, detail = server._readiness()
                        self._send(200 if ready else 503, detail)
                        return
                    self._send(200, server._get(self.path))
                except QueryError as e:
                    self._send_query_error(e)
                except KeyError as e:
                    self._send(404, {"error": str(e)})
                except Exception as e:
                    self._send(500, {"error": str(e)})
                finally:
                    server._leave()

            def do_POST(self):
                server._enter()
                try:
                    payload, headers = server._post(
                        self.path, self._body(),
                        traceparent=self.headers.get("traceparent"))
                    self._send(200, payload, headers)
                except QueryError as e:
                    # taxonomy first: UserError IS a ValueError and
                    # FallbackError maps to 400 through http_status, so
                    # the legacy clause below only sees untyped errors
                    self._send_query_error(e)
                except (ValueError, KeyError) as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:
                    self._send(500, {"error": str(e)})
                finally:
                    server._leave()

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self.httpd.server_address
        self._thread = None

    # ------------------------------------------------------------ control

    def start(self):
        # torch.profiler's first session must start on this thread, not
        # on the handler thread of a POST /debug/profile (obs.profile)
        from tpu_olap_torch.obs.profile import prepare
        prepare()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def _enter(self):
        with self._inflight_cond:
            self._inflight += 1

    def _leave(self):
        with self._inflight_cond:
            self._inflight -= 1
            if self._inflight == 0:
                self._inflight_cond.notify_all()

    def stop(self, drain_timeout_s: float = 10.0):
        """Graceful drain: stop accepting new requests, wait for
        in-flight handler threads up to `drain_timeout_s`, then
        force-close. ThreadingHTTPServer handler threads are daemonic,
        so a bare shutdown()+server_close() could sever a mid-flight
        device query's response; the drain window lets it finish."""
        self.httpd.shutdown()  # stop the accept loop (blocks until out)
        deadline = time.monotonic() + max(0.0, drain_timeout_s)
        with self._inflight_cond:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break  # force-close severs the stragglers, by contract
                self._inflight_cond.wait(min(remaining, 0.1))
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        # deterministic engine shutdown: stop and
        # JOIN the background threads the engine owns — compactor, WAL
        # flushers, cube maintainer — and flush the async event sink so
        # the tail emitted by draining handlers reaches disk before the
        # process exits. The engine stays queryable afterwards.
        self.engine.close()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ----------------------------------------------------------- handlers

    def _readiness(self) -> tuple[bool, dict]:
        """Readiness probe payload: not ready while the breaker is open
        (device sick, degraded serving only) or the device is wedged
        awaiting a reprobe. Liveness (/healthz) stays green either way —
        the replica is alive, it just should not receive new traffic."""
        runner = self.engine.runner
        state = runner.breaker.state
        wedged = bool(runner._wedged)
        ready = state != "open" and not wedged
        return ready, {"ready": ready, "breaker": state,
                       "wedged": wedged,
                       "admission": runner.admission.snapshot()}

    def _get(self, path: str):
        if path == "/status":
            eng = self.engine
            return {
                "engine": "tpu_olap",
                "tables": {name: {
                    "accelerated": e.is_accelerated,
                    # null until the lazy fallback frame materializes —
                    # a monitoring ping must not force a parquet load
                    "numRows": (e.segments.num_rows if e.is_accelerated
                                else e.materialized_rows),
                } for name, e in ((n, eng.catalog.get(n))
                                  for n in eng.catalog.names())},
                "counters": eng.counters(),
                "resilience": {
                    "breaker": eng.runner.breaker.state,
                    "wedged": bool(eng.runner._wedged),
                    "admission": eng.runner.admission.snapshot(),
                },
                "slo": eng.runner.slo.snapshot(),
                "stages": eng.runner.stages.snapshot(),
                "device_bytes": eng.runner.device_bytes_by_table(),
            }
        if path.startswith("/status/metadata/"):
            name = path.rsplit("/", 1)[1]
            entry = self.engine.catalog.get(name)
            if not entry.is_accelerated:
                return {"table": name, "accelerated": False}
            return {"table": name,
                    "columns": entry.segments.column_metadata()}
        if path == "/debug/queries" or path.startswith("/debug/queries?"):
            limit = _int_param(_parse_query(path), ("n", "limit"),
                               cap=self.engine.tracer.ring_limit)
            return self.engine.tracer.snapshot(limit)
        if path == "/debug/events" or path.startswith("/debug/events?"):
            ev = self.engine.runner.events
            n = _int_param(_parse_query(path), ("n", "limit"),
                           cap=ev.limit)
            out = {"limit": ev.limit, "events": ev.snapshot(n)}
            if ev.path is not None:
                out["sink"] = {"path": ev.path,
                               "errors": ev.sink_errors}
            return out
        if path == "/debug/profile" or path.startswith("/debug/profile?"):
            # span-tree timelines in Chrome-trace JSON (obs.profile):
            # save the body to a file and open it in Perfetto
            from tpu_olap_torch.obs.profile import chrome_trace
            n = _int_param(_parse_query(path), ("n", "limit"),
                           cap=self.engine.tracer.ring_limit)
            return chrome_trace(self.engine.tracer.recent_traces(n))
        if path == "/debug/workload" or path.startswith("/debug/workload?"):
            # the workload profiler (obs.workload): top query
            # templates by count plus the cube advisor's ranked rollup
            # recommendations — the same signal as SELECT ... FROM
            # sys.query_templates, without going through SQL. ?n= bounds
            # the template rows (default 20); recommendations always
            # rank over the full template set.
            from tpu_olap_torch.obs.workload import recommend_rollups
            prof = self.engine.runner.workload
            n = _int_param(_parse_query(path), ("n", "limit"),
                           default=20)
            rows = prof.snapshot()
            return {"totals": prof.totals(),
                    "templates": rows[:n] if n else rows,
                    "recommendations": recommend_rollups(rows)}
        if path == "/debug/cubes" or path.startswith("/debug/cubes?"):
            # materialized rollup cubes (tpu_olap_torch.cubes):
            # per cube name/base/dims/grain/rows, base-vs-cube
            # generation (stale detection), last refresh, build cost,
            # and rewrite serve counts — the SQL spelling is
            # SELECT * FROM sys.cubes
            eng = self.engine
            return {"enabled": bool(eng.config.cube_rewrite_enabled),
                    "auto_refresh": bool(eng.config.cube_auto_refresh),
                    "cubes": eng.cubes.snapshot()}
        if path == "/debug/devices" or path.startswith("/debug/devices?"):
            # the configured num_shards and each device's serving
            # state: segments, resident bytes, dispatches, tier-1 cache
            # entries, rebase stats — the SQL spelling is SELECT * FROM
            # sys.devices
            eng = self.engine
            return {"num_shards": int(eng.config.num_shards or 1),
                    "devices": eng.runner.device_snapshot()}
        if path == "/debug/ingest" or path.startswith("/debug/ingest?"):
            # real-time ingest state (segments/delta.py): per-table
            # delta rows/segments, sealed
            # watermark, WAL bytes + fsync lag, compactor state — the
            # SQL spelling of the per-segment half is
            # SELECT * FROM sys.segments (kind/watermark columns)
            return self.engine.ingest.snapshot()
        if path == "/debug/timeseries" \
                or path.startswith("/debug/timeseries?"):
            # the telemetry plane's metrics history (obs.timeseries):
            # bounded per-series rings sampled from the
            # metrics registry on the background telemetry graph. ?n=
            # caps points per series — the SQL spelling is
            # SELECT * FROM sys.metrics_history
            n = _int_param(_parse_query(path), ("n", "limit"))
            return self.engine.runner.telemetry.snapshot(
                limit_per_series=n)
        if path == "/debug/health" or path.startswith("/debug/health?"):
            # regression-sentinel verdict (obs.sentinel):
            # ok=false while any structured alert (latency drift with
            # stage attribution, HBM pressure, eviction thrash, WAL
            # lag, open breaker, admission sheds) is active — the SQL
            # spelling is SELECT * FROM sys.alerts. Always HTTP 200:
            # /readyz answers "can I serve", this answers "am I well"
            return self.engine.runner.sentinel.health()
        if path == "/debug/cache" or path.startswith("/debug/cache?"):
            # semantic result-cache state (executor.resultcache):
            # per-tier entries/bytes/hit counters plus
            # each accelerated table's live ingest generation — the key
            # component that invalidates both tiers
            eng = self.engine
            snap = eng.runner.result_cache.snapshot()
            snap["generations"] = {
                n: eng.catalog.get(n).segments.generation
                for n in eng.catalog.names()
                if eng.catalog.get(n).is_accelerated}
            return snap
        raise KeyError(f"unknown path {path!r}")

    def _get_metrics(self) -> str:
        """GET /metrics: refresh the point-in-time gauges from engine
        state (counters/histograms are maintained incrementally at query
        completion — QueryRunner.record), then render the registry."""
        eng = self.engine
        m = eng.metrics
        ledger = eng.runner._ledger
        m.gauge("hbm_bytes_in_use").set(ledger.bytes_in_use)
        eng.runner._m_hbm_evict.set_total(ledger.evictions)
        m.gauge("history_records",
                "Records retained in the bounded history ring.") \
            .set(len(eng.runner.history))
        m.gauge("tables_registered").set(len(eng.catalog.names()))
        # memory/cache gauges + the SLO burn rate are point-in-time:
        # walk resident buffers and re-prune the SLO window at scrape,
        # not per query
        eng.runner.refresh_resource_gauges()
        m.gauge("slo_burn_rate").set(eng.runner.slo.burn_rate())
        return m.render()

    def _post(self, path: str, body: str, traceparent: str | None = None):
        """(payload, headers) for a POST. /sql and /sql/batch answer
        with an X-Query-Id header so a client can
        correlate a response with /debug/queries, SELECT ... FROM
        sys.queries, and Perfetto traces. A valid W3C `traceparent`
        request header joins the query records and span
        trees to the caller's distributed trace and is echoed back on
        the response; an invalid one is ignored, never an error."""
        from tpu_olap_torch.obs.trace import parse_traceparent
        tp = parse_traceparent(traceparent)
        tp_headers = [("traceparent", tp["traceparent"])] if tp else []
        if path == "/sql":
            req = json.loads(body)
            frame, trace = self.engine._sql_traced(
                req["query"], traceparent=traceparent)
            headers = [("X-Query-Id", trace.query_id)] \
                if trace is not None else []
            return {"columns": list(frame.columns),
                    "rows": frame.to_dict("records")}, \
                headers + tp_headers
        if path == "/sql/batch":
            # explicit batch submission: one POST, N statements, shared
            # scans where compatible (Engine.sql_batch / executor.batch)
            req = json.loads(body)
            frames, qids = self.engine.sql_batch_ids(
                req["queries"], traceparent=traceparent)
            return {"results": [{"columns": list(f.columns),
                                 "rows": f.to_dict("records")}
                                for f in frames]}, \
                [("X-Query-Id", ",".join(qids))] + tp_headers
        if path in ("/druid/v2", "/druid/v2/"):
            spec = json.loads(body)
            res = self.engine.execute_ir(spec)
            return res.druid, []
        if path == "/ingest":
            # real-time append: acknowledged only
            # after the WAL frame is durable; backpressure surfaces as
            # IngestBackpressure -> 429 + Retry-After via the taxonomy
            req = json.loads(body)
            if "table" not in req or "rows" not in req:
                raise UserError(
                    "/ingest expects {\"table\": ..., \"rows\": [...]}")
            return self.engine.append(
                req["table"], req["rows"],
                traceparent=traceparent), tp_headers
        if path == "/debug/profile" or path.startswith("/debug/profile?"):
            # on-demand torch.profiler capture: blocks THIS handler
            # thread for the window while other threads keep serving
            # (their launches get query_id annotations); ms is
            # validated and capped like every /debug param
            from tpu_olap_torch.obs import profile as profile_mod
            ms = _int_param(_parse_query(path), ("ms",),
                            cap=profile_mod.CAPTURE_MS_MAX,
                            default=profile_mod.CAPTURE_MS_DEFAULT)
            return profile_mod.capture_device_profile(ms), []
        raise KeyError(f"unknown path {path!r}")

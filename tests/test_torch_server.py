"""The HTTP query server of the PyTorch port (api.server.QueryServer)
against the JAX package's.

Two servers, one over each package's engine on the same seeded table,
get the same requests: the status codes, the JSON bodies (less the fields
that name a process-wide generation, a wall clock or a timing) and the
headers of the error contract (X-Query-Id, Retry-After, traceparent) must
be the JAX package's. /metrics is checked against the Prometheus text
grammar of tests/test_observability.py.
"""

import json
import math
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest

from test_observability import _METRIC_RE
from tpu_olap import Engine as JaxEngine
from tpu_olap.api.server import QueryServer as JaxServer
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.resilience.faults import FaultInjector as JaxInjector
from tpu_olap_torch.api.server import QueryServer, _jsonable
from tpu_olap_torch.resilience.faults import FaultInjector
from _torch_port import cpu_engine

SQL = "SELECT g, sum(v) AS s, count(*) AS n FROM t GROUP BY g ORDER BY g"
IR = {"queryType": "groupBy", "dataSource": "t", "granularity": "all",
      "intervals": ["2024-01-01/2024-03-01"], "dimensions": ["g"],
      "aggregations": [{"type": "longSum", "name": "s", "fieldName": "v"}]}
ROWS = [{"ts": "2024-02-03T04:05:06", "g": "g3", "v": 11},
        {"ts": "2024-02-04T00:00:00", "g": "g9", "v": 2}]
TP = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
# process-wide counters and clocks, different in the two packages
VOLATILE = {"generation", "sealed_generation", "ts_ms", "service_ewma_ms"}


def _df(n=3000, seed=21):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "ts": pd.to_datetime("2024-01-01")
        + pd.to_timedelta(rng.integers(0, 86400 * 50, n), unit="s"),
        "g": rng.choice([f"g{i}" for i in range(7)], n),
        "v": rng.integers(0, 800, n).astype(np.int64),
    })


def _engine(jax, **kw):
    kw = dict(kw, telemetry_interval_s=0.0, cube_auto_refresh=False,
              ingest_auto_compact=False)
    eng = JaxEngine(JaxConfig(use_pallas="never", **kw)) if jax \
        else cpu_engine(**kw)
    eng.register_table("t", _df(), time_column="ts", block_rows=512)
    return eng


@pytest.fixture(scope="module")
def servers():
    out = [(JaxServer if jax else QueryServer)(_engine(jax)).start()
           for jax in (True, False)]
    yield out
    for srv in out:
        srv.stop()


def _call(srv, method, path, payload=None, headers=None):
    """(status, headers, parsed body) of one request."""
    data = None if payload is None else (
        payload if isinstance(payload, bytes)
        else json.dumps(payload).encode())
    req = urllib.request.Request(srv.url + path, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status, hdrs, body = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, body = e.code, dict(e.headers), e.read()
    text = body.decode()
    try:
        return status, hdrs, json.loads(text)
    except json.JSONDecodeError:
        return status, hdrs, text


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


REQUESTS = [
    ("POST", "/sql", {"query": SQL}),
    ("POST", "/sql", {"query": "SELECT g FROM t WHERE v < 5 ORDER BY v, g "
                               "LIMIT 4"}),
    ("POST", "/sql", {"query": "SELEC g FROM t"}),
    ("POST", "/sql", {"query": "SELECT nope FROM t"}),
    ("POST", "/sql", {"query": "SELECT count(*) AS n FROM sys.tables"}),
    ("POST", "/sql", {"nokey": 1}),
    ("POST", "/sql/batch", {"queries": [SQL, "SELECT sum(v) AS s FROM t"]}),
    ("POST", "/druid/v2", IR),
    ("POST", "/druid/v2/", {"queryType": "timeBoundary",
                            "dataSource": "t"}),
    ("POST", "/druid/v2", {"queryType": "groupBy", "dataSource": "nope"}),
    ("POST", "/ingest", {"table": "t", "rows": ROWS}),
    ("POST", "/ingest", {"table": "t"}),
    ("POST", "/sql", {"query": SQL}),
    ("POST", "/nope", {}),
    ("POST", "/debug/profile?ms=nope", b""),
    ("GET", "/nope", None),
    ("GET", "/healthz", None),
    ("GET", "/debug/queries?n=oops", None),
    ("GET", "/debug/events?limit=-1", None),
    ("GET", "/debug/cubes", None),
    ("GET", "/status/metadata/t", None),
    ("GET", "/debug/timeseries?n=x", None),
]


def test_same_requests_same_codes_and_bodies(servers):
    for method, path, payload in REQUESTS:
        got = [_call(srv, method, path, payload) for srv in servers]
        (jc, jh, jb), (pc, ph, pb) = got
        assert pc == jc, (path, payload, jc, pc, pb)
        assert _strip(pb) == _strip(jb), (path, payload)
        assert ("X-Query-Id" in ph) == ("X-Query-Id" in jh), path
        assert ph["Content-Type"] == jh["Content-Type"], path
    status, hdrs, body = _call(servers[1], "POST", "/sql/batch", {
        "queries": [SQL, "SELECT count(*) AS n FROM sys.queries"]})
    ids = hdrs["X-Query-Id"].split(",")
    assert status == 200 and len(ids) == 2 and ids[1] == "-"


def test_query_ids_reach_history_and_debug_queries(servers):
    _, port = servers
    status, hdrs, _ = _call(port, "POST", "/sql",
                            {"query": "SELECT max(v) AS m FROM t"},
                            headers={"traceparent": TP})
    qid = hdrs["X-Query-Id"]
    assert status == 200 and hdrs["traceparent"] == TP
    rec = [h for h in port.engine.history if h.get("query_id") == qid]
    assert len(rec) == 1 and rec[0]["traceparent"] == TP
    got = port.engine.sql(
        f"SELECT path FROM sys.queries WHERE query_id = '{qid}'")
    assert list(got["path"]) == [rec[0]["path"]]
    _, _, dbg = _call(port, "GET", "/debug/queries?n=5")
    assert qid in json.dumps(dbg)


def test_debug_endpoints_have_the_jax_keys(servers):
    for path in ("/status", "/debug/devices", "/debug/health",
                 "/debug/timeseries", "/debug/workload", "/debug/cache",
                 "/debug/ingest", "/debug/events?n=3", "/readyz"):
        (jc, _, jb), (pc, _, pb) = [_call(s, "GET", path)
                                    for s in servers]
        assert (pc, sorted(pb)) == (jc, sorted(jb)), path
    _, _, dev = _call(servers[1], "GET", "/debug/devices")
    assert dev["num_shards"] == 1 and len(dev["devices"]) == 1
    assert dev["devices"][0]["device"] == "cpu"
    _, _, st = _call(servers[1], "GET", "/status")
    assert st["engine"] == "tpu_olap" and st["tables"]["t"]["accelerated"]


def test_metrics_endpoint_prometheus_grammar(servers):
    _, port = servers
    port.engine.sql_batch([SQL, SQL, "SELECT sum(v) AS s FROM t"])
    req = urllib.request.urlopen(port.url + "/metrics", timeout=30)
    ctype, text = req.headers["Content-Type"], req.read().decode()
    assert ctype.startswith("text/plain") and "version=0.0.4" in ctype
    seen = set()
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            assert line.startswith(("# HELP tpu_olap_",
                                    "# TYPE tpu_olap_")), line
            continue
        m = _METRIC_RE.match(line)
        assert m, f"bad exposition line: {line!r}"
        assert math.isfinite(float(m.group("value"))), line
        seen.add(line.split("{")[0].split(" ")[0])
    for name in ("tpu_olap_queries_total", "tpu_olap_history_records",
                 "tpu_olap_query_latency_ms_bucket",
                 "tpu_olap_device_bytes", "tpu_olap_cache_entries",
                 "tpu_olap_hbm_chip_bytes", "tpu_olap_batch_size_count",
                 "tpu_olap_slo_burn_rate", "tpu_olap_tables_registered"):
        assert name in seen, name


def _error_pair(make, request):
    """The (status, Retry-After present, body) of `request` on a fresh
    server of each package built by make(jax)."""
    out = []
    for jax in (True, False):
        srv = (JaxServer if jax else QueryServer)(make(jax)).start()
        try:
            status, hdrs, body = request(srv, jax)
            out.append((status, "Retry-After" in hdrs, body))
        finally:
            srv.stop(drain_timeout_s=2.0)
    return out


def test_ingest_backpressure_is_429_with_retry_after():
    got = _error_pair(
        lambda jax: _engine(jax, ingest_max_delta_rows=1),
        lambda srv, jax: _call(srv, "POST", "/ingest",
                               {"table": "t", "rows": ROWS}))
    assert got[0][:2] == (429, True)
    assert got[1] == got[0]


def test_open_breaker_is_503_with_retry_after():
    def request(srv, jax):
        br = srv.engine.runner.breaker
        br.record_failure()
        try:
            return _call(srv, "POST", "/druid/v2", IR)
        finally:
            br.close()
    got = _error_pair(
        lambda jax: _engine(jax, breaker_failure_threshold=1,
                            breaker_open_cooldown_s=60.0), request)
    assert got[0][:2] == (503, True)
    assert got[1][:2] == got[0][:2]
    assert {k: v for k, v in got[1][2].items() if k != "error"} == \
        {k: v for k, v in got[0][2].items() if k != "error"}


def test_deadline_is_504_and_readyz_follows_the_wedge():
    def request(srv, jax):
        eng = srv.engine
        eng.config.fault_injector = (JaxInjector if jax else FaultInjector)(
            rate=1.0, stages={"dispatch"}, latency_s=0.4)
        try:
            out = _call(srv, "POST", "/druid/v2", IR)
        finally:
            eng.config.fault_injector = None
        ready = _call(srv, "GET", "/readyz")
        time.sleep(0.45)   # the abandoned dispatch ends
        return out[0], out[1], (out[2], ready[0], ready[2]["wedged"])
    got = _error_pair(lambda jax: _engine(jax, query_deadline_s=0.2,
                                          dispatch_retries=0), request)
    assert got[0][0] == 504
    assert got[1][0] == 504
    assert got[1][2][0] == got[0][2][0]
    assert got[1][2][1:] == got[0][2][1:] == (503, True)


def test_stop_drains_an_inflight_request():
    eng = _engine(False)
    srv = QueryServer(eng).start()
    eng.config.fault_injector = FaultInjector(
        rate=1.0, stages={"dispatch"}, latency_s=0.3)
    box = {}
    t = threading.Thread(target=lambda: box.setdefault(
        "r", _call(srv, "POST", "/sql", {"query": SQL})))
    t.start()
    deadline = time.time() + 10
    while srv._inflight == 0 and time.time() < deadline:
        time.sleep(0.005)     # the request is in its handler
    srv.stop(drain_timeout_s=5.0)
    t.join(timeout=10)
    assert box["r"][0] == 200 and box["r"][2]["rows"]


def test_jsonable_turns_pandas_nulls_into_json_null():
    assert _jsonable({"a": [float("nan"), pd.NaT, pd.NA, 1, "x"]}) == \
        {"a": [None, None, None, 1, "x"]}


def test_debug_devices_lists_every_mesh_device():
    """GET /debug/devices on a mesh of 8 CPU devices: the configured
    num_shards and one row per device, as the JAX server's over its
    mesh; /status keeps the JAX keys."""
    from tpu_olap_torch.api.server import QueryServer
    eng = cpu_engine(num_shards=8, cube_auto_refresh=False)
    eng.register_table("t", _df(), time_column="ts", block_rows=256)
    srv = QueryServer(eng, host="127.0.0.1", port=0).start()
    try:
        _call(srv, "POST", "/sql", {"query": SQL})
        status, _, dev = _call(srv, "GET", "/debug/devices")
        assert status == 200 and dev["num_shards"] == 8
        assert [d["index"] for d in dev["devices"]] == list(range(8))
        assert all(d["chips"] == 8 and d["dispatches"] > 0
                   for d in dev["devices"])
        n_seg = len(eng.catalog.get("t").segments.segments)
        assert sum(d["segments"] for d in dev["devices"]) == n_seg
    finally:
        srv.stop()
        eng.close()

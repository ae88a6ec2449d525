"""Device profiling of the PyTorch port (obs.profile): the Chrome-trace
export of span trees, torch.profiler captures (POST /debug/profile and
EngineConfig.profile_dir), and the query-id annotation of kernel launches,
against the JAX package's obs.profile.

On the CPU a capture records CPU activity only; the annotation of device
kernels is held here on a trace in torch.profiler's export format with
the launches of two threads, as the card writes it (`annotate_trace`).
One profiler session runs in the process at a time, in both packages
alike: a second capture degrades, a capture that meets a profiled
statement degrades, and a profiled statement that meets a capture fails
on the device and is served by the fallback interpreter.
"""

import json
import os
import threading
import time

import numpy as np
import pandas as pd
import pytest

from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.obs import profile as jax_profile
from tpu_olap_torch.obs import profile
from _torch_port import cpu_engine

GROUP_SQL = "SELECT g, sum(v) AS s FROM t GROUP BY g ORDER BY g"
AGG_SQL = "SELECT sum(v) AS s, count(*) AS n FROM t"


def _df(n=2000, seed=11):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "ts": pd.to_datetime("2023-03-01")
        + pd.to_timedelta(rng.integers(0, 86400 * 90, n), unit="s"),
        "g": rng.choice([f"g{i}" for i in range(12)], n),
        "v": rng.integers(0, 1000, n).astype(np.int64),
    })


def _engine(jax, **kw):
    kw = dict(kw, telemetry_interval_s=0.0, cube_auto_refresh=False)
    eng = JaxEngine(JaxConfig(use_pallas="never", **kw)) if jax \
        else cpu_engine(fallback_on_device_failure=True, **kw)
    eng.register_table("t", _df(), time_column="ts", block_rows=1 << 10)
    return eng


def _x_events(doc):
    return [e for e in doc["traceEvents"] if e.get("ph") == "X"]


def test_chrome_trace_round_trip_like_the_jax_package():
    docs = []
    for jax in (True, False):
        eng = _engine(jax)
        eng.sql(GROUP_SQL)
        eng.sql(AGG_SQL)
        mod = jax_profile if jax else profile
        docs.append(json.loads(json.dumps(
            mod.chrome_trace(eng.tracer.recent_traces()))))
        eng.close()
    jdoc, doc = docs
    assert doc["traceEvents"][0]["args"]["name"] == "tpu_olap"
    xs = _x_events(doc)
    by_tid = {}
    for e in xs:
        for k in ("name", "ts", "dur", "pid", "tid"):
            assert k in e, f"event missing {k}: {e}"
        assert e["dur"] >= 0 and e["ts"] > 0
        by_tid.setdefault(e["tid"], []).append(e)
    assert len(by_tid) == 2
    for evs in by_tid.values():
        root = next(e for e in evs if e["name"] == "sql")
        assert root["args"]["query_id"].startswith("q")
        lo, hi = root["ts"], root["ts"] + root["dur"]
        for e in evs:
            assert lo - 1.0 <= e["ts"] and e["ts"] + e["dur"] <= hi + 500.0
    metas = [e for e in doc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "thread_name"]
    assert [m["args"]["name"][:7] for m in metas] == ["query q"] * 2
    assert {e["name"] for e in xs} == {e["name"] for e in _x_events(jdoc)}


def _wait_live(mod):
    """Until `mod`'s capture is live (at most 10 s)."""
    deadline = time.time() + 10
    while not mod.capture_active() and time.time() < deadline:
        time.sleep(0.005)
    assert mod.capture_active()


def _post(srv, path):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(srv.url + path, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_capture_endpoint_and_overlapping_captures():
    """POST /debug/profile runs a capture in both packages; two at once:
    one runs, the other degrades with "capture already in progress"."""
    from tpu_olap.api.server import QueryServer as JaxServer
    from tpu_olap_torch.api.server import QueryServer
    got = []
    for jax in (True, False):
        srv = (JaxServer if jax else QueryServer)(_engine(jax)).start()
        try:
            code, out = _post(srv, "/debug/profile?ms=20")
            assert code == 200 and out["ok"], out
            assert sorted(out) == ["ms", "ok", "trace_dir"]
            assert os.path.isdir(out["trace_dir"])
            mod = jax_profile if jax else profile
            res = {}
            t = threading.Thread(target=lambda: res.setdefault(
                "a", mod.capture_device_profile(300)))
            t.start()
            _wait_live(mod)
            res["b"] = mod.capture_device_profile(10)
            t.join(timeout=30)
            got.append(sorted((r["ok"], r.get("reason")) for r in
                              res.values()))
        finally:
            srv.stop()
    assert got[0] == got[1] == [(False, "capture already in progress"),
                                (True, None)]
    assert os.path.isfile(os.path.join(out["trace_dir"], profile.TRACE_FILE))


def test_profile_dir_writes_one_trace_per_statement(tmp_path):
    eng = _engine(False, profile_dir=str(tmp_path))
    try:
        eng.sql(GROUP_SQL)
        eng.sql(AGG_SQL)
        recs = list(eng.history)[-2:]
        dirs = [r["profile_trace"] for r in recs]
        assert len(set(dirs)) == 2
        for r, d in zip(recs, dirs):
            assert d.startswith(str(tmp_path))
            with open(os.path.join(d, profile.TRACE_FILE)) as f:
                doc = json.load(f)
            # the statement's own thread ran the session: its dispatch
            # sits under a record_function range named by its query id
            names = {e.get("name") for e in doc["traceEvents"]}
            assert r["query_id"] in names
    finally:
        eng.close()
    jeng = _engine(True, profile_dir=str(tmp_path / "jax"))
    jeng.sql(AGG_SQL)
    assert os.path.isdir(jeng.history[-1]["profile_trace"])
    jeng.close()


def test_sessions_collide_as_in_the_jax_package(tmp_path):
    """A profiled statement during a capture fails on the device with the
    JAX package's message and the fallback serves it; a capture during a
    profiled statement degrades with the start failure."""
    got = []
    for jax in (True, False):
        eng = _engine(jax, profile_dir=str(tmp_path / str(jax)))
        mod = jax_profile if jax else profile
        want = eng.sql(AGG_SQL)
        res = {}
        t = threading.Thread(target=lambda: res.setdefault(
            "c", mod.capture_device_profile(450)))
        t.start()
        _wait_live(mod)
        out = eng.sql(AGG_SQL)
        t.join(timeout=30)
        pd.testing.assert_frame_equal(out, want)
        failed, served = list(eng.history)[-2:]
        got.append((res["c"]["ok"], failed.get("failed"), failed["path"],
                    served["path"], served.get("fallback_reason")))
        eng.close()
    assert got[0] == got[1]
    assert got[1][:4] == (True, True, "dense", "fallback")
    assert profile.ALREADY_STARTED in got[1][4]
    # the other way round: a live profiled statement's session
    with profile.profile_query(str(tmp_path / "q"), cuda=False):
        res = profile.capture_device_profile(10)
    assert not res["ok"]
    assert res["reason"] == ("torch.profiler start failed: "
                             + profile.ALREADY_STARTED)
    with pytest.raises(RuntimeError, match="Only one profile"):
        with profile.profile_query(str(tmp_path / "a"), cuda=False):
            with profile.profile_query(str(tmp_path / "b"), cuda=False):
                pass
    assert profile.capture_device_profile(5)["ok"]


def test_launches_of_other_threads_are_recorded_under_their_query(
        tmp_path):
    assert profile.annotate_dispatch("q1") is profile._NULL_CM
    seen = []

    def dispatch(qid):
        with profile.annotate_dispatch(qid):
            profile.note_launch("fused_reduce_gen")
        ident = threading.get_ident() & 0xFFFFFFFF
        seen.append((threading.get_native_id(),
                     (1 << 32) - ident if ident >= 1 << 31 else ident))
    with profile.profile_query(str(tmp_path), cuda=False):
        assert profile.capture_active()
        profile.note_launch("row_mask_gen")     # outside any dispatch
        t = threading.Thread(target=dispatch, args=("q7",))
        t.start()
        t.join()
        log = list(profile._launch_log)
    assert log[0][1:] == (None, "row_mask_gen")
    assert log[1] == (seen[0], "q7", "fused_reduce_gen")
    assert profile._launch_log is None and not profile.capture_active()
    assert os.path.isfile(tmp_path / profile.TRACE_FILE)


def _trace(tmp_path, events):
    path = str(tmp_path / "trace.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return path


def test_annotate_trace_ties_kernels_to_their_queries(tmp_path):
    """Two threads' cuLaunchKernel events, one thread under its native
    id (the session's own) and one under the absolute value of its
    pthread id as a signed 32-bit integer, as torch.profiler writes
    them on the card; the first launch's host event lost. Each kernel
    gets the query id of its launch."""
    def launch(tid, ts, corr):
        return {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel",
                "tid": tid, "pid": 1, "ts": ts, "dur": 3,
                "args": {"correlation": corr}}

    def kernel(name, corr):
        return {"ph": "X", "cat": "kernel", "name": name, "tid": 7,
                "pid": 0, "ts": 100 + corr, "dur": 5,
                "args": {"correlation": corr}}
    events = [launch(118, 10, 1), launch(118, 20, 2),
              launch(1157638464, 15, 3), launch(1157638464, 25, 4),
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
               "tid": 118, "pid": 1, "ts": 30, "dur": 2,
               "args": {"correlation": 5}},
              kernel("fused_reduce_gen", 1), kernel("row_mask_gen", 2),
              kernel("fused_reduce_gen", 3), kernel("fused_reduce_gen", 4),
              kernel("elementwise_kernel", 5)]
    path = _trace(tmp_path, events)
    log = [((118, 99), "qA", "fused_reduce_gen"),
           ((118, 99), "qA", "row_mask_gen"),
           ((140, 1157638464), "qB", "fused_reduce_gen"),   # host event lost
           ((140, 1157638464), "qB", "fused_reduce_gen"),
           ((141, 1157638464), "qC", "fused_reduce_gen")]
    assert profile.annotate_trace(path, log) == 4
    with open(path) as f:
        doc = json.load(f)
    by_corr = {e["args"]["correlation"]: e for e in doc["traceEvents"]
               if e["cat"] == "kernel"}
    assert [by_corr[c]["args"].get("query_id") for c in (1, 2, 3, 4, 5)] \
        == ["qA", "qA", "qB", "qC", None]
    hosts = [e["args"].get("query_id") for e in doc["traceEvents"]
             if e["cat"] == "cuda_driver"]
    assert hosts == ["qA", "qA", "qB", "qC"]
    assert profile.annotate_trace(path, [((1, 2), None, "x")]) == 0

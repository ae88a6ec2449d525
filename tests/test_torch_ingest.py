"""Real-time ingest in the PyTorch port against the JAX package.

The scenarios of tests/test_realtime_ingest.py (HTTP and sys.* aside),
run on a pair of engines over the same frames: the JAX package's
(numpy platform, use_pallas="never") and the port's (device="cpu",
the fused reduce forced, so that B1's and its segment-extended
variant's plain versions serve). Both get the same appends; their
answers are compared with assert_frame_parity, and their acks,
compaction results and recovered state field by field. Table
generations are per-process counters of each package, so acks compare
them relative to the registered base's. The WAL format is shared: a log
the JAX engine wrote is replayed by a port engine.
"""

import os
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

import test_realtime_ingest as jri
from test_realtime_ingest import BLOCK, PARITY_QUERIES, _df
from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.resilience.errors import IngestBackpressure as JaxBackpressure
from tpu_olap.resilience.errors import UserError as JaxUserError
from tpu_olap.segments import delta as jax_delta
from tpu_olap_torch.bench.parity import assert_frame_parity
from tpu_olap_torch.executor.dataset import DeviceDataset
from tpu_olap_torch.resilience import FaultInjector
from tpu_olap_torch.resilience.errors import IngestBackpressure, UserError
from tpu_olap_torch.segments import delta as port_delta
from tpu_olap_torch.segments import wal as port_wal

from _torch_port import cpu_engine, sql_literals

ACK_KEYS = ("rows", "delta_rows", "watermark", "wal_seq")
COMPACT_KEYS = ("status", "rows_sealed", "delta_rows_folded",
                "delta_rows_carried", "mode", "segments_reused")


def _jax(**kw):
    kw.setdefault("ingest_auto_compact", False)
    kw.setdefault("cube_auto_refresh", False)
    return JaxEngine(JaxConfig(platform="cpu", use_pallas="never", **kw))


def _port(**kw):
    kw.setdefault("ingest_auto_compact", False)
    kw.setdefault("cube_auto_refresh", False)
    kw.setdefault("use_fused_reduce", "force")
    return cpu_engine(**kw)


def _dirs(tmp_path, side, wal, store):
    out = {}
    if wal:
        out["ingest_wal_dir"] = str(tmp_path / side / "wal")
    if store:
        out["ingest_store_dir"] = str(tmp_path / side / "store")
    return out


@pytest.fixture
def pair(request, tmp_path):
    """pair(data=None, wal=False, store=False, **config) -> (jax, port),
    each with table t registered (and WAL/store dirs of its own under
    tmp_path); every engine is closed when the test ends."""
    made = []
    request.addfinalizer(lambda: [e.close() for e in made])

    def make(data=None, wal=False, store=False, **kw):
        data = _df() if data is None else data
        engines = (_jax(**kw, **_dirs(tmp_path, "jax", wal, store)),
                   _port(**kw, **_dirs(tmp_path, "port", wal, store)))
        for eng in engines:
            made.append(eng)
            eng.register_table("t", data, time_column="ts",
                               block_rows=BLOCK)
        return engines
    make.made = made
    return make


def _same(jax, port, queries=PARITY_QUERIES, label=""):
    for q in queries:
        assert_frame_parity(port.sql(q), jax.sql(q), ordered=True,
                            label=f"{label}: {q}")


def _gen0(eng):
    return eng.catalog.get("t").segments.generation


def _same_ack(ja, pa, jg0, pg0):
    for k in ACK_KEYS:
        assert pa[k] == ja[k], (k, pa, ja)
    assert pa["generation"] - pg0 == ja["generation"] - jg0
    assert pa["sealed_generation"] - pg0 == ja["sealed_generation"] - jg0


def _both(engines, fn):
    """fn(engine) on each engine: its result, or the exception it
    raised."""
    out = []
    for eng in engines:
        try:
            out.append(fn(eng))
        except Exception as e:  # noqa: BLE001 — compared by the caller
            out.append(e)
    return out


def _same_error(jax_err, port_err):
    assert isinstance(jax_err, Exception) and \
        isinstance(port_err, Exception), (jax_err, port_err)
    assert type(port_err).__name__ == type(jax_err).__name__
    assert str(port_err) == str(jax_err)


# ------------------------------------------------------------- appends

APPENDS = [
    [{"ts": "2022-04-20T01:02:03", "g": "g1", "v": 7},
     {"ts": "2022-05-02T00:00:00", "g": "g5", "v": 10}],
    [{"ts": "2022-03-03", "g": "aardvark", "v": 1},
     {"ts": "2022-04-21", "g": "zzz", "v": 2}],
    [{"ts": "2022-04-22", "g": None, "v": None},
     {"ts": "2022-04-23", "g": "g3", "v": 1_000_000}],
]


def test_append_acks_and_parity(pair):
    jax, port = pair()
    jg0, pg0 = _gen0(jax), _gen0(port)
    for rows in APPENDS:
        _same_ack(jax.append("t", rows), port.append("t", rows), jg0, pg0)
        _same(jax, port, label="append")
        assert port.runner.last_metrics["route"] == "packed"
    # nulls, a widened LONG and new dictionary values, on the device
    # path of the port
    assert not port.catalog.get("t").segments.dictionaries["g"].is_sorted
    _same(jax, port, ["SELECT count(*) AS n, sum(v) AS s, count(v) AS nv "
                      "FROM t"], "nulls")
    empty = (jax.append("t", []), port.append("t", []))
    _same_ack(*empty, jg0, pg0)


def test_new_dict_values_and_lex_bounds(pair):
    jax, port = pair()
    rows = APPENDS[1] + [{"ts": "2022-04-22", "g": "g3", "v": 3}]
    jax.append("t", rows)
    port.append("t", rows)
    queries = [q for name, q in sql_literals(jri)
               if name == "test_append_new_dict_values_and_lex_bounds"]
    assert len(queries) >= 3
    _same(jax, port, queries, "lex")


def test_append_validation_never_half_applied(pair):
    jax, port = pair()
    before = port.catalog.get("t").segments
    for bad in ([{"ts": "2022-04-20", "nope": 1}],
                [{"ts": "2022-04-20", "g": "g1", "v": "x"}],
                [{"g": "g1", "v": 1}]):
        j, p = _both((jax, port), lambda e: e.append("t", bad))
        assert isinstance(j, JaxUserError) and isinstance(p, UserError)
        _same_error(j, p)
    assert port.catalog.get("t").segments is before
    for eng in (jax, port):
        eng.register_table("plain", pd.DataFrame({"x": [1]}),
                           accelerate=False)
    _same_error(*_both((jax, port),
                       lambda e: e.append("plain", [{"x": 2}])))


@pytest.mark.parametrize("frame", [
    pd.DataFrame({"ts": pd.to_datetime(["2022-04-01 00:00:00.0019", None]),
                  "g": ["a", None], "v": [1, 2], "w": [1.5, np.nan],
                  "b": [True, False]}),
    pd.DataFrame({"ts": [1648771200000, 1648771200001],
                  "v": pd.array([1, None], dtype="Int64")}),
    pd.DataFrame({"ts": [1.6487712e12, np.nan], "g": ["x", "y"]}),
], ids=["datetime", "int-time", "float-time"])
def test_frame_canonicalization_matches_jax(frame):
    """A DataFrame append is canonicalized a column at a time: the same
    rows, key order and scalar types (so the same WAL bytes) as the JAX
    package's per-row path."""
    import json
    for tc in ("ts", None):
        want = jax_delta.canonicalize_rows(frame, tc)
        got = port_delta.canonicalize_rows(frame, tc)
        assert json.dumps(got) == json.dumps(want)
        assert [[type(v) for v in r.values()] for r in got] == \
            [[type(v) for v in r.values()] for r in want]


def test_insert_into_and_fallback_sees_delta(pair):
    jax, port = pair()
    inserts = [q for _, q in sql_literals(jri, starts=("INSERT",))]
    assert len(inserts) >= 2
    for q in inserts:
        j, p = _both((jax, port), lambda e: e.sql(q))
        if isinstance(j, Exception):
            _same_error(j, p)
            continue
        assert list(p.columns) == list(j.columns)
        assert p[["rows", "delta_rows", "wal_seq"]].equals(
            j[["rows", "delta_rows", "wal_seq"]])
    _same(jax, port, ["SELECT count(*) AS n FROM t WHERE g = 'it''s'"]
          + PARITY_QUERIES, "insert")
    # a statement the planner does not rewrite: the interpreter's frame
    # holds the delta rows
    q = "SELECT g, count(*) AS n FROM t GROUP BY g HAVING count(*) > 0 " \
        "ORDER BY g"
    got = port.sql(q)
    assert_frame_parity(got, jax.sql(q), ordered=True)
    from tpu_olap_torch.planner.fallback import execute_fallback
    from tpu_olap_torch.planner.sqlparse import parse_sql
    full = execute_fallback(parse_sql("SELECT count(*) AS n FROM t"),
                            port.catalog, port.config)
    assert int(full["n"][0]) == 2002


# ---------------------------------------------------- WAL / recovery

def test_wal_replay_and_jax_written_wal(pair, tmp_path):
    jax, port = pair(wal=True)
    jg0, pg0 = _gen0(jax), _gen0(port)
    for i in range(4):
        rows = [{"ts": f"2022-05-{10 + i:02d}", "g": f"w{i}",
                 "v": i * 100}]
        _same_ack(jax.append("t", rows), port.append("t", rows), jg0, pg0)
    jwal = os.path.join(jax.config.ingest_wal_dir, "t.wal")
    pwal = os.path.join(port.config.ingest_wal_dir, "t.wal")
    # the same frames, byte for byte
    with open(jwal, "rb") as a, open(pwal, "rb") as b:
        assert a.read() == b.read()
    # a crash: fresh engines over the logs replay to the acked state;
    # the port replays the JAX engine's own log too
    rec_p = _port(ingest_wal_dir=port.config.ingest_wal_dir)
    from_jax = _port(ingest_wal_dir=jax.config.ingest_wal_dir)
    pair.made.extend([rec_p, from_jax])
    for eng in (rec_p, from_jax):
        eng.register_table("t", _df(), time_column="ts", block_rows=BLOCK)
        assert eng.catalog.get("t").segments.delta_rows == 4
        assert eng.ingest._state("t").replayed_rows == 4
        _same(jax, eng, label="replay")
    assert from_jax.append("t", [{"ts": "2022-05-20", "g": "x",
                                  "v": 1}])["wal_seq"] == 5


def test_wal_torn_tail_seq_regression_and_failed_write(pair, tmp_path,
                                                       monkeypatch):
    jax, port = pair(wal=True)
    rows = [{"ts": "2022-05-10", "g": "w", "v": 1}]
    for eng in (jax, port):
        eng.append("t", rows)
    path = os.path.join(port.config.ingest_wal_dir, "t.wal")
    good = os.path.getsize(path)
    with open(path, "ab") as f:
        f.write(b"\x40\x00\x00\x00torn-frame-garbage")
    rec = _port(ingest_wal_dir=port.config.ingest_wal_dir)
    pair.made.append(rec)
    rec.register_table("t", _df(), time_column="ts", block_rows=BLOCK)
    assert os.path.getsize(path) == good
    _same(jax, rec, PARITY_QUERIES[:1], "torn")
    # a frame whose seq does not advance stops replay, as in the JAX
    # package's reader
    import json
    import struct
    import zlib

    from tpu_olap.segments.wal import replay_wal as jax_replay
    reg = str(tmp_path / "reg.wal")
    with open(reg, "wb") as f:
        for seq, v in [(1, 10), (2, 20), (2, 99), (3, 30)]:
            payload = json.dumps(
                {"seq": seq, "rows": [{"__time": 1648771200000,
                                       "g": "g1", "v": v}]},
                separators=(",", ":")).encode()
            f.write(struct.pack("<II", len(payload), zlib.crc32(payload))
                    + payload)
    want = jax_replay(reg)
    assert port_wal.replay_wal(reg) == want and [s for s, _ in want] == [1, 2]
    # an fsync failure rolls the log back and the batch never lands
    real_fsync = os.fsync

    def flaky(fd):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(os, "fsync", flaky)
    with pytest.raises(OSError):
        rec.append("t", [{"ts": "2022-04-02", "g": "g2", "v": 123456}])
    monkeypatch.setattr(os, "fsync", real_fsync)
    assert os.path.getsize(path) == good
    assert int(rec.sql("SELECT count(*) AS n FROM t WHERE v = 123456")
               ["n"].iloc[0]) == 0


def test_reregister_resets_and_drop_deletes_wal(pair):
    jax, port = pair(wal=True)
    for eng in (jax, port):
        eng.append("t", [{"ts": "2022-05-10", "g": "w", "v": 1}])
        path = os.path.join(eng.config.ingest_wal_dir, "t.wal")
        assert os.path.getsize(path) > 0
        eng.register_table("t", _df(seed=9), time_column="ts",
                           block_rows=BLOCK)
        assert eng.catalog.get("t").segments.delta_rows == 0
        assert os.path.getsize(path) == 0
        eng.append("t", [{"ts": "2022-05-11", "g": "w", "v": 2}])
        eng.close()
        eng.register_table("t", _df(seed=9), time_column="ts",
                           block_rows=BLOCK)
        assert not os.path.exists(path) or os.path.getsize(path) == 0
        eng.append("t", [{"ts": "2022-05-11", "g": "w", "v": 2}])
        eng.drop_table("t")
        assert not os.path.exists(path)


# ------------------------------------------- backpressure / compaction

def test_backpressure_sheds_never_drops(pair):
    jax, port = pair(wal=True, ingest_max_delta_rows=8)
    row = {"ts": "2022-05-01", "g": "a", "v": 1}
    for eng in (jax, port):
        eng.append("t", [row] * 8)
    path = os.path.join(port.config.ingest_wal_dir, "t.wal")
    size = os.path.getsize(path)
    j, p = _both((jax, port), lambda e: e.append("t", [row]))
    assert isinstance(j, JaxBackpressure) and \
        isinstance(p, IngestBackpressure)
    _same_error(j, p)
    assert p.http_status == 429 and p.retry_after_s == j.retry_after_s
    assert port.catalog.get("t").segments.delta_rows == 8
    assert os.path.getsize(path) == size
    _same(jax, port, ["SELECT count(*) AS n FROM t"], "shed")
    jr, pr = jax.compact_now("t"), port.compact_now("t")
    for k in COMPACT_KEYS:
        assert pr[k] == jr[k], k
    assert port.append("t", [row])["rows"] == 1


def test_compaction_results_statuses_and_frames(pair):
    jax, port = pair()
    rows = [{"ts": "2022-04-20", "g": "zzz", "v": 5},
            {"ts": "2022-02-01", "g": "aaa", "v": 6}]
    for i in range(3):
        for eng in (jax, port):
            eng.append("t", rows[i % 2:i % 2 + 1])
    assert len(port.ingest._state("t").frames) == 3
    # skip statuses: breaker open, then compacted, then an empty delta
    for eng in (jax, port):
        for _ in range(eng.config.breaker_failure_threshold):
            eng.runner.breaker.record_failure()
    j, p = jax.compact_now("t"), port.compact_now("t")
    assert p == j == {"table": "t", "status": "breaker-open"}
    j, p = (e.sql("COMPACT DRUID TABLE t") for e in (jax, port))
    assert p["status"].iloc[0] == j["status"].iloc[0] == "breaker-open"
    for eng in (jax, port):
        eng.runner.breaker.close()
    j, p = jax.compact_now("t"), port.compact_now("t")
    for k in COMPACT_KEYS:
        assert p[k] == j[k], k
    ts = port.catalog.get("t").segments
    assert ts.delta_rows == 0 and ts.dictionaries["g"].is_sorted
    assert [s.meta.time_min for s in ts.segments] == sorted(
        s.meta.time_min for s in ts.segments)
    assert len(port.ingest._state("t").frames) <= 1
    assert jax.compact_now("t") is None and port.compact_now("t") is None
    j, p = (e.sql("COMPACT DRUID TABLE t") for e in (jax, port))
    assert p["status"].iloc[0] == j["status"].iloc[0] == "empty-delta"
    _same(jax, port, label="compacted")


def test_compaction_keeps_racing_appends(pair):
    jax, port = pair()
    stop = threading.Event()
    appended = []

    def writer():
        i = 0
        while not stop.is_set() and i < 400:
            rows = [{"ts": "2022-04-25", "g": f"r{i % 4}", "v": i}]
            port.append("t", rows)
            appended.extend(rows)
            i += 1

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(3):
            port.compact_now("t")
    finally:
        stop.set()
        t.join()
    port.compact_now("t")
    jax.append("t", appended)
    _same(jax, port, label="racing")


def test_background_compactor_and_close(pair):
    jax, port = pair(ingest_auto_compact=True, ingest_compact_rows=4,
                     ingest_compact_interval_s=0.05)
    rows = [{"ts": "2022-04-25", "g": "bg", "v": 1}] * 6
    for eng in (jax, port):
        eng.append("t", rows)
    deadline = time.monotonic() + 10
    while port.catalog.get("t").segments.delta_rows and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert port.catalog.get("t").segments.delta_rows == 0
    _same(jax, port, label="bg-compact")
    compactor = port.ingest._compact_handle
    port.close()
    assert port.ingest._compact_handle is None
    assert compactor.cancelled and not compactor.running
    assert port.runner.stages._ticker is None
    assert int(port.sql("SELECT count(*) AS n FROM t")["n"][0]) == 2006


# ------------------------------------------------- partial survival

def test_delta_append_keeps_tier1_partials(pair):
    jax, port = pair(data=_df(4000), segment_cache_enabled=True,
                     result_cache_enabled=True)
    q = PARITY_QUERIES[0]
    row = [{"ts": "2022-05-01", "g": "g3", "v": 3}]
    for step in range(3):
        _same(jax, port, [q], f"tier1 {step}")
        rec, m = jax.runner.history[-1], port.runner.last_metrics
        for k in ("segments_cached", "segments_computed", "cache_tier"):
            assert m.get(k) == rec.get(k), (step, k, m, rec)
        if step:
            # the sealed partials survive the append: only straddlers
            # and the delta block are computed
            assert 0 < m["segments_computed"] < m["segments_cached"]
        for eng in (jax, port):
            eng.append("t", row)


def test_delta_append_keeps_cube_current(pair):
    jax, port = pair(data=_df(4000), cube_serve_min_reduction=0.0)
    ddl = ("CREATE DRUID CUBE c1 ON t DIMENSIONS (g) "
           "GRANULARITY month AGGREGATES (sum(v), count(*))")
    q = PARITY_QUERIES[0]
    rows = [{"ts": "2022-05-01", "g": "g3", "v": 3},
            {"ts": "2022-03-05", "g": "new_val", "v": 11}]
    for eng in (jax, port):
        eng.sql(ddl)
        eng.append("t", rows)
    _same(jax, port, [q], "cube delta")
    m = port.runner.last_metrics
    assert m["path"] == "cube" and m["delta_segments"] == 1
    assert jax.runner.history[-1].get("delta_segments") == 1
    assert port.cubes.get("c1").refreshes == 0
    for eng in (jax, port):
        eng.compact_now("t")
    _same(jax, port, [q], "cube stale")
    assert port.runner.last_metrics.get("path") != "cube"
    for eng in (jax, port):
        eng.sql("REFRESH DRUID CUBES")
    _same(jax, port, [q], "cube refreshed")
    assert port.runner.last_metrics["path"] == "cube"


# ------------------------------------------------------------ chaos

def test_chaos_kill_and_recover(pair, tmp_path):
    """One seed of the kill-and-recover round: appends, queries and
    compactions under seeded faults at the ingest sites, then a crash
    and a replay (itself under faults) into a fresh engine."""
    jax, port = pair(wal=True)
    inj = FaultInjector(seed=7, rate=0.2,
                        stages={"append", "wal-write", "compact"})
    port.config.fault_injector = inj
    rng = np.random.default_rng(7)
    acked = []
    q = PARITY_QUERIES[0]
    for _ in range(40):
        op = rng.integers(0, 10)
        if op < 6:
            rows = [{"ts": "2022-04-25", "g": f"c{int(rng.integers(4))}",
                     "v": int(rng.integers(100))}]
            try:
                port.append("t", rows)
                acked.extend(rows)
            except RuntimeError:
                pass
        elif op < 8:
            assert int(port.sql(q)["n"].sum()) == 2000 + len(acked)
        else:
            try:
                port.compact_now("t")
            except RuntimeError:
                pass
    port.config.fault_injector = None
    assert inj.faults > 0
    rec = _port(ingest_wal_dir=port.config.ingest_wal_dir)
    pair.made.append(rec)
    rec.config.fault_injector = FaultInjector(seed=8, rate=0.3,
                                              stages={"wal-replay"})
    try:
        rec.register_table("t", _df(), time_column="ts", block_rows=BLOCK)
    except RuntimeError:
        assert int(rec.sql(q)["n"].sum()) == 2000  # cleanly base-only
        rec.config.fault_injector = None
        rec.register_table("t", _df(), time_column="ts", block_rows=BLOCK)
    rec.config.fault_injector = None
    jax.append("t", acked)
    _same(jax, rec, label="chaos")
    rec.compact_now("t")
    _same(jax, rec, label="chaos compacted")


def test_out_of_bounds_time_follows_the_reference(pair):
    """pandas 3 represents 10**16 ms (year 318857) at ms resolution, so
    the JAX package acknowledges such a row (ROADMAP.md C); the port
    answers as the reference does."""
    jax, port = pair()
    row = [{"ts": 10**16, "g": "g1", "v": 123456}]
    j, p = _both((jax, port), lambda e: e.append("t", row))
    if isinstance(j, Exception):
        _same_error(j, p)
    else:
        assert p["rows"] == j["rows"] == 1
    _same(jax, port, ["SELECT count(*) AS n FROM t WHERE v = 123456"],
          "oob")


# ------------------------------------------------------------ rebase

def _full_stacks(ds, cols):
    """The stacks a dataset without a predecessor builds."""
    fresh = DeviceDataset(ds.table, ds.device)
    out = {c: fresh.col(c) for c in cols}
    out["\0valid"] = fresh.valid()
    return out


def test_rebase_uploads_only_changed_segments(pair):
    _, port = pair()
    port.sql(PARITY_QUERIES[1])
    port.append("t", [{"ts": "2022-04-01", "g": "g1", "v": 5}])
    port.sql(PARITY_QUERIES[1])
    for k in range(3):
        port.append("t", [{"ts": "2022-04-02", "g": "g2", "v": k}] * 300)
        table = port.catalog.get("t").segments
        prev = port.runner._datasets["t"]
        old = len(prev.table.segments)
        changed = [i for i, s in enumerate(table.segments)
                   if i >= old or s.uid != prev.table.segments[i].uid]
        got = port.sql(PARITY_QUERIES[1])
        ds = port.runner._datasets["t"]
        assert ds.table is table and ds.rebased_cols >= 3
        assert ds.rebase_rows_uploaded == \
            ds.rebased_cols * len(changed) * BLOCK
        want = _full_stacks(ds, ["v", "__time"])
        for c in ("v", "__time"):
            assert torch.equal(ds.col(c), want[c]), c
        assert torch.equal(ds.valid(), want["\0valid"])
        assert len(got) > 0

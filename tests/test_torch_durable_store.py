"""The durable segment store in the PyTorch port against the JAX package.

The scenarios of tests/test_durable_store.py (sys.* and the debug
surfaces aside, and the CPU rate floor of the batch encoder): the port's
checkpoints, WAL truncation, recovery ladder and crash sites, each
answer held against the JAX package — a JAX engine given the same
appends (numpy platform, use_pallas="never"), or a JAX engine over the
base plus the acknowledged rows. The chunk and manifest format is
shared: a store and a WAL the JAX engine wrote are recovered by a port
engine. The SIGKILL suite runs two of KILL_SITES, each in a fresh
interpreter that kills itself at the site.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pandas as pd
import pytest

from test_durable_store import (BLOCK, PARITY_QUERIES, _batch, _df,
                                _manifest_refs, _store_files)
from tpu_olap import Engine as JaxEngine
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.segments import delta as jax_delta
from tpu_olap_torch.bench.parity import assert_frame_parity
from tpu_olap_torch.resilience import FaultInjector
from tpu_olap_torch.resilience.errors import IngestBackpressure, UserError
from tpu_olap_torch.segments import delta as port_delta
from tpu_olap_torch.segments.store import (SegmentStore, StoreCorrupt,
                                           encode_segment)
from tpu_olap_torch.segments.wal import replay_wal, wal_path
from _torch_port import cpu_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT_KEYS = ("status", "checkpoint_id", "segments", "files_written",
                   "chunks_reused", "bytes", "wal_frames_truncated")


def _cfg(tmp, **kw):
    kw.setdefault("ingest_wal_dir", os.path.join(str(tmp), "wal"))
    kw.setdefault("ingest_store_dir", os.path.join(str(tmp), "store"))
    kw.setdefault("ingest_auto_compact", False)
    kw.setdefault("cube_auto_refresh", False)
    return kw


def _register(eng, data=None):
    eng.register_table("t", _df() if data is None else data,
                       time_column="ts", block_rows=BLOCK,
                       time_partition="month")
    return eng


@pytest.fixture
def engines(request):
    """mk(tmp, jax=False, register=True, **config): a port engine (or a
    JAX one, numpy platform) over the store and WAL under `tmp`, closed
    when the test ends."""
    made = []
    request.addfinalizer(lambda: [e.close() for e in made])

    def mk(tmp, jax=False, register=True, data=None, **kw):
        kw = _cfg(tmp, **kw)
        eng = JaxEngine(JaxConfig(platform="cpu", use_pallas="never",
                                  **kw)) if jax else \
            cpu_engine(use_fused_reduce="force", **kw)
        made.append(eng)
        return _register(eng, data) if register else eng
    return mk


def _reference(extra_rows, data=None):
    """The JAX package over the base plus `extra_rows`, registered at
    once."""
    data = _df() if data is None else data
    if extra_rows:
        ext = pd.DataFrame(extra_rows)
        ext["ts"] = pd.to_datetime(ext["ts"], format="mixed")
        data = pd.concat([data, ext], ignore_index=True)
    ref = JaxEngine(JaxConfig(platform="cpu", use_pallas="never",
                              cube_auto_refresh=False))
    return _register(ref, data)


def _parity(eng, ref, label=""):
    for q in PARITY_QUERIES:
        assert_frame_parity(eng.sql(q), ref.sql(q), ordered=True,
                            label=f"{label}: {q}")


def _rows(lo, hi):
    return [r for i in range(lo, hi) for r in _batch(i)]


def _same_checkpoint(p, j):
    for k in CHECKPOINT_KEYS:
        assert p.get(k) == j.get(k), (k, p, j)


# ------------------------------------------------- spill / truncation

def test_checkpoints_truncation_and_tail_recovery_match_jax(engines,
                                                            tmp_path):
    pairs = [engines(tmp_path / "jax", jax=True), engines(tmp_path / "port")]
    for i in range(4):
        for eng in pairs:
            eng.append("t", _batch(i))
    _same_checkpoint(*(e.checkpoint_now("t") for e in pairs[::-1]))
    r = [e.checkpoint_now("t") for e in pairs[::-1]]
    _same_checkpoint(*r)
    assert r[0]["status"] == "noop" and r[0]["files_written"] == 0
    seg = pairs[1].catalog.get("t").segments.segments[0]
    assert encode_segment(seg) == encode_segment(seg)
    for i in range(4, 6):
        for eng in pairs:
            eng.append("t", _batch(i))
    r = [e.checkpoint_now("t") for e in pairs[::-1]]
    _same_checkpoint(*r)
    assert r[0]["wal_frames_truncated"] == 4
    wal = wal_path(pairs[1].config.ingest_wal_dir, "t")
    assert [s for s, _ in replay_wal(wal)] == [5, 6]
    # the chunk files are the same bytes in both stores
    jn, jd = _store_files(tmp_path / "jax")
    pn, pd_ = _store_files(tmp_path / "port")
    assert jn == pn
    for n in pn:
        if not n.startswith("manifest-"):
            with open(os.path.join(jd, n), "rb") as a, \
                    open(os.path.join(pd_, n), "rb") as b:
                assert a.read() == b.read(), n
    for i in range(6, 8):
        for eng in pairs:
            eng.append("t", _batch(i))
    _parity(pairs[1], pairs[0], "live")
    pairs[1].close()
    rec = engines(tmp_path / "port")
    st = rec.ingest._state("t")
    assert st.acked_seq == 8 and st.replayed_rows == 6  # the 2-frame tail
    assert st.last_checkpoint["status"] == "loaded"
    _parity(rec, pairs[0], "tail-only")


def test_jax_written_store_and_wal_recover_in_the_port(engines, tmp_path):
    jax = engines(tmp_path, jax=True)
    for i in range(4):
        jax.append("t", _batch(i))
    jax.checkpoint_now("t")
    for i in range(4, 6):
        jax.append("t", _batch(i))
    jax.close()
    port = engines(tmp_path)
    assert port.ingest._state("t").acked_seq == 6
    _parity(port, jax, "jax store")


def test_checkpoint_on_compact_and_no_store(engines, tmp_path):
    eng = engines(tmp_path)
    for i in range(3):
        eng.append("t", _batch(i))
    res = eng.compact_now("t")
    assert res["checkpoint"]["status"] == "checkpointed"
    st = eng.ingest._state("t")
    assert st.checkpoints == 1 and st.sealed_through_seq == 3
    bare = engines(tmp_path / "bare", ingest_store_dir=None)
    bare.append("t", _batch(0))
    assert bare.checkpoint_now("t")["status"] == "no-store"
    assert bare.sql("CHECKPOINT DRUID TABLE t")["status"][0] == "no-store"


# ---------------------------------------------------- recovery ladder

def _two_checkpoints(engines, tmp):
    """acked batches 0..7: 0-3 in ck1, 4-5 in ck2, 6-7 the WAL tail."""
    eng = engines(tmp)
    for i in range(4):
        eng.append("t", _batch(i))
    eng.checkpoint_now("t")
    for i in range(4, 6):
        eng.append("t", _batch(i))
    eng.checkpoint_now("t")
    for i in range(6, 8):
        eng.append("t", _batch(i))
    eng.close()
    return _rows(0, 8)


def test_ladder_corrupt_manifest_deleted_chunk_and_bitflips(engines,
                                                             tmp_path):
    ref = _reference(_two_checkpoints(engines, tmp_path))
    names, d = _store_files(tmp_path)
    manifests = [n for n in names if n.startswith("manifest-")]
    refs2, _ = _manifest_refs(tmp_path, -1)
    refs1, _ = _manifest_refs(tmp_path, 0)
    # a bit flipped in every recoverable file, one at a time: detected,
    # recorded, and recovered to the oracle's answers
    for fname in manifests + sorted(refs1 ^ refs2):
        path = os.path.join(d, fname)
        with open(path, "rb") as f:
            orig = f.read()
        pos = len(orig) // 2
        with open(path, "wb") as f:
            f.write(orig[:pos] + bytes([orig[pos] ^ 0x55]) + orig[pos + 1:])
        rec = engines(tmp_path)
        falls = rec.ingest._state("t").store_fallbacks
        if fname == manifests[-1]:
            assert falls and falls[0][0] == fname, falls
        _parity(rec, ref, f"bit-flip {fname}")
        rec.close()
        with open(path, "wb") as f:
            f.write(orig)
    # the newest manifest's own chunk deleted: one rung down
    fresh = sorted(refs2 - refs1)[0]
    with open(os.path.join(d, fresh), "rb") as f:
        keep = f.read()
    os.unlink(os.path.join(d, fresh))
    rec = engines(tmp_path)
    falls = rec.ingest._state("t").store_fallbacks
    assert falls and "missing chunk" in falls[0][1]
    _parity(rec, ref, "deleted chunk")
    rec.close()
    with open(os.path.join(d, fresh), "wb") as f:
        f.write(keep)
    # the chunk every rung shares is the only copy of its rows: the
    # registration is refused, never served short
    shared = sorted(refs1 & refs2)[0]
    path = os.path.join(d, shared)
    with open(path, "rb") as f:
        orig = f.read()
    with open(path, "wb") as f:
        f.write(orig[:64] + bytes([orig[64] ^ 0x55]) + orig[65:])
    rec = engines(tmp_path, register=False)
    with pytest.raises(RuntimeError, match="recovery .* refused"):
        _register(rec)
    assert rec.catalog.maybe("t") is None
    with open(path, "wb") as f:
        f.write(orig)
    _parity(engines(tmp_path), ref, "restored")


def test_all_manifests_torn_replays_whole_wal(engines, tmp_path):
    eng = engines(tmp_path)
    for i in range(4):
        eng.append("t", _batch(i))
    eng.checkpoint_now("t")
    eng.close()
    names, d = _store_files(tmp_path)
    for n in names:
        if n.startswith("manifest-"):
            with open(os.path.join(d, n), "ab") as f:
                f.truncate(10)
    rec = engines(tmp_path)
    assert rec.ingest._state("t").replayed_rows == 12
    _parity(rec, _reference(_rows(0, 4)), "base + WAL")


def test_store_unit_load_ladder(engines, tmp_path):
    _two_checkpoints(engines, tmp_path)
    store = SegmentStore(os.path.join(str(tmp_path), "store"))
    loaded = store.load("t")
    assert loaded.segments is not None and not loaded.fallbacks
    names, d = _store_files(tmp_path)
    for n in names:
        if n.startswith(("seg-", "dict-")):
            with open(os.path.join(d, n), "r+b") as f:
                f.seek(8)
                f.write(b"\x00\x00\x00\x00")
    loaded = store.load("t")
    assert loaded.segments is None and len(loaded.fallbacks) == 2
    assert store.load("missing") is None
    with pytest.raises(StoreCorrupt):
        store._read_manifest(os.path.join(d, "manifest-absent.json"))


# -------------------------------------------------------- crash sites

KILLED_SITES = ("spill-write", "wal-truncate")

_CHILD = textwrap.dedent("""
    import os, signal, sys
    sys.path[:0] = [{repo!r}, {tests!r}]
    from test_durable_store import BLOCK, _batch, _df
    from tpu_olap_torch import Engine

    class KillAt:
        stages = {{{site!r}}}
        def __call__(self, stage, attempt):
            os.kill(os.getpid(), signal.SIGKILL)

    eng = Engine(device="cpu", ingest_wal_dir={wal!r},
                 ingest_store_dir={store!r}, ingest_auto_compact=False,
                 cube_auto_refresh=False, ingest_wal_fsync="always")
    eng.register_table("t", _df(), time_column="ts", block_rows=BLOCK,
                       time_partition="month")
    for i in range(3):
        eng.append("t", _batch(i))
    eng.checkpoint_now("t")
    for i in range(3, 6):
        eng.append("t", _batch(i))
    eng.checkpoint_now("t")   # a second rung: wal-truncate runs
    for i in range(6, 8):
        eng.append("t", _batch(i))
    eng.config.fault_injector = KillAt()
    eng.checkpoint_now("t")
    sys.exit(86)              # the site never fired
""")


@pytest.mark.parametrize("site", KILLED_SITES)
def test_sigkill_at_fault_site_recovers(engines, tmp_path, site):
    code = _CHILD.format(repo=REPO, tests=os.path.join(REPO, "tests"),
                         site=site, wal=str(tmp_path / "wal"),
                         store=str(tmp_path / "store"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == -9, out.stdout + out.stderr
    rec = engines(tmp_path)
    assert rec.ingest._state("t").acked_seq == 8
    _parity(rec, _reference(_rows(0, 8)), f"SIGKILL {site}")


def test_seeded_chaos_at_the_store_sites(engines, tmp_path):
    eng = engines(tmp_path)
    inj = FaultInjector(seed=23, rate=0.35,
                        stages={"spill-write", "manifest-swap",
                                "wal-truncate", "compact"})
    eng.config.fault_injector = inj
    rng = np.random.default_rng(23)
    acked = []
    for i in range(24):
        try:
            eng.append("t", _batch(i))
            acked.extend(_batch(i))
        except RuntimeError:
            pass
        if rng.random() < 0.4:
            try:
                res = eng.checkpoint_now("t")
                assert res["status"] in ("checkpointed", "noop", "busy",
                                         "error", "compacted",
                                         "breaker-open")
            except RuntimeError:
                pass
    assert inj.faults > 0
    eng.config.fault_injector = None
    eng.close()
    _parity(engines(tmp_path), _reference(acked), "chaos")


def test_double_crash_during_recovery(engines, tmp_path):
    ref = _reference(_two_checkpoints(engines, tmp_path))
    rec = engines(tmp_path, register=False)
    for site in ("store-load", "wal-replay"):
        rec.config.fault_injector = FaultInjector(seed=1, rate=1.0,
                                                  stages={site})
        with pytest.raises(RuntimeError):
            _register(rec)
    rec.config.fault_injector = None
    _register(rec)
    _parity(rec, ref, "double crash")


def test_checkpoint_racing_appends(engines, tmp_path):
    eng = engines(tmp_path)
    acked, stop = [], threading.Event()
    lock = threading.Lock()

    def writer():
        i = 100
        while not stop.is_set() and i < 400:
            eng.append("t", _batch(i))
            with lock:
                acked.extend(_batch(i))
            i += 1

    th = threading.Thread(target=writer)
    th.start()
    try:
        for _ in range(4):
            res = eng.checkpoint_now("t")
            assert res["status"] in ("checkpointed", "noop", "busy")
            st = eng.ingest._state("t")
            assert st.sealed_through_seq <= st.acked_seq
            time.sleep(0.01)
    finally:
        stop.set()
        th.join()
    assert int(eng.sql("SELECT count(*) AS n FROM t")["n"][0]) \
        == 2000 + len(acked)
    eng.close()
    _parity(engines(tmp_path), _reference(acked), "racing")


def test_noop_checkpoint_still_truncates(engines, tmp_path):
    eng = engines(tmp_path)
    wal = wal_path(eng.config.ingest_wal_dir, "t")
    for i in range(3):
        eng.append("t", _batch(i))
    eng.checkpoint_now("t")
    for i in range(3, 5):
        eng.append("t", _batch(i))
    eng.config.fault_injector = FaultInjector(seed=3, rate=1.0,
                                              stages={"wal-truncate"})
    with pytest.raises(RuntimeError):
        eng.checkpoint_now("t")
    eng.config.fault_injector = None
    assert len(replay_wal(wal)) == 5
    res = eng.checkpoint_now("t")
    assert res["status"] == "noop" and res["wal_frames_truncated"] == 3
    assert [s for s, _ in replay_wal(wal)] == [4, 5]
    _parity(eng, _reference(_rows(0, 5)), "noop truncate")


def test_stale_checkpoint_replacement_reregister_and_drop(engines,
                                                          tmp_path):
    eng = engines(tmp_path)
    eng.append("t", _batch(0))
    old_entry, old_st = eng.catalog.get("t"), eng.ingest._state("t")
    _register(eng, _df(seed=9))
    assert eng.ingest._checkpoint_sealed("t", old_entry, old_st) == \
        {"status": "stale"}
    d = os.path.join(str(tmp_path), "store", "t")
    assert not os.path.isdir(d)
    eng.append("t", _batch(1))
    eng.checkpoint_now("t")
    assert os.path.isdir(d)
    _register(eng, _df(seed=9))           # a live re-registration
    assert not os.path.isdir(d)
    assert int(eng.sql("SELECT count(*) AS n FROM t")["n"][0]) == 2000
    eng.append("t", _batch(2))
    eng.checkpoint_now("t")
    eng.drop_table("t")
    assert not os.path.isdir(d)


def test_close_reopen_checkpoint_idempotent(engines, tmp_path):
    eng = engines(tmp_path)
    for i in range(3):
        eng.append("t", _batch(i))
    assert eng.checkpoint_now("t")["status"] == "checkpointed"
    eng.close()
    rec = engines(tmp_path)
    r2 = rec.checkpoint_now("t")
    assert r2["status"] == "noop" and r2["files_written"] == 0
    rec.close()
    _parity(engines(tmp_path), _reference(_rows(0, 3)), "reopen")


# --------------------------------------------------------- compaction

def test_incremental_and_full_compaction_match_jax(engines, tmp_path):
    jax, port = engines(tmp_path / "j", jax=True), engines(tmp_path / "p")
    for eng in (jax, port):
        eng.checkpoint_now("t")
        for i in range(3):
            eng.append("t", _batch(i))  # April only
    j, p = jax.compact_now("t"), port.compact_now("t")
    assert p["mode"] == j["mode"] == "incremental"
    assert p["segments_reused"] == j["segments_reused"] > 0
    _same_checkpoint(p["checkpoint"], j["checkpoint"])
    assert p["checkpoint"]["chunks_reused"] >= p["segments_reused"]
    row = [{"ts": "2022-04-02T00:00:00", "g": "aaa_new", "v": 5}]
    for eng in (jax, port):
        eng.append("t", row)
    j, p = jax.compact_now("t"), port.compact_now("t")
    assert p["mode"] == j["mode"] == "full"
    assert port.catalog.get("t").segments.dictionaries["g"].is_sorted
    _parity(port, jax, "compactions")


def test_encode_rows_matches_jax(engines, tmp_path):
    jax = engines(tmp_path / "j", jax=True)
    port = engines(tmp_path / "p")
    rows = [{"ts": "2022-04-01T00:00:00", "g": "zz", "v": 1},
            {"ts": "2022-04-01T00:00:01", "g": "aa", "v": None},
            {"ts": "2022-04-01T00:00:02", "g": "zz", "v": None},
            {"ts": "2022-04-01T00:00:03", "g": None, "v": 4},
            {"ts": "2022-04-01T00:00:04", "g": "mm", "v": 5.0}]
    encs = []
    for eng, mod in ((jax, jax_delta), (port, port_delta)):
        canon = mod.canonicalize_rows(rows, "ts")
        encs.append(mod.encode_rows(eng.catalog.get("t").segments, canon,
                                    require_time=True))
    j, p = encs
    assert p.n == j.n and p.new_dict_values == j.new_dict_values
    assert set(p.cols) == set(j.cols) and set(p.nulls) == set(j.nulls)
    for c in j.cols:
        assert p.cols[c].dtype == j.cols[c].dtype
        assert np.array_equal(p.cols[c], j.cols[c]), c
    for c in j.nulls:
        assert np.array_equal(p.nulls[c], j.nulls[c]), c
    before = port.catalog.get("t").segments
    with pytest.raises(UserError, match="LONG"):
        port.append("t", [{"ts": "2022-04-01", "g": "x", "v": 1},
                          {"ts": "2022-04-01", "g": "x", "v": "junk"}])
    assert port.catalog.get("t").segments is before


def test_retry_after_from_measured_drain_rate(engines, tmp_path):
    eng = engines(tmp_path, ingest_max_delta_rows=64,
                  ingest_store_checkpoint_on_compact=False)
    st = eng.ingest._state("t")
    for i in range(21):
        eng.append("t", _batch(i))
    with pytest.raises(IngestBackpressure) as e1:
        eng.append("t", _batch(99))
    assert e1.value.retry_after_s == eng.config.ingest_retry_after_s
    eng.compact_now("t")
    assert st.drain_rps and st.drain_rps > 0
    for i in range(21):
        eng.append("t", _batch(i))
    with pytest.raises(IngestBackpressure) as e2:
        eng.append("t", _batch(99))
    lo, hi = eng.ingest._RETRY_AFTER_BOUNDS
    assert e2.value.retry_after_s == pytest.approx(
        min(hi, max(lo, 2 / st.drain_rps)))
    snap = eng.ingest.snapshot()["tables"]["t"]
    assert snap["drain_rows_per_s"] == round(st.drain_rps, 1)
    assert json.dumps(snap, default=str)

"""The port's multi-host mesh with real processes, on the CPU, against
the JAX package.

One run of tpu_olap_torch.bench.multihost (the counterpart of
tools/multihost_check.py): two ranks, spawned, each opening a gloo
process group and an engine of two logical CPU devices (global D = 4)
over the small tables of tests/test_torch_sharding.py — test_sharding's
frame and SSB at 60,000 rows. Every rank runs the same statements: the
13 SSB queries, x4 (sparse), test_sharding's queries (a timeseries
among them), a GROUP BY past the dense budget whose local cap overflows
on purpose, scans, a search, a batch, a tier-1 window and sys.devices.
Each rank's frames are held against the JAX engine on one device with
the parity harness, rank 0's against rank 1's exactly, and the metrics
against the JAX package's multi-host contract (one collective per
aggregate, strategy "broker", tier 1 and batch refused with its reason
strings, `process` per sys.devices row). The ranks import no JAX: only
this process computes the reference.

In this process, without spawning: the rank-order fold of
gather_partials on the same partial tables against the JAX broker
merge, and the ownership map of the multi-host mesh against the
interleaved placement at the global D.
"""

import functools
import inspect

import numpy as np
import pandas as pd
import pytest
import torch

from test_sharding import QUERIES, build
from tpu_olap.bench import ssb as jax_ssb
from tpu_olap.executor import batch as jax_batch
from tpu_olap.executor import resultcache as jax_rc
from tpu_olap.executor import sharding as jax_sh
from tpu_olap_torch.bench import assert_frame_parity, multihost, ssb
from tpu_olap_torch.executor import collective
from tpu_olap_torch.executor import sharding as sh

import _torch_multihost_peers as peers
from _torch_port import cpu_engine

WORLD, LOCAL = 2, 2
D = WORLD * LOCAL
TIER1_REASON = "multi-host mesh (remote shards not addressable)"
BATCH_REASON = "multi-host mesh legs run alone"

SPARSE_SQL = ("SELECT uid, brand, sum(qty) AS s, min(price) AS mn, "
              "count(*) AS n FROM f GROUP BY uid, brand ORDER BY uid, brand")
SCANS = {"scan qty": "SELECT brand, qty FROM f WHERE qty = 49 LIMIT 12",
         "scan ts": "SELECT ts, brand FROM f WHERE region = 'ASIA' "
                    "ORDER BY ts DESC LIMIT 9"}
SEARCH = "SEARCH DRUID DATASOURCE f FOR 'b1' IN brand, region LIMIT 40"
TIER1 = ("SELECT region, sum(qty) AS s FROM f WHERE ts >= '1993-03-01' "
         "AND ts < '1993-09-01' GROUP BY region ORDER BY region")
BATCH = [QUERIES[1], QUERIES[2], QUERIES[3]]

AGGREGATES = {**{n: q for n, q in ssb.QUERIES.items()},
              **{f"f{i}": q for i, q in enumerate(QUERIES)},
              "tier1": TIER1}
STATEMENTS = (
    [(n, q) for n, q in AGGREGATES.items() if n != "tier1"]
    + [("x4", ssb.DISTINCT_QUERIES["x4"]),
       # past the dense budget, with a local cap every device overflows
       ("sparse", SPARSE_SQL, {"dense_group_budget": 1024,
                               "sparse_group_cap": 64}),
       *SCANS.items(),
       ("search", SEARCH),
       ("batch", BATCH),
       ("tier1", TIER1, {"segment_cache_enabled": True,
                         "segment_cache_min_rows": 0}),
       ("devices", "SELECT * FROM sys.devices")])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(JAX engine on one device, the two ranks' records)."""
    jax, df = build(num_shards=None)
    tables = jax_ssb.generate_tables(60_000, 0)
    jax_ssb.register_ssb(jax, tables=tables, block_rows=4096)
    workdir = tmp_path_factory.mktemp("multihost")
    path = workdir / "tables.pkl"
    multihost.write_tables(path, [
        ("f", df, {"time_column": "ts", "block_rows": 1 << 11}),
        ("lineorder", ssb.denormalize(tables),
         {"time_column": ssb.TIME_COL, "star_schema": ssb.star_schema(),
          "block_rows": 4096}),
        *[(t, tables[t], {"accelerate": False})
          for t in ("date", "customer", "supplier", "part")]])
    ranks = multihost.run(
        WORLD, LOCAL, "gloo", "cpu",
        functools.partial(multihost.file_engine, path=str(path),
                          cube_auto_refresh=False),
        STATEMENTS, workdir, repeats=1, timeout_s=120)
    return jax, ranks


def test_ranks_form_one_mesh(run):
    _, ranks = run
    for r, rec in enumerate(ranks):
        assert rec["rank"] == r and rec["is_multihost"]
        assert rec["mesh"]["size"] == D and rec["mesh"]["world"] == WORLD
        assert rec["mesh"]["local_ids"] == list(range(r * LOCAL,
                                                      (r + 1) * LOCAL))
        assert not rec["imports_jax"]


@pytest.mark.parametrize("label", [s[0] for s in STATEMENTS
                                   if s[0] not in ("batch", "devices")])
def test_rank_frames_match_jax(run, label):
    jax, ranks = run
    sql = dict((s[0], s[1]) for s in STATEMENTS)[label]
    want = jax.sql(sql)
    for rec in ranks:
        assert_frame_parity(rec["frames"][label], want,
                            ordered="ORDER BY" in sql,
                            label=f"rank {rec['rank']} {label}")
    pd.testing.assert_frame_equal(ranks[0]["frames"][label],
                                  ranks[1]["frames"][label],
                                  check_exact=True)


@pytest.mark.parametrize("label", list(AGGREGATES))
def test_aggregate_merges_by_one_collective(run, label):
    """Every aggregate folds its local devices, then crosses in one
    all_gather folded in rank order: strategy "broker" as the JAX
    package forces it across processes, merge "collective"."""
    _, ranks = run
    for rec in ranks:
        m = rec["metrics"][label]
        assert m["num_shards"] == D and m["strategy"] == "broker"
        assert m["merge"] == "collective"
        assert m["collectives"] == 1 and m["collective_bytes"] > 0
        assert rec["counts"][label]["collectives"] == 1
        # the local copies: one per device, or one after the device fold
        assert m["host_copies"] in (1, LOCAL)
    assert ranks[0]["metrics"][label]["collective_bytes"] == \
        ranks[1]["metrics"][label]["collective_bytes"]


def test_sparse_merges_under_the_global_budget(run):
    _, ranks = run
    for rec in ranks:
        m = rec["metrics"]["sparse"]
        assert m["route"] == "sparse" and m["sparse_merge"] == "collective"
        assert m["sparse_reruns"] == [64]   # every rank re-ran together
        # agree at cap 64, agree again, then the lengths and the tables
        assert m["collectives"] == 4
        assert m["result_groups"] == len(rec["frames"]["sparse"])
        assert rec["metrics"]["x4"]["route"] == "sparse"


def test_masks_and_search_cross_ranks(run):
    _, ranks = run
    for rec in ranks:
        for label in (*SCANS, "search"):
            m = rec["metrics"][label]
            assert m["route"] == "mask" and m["num_shards"] == D
            assert m["host_copies"] == LOCAL and m["collectives"] == 1


def test_tier1_and_batch_give_the_jax_reasons(run):
    jax, ranks = run
    assert TIER1_REASON in inspect.getsource(jax_rc)
    assert BATCH_REASON in inspect.getsource(jax_batch.fusable)
    for rec in ranks:
        assert rec["metrics"]["tier1"]["segment_cache"] == \
            f"bypass: {TIER1_REASON}"
        assert rec["batch_reasons"]["batch"] == [BATCH_REASON] * len(BATCH)
        stmts = rec["metrics"]["batch"]["statements"]
        assert all(s.get("route") != "batch" for s in stmts)
        assert rec["counts"]["batch"]["collectives"] == len(BATCH)
        for got, sql in zip(rec["frames"]["batch"], BATCH):
            assert_frame_parity(got, jax.sql(sql), ordered=True)
    for a, b in zip(ranks[0]["frames"]["batch"], ranks[1]["frames"]["batch"]):
        pd.testing.assert_frame_equal(a, b, check_exact=True)


def test_sys_devices_gives_each_devices_process(run):
    _, ranks = run
    for rec in ranks:
        dev = rec["frames"]["devices"]
        assert list(dev["index"]) == list(range(D))
        assert list(dev["process"]) == [g // LOCAL for g in range(D)]
        assert (dev.chips == D).all()
        mine = dev[dev.process == rec["rank"]]
        assert (mine.dispatches > 0).all() and (mine.hbm_bytes > 0).all()
        assert (dev[dev.process != rec["rank"]].hbm_bytes == 0).all()
    # both ranks count every segment of both tables once
    assert list(ranks[0]["frames"]["devices"].segments) == \
        list(ranks[1]["frames"]["devices"].segments)


# ----------------------------------------------- in process, no spawning

def _partials(request, n_dev):
    """The n_dev per-device partial dicts of one real dispatch."""
    _, df = build(num_shards=None)
    eng = cpu_engine(num_shards=n_dev)
    request.addfinalizer(eng.close)
    eng.register_table("f", df, time_column="ts", block_rows=1 << 11)
    plan = eng.planner.plan(
        "SELECT brand, sum(qty) AS s, sum(price) AS p, min(price) AS mn,"
        " max(qty) AS mx, count(*) AS n, count(DISTINCT uid) AS u,"
        " theta_sketch_estimate(theta_sketch(uid)) AS t FROM f GROUP BY brand")
    runner = eng.runner
    phys = runner._lower_cached(plan.query, plan.entry.segments)
    env, valid, seg_mask, consts = runner._prepare(phys, {})
    parts = [{n: t.numpy() for n, t in out.items()}
             for out in sh.launch_per_device(
                 runner.mesh, phys.kernel,
                 sh.device_args(env, valid, seg_mask, consts))]
    return phys, parts


@pytest.mark.parametrize("local", [1, 2])
def test_rank_order_fold_matches_jax_broker_merge(request, local):
    """D = 4 partial tables as 4 ranks of one device, or 2 ranks of two
    (each folded locally first): packed, unpacked and folded in rank
    order, against the JAX broker merge of the same [D·K] tables."""
    phys, parts = _partials(request, D)
    kinds = {p.kind for p in phys.agg_plans}
    assert {"sum", "min", "max", "hll", "theta"} <= kinds
    ranks = [sh.broker_merge(parts[r * local:(r + 1) * local],
                             phys.agg_plans) for r in range(D // local)]
    bufs = [collective.pack(p) for p in ranks]
    got = collective.fold_in_rank_order(bufs, collective.layout(ranks[0]),
                                        phys.agg_plans)
    stacked = {n: np.concatenate([p[n] for p in parts]) for n in parts[0]}
    want = jax_sh.broker_merge(stacked, phys.agg_plans, D)
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n].numpy()
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12)
        else:
            np.testing.assert_array_equal(g, np.asarray(w))


def test_pack_round_trips_every_dtype():
    parts = {"a": torch.arange(5, dtype=torch.int64),
             "b": torch.tensor([True, False, True]),
             "c": torch.rand(3, 2, dtype=torch.float64),
             "_rows": torch.arange(3, dtype=torch.int32),
             "h": torch.arange(7, dtype=torch.uint8)}
    back = collective.unpack(collective.pack(parts),
                             collective.layout(parts))
    for n, t in parts.items():
        assert back[n].dtype == t.dtype and torch.equal(back[n], t)


@pytest.mark.parametrize("world, n", [(2, 4), (2, 8), (4, 8), (4, 4)])
def test_multihost_ownership_matches_placement(world, n):
    """Rank r of make_multihost_mesh's layout holds global devices
    [r·L, (r+1)·L); the shards it uploads, in rank order, are the JAX
    package's placed order at the global D."""
    L = n // world
    for segs in (n, 3 * n, 37):
        s = sh.pad_segments(segs, n)
        to_place, to_logical = jax_sh.placement(s, n)
        per_chip = s // n
        arr = np.arange(s, dtype=np.int64)
        placed = []
        for r in range(world):
            mesh = sh.rank_mesh(r, world, n, "cpu")
            assert sh.is_multihost(mesh) and mesh.size == n
            assert list(mesh.local_ids) == list(range(r * L, (r + 1) * L))
            shards = sh.shard_host(arr, mesh)
            assert len(shards) == L
            for g, t in zip(mesh.local_ids, shards):
                owned = t.numpy()
                assert all(to_place[i] // per_chip == g for i in owned)
                assert all(jax_sh.chip_of(i, n) // L == r for i in owned)
            placed += [t.numpy() for t in shards]
        np.testing.assert_array_equal(np.concatenate(placed), to_logical)


def test_make_multihost_mesh_without_a_group_and_its_errors(monkeypatch):
    mesh = sh.make_multihost_mesh(3, "cpu")
    assert (mesh.rank, mesh.world, mesh.size) == (0, 1, 3)
    assert not sh.is_multihost(mesh)
    with pytest.raises(ValueError, match="does not split over 2"):
        sh.rank_mesh(0, 2, 3, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    a, b = (sh.rank_mesh(r, 2, 2, "cuda") for r in (0, 1))
    assert a.devices == (torch.device("cuda", 0),)
    assert b.devices == (torch.device("cuda", 1),)
    with pytest.raises(ValueError, match="exceeds 2 devices"):
        sh.rank_mesh(0, 2, 4, "cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    from tpu_olap_torch.utils import platform
    try:
        platform.force_virtual_devices(2)
        shared = [sh.rank_mesh(r, 2, 4, "cuda") for r in (0, 1)]
        assert all(m.devices == (torch.device("cuda", 0),) * 2
                   for m in shared)
    finally:
        platform.force_virtual_devices(0)


def test_a_failed_rank_raises(tmp_path):
    """A rank that raises ends the run with its error, and its peers do
    not outlive it."""
    import torch.multiprocessing as mp
    with pytest.raises(mp.ProcessRaisedException, match="FileNotFound"):
        multihost.run(WORLD, LOCAL, "gloo", "cpu",
                      functools.partial(multihost.file_engine,
                                        path=str(tmp_path / "missing.pkl")),
                      [("n", "SELECT 1")], tmp_path, timeout_s=60)


# ------------------------------------------------- one rank goes wrong

@pytest.fixture(scope="module")
def peers_run(tmp_path_factory):
    """(JAX engine on one device, {scenario: {rank: record}}): every
    scenario of _torch_multihost_peers over test_sharding's table, the
    scenarios side by side."""
    jax, df = build(num_shards=None)
    workdir = tmp_path_factory.mktemp("peers")
    path = workdir / "tables.pkl"
    multihost.write_tables(path, [("f", df, {"time_column": "ts",
                                             "block_rows": 1 << 11})])
    return jax, peers.spawn(peers.SCENARIOS, path, workdir)


def _answers_match(jax, outcomes, index):
    frames = [o[index]["frame"] for o in outcomes]
    for f in frames:
        assert_frame_parity(f, jax.sql(peers.STATEMENTS[index]),
                            ordered=True)
    for f in frames[1:]:
        pd.testing.assert_frame_equal(frames[0], f, check_exact=True)


def test_a_failure_on_one_rank_keeps_the_ranks_in_step(peers_run):
    """Rank 1 alone fails a dispatch before its collective: it retries
    at the global D (degrade_shards_on_retry does not shrink one rank's
    mesh), and both ranks answer right. Rank 1 alone fails after its
    collective: it raises and does not re-run the statement, rank 0
    answers, and the next statement runs on both."""
    jax, runs = peers_run
    got = runs["retry"]
    r0, r1 = got[0]["outcomes"], got[1]["outcomes"]
    assert got[0]["num_shards"] == got[1]["num_shards"] == D
    m = r1[1]["metrics"]
    assert m["retries"] == 1 and "degraded_shards" not in m
    assert m["num_shards"] == D and m["collectives"] == 1
    assert "retries" not in r0[1]["metrics"]
    assert r1[2]["error"] == "RuntimeError"
    assert "after the collective" in r1[2]["msg"]
    assert_frame_parity(r0[2]["frame"], jax.sql(peers.STATEMENTS[2]),
                        ordered=True)
    for i in (0, 1, 3):
        _answers_match(jax, (r0, r1), i)


@pytest.mark.parametrize("scenario, bound_s", [
    ("exit", peers.GROUP_TIMEOUT_S), ("exit-deadline", peers.DEADLINE_S)])
def test_a_peer_that_exits_surfaces_as_an_error(peers_run, scenario,
                                                bound_s):
    """Rank 1 exits after the first statement: rank 0's next statement
    raises, within the group's timeout, or within the query deadline
    when one is set; it never hangs."""
    jax, runs = peers_run
    got = runs[scenario]
    assert set(got) == {0}
    first, second = got[0]["outcomes"]
    _answers_match(jax, [got[0]["outcomes"]], 0)
    assert "error" in second and "frame" not in second
    assert second["s"] < bound_s + 2


def test_a_late_peer_answers_where_the_deadline_raised(peers_run):
    """Rank 1 comes LATE_S late to a statement whose deadline is shorter:
    rank 0 raises QueryDeadlineExceeded, but its abandoned worker still
    takes part in the collective, so rank 1 answers, and right. From
    the next statement on both ranks answer again."""
    jax, runs = peers_run
    got = runs["late"]
    r0, r1 = got[0]["outcomes"], got[1]["outcomes"]
    assert r0[1]["error"] == "QueryDeadlineExceeded"
    assert r0[1]["s"] < peers.LATE_S
    assert_frame_parity(r1[1]["frame"], jax.sql(peers.STATEMENTS[1]),
                        ordered=True)
    for i in (0, 2):
        _answers_match(jax, (r0, r1), i)

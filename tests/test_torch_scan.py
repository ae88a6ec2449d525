"""Scan and Select in the PyTorch port (tpu_olap_torch, on the CPU) against
the JAX package, and the row-mask kernel's plain versions.

Both packages serve the same segments (the JAX ingest carried into the
port, segments/carry.py), so the row mask and every gathered row must be
equal exactly: scans copy raw values, there is no tolerance. The cases
mirror the JAX package's own (tests/test_executor.py,
tests/test_sql_extended.py, tests/test_planner.py) and add a
month-partitioned table whose interval cuts the segment window, an
offset past the first segment, no LIMIT, and nullable columns. The
row-mask kernel's generated row function is compiled with the host c++
and held against `rowprog.evaluate`; the kernel itself runs only on a
card (the `gpu` test skips here).
"""

import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from tpu_olap import Engine as JaxEngine
from tpu_olap.bench import ssb as jax_ssb
from tpu_olap.executor import EngineConfig as JaxConfig
from tpu_olap.executor import QueryRunner as JaxRunner
from tpu_olap.executor.lowering import lower as jax_lower
from tpu_olap.ir import serde as jax_serde
from tpu_olap_torch.bench import ssb
from tpu_olap_torch.executor import EngineConfig, QueryRunner
from tpu_olap_torch.executor import runner as runner_mod
from tpu_olap_torch.ir import VirtualColumn, parse_expr
from tpu_olap_torch.ir.serde import query_from_json
from tpu_olap_torch.kernels import row_mask, rowgen
from tpu_olap_torch.segments.carry import carry_table

from _torch_port import carry_into, cpu_engine, export_segments
from test_executor import DF, TABLE
from test_pallas_reduce import _table as nullable_table
from test_torch_rowgen import _check as check_row_function
from test_torch_rowgen import _harness

FILTER = {"type": "and", "fields": [
    {"type": "selector", "dimension": "city", "value": "chicago"},
    {"type": "bound", "dimension": "qty", "lower": "45",
     "ordering": "numeric"}]}

# Druid JSON of each case, run by both packages on test_executor's table
EXEC_CASES = {
    # test_executor.py::test_scan_with_filter_and_limit, both halves
    "filter_limit": {"queryType": "scan", "filter": FILTER,
                     "columns": ["city", "qty", "price"], "limit": 10},
    "filter_offset": {"queryType": "scan", "filter": FILTER,
                      "columns": ["qty"], "offset": 10, "limit": 5},
    # test_executor.py::test_scan_descending
    "descending": {"queryType": "scan", "columns": ["qty"], "limit": 5,
                   "order": "descending"},
    "no_limit": {"queryType": "scan", "filter": FILTER,
                 "columns": ["__time", "city", "uid"]},
    "all_columns": {"queryType": "scan", "limit": 30, "offset": 2040},
    "interval": {"queryType": "scan",
                 "intervals": ["1994-03-01/1994-04-15"],
                 "columns": ["__time", "kind"], "limit": 40, "offset": 7},
    "virtual_filter": {
        "queryType": "scan", "columns": ["qty", "uid"], "limit": 20,
        "virtualColumns": [VirtualColumn("v", parse_expr("qty * 3 - uid"))
                           .to_json()],
        "filter": {"type": "bound", "dimension": "v", "upper": "-500",
                   "ordering": "numeric"}},
    # test_executor.py::test_select_paging, both pages
    "select_page1": {"queryType": "select",
                     "filter": {"type": "selector", "dimension": "kind",
                                "value": "aa"},
                     "dimensions": ["city", "kind"], "metrics": ["qty"],
                     "pagingSpec": {"threshold": 7}},
    "select_page2": {"queryType": "select",
                     "filter": {"type": "selector", "dimension": "kind",
                                "value": "aa"},
                     "dimensions": ["city", "kind"], "metrics": ["qty"],
                     "pagingSpec": {"threshold": 7,
                                    "pagingIdentifiers": {"offset": 7}}},
    "select_descending": {"queryType": "select", "descending": True,
                          "pagingSpec": {"threshold": 9}},
}


@pytest.fixture(scope="module")
def exec_runners():
    """(JAX runner, port runner, port table) over test_executor's table."""
    port_table = carry_table(**export_segments(TABLE))
    return (JaxRunner(JaxConfig(platform="cpu")),
            QueryRunner(EngineConfig(device="cpu")), port_table)


def _ir(case, source="t"):
    spec = dict(EXEC_CASES[case], dataSource=source)
    return jax_serde.query_from_json(spec), query_from_json(spec)


@pytest.mark.parametrize("case", list(EXEC_CASES))
def test_scan_and_select_match_jax(exec_runners, case):
    jax_runner, runner, table = exec_runners
    jq, q = _ir(case)
    want = jax_runner.execute(jq, TABLE)
    got = runner.execute(q, table)
    assert got.rows == want.rows
    assert got.druid == want.druid
    assert len(got.rows) > 0
    m = runner.last_metrics
    assert m["route"] == "mask" and m["host_copies"] == 1
    # a numeric bound on an expression compares against a float64
    # literal, which no row program holds: the torch front half serves it
    assert m["mask_kernel"] == (case != "virtual_filter"), \
        m.get("mask_reason")
    assert ("mask_reason" in m) == (case == "virtual_filter")


def test_scan_rows_match_pandas(exec_runners):
    """test_executor.py's pandas checks, on the port."""
    _, runner, table = exec_runners
    sub = DF[(DF.city == "chicago") & (DF.qty >= 45)]
    got = runner.execute(_ir("filter_limit")[1], table).rows
    assert [r["qty"] for r in got] == sub.qty.iloc[:10].tolist()
    got = runner.execute(_ir("filter_offset")[1], table).rows
    assert [r["qty"] for r in got] == sub.qty.iloc[10:15].tolist()
    got = runner.execute(_ir("no_limit")[1], table).rows
    assert [r["uid"] for r in got] == sub.uid.tolist()
    got = runner.execute(_ir("descending")[1], table).rows
    assert [r["qty"] for r in got] == DF.qty.iloc[::-1].head(5).tolist()


def _port_mask(runner, plan, table, kernel=None):
    """The port's row mask of a plan over the whole segment stack
    (numpy [S, R]), through the plan's kernel or `kernel`."""
    args = runner._dispatch_args(plan, {})
    m = (kernel or plan.kernel)(*args)
    return runner_mod._embed_windowed_mask(
        m.reshape(-1).numpy(),
        runner._segment_window(plan, len(table.segments)),
        len(table.segments))


def _eager_mask(plan):
    """The plan's torch front half run eagerly (the untraced route)."""
    def fn(env, valid, seg_mask, consts):
        flat = {g: {c: a.reshape(-1) for c, a in env[g].items()}
                for g in ("cols", "nulls")}
        base = (valid & seg_mask[:, None]).reshape(-1)
        return plan.front_half(flat, base, consts).reshape(valid.shape)
    return fn


@pytest.mark.parametrize("case", ["filter_limit", "interval", "descending",
                                  "virtual_filter", "select_page1"])
def test_plain_mask_equals_jax_mask(exec_runners, case):
    """The port's row mask — the row program's plain version
    (row_mask_ref, what the kernel is held against) and the eager torch
    front half — equals the JAX mask plan's partials["mask"] exactly."""
    jax_runner, runner, table = exec_runners
    jq, q = _ir(case)
    jplan = jax_lower(jq, TABLE, jax_runner.config)
    want = np.asarray(jax_runner._run_partials(jplan, {})["mask"]) \
        .reshape(len(TABLE.segments), -1)
    plan = runner._lower_cached(q, table)
    assert plan.kind == "mask"
    assert (plan.mask_reason is None) == (case != "virtual_filter")
    np.testing.assert_array_equal(_port_mask(runner, plan, table), want)
    np.testing.assert_array_equal(
        _port_mask(runner, plan, table, _eager_mask(plan)), want)
    assert want.any() and not want.all()


# ---------------------------------------------------------------- SSB, SQL

SQL_CASES = {
    # the non-aggregate statement the planner rewrites into a Scan
    "quantity": "SELECT lo_revenue, lo_orderdate FROM lineorder "
                "WHERE lo_quantity < 5 LIMIT 5",
    # q1.1's filter, four columns
    "q11_filter": "SELECT lo_extendedprice, lo_discount, lo_quantity, "
                  "d_year FROM lineorder WHERE d_year = 1993 AND "
                  "lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25 "
                  "LIMIT 100",
    "selective_no_limit": "SELECT lo_revenue, c_city, p_brand1 FROM "
                          "lineorder WHERE p_category = 'MFGR#12' AND "
                          "s_region = 'AMERICA' AND lo_quantity > 45",
    "star": "SELECT * FROM lineorder WHERE c_region = 'ASIA' LIMIT 3",
    # test_planner.py::test_scan_plan's statement
    "scan_plan": "SELECT p_brand1, lo_revenue FROM lineorder "
                 "WHERE s_region = 'ASIA' LIMIT 7",
}
MONTH_SQL = {
    "month_desc_offset": "SELECT __time, lo_orderkey, lo_revenue FROM "
                         "lo_month WHERE __time >= TIMESTAMP '1995-03-01' "
                         "AND __time < TIMESTAMP '1995-04-01' "
                         "ORDER BY __time DESC LIMIT 50 OFFSET 100",
    "month_asc_offset": "SELECT __time, c_nation FROM lo_month WHERE "
                        "__time >= TIMESTAMP '1994-11-20' AND "
                        "__time < TIMESTAMP '1995-02-10' "
                        "ORDER BY __time LIMIT 40 OFFSET 250",
    "month_filter": "SELECT lo_orderkey, s_city FROM lo_month WHERE "
                    "__time >= TIMESTAMP '1996-06-01' AND "
                    "__time < TIMESTAMP '1996-07-01' AND "
                    "s_region = 'EUROPE'",
}


@pytest.fixture(scope="module")
def ssb_engines():
    """JAX and port engines over one SSB draw of 20,000 rows: lineorder
    (auto partitions, 4,096-row blocks) and lo_month (month partitions,
    1,024-row blocks), the port's carried across."""
    tables = jax_ssb.generate_tables(20_000, 0)
    jax = JaxEngine()
    jax_ssb.register_ssb(jax, tables=tables, block_rows=4096)
    jax.register_table("lo_month", jax_ssb.denormalize(tables),
                       time_column=jax_ssb.TIME_COL, block_rows=1024,
                       time_partition="month")
    port = cpu_engine()
    carry_into(port, jax, "lineorder", ssb.star_schema())
    carry_into(port, jax, "lo_month")
    return jax, port, tables


@pytest.mark.parametrize("name", list(SQL_CASES) + list(MONTH_SQL))
def test_sql_scan_matches_jax(ssb_engines, name):
    jax, port, _ = ssb_engines
    sql = {**SQL_CASES, **MONTH_SQL}[name]
    want = jax.sql(sql)
    got = port.sql(sql)
    assert port.last_plan.query.query_type == "scan"
    assert len(got) > 0
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    m = port.runner.last_metrics
    assert m["host_copies"] == 1 and m["mask_kernel"]
    if name.startswith("month"):
        assert "segments_window" in m   # the interval cut the window


def test_month_window_offset_crosses_segments(ssb_engines):
    """The month table's offset reaches past the first segment of the
    cut window, and the descending scan starts in the window's last."""
    _, port, _ = ssb_engines
    sql = MONTH_SQL["month_asc_offset"]
    plan = port.planner.plan(sql)
    table = port.catalog.get("lo_month").segments
    phys = port.runner._lower_cached(plan.query, table)
    first = table.segments[min(phys.pruned_ids)]
    assert first.meta.n_valid < 250 < sum(
        table.segments[i].meta.n_valid for i in phys.pruned_ids)


def test_selective_scan_matches_pandas(ssb_engines):
    """Scan C's shape on the port: row count and column sums against
    pandas on the denormalized frame."""
    _, port, tables = ssb_engines
    d = ssb.denormalize(tables)
    m = (d.p_category == "MFGR#12") & (d.s_region == "AMERICA") & \
        (d.lo_quantity > 45)
    got = port.sql(SQL_CASES["selective_no_limit"])
    assert len(got) == int(m.sum()) > 0
    assert int(got.lo_revenue.sum()) == int(d.lo_revenue[m].sum())


def test_nullable_scan_and_untraced_mask_match_jax():
    """Nullable string, LONG and DOUBLE columns come back as None; a
    filter on a DOUBLE column does not trace into a row program, so the
    torch front half serves it with the reason recorded."""
    df = nullable_table(1500, seed=5)
    df["fprice"] = df.price / 8.0
    df.loc[df.index[::37], "fprice"] = np.nan
    jax = JaxEngine()
    jax.register_table("t", df, time_column="ts", block_rows=512)
    port = cpu_engine()
    carry_into(port, jax, "t")
    for sql, traced in (
            ("SELECT ts, color, qty, fprice FROM t LIMIT 400", True),
            ("SELECT color, qty FROM t WHERE qty < 9 OR color = 'red' "
             "LIMIT 300 OFFSET 20", True),
            ("SELECT qty, fprice FROM t WHERE fprice > 600.5", False)):
        want = jax.sql(sql)
        got = port.sql(sql)
        pd.testing.assert_frame_equal(got, want, check_exact=True)
        assert got.isna().any().any()
        m = port.runner.last_metrics
        assert m["mask_kernel"] == traced
        assert ("mask_reason" in m) == (not traced)
    assert "front half" in m["mask_reason"]


# ---------------------------------------------------- the row-mask kernel


def _mask_programs(ssb_engines):
    _, port, _ = ssb_engines
    progs = {}
    for name, sql in {**SQL_CASES, **MONTH_SQL}.items():
        plan = port.planner.plan(sql)
        phys = port.runner._lower_cached(plan.query, plan.entry.segments)
        progs[name] = (phys, row_mask.program(phys, plan.entry.segments))
    return progs


def test_generated_mask_function_matches_evaluate(ssb_engines,
                                                  tmp_path):
    """Each scan's generated row function, compiled with the host c++,
    gives rowprog.evaluate's mask on every row of its inputs."""
    import ctypes
    import subprocess
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler: the generated row functions "
                    "cannot be compiled here")
    _, port, _ = ssb_engines
    cases, src = {}, []
    for name, (phys, prog) in _mask_programs(ssb_engines).items():
        assert prog.n_cols == 0
        args = port.runner._dispatch_args(phys, {})
        inputs = [None if kind == "base" else args[0][kind + "s"][n]
                  for n, kind, _ in prog.slots]
        arrays = [None if t is None else t.reshape(-1).numpy()
                  for t in inputs]
        ns = "scan_" + name
        cases[ns] = (prog, arrays, args[1].numel())
        src += [rowgen.row_source(prog, ns), _harness(prog, ns)]
    (tmp_path / "rows.cpp").write_text("\n".join(src))
    out = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w", "-o",
         str(tmp_path / "librows.so"), str(tmp_path / "rows.cpp")],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lib = ctypes.CDLL(str(tmp_path / "librows.so"))
    for ns, (prog, arrays, n) in cases.items():
        assert check_row_function(
            (prog, arrays, n, getattr(lib, f"eval_{ns}"))) > 0, ns


def test_mask_kernel_source_holds_no_literals(ssb_engines):
    """Scans that differ only in literals generate one kernel source (so
    they share one compiled kernel), with other launch constants."""
    _, port, _ = ssb_engines
    srcs, consts = set(), []
    for year, qty in ((1993, 25), (1995, 31)):
        sql = (f"SELECT lo_revenue FROM lineorder WHERE d_year = {year} "
               f"AND lo_discount BETWEEN 1 AND 3 AND lo_quantity < {qty} "
               "LIMIT 10")
        plan = port.planner.plan(sql)
        phys = port.runner._lower_cached(plan.query, plan.entry.segments)
        prog = row_mask.program(phys, plan.entry.segments)
        src = row_mask.kernel_source(prog)
        assert rowgen.SPLICE not in src and rowgen.COMMON_SPLICE not in src
        assert "row_mask_gen" in src
        srcs.add(src)
        consts.append(rowgen.constants(prog))
    assert len(srcs) == 1 and consts[0] != consts[1]


@pytest.mark.parametrize("bad", ["dtype", "rows", "base", "seg_mask"])
def test_mask_wrapper_rejects_bad_inputs(ssb_engines, bad):
    phys, prog = _mask_programs(ssb_engines)["q11_filter"]
    _, port, _ = ssb_engines
    env, valid, seg, _ = port.runner._dispatch_args(phys, {})
    inputs = [None if kind == "base" else env[kind + "s"][n]
              for n, kind, _ in prog.slots]
    if bad == "dtype":
        inputs[0] = inputs[0].to(torch.float64)
    elif bad == "rows":
        inputs[0] = inputs[0].reshape(-1)[:7]
    elif bad == "base":
        inputs[-1] = valid
    else:
        seg = seg[:-1]
    with pytest.raises(ValueError):
        row_mask.row_mask(prog, inputs, valid, seg)


@pytest.mark.gpu
def test_cuda_mask_kernel_matches_plain_version(ssb_engines):
    """The generated row-mask kernel on the card gives its plain
    version's mask exactly, one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _, port, _ = ssb_engines
    for phys, prog in _mask_programs(ssb_engines).values():
        env, valid, seg, _ = port.runner._dispatch_args(phys, {})
        inputs = [None if kind == "base" else
                  env[kind + "s"][n].cuda() for n, kind, _ in prog.slots]
        before = row_mask.launches
        got = row_mask.row_mask(prog, inputs, valid.cuda(), seg.cuda())
        torch.cuda.synchronize()
        assert row_mask.launches == before + 1
        want = row_mask.row_mask_ref(prog, [None if t is None else t.cpu()
                                            for t in inputs], valid, seg)
        assert torch.equal(got.cpu(), want)

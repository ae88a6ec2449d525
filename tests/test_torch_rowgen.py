"""Generated row functions (tpu_olap_torch.kernels.rowgen) against the row
program's plain version, `rowprog.evaluate`, with no card.

The generated row function is C++ behind the ROWGEN_FN qualifier macro
(`__device__` under NVRTC, `static inline` under a host compiler), so the
host `c++` compiles the row functions of every case into one shared
library, called through ctypes over rows made from a numpy seed. Mask,
key, values and selections must equal `evaluate` exactly (integers: the
tolerance is 0) for every opcode at every width, with division and
remainder by 0, INT32_MIN / INT64 edges, negative and out-of-range
gather indexes and the 32-bit narrowing rule, and for the row programs
of all 13 SSB plans. The query's literals reach the row function as
kernel constants (`rowgen.constants`), so a plan's source must not change
when only its literals do."""

import ctypes
import dataclasses
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpu_olap_torch.bench import ssb
from tpu_olap_torch.kernels import fused_reduce as fr
from tpu_olap_torch.kernels import rowgen
from tpu_olap_torch.kernels import rowprog as rp
from _torch_port import cpu_engine

N_RANDOM = 1500
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
WIDTHS = (rp.W64, rp.W32, rp.W16, rp.W8, rp.WU8, rp.WBOOL)
BINARY = (rp.ADD, rp.SUB, rp.MUL, rp.FDIV, rp.TDIV, rp.REM, rp.MIN,
          rp.MAX, rp.EQ, rp.NE, rp.LT, rp.LE, rp.GT, rp.GE, rp.AND, rp.OR,
          rp.XOR)
UNARY = (rp.NEG, rp.ABS, rp.BNOT, rp.LNOT, rp.CAST)
TABLED = (rp.GATHER, rp.SEARCHR, rp.SEARCHL, rp.ISIN)
OP_NAME = {v: k for k, v in vars(rp).items()
           if k.isupper() and isinstance(v, int) and 0 <= v <= rp.ISIN
           and k not in ("ROWS", "MAX_REGS", "MAX_INS", "MAX_SLOTS",
                         "MAX_COLUMNS") and not k.startswith("W")}

# wide (int64) and narrow (int32) edge values; every pair is a row
WIDE_EDGES = [0, 1, -1, 2, -2, 7, -7, I32_MIN, I32_MAX, 1 << 31,
              -(1 << 31) - 1, 1 << 32, -(1 << 32), 3 << 32, I64_MAX,
              I64_MIN + 1, I64_MIN]
NARROW_EDGES = [0, 1, -1, 2, -3, 127, -128, 255, 256, 32767, -32768,
                65535, 65536, I32_MIN, I32_MAX, I32_MIN + 1]
SLOTS = (("m", "col", torch.bool), ("a", "col", torch.int64),
         ("b", "col", torch.int64), ("c", "col", torch.int32),
         ("d", "col", torch.int32), ("s", "col", torch.int16),
         ("g", "col", torch.int8), ("", "base", torch.bool))


def _streams(seed, tdiv):
    """Rows: every pair of wide edges (a, b), every pair of narrow edges
    (c, d), then random rows. torch's CPU truncating division traps on
    INT64_MIN / -1, so the TDIV case leaves INT64_MIN out of the streams
    (it stays an immediate divisor)."""
    rng = np.random.default_rng(seed)
    wide = [v for v in WIDE_EDGES if not (tdiv and v == I64_MIN)]
    a, b = (np.array(x, np.int64).ravel()
            for x in np.meshgrid(wide, wide))
    c, d = (np.array(x, np.int64).ravel()
            for x in np.meshgrid(NARROW_EDGES, NARROW_EDGES))
    n = max(len(a), len(c)) + N_RANDOM

    def fill(edges, lo, hi, dtype):
        out = rng.integers(lo, hi, n, dtype=np.int64, endpoint=True)
        out[:len(edges)] = edges
        small = rng.random(n) < 0.3     # small values hit signs and zeros
        out[len(edges):] = np.where(small[len(edges):],
                                    rng.integers(-9, 10, n)[len(edges):],
                                    out[len(edges):])
        return out.astype(dtype)

    lo = I64_MIN + 1 if tdiv else I64_MIN
    cols = {"m": rng.random(n) < 0.85,
            "a": fill(a, lo, I64_MAX, np.int64),
            "b": fill(b, lo, I64_MAX, np.int64),
            "c": fill(c, I32_MIN, I32_MAX, np.int32),
            "d": fill(d, I32_MIN, I32_MAX, np.int32),
            "s": rng.integers(-32768, 32768, n).astype(np.int16),
            "g": rng.integers(-12, 13, n).astype(np.int8)}
    return cols, n


class _ProgramWriter:
    """A hand-written row program: LOAD m, EXITZ, then the case's values,
    each a reduce column (one with a selection, one count)."""

    def __init__(self):
        self.ins, self.data, self.n = [], [], 0

    def _reg(self):
        self.n += 1
        return self.n - 1

    def emit(self, op, w, a=0, b=0, c=0):
        r = self._reg()
        self.ins.append((op, w, r, a, b, c))
        return r

    def imm(self, v):
        self.data.append(int(v))
        return self.emit(rp.IMM, rp.W64, len(self.data) - 1)

    def table(self, vals):
        off = len(self.data)
        self.data.extend(int(v) for v in vals)
        return off, len(vals)

    def program(self, mask, key, vals):
        sel = self.emit(rp.LOAD, rp.WBOOL, 0)
        cols = [-1] + list(vals)
        sels = [-1, sel] + [-1] * len(vals)
        n_sum = len(cols) - 1
        return rp.RowProgram(
            ins=np.asarray(self.ins, np.int32).reshape(-1, 6),
            data=np.asarray(self.data or [0], np.int64), slots=SLOTS,
            mask_reg=mask, key_reg=key, val_regs=tuple(cols),
            sel_regs=tuple(sels[:len(cols)]), n_sum=n_sum, n_regs=self.n,
            cone_slots=frozenset({0}))


def _op_case(op):
    """Every width of `op` over wide, narrow and mixed sources, and (for
    binary ops) against immediates: 0, -1, INT32_MIN, a constant past
    int32, INT64_MIN."""
    bld = _ProgramWriter()
    m = bld.emit(rp.LOAD, rp.WBOOL, 0)
    bld.ins.append((rp.EXITZ, rp.W64, -1, m, 0, 0))
    a = bld.emit(rp.LOAD, rp.W64, 1)
    b = bld.emit(rp.LOAD, rp.W64, 2)
    c = bld.emit(rp.LOAD, rp.W32, 3)
    d = bld.emit(rp.LOAD, rp.W32, 4)
    s = bld.emit(rp.LOAD, rp.W16, 5)
    g = bld.emit(rp.LOAD, rp.W8, 6)
    vals = []
    if op in BINARY:
        imms = [bld.imm(v) for v in (0, -1, 3, I32_MIN, 5 << 33, I64_MIN)]
        pairs = [(a, b), (c, d), (c, b), (a, d), (s, g), (b, a)]
        pairs += [(x, i) for x in (a, c) for i in imms]
        for w in WIDTHS:
            vals += [bld.emit(op, w, x, y) for x, y in pairs]
    elif op in UNARY:
        for w in WIDTHS:
            vals += [bld.emit(op, w, x) for x in (a, b, c, d, s, g)]
    elif op == rp.SELECT:
        for w in WIDTHS:
            vals += [bld.emit(op, w, x, y, z) for x, y, z in
                     ((g, a, b), (c, c, d), (a, d, c), (s, s, g),
                      (d, a, c))]
    else:
        tables = {rp.GATHER: [[5, -9, I32_MAX, 1 << 40, I64_MIN], [7]],
                  rp.SEARCHR: [[-5, -5, 0, 3, 3, 3, 1 << 35], [0]],
                  rp.SEARCHL: [[-5, -5, 0, 3, 3, 3, 1 << 35], []],
                  rp.ISIN: [[-7, -1, 0, 2, 5, 127],
                            [I32_MIN] + list(range(-12, 13, 2)) + [1 << 33]]}
        for vals_t in tables[op]:
            off, ln = bld.table(vals_t)
            for w in WIDTHS:
                vals += [bld.emit(op, w, x, off, ln) for x in (g, s, a, c)]
    return bld.program(m, vals[0], vals)


def _ssb_calls(queries=ssb.QUERIES):
    """Every fused-reduce call of the 13 SSB queries on a small table
    (CPU, the fused path forced): (name, program, inputs, base mask)."""
    eng = cpu_engine(use_fused_reduce="force")
    ssb.register_ssb(eng, tables=ssb.generate_tables(20_000, seed=0))
    calls = {}
    real = fr.fused_reduce

    def record(prog, inputs, valid, seg_mask, K):
        calls[current] = (prog, inputs, valid, seg_mask, K)
        return real(prog, inputs, valid, seg_mask, K)

    fr.fused_reduce = record
    try:
        for current, q in queries.items():
            eng.sql(q)
    finally:
        fr.fused_reduce = real
    assert set(calls) == set(queries)
    return calls


def _harness(prog, ns):
    """An extern "C" loop calling namespace ns's row function per row."""
    C = prog.n_cols
    args = [", " + rowgen._scalar_load(prog.slots[s][2], s).expr
            for s in rowgen.cone_slots(prog)]
    return (f'extern "C" void eval_{ns}(const void* const* slot, '
            "const long long* data, const long long* k, long long n, "
            "unsigned char* mask, long long* key, long long* val, "
            "unsigned char* sel) {\n"
            "  for (long long i = 0; i < n; ++i) {\n"
            f"    {ns}::RowOut o{{}};\n"
            f"    const bool m = {ns}::row(slot, data, k, i{''.join(args)}, "
            "o);"
            "\n    mask[i] = m;\n    key[i] = m ? o.key : 0;\n"
            f"    for (int c = 0; c < {C}; ++c) {{\n"
            f"      val[i * {C} + c] = m ? o.val[c] : 0;\n"
            f"      sel[i * {C} + c] = m ? o.sel[c] : 0;\n    }}\n  }}\n}}\n")


@pytest.fixture(scope="module")
def compiled_cases(tmp_path_factory):
    """{case: (program, numpy inputs, evaluate's inputs, n, ctypes fn)}:
    the op cases and the SSB calls, compiled together with the host c++
    (skips when there is none)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler: the generated row functions "
                    "cannot be compiled here")
    cases = {}
    for op in BINARY + UNARY + (rp.SELECT,) + TABLED:
        cols, n = _streams(op, tdiv=op == rp.TDIV)
        arrays = [cols[name] if kind != "base" else None
                  for name, kind, _ in SLOTS]
        cases[f"op_{OP_NAME[op]}"] = (_op_case(op), arrays, n)
    for name, (prog, inputs, valid, seg, K) in _ssb_calls().items():
        arrays = [None if t is None else t.reshape(-1).numpy()
                  for t in inputs]
        cases["ssb_" + name.replace(".", "_")] = (prog, arrays,
                                                  valid.numel())
    src = []
    for ns, (prog, _, _) in cases.items():
        src.append(rowgen.row_source(prog, ns))
        src.append(_harness(prog, ns))
    d = tmp_path_factory.mktemp("rowgen")
    (d / "rows.cpp").write_text("\n".join(src))
    out = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w", "-o",
         str(d / "librows.so"), str(d / "rows.cpp")],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lib = ctypes.CDLL(str(d / "librows.so"))
    return {ns: (prog, arrays, n, getattr(lib, f"eval_{ns}"))
            for ns, (prog, arrays, n) in cases.items()}


def _check(case):
    prog, arrays, n, fn = case
    keep = [np.ascontiguousarray(a) if a is not None else None
            for a in arrays]
    ptrs = (ctypes.c_void_p * len(keep))(
        *[0 if a is None else a.ctypes.data for a in keep])
    C = prog.n_cols
    mask = np.zeros(n, np.uint8)
    key = np.zeros(n, np.int64)
    val = np.zeros((n, C), np.int64)
    sel = np.zeros((n, C), np.uint8)
    data = np.ascontiguousarray(prog.data if prog.data.size
                                else np.zeros(1, np.int64))
    k = np.asarray(rowgen.constants(prog) or [0], np.int64)
    fn(ptrs, data.ctypes.data_as(ctypes.c_void_p),
       k.ctypes.data_as(ctypes.c_void_p), ctypes.c_longlong(n),
       mask.ctypes.data_as(ctypes.c_void_p),
       key.ctypes.data_as(ctypes.c_void_p),
       val.ctypes.data_as(ctypes.c_void_p),
       sel.ctypes.data_as(ctypes.c_void_p))
    regs = rp.evaluate(prog, [None if a is None else torch.from_numpy(a)
                              for a in keep], n, "cpu")
    want_mask = (regs[prog.mask_reg] != 0).numpy()
    np.testing.assert_array_equal(mask.astype(bool), want_mask, "mask")
    m = want_mask
    np.testing.assert_array_equal(key[m], regs[prog.key_reg].numpy()[m],
                                  "key")
    for c, (vr, sr) in enumerate(zip(prog.val_regs, prog.sel_regs)):
        want = np.ones(n, np.int64) if vr < 0 else regs[vr].numpy()
        np.testing.assert_array_equal(val[m, c], want[m],
                                      f"column {c} value")
        want = np.ones(n, bool) if sr < 0 else (regs[sr] != 0).numpy()
        np.testing.assert_array_equal(sel[m, c].astype(bool), want[m],
                                      f"column {c} selection")
    return int(m.sum())


@pytest.mark.parametrize("op", [OP_NAME[o] for o in
                                BINARY + UNARY + (rp.SELECT,) + TABLED])
def test_opcode_every_width_matches_evaluate(compiled_cases, op):
    assert _check(compiled_cases[f"op_{op}"]) > 1000


@pytest.mark.parametrize("query", list(ssb.QUERIES))
def test_ssb_row_function_matches_evaluate(compiled_cases, query):
    _check(compiled_cases["ssb_" + query.replace(".", "_")])


def _other_immediates(prog):
    """prog with every immediate moved to another value that keeps its
    sign and int32 range and stays clear of 0 and +-1 (which the trace
    would simplify away)."""
    data = prog.data.copy()
    for op, _, _, a, _, _ in prog.ins.tolist():
        if op == rp.IMM and abs(int(data[a])) > 1:
            v = int(data[a])
            data[a] = v + (7 if abs(v) < (1 << 30) else -7 if v > 0 else 7)
    return dataclasses.replace(prog, data=data, _device={})


def test_ssb_sources_bake_immediates_and_have_no_dispatch(compiled_cases):
    """Per SSB plan: every immediate is baked into the launch as a kernel
    constant (rowgen.constants, one per read), not into the source: a
    program whose immediates take other values has the same source and
    other constants. No IMM is read through `data`, and the kernel
    source has no dispatch switch."""
    for ns, (prog, _, _, _) in compiled_cases.items():
        if not ns.startswith("ssb_"):
            continue
        row = rowgen.row_source(prog, ns)
        imms = [int(prog.data[a]) for op, _, _, a, _, _ in
                prog.ins.tolist() if op == rp.IMM]
        consts = rowgen.constants(prog)
        assert set(imms) == set(consts) and len(consts) >= len(imms), ns
        other = _other_immediates(prog)
        assert rowgen.row_source(other, ns) == row, ns
        assert rowgen.kernel_source(other, 64) == \
            rowgen.kernel_source(prog, 64), ns
        if any(abs(v) > 1 for v in imms):
            assert rowgen.constants(other) != consts, ns
        src = rowgen.kernel_source(prog, 64)
        assert "switch" not in src and "prog[" not in src, ns
        assert rowgen.SPLICE not in src
        body = row.split(f"namespace {ns}", 1)[1]
        # a table read names its literal offset; no IMM goes through data
        assert "data[" not in body and "data + " not in body, ns


def test_equal_literals_take_constants_of_their_own():
    """Two reads of one immediate register (the trace merges equal
    literals) read two constants, so which literals are equal does not
    shape the source; an IN list of at most ISIN_CHAIN entries reads one
    constant per entry, a longer one searches `data`."""
    bld = _ProgramWriter()
    m = bld.emit(rp.LOAD, rp.WBOOL, 0)
    bld.ins.append((rp.EXITZ, rp.W64, -1, m, 0, 0))
    c = bld.emit(rp.LOAD, rp.W32, 3)
    i = bld.imm(1993)
    lo = bld.emit(rp.GE, rp.WBOOL, c, i)
    hi = bld.emit(rp.LE, rp.WBOOL, c, i)
    short = bld.emit(rp.ISIN, rp.WBOOL, c, *bld.table([4, 9, 1 << 40]))
    long = bld.emit(rp.ISIN, rp.WBOOL, c,
                    *bld.table(range(rowgen.ISIN_CHAIN + 1)))
    prog = bld.program(m, c, [lo, hi, short, long])
    assert rowgen.constants(prog) == [1993, 1993, 4, 9, 1 << 40]
    src = rowgen.row_source(prog, "t")
    assert "(int)k[0]" in src and "(int)k[1]" in src and "k[4]" in src
    assert "(int)k[4]" not in src     # 2^40 compares in 64 bits
    assert "rowgen::isin(data + 4, 9," in src


def test_constants_past_the_cap_read_data(tmp_path, monkeypatch):
    """Reads past MAX_CONSTS take the immediate from `data` at its
    offset, and the row function still equals `evaluate`."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler: the generated row functions "
                    "cannot be compiled here")
    monkeypatch.setattr(rowgen, "MAX_CONSTS", 3)
    prog = _op_case(rp.ADD)      # reads its six immediates 72 times
    assert len(rowgen.constants(prog)) == 3
    row = rowgen.row_source(prog, "capped")
    assert "ROWGEN_LDG(data + " in row
    (tmp_path / "rows.cpp").write_text(row + _harness(prog, "capped"))
    out = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w", "-o",
         str(tmp_path / "librows.so"), str(tmp_path / "rows.cpp")],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    cols, n = _streams(rp.ADD, tdiv=False)
    arrays = [cols[name] if kind != "base" else None
              for name, kind, _ in SLOTS]
    fn = ctypes.CDLL(str(tmp_path / "librows.so")).eval_capped
    assert _check((prog, arrays, n, fn)) > 1000


@pytest.fixture(scope="module")
def other_literal_calls():
    return _ssb_calls(ssb.QUERIES_OTHER_LITERALS)


@pytest.mark.parametrize("query", list(ssb.QUERIES))
def test_other_literals_share_the_kernel_source(compiled_cases,
                                                other_literal_calls, query):
    """The query with other literals (ssb.QUERIES_OTHER_LITERALS) lowers
    to a program of the same source and other constants, so it reuses
    the compiled kernel; its row function, run with its own constants,
    still equals `evaluate`."""
    ns = "ssb_" + query.replace(".", "_")
    prog, _, _, fn = compiled_cases[ns]
    other, inputs, valid, _, K = other_literal_calls[query]
    assert rowgen.kernel_source(other, K) == rowgen.kernel_source(prog, K)
    assert rowgen.constants(other) != rowgen.constants(prog)
    arrays = [None if t is None else t.reshape(-1).numpy() for t in inputs]
    _check((other, arrays, valid.numel(), fn))


def test_narrowing_rule_in_source():
    """A truncating width takes 32-bit arithmetic; a WBOOL sum of wide
    sources stays 64-bit (2^32 + 0 is nonzero, its low word is not); a
    comparison of int32 values compares ints."""
    bld = _ProgramWriter()
    m = bld.emit(rp.LOAD, rp.WBOOL, 0)
    bld.ins.append((rp.EXITZ, rp.W64, -1, m, 0, 0))
    a = bld.emit(rp.LOAD, rp.W64, 1)
    c = bld.emit(rp.LOAD, rp.W32, 3)
    v32 = bld.emit(rp.ADD, rp.W32, a, a)
    vb = bld.emit(rp.ADD, rp.WBOOL, a, a)
    lt = bld.emit(rp.LT, rp.WBOOL, c, c)
    prog = bld.program(m, v32, [vb, lt])
    src = rowgen.row_source(prog, "t")
    lines = {int(m.group(1)): ln for ln in src.splitlines()
             for m in [re.match(r"  const (?:int|long long) v(\d+) = ", ln)]
             if m}
    pcs = {r: pc for pc, r in enumerate(prog.ins[:, 2].tolist())}
    assert "(unsigned)" in lines[pcs[v32]] and "const int" in \
        lines[pcs[v32]]
    assert "unsigned long long" in lines[pcs[vb]]
    assert "long long" not in lines[pcs[lt]]


def test_kernel_layout_counts_in_32_bits():
    """Counts take 4 bytes of the shared group table, value sums 8 and
    minimums 4; past SMEM_TABLE_BYTES the table goes global."""
    prog = _op_case(rp.ADD)     # a count, value sums, then one minimum
    lay = rowgen.layout(prog)
    assert lay.n32 == 1 and lay.nmin == 1
    assert lay.n64 == prog.n_cols - 2
    assert lay.kind[0] == "count" and lay.kind[-1] == "min"
    assert lay.table_bytes(10) == 10 * (8 * lay.n64 + 4 + 4)
    K = rowgen.SMEM_TABLE_BYTES // (8 * lay.n64 + 8)
    assert rowgen.table_bytes(prog, K) == lay.table_bytes(K)
    assert rowgen.table_bytes(prog, K + 1) == 0

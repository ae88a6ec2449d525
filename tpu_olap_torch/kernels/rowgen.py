"""Per-plan CUDA source for the fused reduce: a row program written out as
straight-line C++ and spliced into the kernel template
`csrc/fused_reduce_gen.cuh`.

Everything a generic evaluator would look up per row is known once the
plan is traced: opcodes, widths, slot types, table
offsets, K and the reduce columns. So each instruction becomes one
`const` C local (one per program value: registers are SSA-renamed), a
LOAD is a typed read, EXITZ is an early `return false`, GATHER / SEARCH
/ ISIN read their table through `__ldg` at a literal offset and length,
and an IN list of at most ISIN_CHAIN entries becomes a chain of
compares.

The query's literals are not in the source. Each read of an immediate
and each entry of a chained IN list is a kernel constant of its own:
`constants(prog)` lists their values, the launch passes them in its
parameter block, and the row function reads constant j as `k[j]` (a
uniform read of the constant bank). The source thus depends on the
program's structure, and one compiled kernel serves every query that
differs from another only in its literals (d_year = 1994 for 1993,
another brand): a new literal costs no NVRTC compile (0.2-0.4 s a
plan), at the price of the folds ptxas can make only with a literal in
hand (a compare of a masked byte against a shifted literal, a range
check turned unsigned). What still enters the source is whether each
constant fits an int32 (it decides the narrowing below) and what the
trace simplified away: a literal of 0, 1 or -1 can drop an instruction
(x + 0, x * 1), and an operation over literals alone is folded
(rowprog). Past MAX_CONSTS reads, an immediate is read from `data`.

Semantics are bit for bit those of `rowprog.evaluate` / `rowprog._apply`:
every result is wrapped to its width; division and remainder by 0 give
0; floor division and remainder follow Python's signs; a negative gather
index wraps once and an index past the table gives 0.

Narrowing, where it is exact. A value whose width is W32 or narrower is
an `int`; a W64 value is a `long long`. An instruction is computed in 32
bits only where the 64-bit result, wrapped to its width, is provably the
same:
  - ADD, SUB, MUL, NEG, AND, OR, XOR and BNOT whose width truncates
    (W32, W16, W8, WU8): the low 32 bits of a ring operation depend only
    on the low 32 bits of its operands;
  - AND, OR, XOR and BNOT with a WBOOL result when every source is an
    `int` (a sign-extended value is nonzero exactly when its low 32 bits
    are; this does not hold for ADD, SUB, MUL or NEG);
  - comparisons, MIN, MAX and SELECT when every source is an `int`.
Everything else is computed in 64 bits.

The row section (`row_source`) compiles with a host C++ compiler too:
its functions carry the ROWGEN_FN qualifier macro, `__device__` under
NVRTC and `static inline` elsewhere, which is how the tests hold it
against `rowprog.evaluate` without a card.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from tpu_olap_torch.kernels import rowprog as rp

CSRC = Path(__file__).resolve().parent.parent / "csrc"
TEMPLATE = CSRC / "fused_reduce_gen.cuh"
COMMON = CSRC / "row_common.cuh"   # helpers every row kernel template uses
COMMON_SPLICE = "//@@ROW_COMMON@@"
SPLICE = "//@@ROWGEN_PLAN@@"
NAMESPACE = "rowgen_plan"      # the template's name for the plan's code
KERNEL = "fused_reduce_gen"
MULTI_TEMPLATE = CSRC / "fused_reduce_multi_gen.cuh"
MULTI_KERNEL = "fused_reduce_multi_gen"
MAX_LEGS = 64                  # legs of one multi-leg launch
THREADS = 512                  # threads per block (the template's kThreads)
ROWS_PER_THREAD = 16           # one 16-byte load of valid bytes
ISIN_CHAIN = 8                 # IN lists up to this long become compares
MAX_CONSTS = 128               # kernel constants (the template's kMaxConsts)
SMEM_TABLE_BYTES = 200 * 1024  # per-block group table in shared memory
MAX_SLOTS = rp.MAX_SLOTS

# per slot dtype: (C element type, lane helper, value is long long)
_ELEM = {torch.int8: ("signed char", "lane_i8", False),
         torch.int16: ("short", "lane_i16", False),
         torch.int32: ("int", "lane_i32", False),
         torch.int64: ("long long", "lane_i64", True),
         torch.bool: ("unsigned char", "lane_b8", False)}

_NARROW = (rp.W32, rp.W16, rp.W8, rp.WU8)
_ARITH = {rp.ADD: "+", rp.SUB: "-", rp.MUL: "*"}
_BITS = {rp.AND: "&", rp.OR: "|", rp.XOR: "^"}
_CMP = {rp.EQ: "==", rp.NE: "!=", rp.LT: "<", rp.LE: "<=", rp.GT: ">",
        rp.GE: ">="}
_DIV = {rp.FDIV: "fdiv", rp.TDIV: "tdiv", rp.REM: "rem"}

PRELUDE = r"""#ifndef ROWGEN_FN
#if defined(__CUDACC__) || defined(__CUDACC_RTC__)
#define ROWGEN_FN __device__ __forceinline__
#define ROWGEN_LDG(p) __ldg(p)
#else
#define ROWGEN_FN static inline
#define ROWGEN_LDG(p) (*(p))
#endif
namespace rowgen {
ROWGEN_FN long long neg(long long u) {
  return (long long)(0ull - (unsigned long long)u);
}
ROWGEN_FN long long abs64(long long u) { return u < 0 ? neg(u) : u; }
// x / -1 is -x (wrapped): INT64_MIN / -1 would trap
ROWGEN_FN long long tdiv(long long u, long long v) {
  return v == 0 ? 0 : v == -1 ? neg(u) : u / v;
}
ROWGEN_FN long long fdiv(long long u, long long v) {
  if (v == 0) return 0;
  if (v == -1) return neg(u);
  const long long q = u / v;
  return (u % v != 0 && ((u < 0) != (v < 0))) ? q - 1 : q;
}
ROWGEN_FN long long rem(long long u, long long v) {
  if (v == 0 || v == -1) return 0;
  const long long r = u % v;
  return (r != 0 && ((r < 0) != (v < 0))) ? r + v : r;
}
ROWGEN_FN long long gather(const long long* t, long long len, long long j) {
  if (j < 0) j += len;
  return (j >= 0 && j < len) ? ROWGEN_LDG(t + j) : 0;
}
// entries of a sorted table <= x (right) or < x (left)
ROWGEN_FN long long search(const long long* t, int len, long long x,
                           bool right) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const long long m = ROWGEN_LDG(t + mid);
    if (right ? m <= x : m < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}
ROWGEN_FN int isin(const long long* t, int len, long long x) {
  const long long j = search(t, len, x, false);
  return j < len && ROWGEN_LDG(t + j) == x;
}
}  // namespace rowgen
#endif
"""


class _Val(NamedTuple):
    expr: str
    wide: bool          # long long; else int (the value fits int32)


class _Imm(NamedTuple):
    value: int
    offset: int         # its place in `data`


class _Consts:
    """The kernel constants a row function reads, in the order it reads
    them."""

    def __init__(self):
        self.values: list = []

    def read(self, value: int, offset: int) -> _Val:
        """One read of an immediate: a constant of its own while
        MAX_CONSTS last, else a read of `data` at its offset."""
        narrow = -(1 << 31) <= value < (1 << 31)
        if len(self.values) < MAX_CONSTS:
            e = f"k[{len(self.values)}]"
            self.values.append(value)
        else:
            e = f"ROWGEN_LDG(data + {offset})"
        return _Val(f"(int){e}", False) if narrow else _Val(e, True)


def _ll(x: _Val) -> str:
    return x.expr if x.wide else f"(long long){x.expr}"


def _u32(x: _Val) -> str:
    return f"(unsigned){x.expr}"


def _wrap(expr: str, w: int, wide: bool) -> _Val:
    """expr (a long long when wide, else an int or unsigned) wrapped to
    width w."""
    if w == rp.W64:
        return _Val(expr if wide else f"(long long)({expr})", True)
    if w == rp.WBOOL:
        return _Val(f"(int)(({expr}) != 0)", False)
    cast = {rp.W32: "", rp.W16: "(short)", rp.W8: "(signed char)",
            rp.WU8: "(unsigned char)"}[w]
    return _Val(f"(int){cast}({expr})", False)


def _instruction(op, w, x, y, z, b, c, chain=()) -> _Val:
    """The C expression of one instruction over source values x, y, z;
    b, c are a table's offset and length in `data`; `chain` holds a
    chained IN list's entries as constants."""
    narrow = w in _NARROW
    if op in _ARITH or op == rp.NEG:
        if narrow:
            e = f"0u - {_u32(x)}" if op == rp.NEG else \
                f"{_u32(x)} {_ARITH[op]} {_u32(y)}"
            return _wrap(e, w, False)
        e = f"rowgen::neg({_ll(x)})" if op == rp.NEG else (
            f"(long long)((unsigned long long){_ll(x)} {_ARITH[op]} "
            f"(unsigned long long){_ll(y)})")
        return _wrap(e, w, True)
    if op in _BITS or op == rp.BNOT:
        srcs = (x,) if op == rp.BNOT else (x, y)
        if narrow or (w == rp.WBOOL and not any(s.wide for s in srcs)):
            e = f"~{_u32(x)}" if op == rp.BNOT else \
                f"{_u32(x)} {_BITS[op]} {_u32(y)}"
            return _wrap(e, w, False)
        e = f"~{_ll(x)}" if op == rp.BNOT else \
            f"{_ll(x)} {_BITS[op]} {_ll(y)}"
        return _wrap(e, w, True)
    if op in _CMP:
        if x.wide or y.wide:
            return _wrap(f"{_ll(x)} {_CMP[op]} {_ll(y)}", w, False)
        return _wrap(f"{x.expr} {_CMP[op]} {y.expr}", w, False)
    if op in (rp.MIN, rp.MAX):
        s = "<" if op == rp.MIN else ">"
        if x.wide or y.wide:
            a, bb = _ll(x), _ll(y)
            return _wrap(f"{a} {s} {bb} ? {a} : {bb}", w, True)
        return _wrap(f"{x.expr} {s} {y.expr} ? {x.expr} : {y.expr}", w,
                     False)
    if op == rp.SELECT:
        if y.wide or z.wide:
            return _wrap(f"{x.expr} != 0 ? {_ll(y)} : {_ll(z)}", w, True)
        return _wrap(f"{x.expr} != 0 ? {y.expr} : {z.expr}", w, False)
    if op == rp.CAST:
        return _wrap(x.expr, w, x.wide)
    if op == rp.LNOT:
        return _wrap(f"{x.expr} == 0", w, False)
    if op == rp.ABS:
        return _wrap(f"rowgen::abs64({_ll(x)})", w, True)
    if op in _DIV:
        return _wrap(f"rowgen::{_DIV[op]}({_ll(x)}, {_ll(y)})", w, True)
    if op == rp.GATHER:
        return _wrap(f"rowgen::gather(data + {b}, {c}, {_ll(x)})", w, True)
    if op in (rp.SEARCHR, rp.SEARCHL):
        right = "true" if op == rp.SEARCHR else "false"
        return _wrap(f"rowgen::search(data + {b}, {c}, {_ll(x)}, {right})",
                     w, True)
    if op == rp.ISIN:
        if c <= ISIN_CHAIN:
            terms = [f"({_ll(x)} == {_ll(v)})" if x.wide or v.wide else
                     f"({x.expr} == {v.expr})" for v in chain]
            return _wrap(" | ".join(terms) or "0", w, False)
        return _wrap(f"rowgen::isin(data + {b}, {c}, {_ll(x)})", w, False)
    raise ValueError(f"no C form for opcode {op}")


def _scalar_load(dtype, slot: int) -> _Val:
    """Row i of slot `slot` as a value: one typed read (a bool reads as
    0/1)."""
    ctype, _, wide = _ELEM[dtype]
    e = f"ROWGEN_LDG((const {ctype}*)slot[{slot}] + i)"
    if wide:
        return _Val(f"(long long){e}", True)
    if dtype == torch.bool:
        return _Val(f"(int)({e} != 0)", False)
    return _Val(f"(int){e}", False)


def cone_slots(prog: rp.RowProgram) -> list:
    """The slots the mask's cone loads, in order: the row function takes
    their values as arguments (the kernel loads them 16 bytes at a
    time)."""
    return sorted(prog.cone_slots)


def row_source(prog: rp.RowProgram, namespace: str = NAMESPACE) -> str:
    """The row function of `prog` (plus the shared prelude) as C++ that
    NVRTC and a host compiler both take:

        namespace <namespace> {
        constexpr int kCols;
        struct RowOut { long long key; long long val[kCols];
                        bool sel[kCols]; };
        bool row(const void* const* slot, const long long* data,
                 const long long* k, long long i,
                 <one value per cone slot>, RowOut& o);
        }

    `k` holds `constants(prog)`. `row` returns false when the row's mask
    is 0 (EXITZ), else fills the key, every column's value (1 for a
    count) and selection (true when the column has none)."""
    return _generate(prog, namespace)[0]


def constants(prog: rp.RowProgram) -> list:
    """The values of the kernel constants the row function reads, in
    order. Each read of an immediate and each entry of a chained IN list
    takes a constant of its own, so the source does not depend on which
    of the query's literals happen to be equal."""
    return _generate(prog, NAMESPACE)[1]


def _generate(prog: rp.RowProgram, namespace: str) -> tuple:
    cone = cone_slots(prog)
    consts = _Consts()
    cur: dict = {}
    body = []

    def read(r) -> _Val:
        v = cur[r]
        return consts.read(*v) if isinstance(v, _Imm) else v

    # values are named by their index among the instructions that are not
    # IMMs, which the trace merges when literals are equal
    n_imm = 0
    for pc, (op, w, dst, a, b, c) in enumerate(prog.ins.tolist()):
        if op == rp.IMM:
            cur[dst] = _Imm(int(prog.data[a]), a)
            n_imm += 1
            continue
        if op == rp.EXITZ:
            body.append(f"  if (!({read(a).expr})) return false;")
            continue
        if op == rp.LOAD:
            dtype = prog.slots[a][2]
            v = _Val(f"c{a}", _ELEM[dtype][2]) if a in prog.cone_slots \
                else _scalar_load(dtype, a)
        else:
            srcs = [read(r) for r in (a, b, c)[:_arity(op)]]
            srcs += [None] * (3 - len(srcs))
            chain = [consts.read(int(prog.data[e]), e)
                     for e in range(b, b + c)] \
                if op == rp.ISIN and c <= ISIN_CHAIN else ()
            v = _instruction(op, w, *srcs, b, c, chain)
        ctype = "long long" if v.wide else "int"
        body.append(f"  const {ctype} v{pc - n_imm} = {v.expr};")
        cur[dst] = _Val(f"v{pc - n_imm}", v.wide)
    outs = [f"  o.key = {_ll(read(prog.key_reg))};"]
    for k, (vr, sr) in enumerate(zip(prog.val_regs, prog.sel_regs)):
        outs.append(f"  o.val[{k}] = "
                    f"{'1' if vr < 0 else _ll(read(vr))};")
        outs.append(f"  o.sel[{k}] = "
                    f"{'true' if sr < 0 else read(sr).expr + ' != 0'};")
    args = "".join(
        f", {'long long' if _ELEM[prog.slots[s][2]][2] else 'int'} c{s}"
        for s in cone)
    source = (
        PRELUDE + f"namespace {namespace} {{\n"
        f"constexpr int kCols = {prog.n_cols};\n"
        "struct RowOut { long long key; long long val[kCols > 0 ? kCols : 1];"
        " bool sel[kCols > 0 ? kCols : 1]; };\n"
        "ROWGEN_FN bool row(const void* const* __restrict__ slot, "
        "const long long* __restrict__ data, "
        "const long long* __restrict__ k, long long i"
        f"{args}, RowOut& o) {{\n"
        "  (void)slot; (void)data; (void)k; (void)i;\n"
        + "\n".join(body + outs) + "\n  return true;\n}\n"
        f"}}  // namespace {namespace}\n")
    return source, consts.values


def _arity(op) -> int:
    if op == rp.SELECT:
        return 3
    if op in (rp.NEG, rp.ABS, rp.BNOT, rp.LNOT, rp.CAST, rp.GATHER,
              rp.SEARCHR, rp.SEARCHL, rp.ISIN):
        return 1
    return 2


class Layout(NamedTuple):
    """Where each reduce column lives in a block's shared group table:
    value sums in 64 bits, counts in 32 bits (a block sees fewer than
    2^32 rows), minimums in 32 bits."""
    kind: tuple        # per column: "sum", "count" or "min"
    index: tuple       # per column: its index in its part of the table
    n64: int
    n32: int
    nmin: int

    def table_bytes(self, K: int) -> int:
        return K * (8 * self.n64 + 4 * (self.n32 + self.nmin))


def layout(prog: rp.RowProgram) -> Layout:
    """The shared table's layout."""
    kinds, index, n = [], [], {"sum": 0, "count": 0, "min": 0}
    for c, vr in enumerate(prog.val_regs):
        k = "min" if c >= prog.n_sum else ("count" if vr < 0 else "sum")
        kinds.append(k)
        index.append(n[k])
        n[k] += 1
    return Layout(tuple(kinds), tuple(index), n["sum"], n["count"],
                  n["min"])


def table_bytes(prog: rp.RowProgram, K: int) -> int:
    """Dynamic shared memory of the plan's kernel: the block-private group
    table when it fits SMEM_TABLE_BYTES, else 0 (global atomics)."""
    b = layout(prog).table_bytes(K)
    return b if b <= SMEM_TABLE_BYTES else 0


def call_source(prog: rp.RowProgram) -> list:
    """The lines, inside the plan's namespace, that call the row
    function from a kernel template: the `Cone` of staged vectors and
    `cone_load` (16 rows of every cone stream, 16 bytes at a time),
    `row_vec` (row r of the staged rows) and `row_scalar` (row i read
    from its streams)."""
    cone = cone_slots(prog)
    L = []
    words = {s: ROWS_PER_THREAD * torch.empty(0, dtype=prog.slots[s][2])
             .element_size() // 16 for s in cone}
    L.append("struct Cone { " + " ".join(
        f"rowgen::V16 s{s}[{words[s]}];" for s in cone) + " int unused; };")
    L.append("ROWGEN_FN void cone_load(const void* const* slot, "
             "long long i0, Cone& c) {")
    for s in cone:
        size = torch.empty(0, dtype=prog.slots[s][2]).element_size()
        L.append(f"  rowgen::vload(slot[{s}], i0 * {size}, c.s{s});")
    L.append("  (void)slot; (void)i0; (void)c;\n}")
    vec_args = "".join(f", rowgen::{_ELEM[prog.slots[s][2]][1]}(c.s{s}, r)"
                       for s in cone)
    L.append("ROWGEN_FN bool row_vec(const void* const* slot, "
             "const long long* data, const long long* k, long long i, "
             "const Cone& c, int r, RowOut& o) {\n"
             f"  return row(slot, data, k, i{vec_args}, o);\n}}")
    sc_args = "".join(", " + _scalar_load(prog.slots[s][2], s).expr
                      for s in cone)
    L.append("ROWGEN_FN bool row_scalar(const void* const* slot, "
             "const long long* data, const long long* k, long long i, "
             "RowOut& o) {\n"
             f"  return row(slot, data, k, i{sc_args}, o);\n}}")
    return L


def _device_source(prog: rp.RowProgram, K: int,
                   namespace: str = NAMESPACE, seg_groups: int = 0) -> str:
    """The plan's glue for a fused-reduce template: its shape as
    constants, the calls of the row function (`call_source`), and the
    per-column reduce steps with literal table indexes, in `namespace`.
    One group (K = 1) reduces in registers and warp shuffles.
    `seg_groups` > 0 is the segment-extended variant's per-segment group
    count (then K is the window's W * seg_groups)."""
    lay = layout(prog)
    n_min = prog.n_cols - prog.n_sum
    shared = table_bytes(prog, K) > 0
    one_group = K == 1
    L = [f"namespace {namespace} {{",
         f"constexpr long long kGroups = {K};",
         f"constexpr int kSum = {prog.n_sum};",
         f"constexpr int kMin = {n_min};",
         f"constexpr int kN64 = {lay.n64};",
         f"constexpr int kN32 = {lay.n32};",
         f"constexpr int kNMin = {lay.nmin};",
         f"constexpr bool kShared = {'true' if shared else 'false'};",
         f"constexpr bool kOneGroup = {'true' if one_group else 'false'};",
         f"constexpr long long kSegGroups = {int(seg_groups)};"]
    L += call_source(prog)
    # K == 1: per-thread accumulators, reduced across the warp at the end
    L.append("struct Acc { unsigned long long s[kN64 > 0 ? kN64 : 1]; "
             "unsigned n[kN32 > 0 ? kN32 : 1]; "
             "int m[kNMin > 0 ? kNMin : 1]; };")
    init = [f"a.s[{q}] = 0ull;" for q in range(lay.n64)] \
        + [f"a.n[{q}] = 0u;" for q in range(lay.n32)] \
        + [f"a.m[{q}] = 2147483647;" for q in range(lay.nmin)]
    L.append("ROWGEN_FN void acc_init(Acc& a) { " + " ".join(init)
             + " (void)a; }")
    take, warp, spill, shared_take, global_take, flush = [], [], [], [], [], []
    for c, (kind, q) in enumerate(zip(lay.kind, lay.index)):
        sel = f"if (o.sel[{c}]) "
        if kind == "sum":
            take.append(f"{sel}a.s[{q}] += (unsigned long long)o.val[{c}];")
            warp.append(f"a.s[{q}] += __shfl_down_sync(0xffffffffu, "
                        f"a.s[{q}], d);")
            spill.append(f"if (a.s[{q}]) atomicAdd(&t64[{q}], a.s[{q}]);")
            shared_take.append(
                f"{sel}atomicAdd(&t64[k * kN64 + {q}], "
                f"(unsigned long long)o.val[{c}]);")
            flush.append(f"{{ const unsigned long long v = t64[k * kN64 + "
                         f"{q}]; if (v) atomicAdd(&sums[k * kSum + {c}], "
                         "v); }")
        elif kind == "count":
            take.append(f"{sel}a.n[{q}] += 1u;")
            warp.append(f"a.n[{q}] += __shfl_down_sync(0xffffffffu, "
                        f"a.n[{q}], d);")
            spill.append(f"if (a.n[{q}]) atomicAdd(&t32[{q}], a.n[{q}]);")
            shared_take.append(f"{sel}atomicAdd(&t32[k * kN32 + {q}], 1u);")
            flush.append(f"{{ const unsigned v = t32[k * kN32 + {q}]; "
                         f"if (v) atomicAdd(&sums[k * kSum + {c}], "
                         "(unsigned long long)v); }")
        else:
            m = c - prog.n_sum
            take.append(f"{sel}a.m[{q}] = rowgen::min(a.m[{q}], (int)o.val[{c}]);")
            warp.append(f"a.m[{q}] = rowgen::min(a.m[{q}], __shfl_down_sync("
                        f"0xffffffffu, a.m[{q}], d));")
            spill.append(f"if (a.m[{q}] != 2147483647) "
                         f"atomicMin(&tmin[{q}], a.m[{q}]);")
            shared_take.append(f"{sel}atomicMin(&tmin[k * kNMin + {q}], "
                               f"(int)o.val[{c}]);")
            flush.append(f"{{ const int v = tmin[k * kNMin + {q}]; "
                         f"if (v != 2147483647) atomicMin(&mins[k * kMin + "
                         f"{m}], v); }}")
        global_take.append(
            f"{sel}atomicMin(&mins[k * kMin + {c - prog.n_sum}], "
            f"(int)o.val[{c}]);" if kind == "min" else
            f"{sel}atomicAdd(&sums[k * kSum + {c}], "
            f"(unsigned long long)o.val[{c}]);")

    def fn(sig, lines):
        L.append(f"ROWGEN_FN void {sig} {{\n  " + "\n  ".join(lines)
                 + "\n}")

    fn("acc_take(Acc& a, const RowOut& o)",
       ["if (o.key != 0) return;"] + take)
    fn("acc_spill(Acc& a, unsigned long long* t64, unsigned* t32, "
       "int* tmin)",
       ["#pragma unroll", "for (int d = 16; d > 0; d >>= 1) {"]
       + ["  " + x for x in warp] + ["}",
                                     "if ((threadIdx.x & 31) != 0) return;"]
       + spill + ["(void)t64; (void)t32; (void)tmin;"])
    fn("take_shared(const RowOut& o, unsigned long long* t64, "
       "unsigned* t32, int* tmin)",
       ["const long long k = o.key;", "if (k < 0 || k >= kGroups) return;"]
       + shared_take + ["(void)t64; (void)t32; (void)tmin;"])
    fn("take_global(const RowOut& o, unsigned long long* sums, int* mins)",
       ["const long long k = o.key;", "if (k < 0 || k >= kGroups) return;"]
       + global_take + ["(void)sums; (void)mins;"])
    fn("flush(long long k, const unsigned long long* t64, "
       "const unsigned* t32, const int* tmin, unsigned long long* sums, "
       "int* mins)", flush + ["(void)t64; (void)t32; (void)tmin; "
                              "(void)sums; (void)mins;"])
    L.append(f"}}  // namespace {namespace}")
    return "\n".join(L) + "\n"


def splice(template: Path, plan_source: str) -> str:
    """A kernel template with the shared helpers (`COMMON`) and one
    plan's code spliced in at its marks."""
    text = template.read_text()
    for mark in (COMMON_SPLICE, SPLICE):
        if mark not in text:
            raise RuntimeError(f"{template} lacks the splice mark {mark}")
    return text.replace(COMMON_SPLICE, COMMON.read_text()) \
        .replace(SPLICE, plan_source)


def kernel_source(prog: rp.RowProgram, K: int, window: int = 0) -> str:
    """The whole NVRTC source of the plan's fused-reduce kernel: the
    template with the row function and its glue spliced in. It holds
    none of the query's literals (see `constants`). `window` W > 0 gives
    the segment-extended variant: W * K groups, a row of window segment
    j keyed j * K plus its key."""
    if window:
        return splice(TEMPLATE, row_source(prog) + _device_source(
            prog, window * K, seg_groups=K))
    return splice(TEMPLATE, row_source(prog) + _device_source(prog, K))


class Params(ctypes.Structure):
    """The kernel's one argument (`Params` in csrc/fused_reduce_gen.cuh)."""
    _fields_ = [("slot", ctypes.c_void_p * MAX_SLOTS),
                ("valid", ctypes.c_void_p),
                ("seg_mask", ctypes.c_void_p),
                ("data", ctypes.c_void_p),
                ("sums", ctypes.c_void_p),
                ("mins", ctypes.c_void_p),
                ("seg_rows", ctypes.c_longlong),
                ("tiles_per_seg", ctypes.c_longlong),
                ("n_tiles", ctypes.c_longlong),
                ("tile_lo", ctypes.c_longlong),
                ("seg_lo", ctypes.c_longlong),
                ("consts", ctypes.c_longlong * MAX_CONSTS),
                ("vec", ctypes.c_int)]


# ---------------------------------------------------------------------------
# The multi-leg fused reduce: N plans' legs in one launch


def leg_namespace(i: int) -> str:
    return f"rowgen_leg{i}"


def multi_smem(progs, Ks) -> int:
    """Dynamic shared memory of a multi-leg launch: the largest table of
    a leg that keeps it in shared memory (a block serves one leg at a
    time; a leg's table lives there when it fits SMEM_TABLE_BYTES
    alone, as in B1)."""
    return max(table_bytes(p, K) for p, K in zip(progs, Ks))


def _leg_source(i: int) -> str:
    """Leg i's code: its row function and reduce glue in its own
    namespace, then `Leg`, the traits struct through which the
    template's per-leg helpers reach them."""
    ns = leg_namespace(i)
    q = f"::{ns}::"
    fwd = (
        ("void", "cone_load", "const void* const* s, long long i0, Cone& c",
         "s, i0, c"),
        ("bool", "row_vec", "const void* const* s, const long long* d, "
         "const long long* k, long long i, const Cone& c, int r, RowOut& o",
         "s, d, k, i, c, r, o"),
        ("bool", "row_scalar", "const void* const* s, const long long* d, "
         "const long long* k, long long i, RowOut& o", "s, d, k, i, o"),
        ("void", "acc_init", "Acc& a", "a"),
        ("void", "acc_take", "Acc& a, const RowOut& o", "a, o"),
        ("void", "acc_spill", "Acc& a, unsigned long long* t64, "
         "unsigned* t32, int* tmin", "a, t64, t32, tmin"),
        ("void", "take_shared", "const RowOut& o, unsigned long long* t64, "
         "unsigned* t32, int* tmin", "o, t64, t32, tmin"),
        ("void", "take_global", "const RowOut& o, unsigned long long* sums, "
         "int* mins", "o, sums, mins"),
        ("void", "flush", "long long k, const unsigned long long* t64, "
         "const unsigned* t32, const int* tmin, unsigned long long* sums, "
         "int* mins", "k, t64, t32, tmin, sums, mins"))
    L = [f"namespace {ns} {{", "struct Leg {"]
    L += [f"  using {t} = {q}{t};" for t in ("Cone", "Acc", "RowOut")]
    L += [f"  static constexpr {ty} {c} = {q}{c};" for ty, c in (
        ("long long", "kGroups"), ("int", "kN64"), ("int", "kN32"),
        ("int", "kNMin"), ("bool", "kShared"), ("bool", "kOneGroup"))]
    for ret, name, sig, args in fwd:
        L.append(f"  static __device__ __forceinline__ {ret} {name}({sig}) "
                 f"{{ return {q}{name}({args}); }}")
    L += ["};", f"}}  // namespace {ns}"]
    return "\n".join(L) + "\n"


def _leg_code(prog: rp.RowProgram, K: int, i: int) -> str:
    """Leg i's whole code as the program at K groups: its row function,
    reduce glue and traits, memoized on the program."""
    key = ("multi-leg", K, i)
    code = prog._device.get(key)
    if code is None:
        ns = leg_namespace(i)
        code = prog._device[key] = row_source(prog, ns) \
            + _device_source(prog, K, ns) + _leg_source(i)
    return code


def multi_layout(progs) -> tuple:
    """(per leg: the offset of its arguments in the parameter block's
    `words`; the words in all). A leg's words: its slot pointers, then
    its data, segment mask, sums and mins pointers, then its kernel
    constants (rowgen.constants)."""
    offsets, w = [], 0
    for p in progs:
        offsets.append(w)
        w += len(p.slots) + LEG_FIXED_WORDS + _n_consts(p)
    return offsets, w


def _n_consts(prog: rp.RowProgram) -> int:
    n = prog._device.get("n_consts")
    if n is None:
        n = prog._device["n_consts"] = len(constants(prog))
    return n


def _multi_dispatch(progs) -> str:
    """The glue over the legs: the launch's parameter block
    `MultiParams` (MultiHead, then every leg's words) and `run`, which
    sends a block to leg i's instance of the template's `leg_run` with
    the leg's arguments read from the block at literal offsets."""
    offsets, words = multi_layout(progs)
    cases = []
    for i, (p, o) in enumerate(zip(progs, offsets)):
        f = o + len(p.slots)       # the leg's fixed words
        cases.append(
            f"    case {i}: {{\n"
            "      const LegView v = {\n"
            f"          reinterpret_cast<const void* const*>(p.words + {o}),\n"
            f"          reinterpret_cast<const long long*>(p.words[{f}]),\n"
            f"          reinterpret_cast<const unsigned char*>(p.words[{f + 1}]),"
            "\n"
            f"          reinterpret_cast<unsigned long long*>(p.words[{f + 2}]),"
            "\n"
            f"          reinterpret_cast<int*>(p.words[{f + 3}]),\n"
            f"          p.words + {f + 4}}};\n"
            f"      leg_run<::{leg_namespace(i)}::Leg>(v, p.h, p.h.next + {i}, "
            "smem, slots, round);\n"
            "      break;\n    }")
    return ("namespace rowgen_multi {\n"
            f"constexpr int kLegs = {len(progs)};\n"
            "struct MultiParams {\n  rowgen::MultiHead h;\n"
            f"  long long words[{max(1, words)}];\n}};\n"
            "__device__ __forceinline__ void run(int leg, "
            "const MultiParams& p, unsigned char* smem, "
            "unsigned long long* slots, unsigned& round) {\n"
            "  using namespace rowgen;\n"
            "  switch (leg) {\n" + "\n".join(cases)
            + "\n    default: break;\n  }\n"
            "}\n}  // namespace rowgen_multi\n")


def multi_kernel_source(progs, Ks) -> str:
    """The whole NVRTC source of the multi-leg kernel of one batch
    composition: each leg's row function, reduce glue and traits in its
    own namespace, and the glue over the legs, spliced into
    MULTI_TEMPLATE. Like kernel_source it holds none of the legs'
    literals, so batches that differ only in literals share it."""
    if not 1 <= len(progs) <= MAX_LEGS:
        raise ValueError(f"{len(progs)} legs: a multi-leg launch takes 1 "
                         f"to {MAX_LEGS}")
    parts = [_leg_code(prog, K, i)
             for i, (prog, K) in enumerate(zip(progs, Ks))]
    parts.append(_multi_dispatch(progs))
    return splice(MULTI_TEMPLATE, "".join(parts))


# a leg's words after its slot pointers: data, seg_mask, sums, mins
LEG_FIXED_WORDS = 4
# the kernel parameter block of an sm_90 kernel built with CUDA 12.1 or
# later, and the bytes of `MultiHead` at its start
MULTI_PARAM_BYTES = 32764
MULTI_HEAD_BYTES = 48
MAX_MULTI_WORDS = (MULTI_PARAM_BYTES - MULTI_HEAD_BYTES) // 8


class MultiHead(ctypes.Structure):
    """`MultiHead` in csrc/fused_reduce_multi_gen.cuh."""
    _fields_ = [("next", ctypes.c_void_p),
                ("valid", ctypes.c_void_p),
                ("seg_rows", ctypes.c_longlong),
                ("tiles_per_seg", ctypes.c_longlong),
                ("n_tiles", ctypes.c_longlong),
                ("vec", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def multi_params(words: int) -> type:
    """The multi-leg kernel's one argument for a composition of `words`
    words (`rowgen_multi::MultiParams` in its generated source)."""
    return type(f"MultiParams{words}", (ctypes.Structure,), {
        "_fields_": [("h", MultiHead),
                     ("words", ctypes.c_longlong * max(1, words))]})

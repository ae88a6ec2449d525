"""Row programs: a query's per-row front half as data for one kernel.

The fused reduce (kernels.fused_reduce) does in one CUDA kernel what the
TPU kernel B1 does in one Pallas body: AND the masks, evaluate the filter
and the integer virtual columns, compute the dimension ids and the
mixed-radix group key, and reduce per group; the row-mask kernel
(kernels.row_mask) computes a scan's row mask the same way. Filters and expressions are
query-specific Python closures over torch tensors (kernels.filtereval,
kernels.exprs, executor.dimplan, kernels.timebucket); a fixed CUDA
source cannot call them. So the front half is traced once per plan into
a row program, a straight-line list of integer instructions over a small
register file, which kernels.rowgen writes out as the kernel's CUDA and
`evaluate` runs with torch ops (the kernels' plain version).

Tracing runs the SAME closures the generic reduce runs, on `_Sym`
tensors: a torch.Tensor subclass whose `__torch_function__` executes
each op on a few dummy rows and records it. Every recorded op becomes
one instruction whose result is wrapped to the op's torch dtype
(int8/16/32 arithmetic wraps as torch's does, bool is 0/1), so the
program computes bit for bit what the eager closures compute. Constants
read by the closures (ConstPool scalars, dictionary lookup tables, IN
lists, bucket boundaries) are baked into the program: scalars as
immediates, vectors as tables read by GATHER / ISIN / SEARCH.

What does not fit raises RowProgramError, and the plan keeps its torch
version: floating-point row values, ops outside the table below,
value-dependent Python control flow, more than MAX_REGS live values.

Semantics the kernel and `evaluate` share where torch would raise:
integer division or remainder by zero gives 0; a gather index past its
table gives 0 (negative indexes wrap once, as torch's do).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

ROWS = 4099                 # dummy row count of a trace
MAX_REGS = 48               # live values of one row program
MAX_INS = 512               # instructions of one row program
MAX_SLOTS = 32              # input streams one launch takes
MAX_COLUMNS = 64            # reduce columns one launch takes

# opcodes (their C forms: kernels.rowgen._instruction)
(LOAD, IMM, EXITZ, ADD, SUB, MUL, NEG, FDIV, TDIV, REM, ABS, MIN, MAX,
 EQ, NE, LT, LE, GT, GE, AND, OR, XOR, BNOT, LNOT, SELECT, CAST, GATHER,
 SEARCHR, SEARCHL, ISIN) = range(30)
# result widths
W64, W32, W16, W8, WU8, WBOOL = range(6)

_RANGE = {W64: (-(1 << 63), (1 << 63) - 1), W32: (-(1 << 31), (1 << 31) - 1),
          W16: (-(1 << 15), (1 << 15) - 1), W8: (-128, 127), WU8: (0, 255),
          WBOOL: (0, 1)}
_WIDTH = {torch.int64: W64, torch.int32: W32, torch.int16: W16,
          torch.int8: W8, torch.uint8: WU8, torch.bool: WBOOL}
# slot dtypes a program loads
SLOT_TYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
              torch.bool)

_BINARY = {
    "__add__": ADD, "__radd__": ADD, "add": ADD,
    "__sub__": SUB, "sub": SUB, "subtract": SUB,
    "__mul__": MUL, "__rmul__": MUL, "mul": MUL, "multiply": MUL,
    "__and__": AND, "__rand__": AND, "bitwise_and": AND,
    "__or__": OR, "__ror__": OR, "bitwise_or": OR,
    "__xor__": XOR, "__rxor__": XOR, "bitwise_xor": XOR,
    "__eq__": EQ, "eq": EQ, "__ne__": NE, "ne": NE,
    "__lt__": LT, "lt": LT, "__le__": LE, "le": LE,
    "__gt__": GT, "gt": GT, "__ge__": GE, "ge": GE,
    "remainder": REM, "__mod__": REM,
    "floor_divide": FDIV, "__floordiv__": FDIV,
    "minimum": MIN, "maximum": MAX,
}
_SWAPPED = {"__rsub__": SUB, "rsub": SUB, "__rmod__": REM,
            "__rfloordiv__": FDIV}
_SAME_ROWS = ("reshape", "view", "contiguous", "flatten", "clone",
              "detach")
_CASTS = ("to", "long", "int", "short", "char", "byte", "bool", "type")
_IN_PLACE = ("__iadd__", "__isub__", "__imul__", "__iand__", "__ior__",
             "__ixor__", "__imod__", "__ifloordiv__", "__itruediv__")
_VALUE_READS = ("__bool__", "__int__", "__index__", "__float__", "item",
                "tolist", "numpy", "nonzero")


class RowProgramError(ValueError):
    """The front half does not fit a row program."""


@dataclass
class RowProgram:
    """A traced front half. `ins` is int32 [n, 6]: (op, width, dst, a, b,
    c); `data` holds immediates and tables (int64). `slots` name the
    input streams in launch order with their dtypes (kind "col" reads
    env["cols"], "null" reads env["nulls"]). The first `n_pro`
    instructions load immediates; the kernel runs them once per thread
    and the rest once per row. It skips a row at EXITZ (the mask's last instruction) when the mask is 0, and reduces
    the survivors: key register `key_reg`; per column c a value register
    `val_regs[c]` (-1: a count, reads 1) and a selection register
    `sel_regs[c]` (-1: none). Columns [0, n_sum) add into int64, the
    rest take an int32 minimum."""
    ins: np.ndarray
    data: np.ndarray
    slots: tuple
    mask_reg: int
    key_reg: int
    val_regs: tuple
    sel_regs: tuple
    n_sum: int
    n_regs: int
    n_pro: int = 0             # leading IMMs: run once per thread
    cone_slots: frozenset = field(default_factory=frozenset)
    _device: dict = field(default_factory=dict, repr=False)

    @property
    def n_cols(self) -> int:
        return len(self.val_regs)

    @property
    def loaded_slots(self) -> set:
        """Slots the program reads."""
        return set(self.ins[self.ins[:, 0] == LOAD, 3].tolist())

    @property
    def exit_pc(self) -> int:
        """Index of the EXITZ instruction (the mask cone ends there)."""
        return int(np.nonzero(self.ins[:, 0] == EXITZ)[0][0])

    def data_on(self, device) -> torch.Tensor:
        """The program's immediates and tables (`data`) as an int64
        tensor on `device`, uploaded once."""
        dev = torch.device(device)
        hit = self._device.get(dev)
        if hit is None:
            data = self.data if self.data.size else np.zeros(1, np.int64)
            hit = self._device[dev] = torch.from_numpy(
                np.ascontiguousarray(data)).to(dev)
        return hit


# ---------------------------------------------------------------------------
# Tracing


class _Node:
    __slots__ = ("func", "args", "kwargs", "dtype", "slot")

    def __init__(self, func, args, kwargs, dtype, slot=None):
        self.func, self.args, self.kwargs = func, args, kwargs
        self.dtype, self.slot = dtype, slot


class _Sym(torch.Tensor):
    """A traced row stream: dummy rows plus the node that made them."""

    @staticmethod
    def __new__(cls, data, node):
        t = torch.Tensor._make_subclass(cls, data)
        t._node = node
        return t

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _VALUE_READS:
            raise RowProgramError(
                f"value-dependent control flow ({name}) in the front half")
        if name in _IN_PLACE or (name.endswith("_")
                                 and not name.endswith("__")):
            raise RowProgramError(f"in-place op {name} in the front half")
        with torch._C.DisableTorchFunctionSubclass():
            try:
                out = func(*args, **kwargs)
            except (RuntimeError, IndexError):
                # the dummy rows broke the op (a zero divisor, an index
                # past a table): only its shape and dtype matter here
                out = _on_meta(func, args, kwargs)
            if isinstance(out, torch.Tensor):
                for a in args:
                    if out is a:  # e.g. contiguous() of a contiguous row
                        return a
                out = out.as_subclass(torch.Tensor)
        if isinstance(out, torch.Tensor):
            return _Sym(out, _Node(func, args, kwargs, out.dtype))
        if isinstance(out, (tuple, list)) and any(
                isinstance(o, torch.Tensor) for o in out):
            raise RowProgramError(f"op {name} returns several tensors")
        return out


def _on_meta(func, args, kwargs):
    def meta(x):
        return x.to("meta") if isinstance(x, torch.Tensor) else x
    out = func(*[meta(a) for a in args],
               **{k: meta(v) for k, v in kwargs.items()})
    return torch.zeros(out.shape, dtype=out.dtype)


def input_stream(slot: int, dtype: torch.dtype) -> torch.Tensor:
    """A traced input stream of `dtype` read from launch slot `slot`."""
    return _Sym(torch.zeros(ROWS, dtype=dtype), _Node(None, (), {}, dtype,
                                                      slot))


def trace(row_fn, slots) -> RowProgram:
    """Trace row_fn into a RowProgram.

    slots: ((name, kind, dtype), ...) — the input streams; the special
    kind "base" is the validity ∧ segment mask, which the kernel tests
    before the program and the plain version ANDs after it (it reads 1
    inside). row_fn(streams) gets one traced tensor per slot (a list,
    in slot order) and returns (mask, key, sums, mins): sums and mins
    are sequences of (value or None, selection or None) columns — a
    None value is a count (sums only). A row mask alone (kernels.row_mask)
    has no columns and a constant key.
    """
    streams = [input_stream(i, dt) for i, (_, _, dt) in enumerate(slots)]
    try:
        mask, key, sums, mins = row_fn(streams)
    except RowProgramError:
        raise
    except Exception as e:  # the closure cannot run on traced streams
        raise RowProgramError(f"tracing failed: {e!r}") from e
    return _Compiler(slots).compile(mask, key, list(sums) + list(mins),
                                    len(sums))


class _Compiler:
    def __init__(self, slots):
        self.slots = tuple(slots)
        if len(self.slots) > MAX_SLOTS:
            raise RowProgramError(f"{len(self.slots)} input streams "
                                  f"(at most {MAX_SLOTS})")
        self.ops: list = []      # (op, width, source value ids, b, c)
        self.memo: dict = {}
        self.imms: dict = {}
        self.data: list = []
        self.tables: dict = {}

    # -- values ------------------------------------------------------------

    def _emit(self, op, width, srcs=(), b=0, c=0) -> int:
        srcs = tuple(srcs)
        if op not in (LOAD, IMM) and srcs \
                and all(self.ops[s][0] == IMM for s in srcs):
            return self._fold(op, width, srcs, b, c)
        same = self._identity(op, width, srcs)
        if same is not None:
            return same
        self.ops.append((op, width, srcs, b, c))
        return len(self.ops) - 1

    def _fold(self, op, width, srcs, b, c) -> int:
        """An instruction over immediates is an immediate."""
        vals = [torch.tensor([self.data[self.ops[s][3]]]) for s in srcs]
        vals += [None] * (3 - len(vals))
        data = torch.tensor(self.data or [0], dtype=torch.int64)
        return self._imm(int(_apply(op, width, *vals, b, c, data)[0]))

    def _range(self, v) -> tuple:
        op, w, _, b, _ = self.ops[v]
        if op == IMM:
            return (self.data[b], self.data[b])
        return _RANGE[w]

    def _identity(self, op, width, srcs):
        """The source an instruction would copy unchanged, else None:
        a cast to a width that holds the source, x & 1 over 0/1 values,
        x & -1, x | 0, x + 0, x - 0, x * 1."""
        lo, hi = _RANGE[width]

        def fits(v):
            a, b = self._range(v)
            return lo <= a and b <= hi
        if op == CAST:
            return srcs[0] if fits(srcs[0]) else None
        if op not in (AND, OR, ADD, SUB, MUL):
            return None
        x, y = srcs
        for first, (s, o) in enumerate(((y, x), (x, y))):
            if self.ops[s][0] != IMM or (op == SUB and first):
                continue
            v = self.data[self.ops[s][3]]
            keep = (op == AND and (v == -1 or (
                v == 1 and self._range(o)[0] >= 0
                and self._range(o)[1] <= 1))) \
                or (op in (OR, ADD, SUB) and v == 0) \
                or (op == MUL and v == 1)
            if keep and fits(o):
                return o
        return None

    def _imm(self, v: int) -> int:
        v = int(v)
        if not -(1 << 63) <= v < (1 << 63):
            raise RowProgramError(f"constant {v} exceeds int64")
        hit = self.imms.get(v)
        if hit is None:
            self.data.append(v)
            hit = self.imms[v] = self._emit(IMM, W64, (), len(self.data) - 1)
        return hit

    def _table(self, t) -> tuple:
        """(offset, length) of a constant vector in `data`."""
        t = torch.as_tensor(t)
        if t.is_floating_point() or t.is_complex() or t.dim() != 1:
            raise RowProgramError(f"table of {t.dtype} {tuple(t.shape)}")
        vals = t.to(torch.int64).tolist()
        key = tuple(vals)
        hit = self.tables.get(key)
        if hit is None:
            hit = self.tables[key] = (len(self.data), len(vals))
            self.data.extend(vals)
        return hit

    def value(self, x) -> int:
        """Value id of an operand: a traced stream, or a constant that
        is the same on every row."""
        if isinstance(x, _Sym):
            return self._node(x)
        if isinstance(x, (bool, int, np.integer)):
            return self._imm(int(x))
        if isinstance(x, torch.Tensor):
            if x.is_floating_point() or x.is_complex():
                raise RowProgramError(f"{x.dtype} constant in a row op")
            flat = x.reshape(-1)
            if flat.numel() == 1 or (tuple(x.shape) == (ROWS,)
                                     and bool((flat == flat[0]).all())):
                return self._imm(int(flat[0]))
            raise RowProgramError(
                f"constant of shape {tuple(x.shape)} in a row op")
        raise RowProgramError(f"operand {type(x).__name__} in a row op")

    def _node(self, sym) -> int:
        n = sym._node
        hit = self.memo.get(id(n))
        if hit is not None:
            if isinstance(hit, tuple):
                raise RowProgramError("broadcast intermediate used as a row")
            return hit
        v = self._lower(n, sym)
        self.memo[id(n)] = v
        return v

    def _width(self, dtype) -> int:
        w = _WIDTH.get(dtype)
        if w is None:
            raise RowProgramError(f"{dtype} row values")
        return w

    def _lower(self, n, sym):
        if n.func is None:  # an input stream
            name, kind, dtype = self.slots[n.slot]
            if kind == "base":
                # the program only ever sees rows inside the base mask:
                # the kernel tests it first, the plain version ANDs it
                return self._imm(1)
            if dtype not in SLOT_TYPES:
                raise RowProgramError(f"{dtype} input stream {name!r}")
            return self._emit(LOAD, self._width(dtype), (), n.slot)
        name = getattr(n.func, "__name__", "")
        args, kw = n.args, n.kwargs
        shape = tuple(sym.shape)
        if name == "__getitem__":
            return self._getitem(args, sym)
        if name == "any":
            return self._any(args, kw, shape)
        if shape != (ROWS,):
            raise RowProgramError(f"op {name} gives shape {shape}")
        w = self._width(n.dtype)
        if name in _BINARY or name in _SWAPPED:
            if "alpha" in kw or len(args) != 2:
                raise RowProgramError(f"op {name} with {len(args)} args")
            a, b = args if name in _BINARY else args[::-1]
            op = _BINARY.get(name, _SWAPPED.get(name))
            return self._emit(op, w, (self.value(a), self.value(b)))
        if name in ("div", "true_divide", "divide", "__truediv__"):
            mode = kw.get("rounding_mode")
            if mode not in ("floor", "trunc") or len(args) != 2:
                raise RowProgramError(f"division with rounding {mode!r}")
            return self._emit(FDIV if mode == "floor" else TDIV, w,
                              (self.value(args[0]), self.value(args[1])))
        if name in ("__neg__", "neg", "negative"):
            return self._emit(NEG, w, (self.value(args[0]),))
        if name in ("abs", "__abs__"):
            return self._emit(ABS, w, (self.value(args[0]),))
        if name in ("__invert__", "bitwise_not", "logical_not"):
            src = args[0]
            is_bool = (src.dtype == torch.bool
                       if isinstance(src, torch.Tensor) else False)
            if name == "logical_not" and not is_bool:
                raise RowProgramError("logical_not of integers")
            return self._emit(LNOT if is_bool else BNOT, w,
                              (self.value(src),))
        if name == "where":
            if len(args) != 3:
                raise RowProgramError("where with one argument")
            return self._emit(SELECT, w, tuple(self.value(a) for a in args))
        if name in ("clamp", "clip"):
            lo = kw.get("min", args[1] if len(args) > 1 else None)
            hi = kw.get("max", args[2] if len(args) > 2 else None)
            v = self.value(args[0])
            if lo is not None:
                v = self._emit(MAX, W64, (v, self.value(lo)))
            if hi is not None:
                v = self._emit(MIN, W64, (v, self.value(hi)))
            return self._emit(CAST, w, (v,))
        if name in _CASTS:
            return self._emit(CAST, w, (self.value(args[0]),))
        if name in _SAME_ROWS:
            return self._emit(CAST, w, (self.value(args[0]),))
        if name in ("zeros_like", "ones_like", "full_like", "empty_like"):
            fill = {"zeros_like": 0, "ones_like": 1, "empty_like": 0}.get(
                name)
            if fill is None:
                fill = kw.get("fill_value", args[1] if len(args) > 1
                              else None)
                if not isinstance(fill, (bool, int, np.integer)):
                    raise RowProgramError(f"full_like({fill!r})")
            return self._emit(CAST, w, (self._imm(int(fill)),))
        if name == "searchsorted":
            seq = kw.get("sorted_sequence", args[0])
            x = kw.get("input", args[1] if len(args) > 1 else None)
            right = kw.get("right", False) or kw.get("side") == "right"
            if isinstance(seq, _Sym) or "sorter" in kw:
                raise RowProgramError("searchsorted over a row stream")
            off, ln = self._table(seq)
            return self._emit(SEARCHR if right else SEARCHL, w,
                              (self.value(x),), off, ln)
        if name == "isin":
            el = kw.get("elements", args[0])
            te = kw.get("test_elements", args[1] if len(args) > 1 else None)
            if kw.get("invert") or isinstance(te, _Sym):
                raise RowProgramError("isin form")
            return self._isin(self.value(el), te, w)
        raise RowProgramError(f"op {name} is not in the row program's "
                              "instruction set")

    def _getitem(self, args, sym):
        base, idx = args
        if isinstance(base, _Sym):
            # x[..., None]: the broadcast half of an IN-list compare
            if idx == (Ellipsis, None) and tuple(base.shape) == (ROWS,):
                return ("unsqueeze", self.value(base))
            raise RowProgramError(f"indexing a row stream with {idx!r}")
        if not isinstance(idx, _Sym) or tuple(sym.shape) != (ROWS,):
            raise RowProgramError("gather form")
        off, ln = self._table(base)
        return self._emit(GATHER, self._width(sym.dtype),
                          (self.value(idx),), off, ln)

    def _any(self, args, kw, shape):
        src = args[0]
        dim = kw.get("dim", args[1] if len(args) > 1 else None)
        if shape != (ROWS,) or dim not in (-1, 1) \
                or not isinstance(src, _Sym):
            raise RowProgramError("reduction over rows")
        n = src._node
        name = getattr(n.func, "__name__", "")
        if name not in ("__eq__", "eq") or len(n.args) != 2:
            raise RowProgramError(f"any() over {name}")
        a, b = n.args
        if isinstance(b, _Sym):
            a, b = b, a
        ua = self.memo.get(id(a._node)) if isinstance(a, _Sym) else None
        if ua is None and isinstance(a, _Sym):
            ua = self.memo[id(a._node)] = self._lower(a._node, a)
        if not (isinstance(ua, tuple) and ua[0] == "unsqueeze") \
                or isinstance(b, _Sym):
            raise RowProgramError("any() over a non IN-list compare")
        return self._isin(ua[1], b, WBOOL)

    def _isin(self, v, table, w):
        vals = torch.as_tensor(table)
        if vals.is_floating_point():
            raise RowProgramError("IN list of floats")
        uniq = np.unique(vals.reshape(-1).to(torch.int64).numpy())
        off, ln = self._table(torch.from_numpy(uniq))
        return self._emit(ISIN, w, (v,), off, ln)

    # -- program -----------------------------------------------------------

    def compile(self, mask, key, cols, n_sum) -> RowProgram:
        cols = list(cols)
        if len(cols) > MAX_COLUMNS:
            raise RowProgramError(f"{len(cols)} reduce columns (at most "
                                  f"{MAX_COLUMNS})")
        if not 0 <= n_sum <= len(cols) or any(
                v is None for v, _ in cols[n_sum:]):
            raise RowProgramError("count columns must be sums")
        m = self.value(mask)
        outs = [self.value(key)]
        for v, s in cols:
            outs.append(-1 if v is None else self.value(v))
            outs.append(-1 if s is None else self.value(s))
        return self._allocate(m, outs, n_sum)

    def _closure(self, roots) -> set:
        seen: set = set()
        stack = list(roots)
        while stack:
            u = stack.pop()
            if u not in seen:
                seen.add(u)
                stack.extend(self.ops[u][2])
        return seen

    def _allocate(self, mask_v, outs, n_sum) -> RowProgram:
        """Order the values (the mask's cone first, then EXITZ, then the
        rest; value ids are already topological), drop those no output
        reads, and give each a register, reusing one after its last
        read."""
        needed = self._closure([mask_v] + [v for v in outs if v >= 0])
        imms = sorted(v for v in needed if self.ops[v][0] == IMM)
        cone = self._closure([mask_v]) - set(imms)
        rest = needed - cone - set(imms)
        # immediates first: the kernel runs them once per thread, not per
        # row (their registers stay pinned)
        order = imms + sorted(cone) + sorted(rest)
        exit_at = len(imms) + len(cone)
        last = {}
        for i, v in enumerate(order):
            for s in self.ops[v][2]:
                last[s] = i
        pinned = {v for v in outs if v >= 0} | {mask_v} | set(imms)
        rows, reg_of, free, n_regs = [], {}, [], 0
        cone_slots = set()
        for i, v in enumerate(order):
            if i == exit_at:
                rows.append((EXITZ, W64, -1, reg_of[mask_v], 0, 0))
            op, w, srcs, b, c = self.ops[v]
            src = [reg_of[s] for s in srcs]
            for s in set(srcs):
                if last[s] == i and s not in pinned:
                    free.append(reg_of[s])
            if free:
                r = free.pop()
            else:
                r, n_regs = n_regs, n_regs + 1
            reg_of[v] = r
            if op in (LOAD, IMM):
                rows.append((op, w, r, b, 0, 0))
                if op == LOAD and v in cone:
                    cone_slots.add(b)
            elif op in (GATHER, SEARCHR, SEARCHL, ISIN):
                rows.append((op, w, r, src[0], b, c))
            else:
                rows.append((op, w, r, *(src + [0] * (3 - len(src)))))
        if exit_at == len(order):
            rows.append((EXITZ, W64, -1, reg_of[mask_v], 0, 0))
        if n_regs > MAX_REGS:
            raise RowProgramError(f"{n_regs} live values (at most "
                                  f"{MAX_REGS})")
        if len(rows) > MAX_INS:
            raise RowProgramError(f"{len(rows)} instructions (at most "
                                  f"{MAX_INS})")
        regs = [-1 if v < 0 else reg_of[v] for v in outs]
        return RowProgram(
            ins=np.asarray(rows, np.int32).reshape(-1, 6),
            data=np.asarray(self.data, np.int64),
            slots=self.slots, mask_reg=reg_of[mask_v], key_reg=regs[0],
            val_regs=tuple(regs[1::2]), sel_regs=tuple(regs[2::2]),
            n_sum=n_sum, n_regs=max(n_regs, 1), n_pro=len(imms),
            cone_slots=frozenset(cone_slots))


# ---------------------------------------------------------------------------
# The plain version: the program over whole streams with torch ops.


def _wrap(x, w):
    if w == W64:
        return x
    if w == WBOOL:
        return (x != 0).to(torch.int64)
    dt = (torch.int32, torch.int16, torch.int8, torch.uint8)[w - 1]
    return x.to(dt).to(torch.int64)


def _floordiv(a, b):
    z = b == 0
    q = torch.div(a, torch.where(z, 1, b), rounding_mode="floor")
    return torch.where(z, 0, q)


def _truncdiv(a, b):
    z = b == 0
    q = torch.div(a, torch.where(z, 1, b), rounding_mode="trunc")
    return torch.where(z, 0, q)


def _rem(a, b):
    z = b == 0
    r = torch.remainder(a, torch.where(z, 1, b))
    return torch.where(z, 0, r)


_BIN_OPS = {ADD: torch.add, SUB: torch.sub, MUL: torch.mul,
            FDIV: _floordiv, TDIV: _truncdiv, REM: _rem,
            MIN: torch.minimum, MAX: torch.maximum,
            AND: torch.bitwise_and, OR: torch.bitwise_or,
            XOR: torch.bitwise_xor}
_CMP_OPS = {EQ: torch.eq, NE: torch.ne, LT: torch.lt, LE: torch.le,
            GT: torch.gt, GE: torch.ge}


def _apply(op, w, x, y, z, b, c, data):
    """One instruction over int64 row tensors x, y, z (its sources)."""
    if op in _BIN_OPS:
        r = _BIN_OPS[op](x, y)
    elif op in _CMP_OPS:
        r = _CMP_OPS[op](x, y).to(torch.int64)
    elif op == NEG:
        r = -x
    elif op == ABS:
        r = x.abs()
    elif op == BNOT:
        r = ~x
    elif op == LNOT:
        r = (x == 0).to(torch.int64)
    elif op == CAST:
        r = x
    elif op == SELECT:
        r = torch.where(x != 0, y, z)
    elif op == GATHER:
        i = torch.where(x < 0, x + c, x)
        ok = (i >= 0) & (i < c)
        r = torch.where(ok, data[b + torch.where(ok, i, 0)], 0)
    elif op in (SEARCHR, SEARCHL):
        r = torch.searchsorted(data[b:b + c], x.contiguous(),
                               right=op == SEARCHR)
    elif op == ISIN:
        r = torch.isin(x, data[b:b + c]).to(torch.int64)
    else:
        raise ValueError(f"unknown opcode {op}")
    return _wrap(r, w)


def evaluate(prog: RowProgram, inputs, n: int, device) -> list:
    """Run the program over n rows: inputs are the slot tensors (any
    shape with n elements; None for the base slot). Returns the register
    file, int64 [n] tensors (None: never written). Rows outside the base
    mask and past EXITZ are computed too; the caller masks them."""
    flat = [None if t is None else t.reshape(-1) for t in inputs]
    data = torch.from_numpy(prog.data).to(device)
    regs: list = [None] * prog.n_regs
    for op, w, dst, a, b, c in prog.ins.tolist():
        if op == EXITZ:
            continue
        if op == LOAD:
            regs[dst] = flat[a].to(torch.int64)
        elif op == IMM:
            regs[dst] = data[a].expand(n)
        elif op in (GATHER, SEARCHR, SEARCHL, ISIN):
            regs[dst] = _apply(op, w, regs[a], None, None, b, c, data)
        else:
            regs[dst] = _apply(op, w, regs[a], regs[b],
                               regs[c] if op == SELECT else None, 0, 0,
                               data)
    return regs

"""Fused filter -> group key -> grouped reduce: the Hopper counterpart of
the TPU kernel B1.

B1 is the JAX package's Pallas kernel (`kernels/pallas_reduce.py::
build_kernel`): one pass over row blocks that ANDs the validity, segment,
interval and filter masks, evaluates int32 virtual columns, builds the
mixed-radix group key and reduces per group (`_rows`, counts, exact
integer sums, and min/max with a non-null count).

The query-specific part — filters, virtual columns, interval mask,
dimension ids, key — is the plan's row front half
(`PhysicalPlan.front_half`, the same closures the generic reduce runs),
traced once per plan into a row program (kernels.rowprog). When the plan
is lowered for a card, kernels.rowgen writes that program out as
straight-line CUDA, splices it into the kernel template
`csrc/fused_reduce_gen.cuh`, and NVRTC compiles it for sm_90a
(kernels.cuda_build; cached on the program, and in the process and on
disk by the source's hash). The source holds none of the query's
literals, which reach the kernel as launch constants, so plans that
differ only in literals share one compiled kernel. The kernel then
reduces the rows whose mask is set into per-block group tables in shared
memory, flushed to global memory with atomics; past 200 KB of table it
updates global memory directly. Like B1, it reads the resident id
streams that are precomputed once per table (remap and timeFormat
dimension ids, bucket ids, columnComparison translations) instead of
recomputing them.

B1's byte planes, bf16 one-hot matmul, chunked int32 accumulators, f64
half-sum recombination, bias shift and lane factorization exist only
because the TPU's matrix unit has no wide integer product. They are not
ported: the card has native int64 atomics, so sums are exact by
construction (two's-complement wrap of unsigned 64-bit adds, exact while
rows × max|value| < 2^63 — the one overflow rule `eligible()` adds).

`fused_reduce` is the wrapper: on CUDA tensors it launches the plan's
generated kernel or raises (a failed compile or launch is never caught);
on CPU tensors it runs `fused_reduce_ref`, the plain torch version (the
program through `rowprog.evaluate`, then `index_add_` /
`scatter_reduce_` in int64 over the selected rows). `launches` counts
launches of the generated kernel.

`fused_reduce_seg` is the segment-extended variant that serves tier 1 of
the result cache (executor.resultcache): the same generated kernel with
every segment of a window [lo, lo + W) reducing into K groups of its own
(key + (segment - lo) * K, W * K groups), so that one launch returns each
segment's partials; `lo` is a launch parameter, so a window that slides
at the same W compiles nothing. Its plain version is `fused_reduce_ref`
with the same window, and `seg_launches` counts its launches.

`fused_reduce_multi` runs N plans' legs in one launch for the batch
executor (executor.batch): a kernel generated per batch composition from
the legs' row functions (template `csrc/fused_reduce_multi_gen.cuh`,
cached by the source's hash as B1's is), whose blocks serve one leg at a
time, each leg getting exactly what `fused_reduce` gives it alone; its
plain version is `fused_reduce_multi_ref`, and `multi_launches` counts
its launches.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_olap_torch.ir.expr import BinOp, Col, Lit
from tpu_olap_torch.kernels import rowgen, rowprog
from tpu_olap_torch.kernels.groupby import torch_dtype
from tpu_olap_torch.kernels.rowprog import RowProgramError
from tpu_olap_torch.segments.segment import ColumnType

MAX_VALUE = (1 << 31) - 1           # min/max inputs must fit int32
INT64_LIMIT = 1 << 63               # sums accumulate exactly below this
GROUP_CAP = 65536                   # the JAX package's factorized cap

launches = 0                        # generated-kernel launches
seg_launches = 0                    # segment-extended variant launches
multi_launches = 0                  # multi-leg kernel launches


def expr_int_bounds(expr, col_bounds):
    """Conservative integer interval of an expression, or None if unbounded
    / non-integer (division, functions, unknown columns) — or if ANY
    intermediate result can leave int32 (every node must fit, not just
    the root)."""
    def fits(b):
        return b if (b is not None and -MAX_VALUE <= b[0]
                     and b[1] <= MAX_VALUE) else None

    if isinstance(expr, Lit):
        v = expr.value
        if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
            return fits((int(v), int(v)))
        return None
    if isinstance(expr, Col):
        return fits(col_bounds.get(expr.name))
    if isinstance(expr, BinOp) and expr.op in ("+", "-", "*", "%"):
        a = expr_int_bounds(expr.left, col_bounds)
        b = expr_int_bounds(expr.right, col_bounds)
        if a is None or b is None:
            return None
        if expr.op == "+":
            return fits((a[0] + b[0], a[1] + b[1]))
        if expr.op == "-":
            return fits((a[0] - b[1], a[1] - b[0]))
        if expr.op == "%":
            # floored modulo: with a positive constant modulus the result
            # is in [0, m-1] for ANY lhs sign; other moduli stay off
            if not (isinstance(expr.right, Lit) and b[0] == b[1]
                    and b[0] > 0):
                return None
            return fits((0, b[0] - 1))
        prods = [x * y for x in a for y in b]
        return fits((min(prods), max(prods)))
    return None


def _input_bounds(plan, table, field):
    """Integer [min, max] of an aggregation input (a LONG column or an
    integer virtual expression over LONG columns), or None."""
    expr = plan.virtual_exprs.get(field, Col(field))
    cols = expr.columns()
    if any(table.schema.get(c) is not ColumnType.LONG for c in cols):
        return None
    md = table.column_metadata(set(cols))
    bounds = {}
    for c in cols:
        m = md.get(c, {})
        bounds[c] = (0, 0) if m.get("min") is None else \
            (int(m["min"]), int(m["max"]))
    return expr_int_bounds(expr, bounds)


def eligible(plan, table) -> str | None:
    """None if the plan can run on the fused reduce, else the reason.

    B1's rules on the aggregations (count/sum/min/max, integer sums,
    inputs bounded to int32) and its group cap, plus one int64 overflow
    rule for sums; the TPU's tiling rules (block_rows % 128, the
    rows-per-block plane bound, the f64 row cap, the factorization past
    the direct cap) do not apply. Everything else — filters, virtual
    columns, dimension ids, buckets, the interval mask — is eligible
    when the front half traces into a row program."""
    if plan.kind != "agg":
        return "not an aggregate plan"
    if plan.total_groups > GROUP_CAP:
        return (f"group space {plan.total_groups} exceeds fused cap "
                f"{GROUP_CAP}")
    for p in plan.agg_plans:
        if p.kind == "count":
            continue
        if p.kind not in ("sum", "min", "max"):
            return f"aggregation kind {p.kind!r}"
        if p.kind == "sum" and np.dtype(p.acc_dtype).kind != "i":
            return f"non-integer sum {p.name!r}"
        b = _input_bounds(plan, table, p.fields[0])
        if b is None:
            return f"cannot bound {p.kind} input {p.fields[0]!r}"
        if p.kind == "sum" and \
                max(abs(b[0]), abs(b[1])) * table.num_rows >= INT64_LIMIT:
            return f"sum of {p.fields[0]!r} over {table.num_rows} rows " \
                   "may overflow int64"
    try:
        program(plan, table)
    except RowProgramError as e:
        return f"front half: {e}"
    return None


# ---------------------------------------------------------------------------
# The plan's row program


def env_slots(plan, table) -> tuple:
    """(name, kind, dtype) of every stream the runner's env carries for
    this plan (QueryRunner._prepare), then the base mask: the launch's
    input slots."""
    # imported here: the executor package imports this module's
    # importers (lowering, row_mask), so a module-level import would
    # make importing this module first a cycle
    from tpu_olap_torch.executor.dataset import has_nulls, resident_dtype
    slots = [(c, "col", resident_dtype(table, c)) for c in plan.columns]
    derived = [dp.derived_name for dp in plan.dim_plans
               if dp.cache_token is not None]
    if plan.bucket_plan is not None and plan.bucket_plan.cache_token:
        derived.append(plan.bucket_plan.derived_name)
    derived += ["\0d:" + t for t, _, _ in plan.filter_streams]
    slots += [(d, "col", torch.int32) for d in dict.fromkeys(derived)]
    slots += [(c, "null", torch.bool) for c in plan.null_cols
              if has_nulls(table, c)]
    slots.append(("", "base", torch.bool))
    return tuple(slots)


def program(plan, table) -> rowprog.RowProgram:
    """The plan's front half and reduce columns as a row program, traced
    once (memoized on the plan). Raises RowProgramError.

    Columns: sums first (column 0 is `_rows`; counts read 1), then
    minimums (a max rides negated); plan._fused_reads maps each
    aggregation to its columns."""
    prog = getattr(plan, "_fused_program", None)
    if prog is not None:
        return prog
    slots = env_slots(plan, table)
    consts = {k: torch.as_tensor(np.atleast_1d(v))
              for k, v in plan.pool.consts.items()}
    reads = []

    def row_fn(streams):
        env = {"cols": {}, "nulls": {}}
        for (name, kind, _), s in zip(slots, streams):
            if kind != "base":
                env[kind + "s"][name] = s
        key, mask, fenv = plan.front_half(env, streams[-1], consts)
        sum_cols = [(None, None)]  # _rows
        min_cols = []
        for p in plan.agg_plans:
            extra = p.filter_fn(fenv, consts) if p.filter_fn else None
            if p.kind == "count":
                if extra is None:
                    reads.append(("count", 0, None))
                else:
                    sum_cols.append((None, extra))
                    reads.append(("count", len(sum_cols) - 1, None))
                continue
            f = p.fields[0]
            v = fenv["cols"][f]
            nm = fenv["nulls"].get(f)
            sel = extra if nm is None else (
                ~nm if extra is None else extra & ~nm)
            if p.kind == "sum":
                sum_cols.append((v, sel))
                reads.append(("sum", len(sum_cols) - 1, None))
                continue
            min_cols.append((-v if p.kind == "max" else v, sel))
            nn = 0
            if sel is not None:
                sum_cols.append((None, sel))
                nn = len(sum_cols) - 1
            reads.append((p.kind, len(min_cols) - 1, nn))
        return mask, key, sum_cols, min_cols

    prog = rowprog.trace(row_fn, slots)
    plan._fused_reads = reads
    plan._fused_program = prog
    return prog


def build_kernel(plan, table, device):
    """The fused replacement for lowering's generic agg kernel closure.

    Same contract: fn(env, valid, seg_mask, consts) -> partial dict with
    "_rows" plus one [K] tensor per aggregation (and "_nn_<name>" int32
    non-null counts for min/max). Empty min/max groups carry the
    identity (±(2^31 - 1)); finalize renders them NULL via "_nn_".

    On a CUDA device the plan's kernel is generated and compiled here,
    at lowering (kept on plan._fused_program), so compile time falls in
    lower_ms and the first run only."""
    prog = program(plan, table)
    K = plan.total_groups
    if torch.device(device).type == "cuda":
        compiled(prog, K, device)

    def fn(env, valid, seg_mask, consts):
        sums, mins = fused_reduce(prog, program_inputs(prog, env), valid,
                                  seg_mask, K)
        return partials(plan, sums, mins)

    return fn


def program_inputs(prog, env) -> list:
    """The launch's inputs for `prog` from a kernel env: one stream per
    slot, None for the base slot."""
    return [None if kind == "base" else env[kind + "s"][name]
            for name, kind, _ in prog.slots]


def partials(plan, sums, mins) -> dict:
    """The plan's partial dict (the generic reduce's contract) from the
    kernel's outputs: "_rows", one [K] tensor per aggregation, and
    "_nn_<name>" non-null counts for min/max."""
    res = {"_rows": sums[:, 0]}
    for p, (kind, col, nn) in zip(plan.agg_plans, plan._fused_reads):
        acc = torch_dtype(p.acc_dtype)
        if kind in ("count", "sum"):
            res[p.name] = sums[:, col].to(acc)
            continue
        v = mins[:, col]
        res[p.name] = (-v if kind == "max" else v).to(acc)
        res[f"_nn_{p.name}"] = sums[:, nn].to(torch.int32)
    return res


# ---------------------------------------------------------------------------
# The kernel: wrapper, plain version, launch.


def _check(prog, inputs, valid, seg_mask, K):
    if K < 1:
        raise ValueError(f"K must be >= 1; got {K}")
    if valid.dtype != torch.bool or valid.dim() != 2 \
            or not valid.is_contiguous():
        raise ValueError("valid must be a contiguous bool [S, R] tensor")
    if seg_mask.dtype != torch.bool \
            or tuple(seg_mask.shape) != (valid.shape[0],):
        raise ValueError("seg_mask must be a bool [S] tensor")
    if len(inputs) != len(prog.slots):
        raise ValueError(f"{len(inputs)} inputs for {len(prog.slots)} "
                         "program slots")
    n = valid.numel()
    for t, (name, kind, dtype) in zip(inputs, prog.slots):
        if kind == "base":
            if t is not None:
                raise ValueError("the base slot takes no tensor")
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != dtype \
                or t.numel() != n or not t.is_contiguous():
            got = (f"{t.dtype} {tuple(t.shape)}"
                   if isinstance(t, torch.Tensor) else type(t).__name__)
            raise ValueError(f"input {name!r} must be a contiguous {dtype} "
                             f"tensor of {n} rows; got {got}")
        if t.device != valid.device:
            raise ValueError("all inputs must be on one device")
    if seg_mask.device != valid.device:
        raise ValueError("all inputs must be on one device")


def fused_reduce(prog, inputs, valid, seg_mask, K):
    """Run a row program over every row and reduce per group.

    prog: a RowProgram; inputs: one tensor per program slot (None for
    the base slot), each holding valid.numel() rows in valid's layout;
    valid: bool [S, R] row validity; seg_mask: bool [S] segments kept.
    A row counts when valid ∧ seg_mask ∧ the program's mask; its group
    is the program's key, in [0, K). Returns (sums int64 [K, n_sum],
    mins int32 [K, C - n_sum]); an empty group's minimum is 2^31 - 1.

    CPU tensors run the plain version; CUDA tensors launch the plan's
    generated kernel (compiled on first use if lowering did not).
    """
    _check(prog, inputs, valid, seg_mask, K)
    if valid.device.type == "cpu":
        return fused_reduce_ref(prog, inputs, valid, seg_mask, K)
    if valid.device.type != "cuda":
        raise ValueError(f"fused_reduce runs on cuda or cpu, not "
                         f"{valid.device}")
    return _launch_gen(prog, inputs, valid, seg_mask, K)


def fused_reduce_seg(prog, inputs, valid, seg_mask, K, lo, W):
    """fused_reduce with the segment-extended key: only the segments of
    the window [lo, lo + W) count, and a row of segment s with key k in
    [0, K) reduces into group (s - lo) * K + k of W * K. Returns (sums
    int64 [W * K, n_sum], mins int32 [W * K, C - n_sum]).

    CPU tensors run the plain version; CUDA tensors launch the plan's
    segment-extended kernel (compiled once per (program, K, W)) or
    raise."""
    _check(prog, inputs, valid, seg_mask, K)
    S = valid.shape[0]
    if not (W >= 1 and 0 <= lo and lo + W <= S):
        raise ValueError(f"window [{lo}, {lo + W}) outside {S} segments")
    if valid.device.type == "cpu":
        return fused_reduce_ref(prog, inputs, valid, seg_mask, K, (lo, W))
    if valid.device.type != "cuda":
        raise ValueError(f"fused_reduce_seg runs on cuda or cpu, not "
                         f"{valid.device}")
    return _launch_gen(prog, inputs, valid, seg_mask, K, (lo, W))


def fused_reduce_ref(prog, inputs, valid, seg_mask, K, window=None):
    """The plain torch version of the kernel: the row program through
    rowprog.evaluate, then index_add_ and scatter_reduce_(amin) in int64
    over the selected rows, one column at a time. `window` (lo, W) gives
    the segment-extended variant's W * K groups."""
    dev = valid.device
    base = (valid & seg_mask[:, None]).reshape(-1)
    regs = rowprog.evaluate(prog, inputs, base.numel(), dev)
    mask = base & (regs[prog.mask_reg] != 0)
    key = regs[prog.key_reg]
    mask = mask & (key >= 0) & (key < K)
    if window is not None:
        lo, W = window
        S, R = valid.shape
        seg = torch.arange(S, device=dev).repeat_interleave(R)
        mask = mask & (seg >= lo) & (seg < lo + W)
        key = key + (seg - lo) * K
        K = W * K
    n_sum = prog.n_sum
    sums = torch.zeros((K, n_sum), dtype=torch.int64, device=dev)
    mins = torch.full((K, prog.n_cols - n_sum), MAX_VALUE,
                      dtype=torch.int64, device=dev)
    for c, (vr, sr) in enumerate(zip(prog.val_regs, prog.sel_regs)):
        m = mask if sr < 0 else mask & (regs[sr] != 0)
        k = key[m]
        v = torch.ones_like(k) if vr < 0 else regs[vr][m]
        if c < n_sum:
            sums[:, c].index_add_(0, k, v)
        else:
            mins[:, c - n_sum].scatter_reduce_(0, k, v.to(torch.int32)
                                               .to(torch.int64), "amin")
    return sums, mins.to(torch.int32)


# ---------------------------------------------------------------------------
# The generated kernel


def compiled(prog, K, device):
    """The plan's generated kernel on `device`: source from
    kernels.rowgen, compiled by NVRTC and loaded (kernels.cuda_build,
    which shares one kernel among programs of one structure), memoized
    on the program. Raises if it does not compile or load."""
    from tpu_olap_torch.kernels import cuda_build
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = ("gen", K, index)
    kern = prog._device.get(key)
    if kern is None:
        kern = prog._device[key] = cuda_build.nvrtc_kernel(
            rowgen.kernel_source(prog, K), rowgen.KERNEL,
            rowgen.THREADS, rowgen.table_bytes(prog, K), index)
    return kern


def compiled_seg(prog, K, W, device):
    """The plan's segment-extended kernel for a window of W segments
    (rowgen.kernel_source(prog, K, W)), compiled and loaded as
    `compiled` does; memoized on the program per (K, W): one plan has
    at most log2(S) of them, since the runner rounds W up to a power of
    two."""
    from tpu_olap_torch.kernels import cuda_build
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = ("seg", K, W, index)
    kern = prog._device.get(key)
    if kern is None:
        kern = prog._device[key] = cuda_build.nvrtc_kernel(
            rowgen.kernel_source(prog, K, W), rowgen.KERNEL,
            rowgen.THREADS, rowgen.table_bytes(prog, W * K), index)
    return kern


def _launch_gen(prog, inputs, valid, seg_mask, K, window=None):
    global launches, seg_launches
    dev = valid.device
    n_sum, C = prog.n_sum, prog.n_cols
    G = K if window is None else window[1] * K
    sums = torch.zeros((G, n_sum), dtype=torch.int64, device=dev)
    mins = torch.full((G, C - n_sum), MAX_VALUE, dtype=torch.int32,
                      device=dev)
    if valid.numel() == 0:
        return sums, mins
    if window is None:
        kern, seg_lo, n_seg = compiled(prog, K, dev), 0, valid.shape[0]
    else:
        kern = compiled_seg(prog, K, window[1], dev)
        seg_lo, n_seg = window
    data = prog.data_on(dev)
    R, tiles_per_seg, tile_lo, n_tiles, grid = _grid(kern, valid, seg_lo,
                                                     n_seg)
    p = rowgen.Params()
    for i, t in enumerate(inputs):
        p.slot[i] = 0 if t is None else t.data_ptr()
    cone = [p.slot[s] for s in rowgen.cone_slots(prog)]
    p.vec = int(R % rowgen.ROWS_PER_THREAD == 0 and all(
        a % 16 == 0 for a in cone + [valid.data_ptr()]))
    p.valid, p.seg_mask = valid.data_ptr(), seg_mask.data_ptr()
    p.data, p.sums, p.mins = data.data_ptr(), sums.data_ptr(), \
        mins.data_ptr()
    p.seg_rows, p.tiles_per_seg, p.n_tiles = R, tiles_per_seg, n_tiles
    p.tile_lo, p.seg_lo = tile_lo, seg_lo
    values = _constants(prog)
    p.consts[:len(values)] = values
    _launch_on(kern, dev, grid, p)
    if window is None:
        launches += 1
    else:
        seg_launches += 1
    return sums, mins


def _launch_on(kern, dev: torch.device, grid: int, params):
    """Launch a loaded kernel over tensors on `dev`: the kernel must
    belong to that device's context (a module loaded on one device and
    launched with another's pointers fails), and the launch runs under
    the device's context on its current stream. The device comes from
    the input stacks, never from the engine: under a mesh each device's
    launch reads that device's stacks."""
    if kern.device_index != dev.index:
        raise ValueError(f"kernel loaded on cuda:{kern.device_index} "
                         f"launched over tensors on {dev}")
    with torch.cuda.device(dev):
        kern.launch(grid, params, torch.cuda.current_stream(dev).cuda_stream)


def _constants(prog) -> list:
    """rowgen.constants(prog), memoized on the program."""
    values = prog._device.get("consts")
    if values is None:
        values = prog._device["consts"] = rowgen.constants(prog)
    return values


def _grid(kern, valid, seg_lo=0, n_seg=None):
    """(R, tiles per segment, first tile, end tile, blocks) of a launch
    over the segments [seg_lo, seg_lo + n_seg) of valid's [S, R] rows
    (all of them by default); raises where a block would count 2^32 rows
    in its 32-bit shared counters."""
    S, R = valid.shape
    n_seg = S if n_seg is None else n_seg
    tile = rowgen.THREADS * rowgen.ROWS_PER_THREAD
    tiles_per_seg = -(-R // tile)
    tile_lo = seg_lo * tiles_per_seg
    n_tiles = (seg_lo + n_seg) * tiles_per_seg
    grid = min(kern.max_blocks, n_tiles - tile_lo)
    if -(-(n_tiles - tile_lo) // grid) * tile >= 1 << 32:
        raise ValueError(f"{valid.numel()} rows: a block would see 2^32 "
                         "rows or more")
    return R, tiles_per_seg, tile_lo, n_tiles, grid


# ---------------------------------------------------------------------------
# The multi-leg kernel: N plans' legs in one launch (the batch executor)


def fused_reduce_multi(progs, inputs_per_leg, valid, seg_masks, Ks) -> list:
    """N legs of fused_reduce in one launch: leg i is
    (progs[i], inputs_per_leg[i], seg_masks[i], Ks[i]) over the shared
    `valid`. Returns [(sums, mins)] per leg, each exactly what
    fused_reduce gives for that leg alone.

    CPU tensors run the plain version (fused_reduce_multi_ref); CUDA
    tensors launch the batch composition's generated multi-leg kernel
    once (compiled on first use, cached by its source), or raise."""
    n = len(progs)
    if n < 1 or not len(inputs_per_leg) == len(seg_masks) == len(Ks) == n:
        raise ValueError(f"{n} programs, {len(inputs_per_leg)} input lists, "
                         f"{len(seg_masks)} segment masks, {len(Ks)} Ks")
    for args in zip(progs, inputs_per_leg, seg_masks, Ks):
        prog, inputs, seg_mask, K = args
        _check(prog, inputs, valid, seg_mask, K)
    if valid.device.type == "cpu":
        return fused_reduce_multi_ref(progs, inputs_per_leg, valid,
                                      seg_masks, Ks)
    if valid.device.type != "cuda":
        raise ValueError(f"fused_reduce_multi runs on cuda or cpu, not "
                         f"{valid.device}")
    return _launch_multi(progs, inputs_per_leg, valid, seg_masks, Ks)


def fused_reduce_multi_ref(progs, inputs_per_leg, valid, seg_masks,
                           Ks) -> list:
    """The plain version: each leg through fused_reduce_ref."""
    return [fused_reduce_ref(p, i, valid, s, K)
            for p, i, s, K in zip(progs, inputs_per_leg, seg_masks, Ks)]


def compiled_multi(progs, Ks, device):
    """The multi-leg kernel of one batch composition on `device`: its
    generated source (rowgen.multi_kernel_source) compiled by NVRTC and
    loaded by cuda_build.nvrtc_kernel, which caches it by the source's
    hash, as B1's. The source holds no literal, so batches that differ
    only in literals compile nothing. Raises if it does not compile or
    load."""
    from tpu_olap_torch.kernels import cuda_build
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return cuda_build.nvrtc_kernel(
        rowgen.multi_kernel_source(progs, Ks), rowgen.MULTI_KERNEL,
        rowgen.THREADS, rowgen.multi_smem(progs, Ks), index)


def _launch_multi(progs, inputs_per_leg, valid, seg_masks, Ks) -> list:
    global multi_launches
    n = len(progs)
    offsets, words = rowgen.multi_layout(progs)
    if words > rowgen.MAX_MULTI_WORDS:
        raise ValueError(f"{n} legs need {words} parameter words: one "
                         f"multi-leg launch takes at most "
                         f"{rowgen.MAX_MULTI_WORDS}")
    dev = valid.device
    # every leg's outputs are views of one int64 and one int32 buffer;
    # the int64 one ends with the legs' tile counters (zero)
    n_sums = [K * p.n_sum for p, K in zip(progs, Ks)]
    n_mins = [K * (p.n_cols - p.n_sum) for p, K in zip(progs, Ks)]
    sums_all = torch.zeros(sum(n_sums) + n, dtype=torch.int64, device=dev)
    mins_all = torch.full((sum(n_mins),), MAX_VALUE, dtype=torch.int32,
                          device=dev)
    outs, a, b = [], 0, 0
    for p, K, ns, nm in zip(progs, Ks, n_sums, n_mins):
        outs.append((sums_all[a:a + ns].view(K, p.n_sum),
                     mins_all[b:b + nm].view(K, p.n_cols - p.n_sum)))
        a, b = a + ns, b + nm
    if valid.numel() == 0:
        return outs
    kern = compiled_multi(progs, Ks, dev)
    S, R = valid.shape
    tile = rowgen.THREADS * rowgen.ROWS_PER_THREAD
    tiles_per_seg = -(-R // tile)
    n_tiles = S * tiles_per_seg
    # a block may draw every tile of a leg: its 32-bit shared counters
    # must hold all the rows
    if n_tiles * tile >= 1 << 32:
        raise ValueError(f"{valid.numel()} rows: a block could see 2^32 "
                         "rows or more")
    p = rowgen.multi_params(words)()
    w = p.words
    aligned = valid.data_ptr() % 16 == 0
    for o, prog, inputs, seg_mask, (sums, mins) in zip(
            offsets, progs, inputs_per_leg, seg_masks, outs):
        ptrs = [0 if t is None else t.data_ptr() for t in inputs]
        aligned &= all(ptrs[s] % 16 == 0 for s in rowgen.cone_slots(prog))
        f = o + len(prog.slots)
        values = _constants(prog)
        w[o:f + rowgen.LEG_FIXED_WORDS + len(values)] = ptrs + [
            prog.data_on(dev).data_ptr(), seg_mask.data_ptr(),
            sums.data_ptr(), mins.data_ptr()] + [int(v) for v in values]
    p.h.next = sums_all.data_ptr() + 8 * sum(n_sums)
    p.h.valid = valid.data_ptr()
    p.h.seg_rows, p.h.tiles_per_seg, p.h.n_tiles = R, tiles_per_seg, n_tiles
    p.h.vec = int(aligned and R % rowgen.ROWS_PER_THREAD == 0)
    _launch_on(kern, dev, min(kern.max_blocks, n * n_tiles), p)
    multi_launches += 1
    return outs

"""The row mask of a Scan, Select or Search: one generated CUDA kernel.

A scan's device work is its row mask: validity ∧ kept segment ∧ filter
∧ interval (`PhysicalPlan.front_half` of a "mask" plan,
executor.lowering). The JAX package runs that front half as a plain XLA
program (`tpu_olap/executor/lowering.py::_lower_mask`); it reaches no
Pallas kernel. Run as torch ops it is one launch per operator, tens per
query. Here, as for the fused reduce, the front half is traced once per
plan into a row program (kernels.rowprog: no key, no reduce columns),
kernels.rowgen writes its row function out as straight-line CUDA, and
the template `csrc/row_mask_gen.cuh` turns it into one kernel that
writes a byte per row. NVRTC compiles it when the plan is lowered on a
card (kernels.cuda_build: cached on the program, in the process and in
`_build/` by the source's hash); the query's literals are launch
constants, so scans that differ only in literals compile nothing.

What bounds it: bytes — each row's valid byte, the mask cone's streams
for the valid rows of kept segments, and the mask written. The kernel
reads them with 16-byte loads and writes 16 rows per 16-byte store.

`row_mask` is the wrapper: on CUDA tensors it launches the kernel or
raises (a failed compile or launch is never caught); on CPU tensors it
runs `row_mask_ref`, the plain torch version (the program through
`rowprog.evaluate`). `launches` counts launches of the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_olap_torch.kernels import rowgen, rowprog
from tpu_olap_torch.kernels.fused_reduce import _launch_on, env_slots

TEMPLATE = rowgen.CSRC / "row_mask_gen.cuh"
KERNEL = "row_mask_gen"

launches = 0                        # row-mask kernel launches


def program(plan, table) -> rowprog.RowProgram:
    """The mask plan's front half as a row program with no key and no
    reduce columns, traced once (memoized on the plan). Raises
    RowProgramError."""
    prog = getattr(plan, "_mask_program", None)
    if prog is not None:
        return prog
    slots = env_slots(plan, table)
    consts = {k: torch.as_tensor(np.atleast_1d(v))
              for k, v in plan.pool.consts.items()}

    def row_fn(streams):
        env = {"cols": {}, "nulls": {}}
        for (name, kind, _), s in zip(slots, streams):
            if kind != "base":
                env[kind + "s"][name] = s
        return plan.front_half(env, streams[-1], consts), 0, [], []

    prog = plan._mask_program = rowprog.trace(row_fn, slots)
    return prog


def build_kernel(plan, table, device):
    """The mask plan's kernel closure: fn(env, valid, seg_mask, consts)
    -> bool [S, R] row mask over the dispatched segment stack. Raises
    RowProgramError when the front half does not trace. On a CUDA device
    the kernel is compiled here, at lowering, so its compile time falls
    in lower_ms and the first run only."""
    prog = program(plan, table)
    if torch.device(device).type == "cuda":
        compiled(prog, device)

    def fn(env, valid, seg_mask, consts):
        inputs = [None if kind == "base" else env[kind + "s"][name]
                  for name, kind, _ in prog.slots]
        return row_mask(prog, inputs, valid, seg_mask)

    return fn


# ---------------------------------------------------------------------------
# The kernel: wrapper, plain version, launch.


def _check(prog, inputs, valid, seg_mask):
    if valid.dtype != torch.bool or valid.dim() != 2 \
            or not valid.is_contiguous():
        raise ValueError("valid must be a contiguous bool [S, R] tensor")
    if seg_mask.dtype != torch.bool \
            or tuple(seg_mask.shape) != (valid.shape[0],) \
            or seg_mask.device != valid.device:
        raise ValueError("seg_mask must be a bool [S] tensor on valid's "
                         "device")
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
                or t.numel() != n or not t.is_contiguous() \
                or t.device != valid.device:
            got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
                   if isinstance(t, torch.Tensor) else type(t).__name__)
            raise ValueError(f"input {name!r} must be a contiguous {dtype} "
                             f"tensor of {n} rows on {valid.device}; got "
                             f"{got}")


def row_mask(prog, inputs, valid, seg_mask) -> torch.Tensor:
    """The row mask of a program over every row: bool [S, R], True where
    valid ∧ seg_mask ∧ the program's mask.

    prog: a RowProgram; inputs: one tensor per program slot (None for
    the base slot), each holding valid.numel() rows in valid's layout;
    valid: bool [S, R] row validity; seg_mask: bool [S] segments kept.
    CPU tensors run the plain version; CUDA tensors launch the
    generated kernel (compiled on first use if lowering did not)."""
    _check(prog, inputs, valid, seg_mask)
    if valid.device.type == "cpu":
        return row_mask_ref(prog, inputs, valid, seg_mask)
    if valid.device.type != "cuda":
        raise ValueError(f"row_mask runs on cuda or cpu, not {valid.device}")
    return _launch(prog, inputs, valid, seg_mask)


def row_mask_ref(prog, inputs, valid, seg_mask) -> torch.Tensor:
    """The plain torch version of the kernel: the row program through
    rowprog.evaluate, ANDed with the validity and segment masks."""
    base = valid & seg_mask[:, None]
    regs = rowprog.evaluate(prog, inputs, base.numel(), valid.device)
    return base & (regs[prog.mask_reg] != 0).reshape(base.shape)


class MaskParams(ctypes.Structure):
    """The kernel's one argument (`MaskParams` in csrc/row_mask_gen.cuh)."""
    _fields_ = [("slot", ctypes.c_void_p * rowgen.MAX_SLOTS),
                ("valid", ctypes.c_void_p),
                ("seg_mask", ctypes.c_void_p),
                ("data", ctypes.c_void_p),
                ("out", ctypes.c_void_p),
                ("seg_rows", ctypes.c_longlong),
                ("tiles_per_seg", ctypes.c_longlong),
                ("n_tiles", ctypes.c_longlong),
                ("consts", ctypes.c_longlong * rowgen.MAX_CONSTS),
                ("vec", ctypes.c_int)]


def kernel_source(prog: rowprog.RowProgram) -> str:
    """The whole NVRTC source of the program's row-mask kernel. It holds
    none of the query's literals (rowgen.constants)."""
    plan = rowgen.row_source(prog) + "\n".join(
        [f"namespace {rowgen.NAMESPACE} {{", *rowgen.call_source(prog),
         f"}}  // namespace {rowgen.NAMESPACE}"]) + "\n"
    return rowgen.splice(TEMPLATE, plan)


def compiled(prog, device):
    """The program's row-mask kernel on `device`, compiled by NVRTC and
    loaded (kernels.cuda_build), memoized on the program. Raises if it
    does not compile or load."""
    from tpu_olap_torch.kernels import cuda_build
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = ("mask", index)
    kern = prog._device.get(key)
    if kern is None:
        kern = prog._device[key] = cuda_build.nvrtc_kernel(
            kernel_source(prog), KERNEL, rowgen.THREADS, 0, index)
    return kern


def _launch(prog, inputs, valid, seg_mask) -> torch.Tensor:
    global launches
    dev = valid.device
    out = torch.empty(valid.shape, dtype=torch.bool, device=dev)
    if valid.numel() == 0:
        return out
    kern = compiled(prog, dev)
    data = prog.data_on(dev)
    S, R = valid.shape
    tile = rowgen.THREADS * rowgen.ROWS_PER_THREAD
    tiles_per_seg = -(-R // tile)
    n_tiles = S * tiles_per_seg
    p = MaskParams()
    for i, t in enumerate(inputs):
        p.slot[i] = 0 if t is None else t.data_ptr()
    cone = [p.slot[s] for s in rowgen.cone_slots(prog)]
    p.vec = int(R % rowgen.ROWS_PER_THREAD == 0 and all(
        a % 16 == 0 for a in cone + [valid.data_ptr(), out.data_ptr()]))
    p.valid, p.seg_mask = valid.data_ptr(), seg_mask.data_ptr()
    p.data, p.out = data.data_ptr(), out.data_ptr()
    p.seg_rows, p.tiles_per_seg, p.n_tiles = R, tiles_per_seg, n_tiles
    values = prog._device.get("consts")
    if values is None:
        values = prog._device["consts"] = rowgen.constants(prog)
    p.consts[:len(values)] = values
    _launch_on(kern, dev, min(kern.max_blocks, n_tiles), p)
    launches += 1
    return out

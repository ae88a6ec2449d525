"""Row programs (tpu_olap_torch.kernels.rowprog): a traced front half run
by `evaluate` (the fused kernel's plain version) must compute exactly
what the eager torch closures compute, op for op, including int32/int16
wrap-around; what does not fit must raise RowProgramError."""

import numpy as np
import pytest
import torch

from tpu_olap_torch.kernels import rowprog
from tpu_olap_torch.kernels.rowprog import RowProgramError

N = 3000


def _columns(seed):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.integers(-100, 100, N).astype(np.int8)),
        "b": torch.from_numpy(rng.integers(-30000, 30000, N)
                              .astype(np.int16)),
        "c": torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, N)
                              .astype(np.int32)),
        "t": torch.from_numpy(rng.integers(0, 10 ** 12, N)
                              .astype(np.int64)),
        "n": torch.from_numpy(rng.random(N) < 0.3)}


def _tables(seed):
    rng = np.random.default_rng(seed + 100)
    return {"lut": torch.from_numpy(rng.integers(0, 5, 256)
                                    .astype(np.int32)),
            "blut": torch.from_numpy(rng.random(300) < 0.5),
            "bounds": torch.from_numpy(np.sort(rng.integers(0, 10 ** 12,
                                                            20))),
            "in": torch.tensor([1, 5, 7, -3]),
            "one": torch.tensor([86_400_000])}


def _front(e, base, c):
    """Every op family the lowered closures use: boolean algebra,
    comparisons, IN lists, lookup-table gathers, where/clamp, casts,
    searchsorted, floored division and remainder, and int32 / int16
    arithmetic that wraps."""
    a, b, x, t, n = e["a"], e["b"], e["c"], e["t"], e["n"]
    m = base & ((a > 3) | c["blut"][torch.remainder(b.long(), 300)]) & ~n
    m = m & (a[..., None] == c["in"]).any(dim=-1) | (b < 0)
    k1 = torch.where((a >= 1) & (a < 50), a.to(torch.int32), 0)
    k2 = c["lut"][(b.long() + 30000) % 256]
    k3 = (torch.searchsorted(c["bounds"], t.contiguous(), right=True) - 1
          ).clamp(0, 18).to(torch.int32)
    key = (k1 * 5 + k2) * 19 + k3
    sums = [(None, None), (x * 3, None),
            (torch.div(t - 7, c["one"], rounding_mode="floor"), n),
            (None, ~n), (b * b, None), (~x ^ 5, m)]
    mins = [(-(b.to(torch.int32) * b), m),
            (torch.remainder(x, 7) + torch.zeros_like(x), None),
            (torch.minimum(x, b.to(torch.int32)).abs(), None)]
    return m, key, sums, mins


def _trace_and_eval(seed):
    cols, consts = _columns(seed), _tables(seed)
    names = list(cols)
    slots = tuple((k, "col", cols[k].dtype) for k in names) \
        + (("", "base", torch.bool),)

    def row_fn(s):
        return _front(dict(zip(names, s[:-1])), s[-1], consts)

    prog = rowprog.trace(row_fn, slots)
    base = torch.from_numpy(np.random.default_rng(seed).random(N) < 0.9)
    regs = rowprog.evaluate(prog, [cols[k] for k in names] + [None], N,
                            "cpu")
    return prog, regs, base, _front(cols, base, consts)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_program_matches_eager_closures(seed):
    """Equal on every row inside the base mask (the program reads the
    base as 1: the kernel only runs it there)."""
    prog, regs, base, (m, key, sums, mins) = _trace_and_eval(seed)
    assert torch.equal((regs[prog.mask_reg] != 0)[base], m[base])
    assert torch.equal(regs[prog.key_reg][base], key.long()[base])
    for (v, s), vr, sr in zip(sums + mins, prog.val_regs, prog.sel_regs):
        assert (v is None) == (vr < 0) and (s is None) == (sr < 0)
        if v is not None:
            assert torch.equal(regs[vr][base], v.long()[base])
        if s is not None:
            assert torch.equal((regs[sr] != 0)[base], s[base])
    assert prog.n_sum == len(sums)


def test_program_layout():
    """Immediates come first (the kernel loads them once per thread),
    then the mask's cone, which ends at EXITZ; registers are reused
    (fewer registers than values); the cone's loads are listed."""
    prog, _, _, _ = _trace_and_eval(0)
    ops = prog.ins[:, 0]
    pc = prog.exit_pc
    assert ops[pc] == rowprog.EXITZ and (ops == rowprog.EXITZ).sum() == 1
    assert prog.ins[pc, 3] == prog.mask_reg
    assert (ops[:prog.n_pro] == rowprog.IMM).all()
    assert (ops[prog.n_pro:] != rowprog.IMM).all()
    assert prog.n_regs < len(prog.ins) - 1
    assert prog.cone_slots <= prog.loaded_slots
    assert prog.cone_slots == {0, 1, 4}   # a, b and n decide the mask


def _trace_one(fn, dtype=torch.int32):
    slots = (("x", "col", dtype), ("", "base", torch.bool))
    return rowprog.trace(lambda s: (s[1], fn(s[0]), [(None, None)], []),
                         slots)


@pytest.mark.parametrize("case", ["float", "control_flow", "in_place",
                                  "unknown_op", "float_stream"])
def test_untraceable_front_halves_raise(case):
    if case == "float":
        fn = lambda x: (x / 2).to(torch.int32)               # noqa: E731
    elif case == "control_flow":
        def fn(x):
            return x if bool((x > 0).any()) else -x
    elif case == "in_place":
        def fn(x):
            x += 1
            return x
    elif case == "unknown_op":
        fn = lambda x: torch.cumsum(x, 0)                    # noqa: E731
    else:
        fn = lambda x: x.to(torch.int32)                     # noqa: E731
    with pytest.raises(RowProgramError):
        _trace_one(fn, torch.float64 if case == "float_stream"
                   else torch.int32)


def test_division_and_gather_edges():
    """Where torch would raise, the program gives 0 (division or
    remainder by zero; a gather index past its table); negative gather
    indexes wrap once as torch's do."""
    lut = torch.tensor([10, 20, 30])
    x = torch.tensor([-4, -3, -1, 0, 1, 2, 3, 7], dtype=torch.int32)
    zero = torch.zeros_like(x)
    slots = (("x", "col", torch.int32), ("z", "col", torch.int32),
             ("", "base", torch.bool))

    def row_fn(s):
        v, z, base = s
        return (base, torch.zeros_like(v), [
            (torch.div(v, z, rounding_mode="floor"), None),
            (torch.remainder(v, z), None), (lut[v.long()], None),
            (torch.div(v, 2, rounding_mode="floor"), None)], [])

    prog = rowprog.trace(row_fn, slots)
    regs = rowprog.evaluate(prog, [x, zero, None], 8, "cpu")
    d, r, g, h = (regs[v] for v in prog.val_regs)
    assert d.tolist() == [0] * 8 and r.tolist() == [0] * 8
    assert g.tolist() == [0, 10, 30, 10, 20, 30, 0, 0]
    assert h.tolist() == [-2, -2, -1, 0, 0, 1, 1, 3]

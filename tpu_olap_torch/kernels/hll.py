"""HyperLogLog per-group registers on the device.

The counterpart of the JAX package's `kernels/hll.py` (Druid's
HyperLogLogCollector analog): per-group register arrays updated with a
scatter-max, merged with an elementwise max, estimated on the device in
the packed path or on the host. log2m = 11 (2048 registers), Druid's
default; the classic estimate with the linear-counting small-range
correction.

torch has no count-leading-zeros: ρ comes from floor(log2(w)) in
float64, as the JAX package's numpy branch takes it, which is exact for
the w < 2^21 that 32 - log2m bits allow. Only the rows that pass are
scattered: sending every masked-out row to slot 0 serialises the card's
atomics on one address.
"""

from __future__ import annotations

import torch

LOG2M = 11
NUM_REGISTERS = 1 << LOG2M  # 2048
_ALPHA = 0.7213 / (1 + 1.079 / NUM_REGISTERS)


def hll_update(h, valid, key, num_groups):
    """h: [N] int32 hashes; valid: [N] bool; key: [N] group ids.

    Returns [num_groups, NUM_REGISTERS] int32 ρ registers."""
    sel = valid.nonzero().squeeze(1)
    u, key = h[sel].to(torch.int64) & 0xFFFFFFFF, key[sel]
    reg = u & (NUM_REGISTERS - 1)
    w = u >> LOG2M
    fl = torch.floor(torch.log2(w.clamp(min=1).to(torch.float64)))
    rho = torch.where(w != 0, (32 - LOG2M) - fl.to(torch.int64),
                      (32 - LOG2M) + 1).to(torch.int32)
    flat = key.to(torch.int64) * NUM_REGISTERS + reg
    regs = torch.zeros(num_groups * NUM_REGISTERS, dtype=torch.int32,
                       device=h.device)
    regs.scatter_reduce_(0, flat, rho, "amax")
    return regs.reshape(num_groups, NUM_REGISTERS)


def hll_merge(a, b):
    return torch.maximum(a, b)


def hll_estimate(registers, float_dtype=torch.float64):
    """[K, m] integer registers -> [K] estimates. The sum of 2^-ρ is exact in
    float64 for any summation order (every term is a multiple of 2^-22
    and the sum is at most 2^11), so the estimate does not depend on the
    reduction order of the device."""
    regs = registers.to(torch.int64).clamp(0, 64)
    m = NUM_REGISTERS
    # 2^-rho built from its exponent bits: exact, where pow may not be
    inv = ((1023 - regs) << 52).view(torch.float64).sum(dim=-1) \
        .to(float_dtype)
    # a tensor numerator: torch computes `scalar / tensor` as a
    # reciprocal times the scalar, one rounding more than a division
    est = torch.full_like(inv, _ALPHA * m * m) / inv
    zeros = (regs == 0).sum(dim=-1)
    small = est <= 2.5 * m
    ratio = torch.where(zeros > 0, torch.full_like(inv, m)
                        / zeros.clamp(min=1).to(float_dtype),
                        torch.ones_like(est))
    lc = m * torch.log(ratio)
    return torch.where(small & (zeros > 0), lc, est)

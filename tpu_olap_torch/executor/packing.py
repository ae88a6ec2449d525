"""Device-side finalize + compact + pack: ONE host copy per aggregate query.

The counterpart of the JAX package's `executor/packing.py`. A dense
aggregate query finishes on the device and ships back only its answer:

  1. sketches are finalized there (HLL registers and theta tables become
     estimates), so the [K, 2048] / [K, k] state never crosses the link;
  2. the group tables are compacted to the non-empty groups, at most
     `cap` of them, with `torch.nonzero_static`: a fixed-size result,
     so no host sync;
  3. every per-group tensor is viewed as int32 words and concatenated
     into one 1-D buffer: one device-to-host copy.

If more than `cap` groups are non-empty (the count is the buffer's first
word), the runner re-runs with a larger cap or unpacked; the cap bounds
the common case, not the answer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_olap_torch.kernels import hll as hll_mod
from tpu_olap_torch.kernels import theta as theta_mod
from tpu_olap_torch.kernels.groupby import torch_dtype

_WORD = np.dtype(np.int32)  # buffer word: everything is viewed as int32


@dataclass(frozen=True)
class PackLayout:
    """Static buffer layout: [count:int32][idx:int32[cap]] then one
    [cap]-slot slab per field, each viewed as int32 words."""
    cap: int
    total: int
    fields: tuple  # ((name, np.dtype), ...) in buffer order


def make_layout(plan, config, cap: int | None = None) -> PackLayout:
    cap = min(cap if cap is not None else config.result_group_cap,
              plan.total_groups)
    fields = [("_rows", np.dtype(np.int32))]
    for p in plan.agg_plans:
        if p.kind in ("count", "sum"):
            fields.append((p.name, np.dtype(p.acc_dtype)))
        else:  # min | max | hll | theta -> finalized float64
            fields.append((p.name, np.dtype(np.float64)))
    return PackLayout(cap, plan.total_groups, tuple(fields))


def device_finalize(out: dict, agg_plans) -> dict:
    """Partial-aggregate dict -> final per-group values, on the tensors'
    device (results.finalize_aggs' counterpart; the HLL rounding stays on
    the host since it is per spec)."""
    res = {"_rows": out["_rows"].to(torch.int32)}
    for p in agg_plans:
        v = out[p.name]
        if p.kind in ("count", "sum"):
            res[p.name] = v
        elif p.kind in ("min", "max"):
            nn = out[f"_nn_{p.name}"]
            res[p.name] = torch.where(nn > 0, v.to(torch.float64),
                                      float("nan"))
        elif p.kind == "hll":
            res[p.name] = hll_mod.hll_estimate(v)
        elif p.kind == "theta":
            res[p.name] = theta_mod.theta_estimate(v)
        else:
            raise AssertionError(p.kind)
    return res


def build_packer(inner, plan, layout: PackLayout):
    """Wrap a partials kernel so that it returns the one packed int32
    buffer, computed on the kernel's device without a host sync."""
    agg_plans = plan.agg_plans

    def fn(env, valid, seg_mask, consts):
        fin = device_finalize(inner(env, valid, seg_mask, consts), agg_plans)
        present = fin["_rows"] > 0
        count = present.sum(dtype=torch.int32)
        # the first cap present groups, padded with 0: the JAX package's
        # nonzero(size=cap, fill_value=0), without a host sync
        idx = torch.nonzero_static(present, size=layout.cap,
                                   fill_value=0).squeeze(1)
        parts = [count.reshape(1), idx.to(torch.int32)]
        for name, dt in layout.fields:
            parts.append(fin[name][idx].to(torch_dtype(dt))
                         .contiguous().view(torch.int32))
        return torch.cat(parts)

    return fn


def unpack(buf, layout: PackLayout):
    """Packed buffer (host numpy int32[...]) -> (count, idx[n], {name:
    array[n]}) with n = min(count, cap). count > cap means overflow: the
    caller must re-run with a larger cap or unpacked."""
    words = np.asarray(buf)
    count = int(words[0])
    cap = layout.cap
    n = min(count, cap)
    idx = np.asarray(words[1:1 + cap][:n], np.int64)
    pos = 1 + cap
    arrays = {}
    for name, dt in layout.fields:
        w = dt.itemsize // _WORD.itemsize
        slab = words[pos:pos + cap * w]
        pos += cap * w
        arrays[name] = np.ascontiguousarray(slab).view(dt)[:n]
    return count, idx, arrays


def densify(idx, compact: dict, layout: PackLayout, agg_plans) -> dict:
    """Compacted results -> dense [total] arrays (what the host assembly
    consumes). Empty groups: 0 for counts, sums and sketch estimates, NaN
    for min/max (rendered as SQL null)."""
    kinds = {p.name: p.kind for p in agg_plans}
    out = {}
    for name, dt in layout.fields:
        fill = np.nan if kinds.get(name) in ("min", "max") else 0
        a = np.full(layout.total, fill, dt)
        a[idx] = compact[name]
        out[name] = a
    return out

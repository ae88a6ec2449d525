"""Cost-based choice of a mesh aggregate's merge: the DruidQueryCostModel
analog (SURVEY.md §3.2), the counterpart of the JAX package's
`planner/cost.py`, term for term.

The reference chooses, per rewritten query, between one query to the
Druid broker (Druid fans out and merges internally) and a fan-out to the
historicals with Spark merging ("direct historicals"). Over the port's
mesh (executor.sharding) every device runs the plan's kernel over its
own stacks, and the choice is where the D partial tables merge:

- "historicals": each device's unfinalized partial table is copied to
  the host, and the host broker folds the D tables (D copies);
- "broker": the tables are copied device to device onto the mesh's
  first device and folded there, and one table is copied to the host.

The model: scan_us = rows x columns x scan_ns_per_row_col / D;
merge_us = hops x (collective_lat_us + table_bytes x merge_ns_per_byte x
shard_merge_factor) with hops = ceil(log2 D); "broker" wins when
merge_us > gspmd_overhead x (scan_us + collective_lat_us x hops). Both
merges give the same answer — the model only picks the cheaper one, and
`cost_model_enabled=False` pins "historicals".

The four constants resolve: an explicit EngineConfig.cost_* value, else
the entry of cost_calibration.json for the engine's torch device type
("cuda", "cpu"), fitted by chip_smoke.py's phase 16 on the card, else
DATASHEET: first-principles values of an H100 SXM (HBM3 at 3.35 TB/s
for the scan's 4-byte column reads, NVLink 4 at 450 GB/s a direction for
the merge's bytes, 10 us per collective step, overhead 1.0). Every term
is in the explain payload, so a misprediction is visible.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from math import ceil, log2

import numpy as np
import torch

from tpu_olap_torch.kernels.hll import NUM_REGISTERS

DATASHEET = {
    "scan_ns_per_row_col": 4 / 3.35e12 * 1e9,   # a 4-byte read at HBM3
    "merge_ns_per_byte": 1 / 450e9 * 1e9,       # NVLink 4, one direction
    "collective_lat_us": 10.0,
    "gspmd_overhead": 1.0,
}
_calibration_cache: dict | None = None


def _calibration(device_type: str) -> dict:
    """The fitted constants for a torch device type, {} when none."""
    global _calibration_cache
    if _calibration_cache is None:
        path = os.path.join(os.path.dirname(__file__),
                            "cost_calibration.json")
        data = {}
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
        _calibration_cache = data
    return _calibration_cache.get(device_type, {})


def constants(config) -> dict:
    """The four model constants: explicit config pin > fitted
    calibration for the engine's device type > DATASHEET."""
    cal = _calibration(torch.device(config.device).type)
    out = {}
    for name, fb in DATASHEET.items():
        pinned = getattr(config, "cost_" + name, None)
        out[name] = pinned if pinned is not None else cal.get(name, fb)
    return out


@dataclass(frozen=True)
class CostDecision:
    strategy: str            # "historicals" (host broker merge) |
    #                          "broker" (fold on the first device)
    shards: int
    rows_scanned: int
    groups: int
    table_bytes: int         # merged group-table size (all aggregators)
    scan_us: float           # per-device scan estimate
    merge_us: float          # merge estimate
    reason: str

    def to_json(self) -> dict:
        return {
            "strategy": self.strategy, "shards": self.shards,
            "rowsScanned": self.rows_scanned, "groups": self.groups,
            "tableBytes": self.table_bytes,
            "scanUs": round(self.scan_us, 1),
            "mergeUs": round(self.merge_us, 1),
            "reason": self.reason,
        }


def estimate_groups(plan) -> int:
    """Expected non-empty groups: the dense id space capped by the rows
    that can populate it."""
    rows = sum(plan.table.segments[i].meta.n_valid for i in plan.pruned_ids)
    return max(1, min(plan.total_groups, rows))


def table_width_bytes(plan) -> int:
    """Bytes per group across all partial-aggregate state (what the merge
    moves): accumulators, per-plan non-null counts and sketch state."""
    width = 4  # _rows int32
    for p in plan.agg_plans:
        if p.kind == "hll":
            width += 4 * NUM_REGISTERS
        elif p.kind == "theta":
            width += 8 * p.theta_k
        else:
            width += np.dtype(p.acc_dtype).itemsize
            if p.kind in ("sum", "min", "max"):
                width += 4  # _nn_<name>
    return width


def decide(plan, config, shards: int) -> CostDecision:
    """Pick the merge of an aggregate plan on a mesh of `shards`."""
    rows = sum(plan.table.segments[i].meta.n_valid for i in plan.pruned_ids)
    groups = plan.total_groups
    n_cols = max(1, len(plan.columns))
    width = table_width_bytes(plan)
    table_bytes = groups * width
    c = constants(config)

    scan_us = (rows * n_cols * c["scan_ns_per_row_col"] / 1000.0
               / max(1, shards))
    hops = max(1, ceil(log2(max(2, shards))))
    merge_us = hops * (c["collective_lat_us"]
                       + table_bytes * c["merge_ns_per_byte"] / 1000.0
                       * config.shard_merge_factor)

    if shards <= 1:
        return CostDecision("historicals", 1, rows, groups, table_bytes,
                            scan_us, 0.0, "single device")
    if config.force_strategy is not None:
        return CostDecision(config.force_strategy, shards, rows, groups,
                            table_bytes, scan_us, merge_us,
                            "forced by config")
    if not config.cost_model_enabled:
        return CostDecision("historicals", shards, rows, groups,
                            table_bytes, scan_us, merge_us,
                            "cost model disabled")
    # the device fold wins when the host merge dwarfs the scan
    if merge_us > c["gspmd_overhead"] * (scan_us
                                         + c["collective_lat_us"] * hops):
        return CostDecision("broker", shards, rows, groups, table_bytes,
                            scan_us, merge_us,
                            "merge dominates scan; defer to partitioner")
    return CostDecision("historicals", shards, rows, groups, table_bytes,
                        scan_us, merge_us, "explicit partials cheaper")

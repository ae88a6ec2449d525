"""QueryRunner: execute a QuerySpec against a registered table.

The analog of the reference's DruidRDD.compute + broker round-trip
(SURVEY.md §4.2) collapsed into an in-process call: lower -> device
dispatch over the resident column stacks -> ONE device-to-host copy ->
host finalize and assembly.

Three routes on one device, as in the JAX package:
  - packed (every dense aggregate query): the kernel, then finalize,
    compaction to the non-empty groups and packing on the device
    (executor.packing), one buffer back; a result past
    `result_group_cap` groups re-runs unpacked;
  - unpacked: every partial table back in one copy — queries whose theta
    set-op post-aggregations need the raw tables, and packed overflows;
  - sparse (a GroupBy past the dense budgets): the sort-based sparse
    group-by (kernels.sparse_groupby), re-run at the next power of two
    while the groups overflow its cap, up to `sparse_group_budget`.
The caches, the batch coalescer, the stage graph, the mesh and the
scan/search/metadata query types are not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_olap_torch.executor.config import EngineConfig
from tpu_olap_torch.executor.dataset import DeviceDataset
from tpu_olap_torch.executor.lowering import PhysicalPlan, lower
from tpu_olap_torch.executor.packing import (build_packer, densify,
                                             make_layout, unpack)
from tpu_olap_torch.executor.results import (agg_specs_by_name, eval_having,
                                             eval_post_aggs, finalize_aggs,
                                             iso, render_value,
                                             theta_raw_fields)
from tpu_olap_torch.ir.interval import ETERNITY
from tpu_olap_torch.kernels.filtereval import _take
from tpu_olap_torch.kernels.sparse_groupby import SENTINEL
from tpu_olap_torch.ir.query import (GroupByQuerySpec, TimeseriesQuerySpec,
                                     TopNQuerySpec)
from tpu_olap_torch.segments.segment import TIME_COLUMN


@dataclass
class QueryResult:
    query: object
    rows: list                 # flat records (dims/aggs/postaggs [+timestamp])
    druid: list                # Druid-wire-shaped result
    metrics: dict = field(default_factory=dict)

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame(self.rows)


def resolve_device(name: str) -> torch.device:
    """The device the engine runs on; "cuda" without a card raises —
    the engine never carries on on the CPU in its place."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"EngineConfig.device={name!r} but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


class QueryRunner:
    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device)
        self._datasets: dict[str, DeviceDataset] = {}
        self._plan_cache: dict = {}
        # last observed group count per query template and route: sizes
        # the next run's packed / sparse cap
        self._cap_hints: dict = {}
        self.last_metrics: dict = {}

    def execute(self, query, table) -> QueryResult:
        t0 = time.perf_counter()
        if not isinstance(query, (TimeseriesQuerySpec, GroupByQuerySpec,
                                  TopNQuerySpec)):
            raise NotImplementedError(
                f"not yet ported: {query.query_type} queries")
        res = self._run_agg(query, table)
        res.metrics["total_ms"] = (time.perf_counter() - t0) * 1000
        return res

    def clear_cache(self, table_name: str):
        """Drop one table's resident columns and memoized plans."""
        self._datasets.pop(table_name, None)
        for k in [k for k in self._plan_cache if k[0] == table_name]:
            del self._plan_cache[k]

    def device_bytes(self) -> int:
        """Resident device bytes over every table's dataset."""
        return sum(ds.resident_bytes() for ds in self._datasets.values())

    def _dataset(self, table) -> DeviceDataset:
        ds = self._datasets.get(table.name)
        if ds is None or ds.table is not table:
            ds = DeviceDataset(table, self.device)
            self._datasets[table.name] = ds
        return ds

    def _lower_cached(self, query, table) -> PhysicalPlan:
        """Memoized lower(): re-lowering an unchanged query costs
        milliseconds of pure Python per execution. Keyed on the full
        query JSON plus the config; a table identity check invalidates on
        re-registration."""
        import json
        key = (table.name,
               json.dumps(query.to_json(), sort_keys=True, default=str),
               repr(self.config))
        hit = self._plan_cache.get(key)
        if hit is not None and hit[0] is table:
            return hit[1]
        plan = lower(query, table, self.config)
        if len(self._plan_cache) > 512:
            self._plan_cache.pop(next(iter(self._plan_cache)))
        self._plan_cache[key] = (table, plan)
        return plan

    def _device_consts(self, plan: PhysicalPlan) -> dict:
        """The plan's ConstPool on the device, once per plan. Scalars ride
        as 1-element tensors: torch lets a 0-d int64 tensor take the
        dtype of an int8 column it meets (and wrap), where numpy and JAX
        promote to int64; a 1-element tensor promotes like numpy."""
        consts = getattr(plan, "_device_consts", None)
        if consts is None:
            consts = plan._device_consts = {
                k: torch.as_tensor(np.atleast_1d(v)).to(self.device)
                for k, v in plan.pool.consts.items()}
        return consts

    def _prepare(self, plan: PhysicalPlan, metrics: dict):
        """Dataset env + derived streams + validity/segment masks + scan
        metrics."""
        table = plan.table
        ds = self._dataset(table)
        env = ds.env(plan.columns, plan.null_cols)
        consts = self._device_consts(plan)
        for dp in plan.dim_plans:
            if dp.cache_token is not None:
                env["cols"][dp.derived_name] = ds.derived(
                    dp.cache_token,
                    lambda dp=dp: self._build_derived(ds, consts, dp))
        bp = plan.bucket_plan
        if bp is not None and bp.cache_token:
            env["cols"][bp.derived_name] = ds.derived(
                bp.cache_token,
                lambda: bp.build_stream(ds.col(TIME_COLUMN), consts)
                .to(torch.int32))
        for token, src, cname in plan.filter_streams:
            env["cols"]["\0d:" + token] = ds.derived(
                token, lambda src=src, cname=cname:
                    _take(consts[cname], ds.col(src)).to(torch.int32))
        valid = ds.valid()
        kept = plan.pruned_ids if not plan.empty else []
        # once per plan: a host-to-device copy per query would sync
        seg_mask = getattr(plan, "_device_seg_mask", None)
        if seg_mask is None:
            seg_mask = plan._device_seg_mask = ds.segment_mask(kept)
        metrics["segments_total"] = len(table.segments)
        metrics["segments_scanned"] = len(kept)
        metrics["rows_scanned"] = int(sum(
            table.segments[i].meta.n_valid for i in kept))
        return env, valid, seg_mask, consts

    @staticmethod
    def _build_derived(ds, consts, dp) -> torch.Tensor:
        """One precomputed dim id stream [S, R] int32 from its resident
        source column (dictionary codes for remap, __time for
        timeformat)."""
        src = dp.source_col if dp.source_col is not None else TIME_COLUMN
        env = {"cols": {src: ds.col(src)}, "nulls": {}}
        return dp.ids(env, consts).to(torch.int32)

    def _segment_window(self, plan: PhysicalPlan, n_segments: int):
        """(lo, W) covering every pruned segment, or None. Interval and
        bounds pruning is mask-only inside the kernel (pruned segments
        still cost their bytes); with time-partitioned ingest the pruned
        set is contiguous on the segment axis, so the dispatch slices the
        [S, R] working set down to a pow2-quantized window and reads ONLY
        those bytes. Skipped when the window saves <25%."""
        ids = plan.pruned_ids
        if plan.empty or not ids:
            return None
        lo, hi = min(ids), max(ids) + 1
        W = _next_pow2(hi - lo)
        if 4 * W >= 3 * n_segments:
            return None
        return min(lo, n_segments - W), W

    def _dispatch_args(self, plan: PhysicalPlan, metrics: dict):
        """(env, valid, seg_mask, consts) of the plan's kernel, cut to
        the segment window when it saves enough."""
        t0 = time.perf_counter()
        env, valid, seg_mask, consts = self._prepare(plan, metrics)
        metrics["prepare_ms"] = (time.perf_counter() - t0) * 1000
        win = self._segment_window(plan, len(seg_mask))
        if win is not None:
            lo, W = win
            metrics["segments_window"] = W
            sl = slice(lo, lo + W)
            env = {"cols": {c: a[sl] for c, a in env["cols"].items()},
                   "nulls": {c: a[sl] for c, a in env["nulls"].items()}}
            valid, seg_mask = valid[sl], seg_mask[sl]
        return env, valid, seg_mask, consts

    def _run_partials(self, plan: PhysicalPlan, metrics: dict) -> dict:
        """Unpacked route: dispatch the plan's kernel and fetch every
        partial table with one device-to-host copy."""
        args = self._dispatch_args(plan, metrics)
        t0 = time.perf_counter()
        out = _fetch(plan.kernel(*args), metrics)
        metrics["execute_ms"] = (time.perf_counter() - t0) * 1000
        return out

    def _cap_hint(self, plan: PhysicalPlan, route: str, first: int,
                  limit: int) -> tuple:
        """(hint key, first cap): the config's cap on a template's first
        run, then twice the group count last seen (a power of two, at
        least 64), never past `limit`."""
        key = (plan.table.name, route, plan.sizes,
               tuple((p.kind, p.name) for p in plan.agg_plans))
        hint = self._cap_hints.get(key)
        cap = min(limit, first) if hint is None else \
            min(limit, max(64, _next_pow2(2 * hint)))
        return key, cap

    def _run_packed(self, plan: PhysicalPlan, metrics: dict):
        """Packed route: the kernel plus device finalize/compact/pack, one
        buffer back. The cap adapts per template, with a sized retry when
        a run overflows its hint. Returns (idx, compact, layout), or None
        when the groups exceed `result_group_cap` (the caller re-runs
        unpacked)."""
        args = self._dispatch_args(plan, metrics)
        cap_limit = min(self.config.result_group_cap, plan.total_groups)
        key, cap = self._cap_hint(plan, "packed", cap_limit, cap_limit)
        t0 = time.perf_counter()
        while True:
            layout = make_layout(plan, self.config, cap)
            buf = build_packer(plan.kernel, plan, layout)(*args)
            count, idx, compact = unpack(to_host(buf, metrics), layout)
            if count <= layout.cap:
                break
            if count > cap_limit:
                metrics["result_groups"] = count
                return None
            cap = min(cap_limit, _next_pow2(count))
        self._cap_hints[key] = count
        metrics["execute_ms"] = (time.perf_counter() - t0) * 1000
        metrics["result_groups"] = count
        metrics["result_cap"] = layout.cap
        return idx, compact, layout

    def _run_sparse(self, plan: PhysicalPlan, metrics: dict) -> dict:
        """Sparse route: the sort-based group-by with an adaptive compact
        table cap; each attempt is one copy back. Past
        `sparse_group_budget` present groups the query needs the fallback
        interpreter, which is not ported: FallbackNotPorted."""
        args = self._dispatch_args(plan, metrics)
        cap_limit = min(self.config.sparse_group_budget, plan.total_groups)
        key, cap = self._cap_hint(plan, "sparse",
                                  self.config.sparse_group_cap, cap_limit)
        t0 = time.perf_counter()
        reruns = []
        while True:
            out = _fetch(plan.make_sparse_kernel(cap)(*args), metrics)
            count = int(out["_count"])
            if count <= cap:
                break
            if count > cap_limit:
                from tpu_olap_torch.planner.plan import FallbackNotPorted
                raise FallbackNotPorted(
                    f"{count} present groups exceed sparse budget "
                    f"{cap_limit}; not yet ported: fallback interpreter")
            reruns.append(cap)
            cap = min(cap_limit, _next_pow2(count))
        self._cap_hints[key] = count
        metrics["execute_ms"] = (time.perf_counter() - t0) * 1000
        metrics["result_groups"] = count
        metrics["result_cap"] = cap
        metrics["sparse_reruns"] = reruns  # the caps that overflowed
        return out

    def _run_agg(self, query, table) -> QueryResult:
        metrics = self.last_metrics = {"host_copies": 0}
        t0 = time.perf_counter()
        plan = self._lower_cached(query, table)
        metrics["lower_ms"] = (time.perf_counter() - t0) * 1000
        metrics["fused"] = plan.fused_reason is None
        if plan.fused_reason is not None:
            metrics["fused_reason"] = plan.fused_reason
        specs = agg_specs_by_name(query.aggregations)
        # theta set-op post-aggregations read RAW sketch tables on the
        # host; the packed route finalizes sketches on the device
        keep_raw = theta_raw_fields(query.post_aggregations)

        if plan.sparse:
            metrics["route"] = "sparse"
            out = self._run_sparse(plan, metrics)
            t0 = time.perf_counter()
            arrays = finalize_aggs(out, plan.agg_plans, specs, keep_raw)
            eval_post_aggs(arrays, query.post_aggregations)
            names = self._out_names(query)
            pm = out["_keys"] != SENTINEL  # empty slots fill the tail
            present = out["_keys"][pm]
            sub = {n: np.asarray(arrays[n])[pm] for n in names}
            res = self._emit_groupby(query, plan, present, sub)
            res.metrics = metrics
            metrics["assemble_ms"] = (time.perf_counter() - t0) * 1000
            return res

        packed = None if keep_raw else self._run_packed(plan, metrics)
        if packed is not None:
            metrics["route"] = "packed"
            idx, compact, layout = packed
            t0 = time.perf_counter()
            for p in plan.agg_plans:
                if p.kind == "hll" and \
                        getattr(specs.get(p.name), "round", True):
                    compact[p.name] = np.round(compact[p.name])
            arrays = densify(idx, compact, layout, plan.agg_plans)
        else:
            # theta set ops, or a packed overflow past result_group_cap
            metrics["route"] = "unpacked"
            partials = self._run_partials(plan, metrics)
            t0 = time.perf_counter()
            arrays = finalize_aggs(partials, plan.agg_plans, specs,
                                   keep_raw)
        eval_post_aggs(arrays, query.post_aggregations)
        res = self._assemble_agg(query, plan, arrays)
        res.metrics = metrics
        metrics["assemble_ms"] = (time.perf_counter() - t0) * 1000
        return res

    def _assemble_agg(self, query, plan, arrays) -> QueryResult:
        """Final-arrays -> QueryResult by query type."""
        if isinstance(query, TimeseriesQuerySpec):
            return self._assemble_timeseries(query, plan, arrays)
        if isinstance(query, GroupByQuerySpec):
            return self._assemble_groupby(query, plan, arrays)
        return self._assemble_topn(query, plan, arrays)

    def _out_names(self, query):
        names = [a.name for a in query.aggregations]
        names += [p.name for p in query.post_aggregations]
        return names

    def _bucket_emit_ids(self, query, plan):
        """Bucket ids to emit, honoring intervals and descending order."""
        if plan.empty:
            return []
        intervals = query.intervals or (ETERNITY,)
        starts = plan.bucket_plan.starts
        ids = [b for b in range(plan.bucket_plan.n_buckets)
               if any(iv.overlaps(int(starts[b]),
                                  int(starts[b + 1])
                                  if b + 1 < len(starts) else plan.t_max + 1)
                      for iv in intervals)]
        return ids

    def _assemble_timeseries(self, query, plan, arrays) -> QueryResult:
        names = self._out_names(query)
        rows, druid = [], []
        skip_empty = bool(dict(query.context).get(
            "skipEmptyBuckets", self.config.skip_empty_buckets))
        bucket_ids = self._bucket_emit_ids(query, plan)
        if query.descending:
            bucket_ids = bucket_ids[::-1]
        present = arrays["_rows"] > 0
        for b in bucket_ids:
            if skip_empty and not present[b]:
                continue
            vals = {n: render_value(arrays[n][b]) for n in names}
            ts = iso(plan.bucket_plan.starts[b])
            rows.append({"timestamp": ts, **vals})
            druid.append({"timestamp": ts, "result": vals})
        return QueryResult(query, rows, druid)

    def _decode_groups(self, plan, idx: np.ndarray):
        """Present flat group ids -> (bucket ids, {dim name -> values})."""
        sizes = plan.sizes
        rem = idx
        radix_vals = []
        for s in sizes[::-1]:
            radix_vals.append(rem % s)
            rem = rem // s
        radix_vals = radix_vals[::-1]  # bucket first, then dims in order
        buckets = radix_vals[0]
        dim_vals = {}
        for dp, ids in zip(plan.dim_plans, radix_vals[1:]):
            dim_vals[dp.name] = dp.labels[ids]
        return buckets, dim_vals

    def _assemble_groupby(self, query, plan, arrays) -> QueryResult:
        names = self._out_names(query)
        present = np.nonzero(arrays["_rows"] > 0)[0]
        sub = {n: np.asarray(arrays[n])[present] for n in names}
        return self._emit_groupby(query, plan, present, sub)

    def _emit_groupby(self, query, plan, present, sub) -> QueryResult:
        """present: flat group ids (any int width); sub: compact per-group
        final values."""
        names = self._out_names(query)
        buckets, dim_vals = self._decode_groups(plan, present)

        if query.having is not None:
            hmask = eval_having(query.having, sub, dim_vals)
            present = present[hmask]
            buckets = buckets[hmask]
            dim_vals = {k: v[hmask] for k, v in dim_vals.items()}
            sub = {k: v[hmask] for k, v in sub.items()}

        order = np.arange(len(present))
        ls = query.limit_spec
        if ls is not None and ls.columns:
            keys = []
            for c in ls.columns[::-1]:
                if c.dimension == "timestamp":
                    k = np.asarray(buckets, np.float64)
                elif c.dimension in dim_vals:
                    v = dim_vals[c.dimension]
                    k = np.asarray([("" if x is None else str(x)) for x in v])
                    if c.dimension_order == "numeric":
                        k = np.asarray([float(x) if x else -np.inf for x in k])
                else:
                    k = np.asarray(sub[c.dimension], np.float64)
                if c.direction == "descending":
                    k = _invert_sort_key(k)
                keys.append(k)
            order = np.lexsort(keys)
        if ls is not None:
            lo = ls.offset
            hi = None if ls.limit is None else lo + ls.limit
            order = order[lo:hi]

        rows, druid = [], []
        starts = plan.bucket_plan.starts
        for i in order:
            ts = iso(starts[buckets[i]])
            ev = {dp.name: render_value(dim_vals[dp.name][i])
                  for dp in plan.dim_plans}
            ev.update({n: render_value(sub[n][i]) for n in names})
            rows.append({"timestamp": ts, **ev})
            druid.append({"version": "v1", "timestamp": ts, "event": ev})
        return QueryResult(query, rows, druid)

    def _assemble_topn(self, query, plan, arrays) -> QueryResult:
        names = self._out_names(query)
        n_b = plan.sizes[0]
        d_size = plan.sizes[1]
        metric = np.asarray(arrays[query.metric], np.float64) \
            .reshape(n_b, d_size)
        present = (arrays["_rows"] > 0).reshape(n_b, d_size)
        dp = plan.dim_plans[0]
        rows, druid = [], []
        for b in self._bucket_emit_ids(query, plan):
            m = np.where(present[b],
                         -metric[b] if query.inverted else metric[b],
                         -np.inf)
            order = np.argsort(-m, kind="stable")
            order = order[m[order] > -np.inf][:query.threshold]
            ts = iso(plan.bucket_plan.starts[b])
            result = []
            for g in order:
                flat = b * d_size + g
                ev = {dp.name: render_value(dp.labels[g])}
                ev.update({n: render_value(np.asarray(arrays[n])[flat])
                           for n in names})
                result.append(ev)
                rows.append({"timestamp": ts, **ev})
            druid.append({"timestamp": ts, "result": result})
        return QueryResult(query, rows, druid)


def to_host(buf: torch.Tensor, metrics: dict) -> np.ndarray:
    """The one device-to-host copy of a query route: a 1-D tensor to a
    numpy array (counted in metrics["host_copies"])."""
    metrics["host_copies"] = metrics.get("host_copies", 0) + 1
    return buf.cpu().numpy()


def _fetch(out: dict, metrics: dict) -> dict:
    """{name: device tensor} -> {name: numpy array} in ONE device-to-host
    copy: every tensor's bytes concatenate into one uint8 buffer."""
    names = list(out)
    # fresh dense copies: a column view such as sums[:, 0] keeps its
    # stride even where torch calls it contiguous (size-1 dims), and
    # viewing bytes needs stride 1
    ts = [out[n].new_empty(out[n].shape).copy_(out[n]) for n in names]
    if not ts:
        return {}
    host = to_host(torch.cat([t.reshape(-1).view(torch.uint8) for t in ts]),
                   metrics)
    res, off = {}, 0
    for n, t in zip(names, ts):
        nb = t.numel() * t.element_size()
        res[n] = host[off:off + nb].view(_np_dtype(t.dtype)).reshape(t.shape)
        off += nb
    return res


def _np_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


def _invert_sort_key(k: np.ndarray):
    if k.dtype.kind in "fiu":
        return -k.astype(np.float64)
    # lexicographic descending for strings: invert via codes trick
    uniq, inv = np.unique(k, return_inverse=True)
    return -inv

"""Shared-scan batch executor: N compatible queries in ONE pass.

A dashboard sends many aggregate queries against one table at once. Run
one by one, each costs its own lowering, its own launch and its own
device-to-host copy, and re-reads the columns the others read. This
module runs them together, as the JAX package's `executor/batch.py`
does (the reference's broker answering many rewritten queries from one
shared column store, SURVEY.md §3.1):

- identical queries are deduplicated: one pass serves every copy (the
  dashboard storm, eight users on one panel);
- dense aggregate legs whose pruned segment windows overlap form a fused
  group that reads the union window once: the legs the fused reduce
  takes (`plan.fused_reason is None`) run as ONE launch of the
  multi-leg kernel (kernels.fused_reduce.fused_reduce_multi), the rest
  (sketch aggregations; every leg under use_fused_reduce="never")
  through kernels.groupby.group_reduce_batch over the same resident
  streams; every leg's partials come back in ONE device-to-host copy;
- everything else runs through the single-query path.
Every leg's answer equals the same statement run alone: a leg reads the
union window, and its own segment mask adds exact zeros for the rest.
Legs share the full-result cache (executor.resultcache, tier 2) with the
single-query path: a cached leg is served and fanned out to its
duplicates without lowering or a scan, and a fused leg fills the cache.

Entry points: run_batch(runner, queries, table) (boxed: per-leg
failures come back as exceptions in the leg's place), the Coalescer
(the micro-batching window behind EngineConfig.batch_window_ms), and
fusable(plan, mesh), the compatibility rule.

Metrics on every leg of a fused group: `batch_id` (count the shared
pass once per id), `batch_size` (logical queries served), `batch_legs`,
`scan_ms_shared` (wall of the shared pass, launch to fetched),
`agg_ms` (the leg's share of it, attributed by scanned-work weight: one
launch cannot be timed per leg), `fused_batch` (legs in the multi-leg
kernel), `host_copies` (the group's one copy, shared like
scan_ms_shared) and route "batch".

Resilience, as in the JAX package: a batch submission holds ONE
admission slot (`QueryRunner._execute_batch_boxed`; a shed raises
QueryShed out of `sql_batch`), the shared pass runs through
`QueryRunner._guarded_dispatch` (the breaker check, the per-query
deadline with its wedge reprobe, then the retry layer), single legs run
through `QueryRunner._execute_guarded` (the single-query path's own
deadline), and the "batch-leg" fault site fires in each leg's finalize:
a leg that fails there is served alone by the single-query path while
the other legs keep their shared answers. The shared pass is two-staged
like a single statement: stage 1 (the legs' stacks, the launch and the
queued copy) under the enqueue lock, stage 2 (the copy's wait, every
leg's finalize and assembly) without it.

Observability, as in the JAX package: the fused pass is one
`shared-scan` span with a `leg` span per statement, single legs run
under their statement's query id (`use_query_id`), and every leg and
every deduplicated copy leaves its own history record.

Under a mesh (executor.sharding) a fused group runs on every device over
that device's stacks and the per-device union window
(sharding.local_window): the multi-leg kernel once per device, the other
legs' generic reduce per device, one copy per device, and the host
broker merges each leg's D partial tables (sharding.broker_merge).
"""

from __future__ import annotations

import json
import threading
import time

from tpu_olap_torch.executor import sharding as sh
from tpu_olap_torch.executor.runner import QueryResult, _next_pow2
from tpu_olap_torch.ir.query import (GroupByQuerySpec, TimeseriesQuerySpec,
                                     TopNQuerySpec)
from tpu_olap_torch.kernels import fused_reduce, rowgen
from tpu_olap_torch.kernels.groupby import group_reduce_batch
from tpu_olap_torch.obs.trace import span as _span, use_query_id
from tpu_olap_torch.resilience.errors import InternalError
from tpu_olap_torch.resilience.faults import maybe_inject

AGG_QUERY_TYPES = (TimeseriesQuerySpec, GroupByQuerySpec, TopNQuerySpec)


def fusable(plan, mesh=None) -> str | None:
    """None when the plan can ride a fused shared-scan group, else why
    it runs alone (through the single-query path). Mesh legs fuse too:
    every device runs the group over its own stacks and the broker
    merges each leg; as in the JAX package, whose mesh legs extend their
    key by the chip, a leg whose D x K reaches 2^31 runs alone. Across
    processes every leg runs alone, as in the JAX package."""
    if plan.kind != "agg":
        return "only aggregation plans fuse"
    if plan.sparse:
        return "sparse group-by legs run alone"
    if plan.front_half is None:
        return "plan has no front half"
    if mesh is not None:
        if mesh.size * plan.total_groups >= (1 << 31):
            return "chip-extended group key overflows int32"
        if sh.is_multihost(mesh):
            return "multi-host mesh legs run alone"
    return None


def run_batch(runner, queries, table, query_ids=None) -> list:
    """Execute N queries against one table, sharing scans where
    possible. Returns a boxed list in input order: a QueryResult per
    success, the exception per failed leg (the caller re-raises or
    serves the statement another way, per query). `query_ids`, parallel
    to `queries`, names each statement's records."""
    queries = list(queries)
    boxed: list = [None] * len(queries)
    query_ids = list(query_ids) if query_ids is not None \
        else [None] * len(queries)

    # identical queries first: one pass serves every copy
    uniq: dict[str, list[int]] = {}
    for i, q in enumerate(queries):
        key = json.dumps(q.to_json(), sort_keys=True, default=str)
        uniq.setdefault(key, []).append(i)

    singles, fused = [], []   # [(query, duplicate indexes, plan)]
    for idxs in uniq.values():
        q = queries[idxs[0]]
        with use_query_id(query_ids[idxs[0]]):
            cached = runner._serve_full_cache(q, table)
        if cached is not None:
            _fan_out(runner, boxed, cached, idxs, queries, query_ids)
            continue
        try:
            plan = runner._lower_cached(q, table)
            reason = fusable(plan, runner.mesh) \
                if isinstance(q, AGG_QUERY_TYPES) \
                else "non-agg query type"
        except Exception as e:  # noqa: BLE001 — boxed per leg
            for i in idxs:
                boxed[i] = e
            continue
        (fused if reason is None else singles).append((q, idxs, plan))

    # legs with disjoint windows would multiply each other's work: fuse
    # only overlap clusters; a lone leg gains nothing from fusing
    clusters, alone = _window_clusters(fused)
    singles.extend(alone)
    fused_groups = []
    for cl in clusters:
        if len(cl) == 1:
            singles.append(cl[0])
        else:
            fused_groups.append(cl)

    for q, idxs, plan in singles:
        try:
            # the single-query path's deadline and wedge reprobe, under
            # the statement's own id (its record and `query` event agree)
            with use_query_id(query_ids[idxs[0]]):
                res = runner._execute_guarded(q, table)
        except Exception as e:  # noqa: BLE001 — boxed per leg
            for i in idxs:
                boxed[i] = e
            continue
        if len(idxs) > 1:
            m = res.metrics
            m["batch_id"] = runner._next_batch_id()
            m["batch_size"] = len(idxs)
            m["batch_legs"] = 1
            m["scan_ms_shared"] = m.get("execute_ms", 0.0)
            m["agg_ms"] = m.get("execute_ms", 0.0)
            runner._m_batch.observe(len(idxs))
        _fan_out(runner, boxed, res, idxs, queries, query_ids)

    maxq = max(2, min(int(runner.config.batch_max_queries),
                      rowgen.MAX_LEGS))
    for cl in fused_groups:
        # canonical leg order: a repeated composition meets the same
        # multi-leg kernel
        cl.sort(key=lambda t: repr(t[2].fingerprint()))
        try:
            groups = _split(cl, maxq, table)
        except Exception as e:  # noqa: BLE001 — boxed per leg
            for _, idxs, _ in cl:
                for i in idxs:
                    boxed[i] = e
            continue
        for group in groups:
            try:
                if len(group) == 1:  # a max-size split remainder
                    with use_query_id(query_ids[group[0][1][0]]):
                        results = [runner._execute_guarded(group[0][0],
                                                           table)]
                else:
                    results = _run_fused(runner, table, group, query_ids)
            except Exception as e:  # noqa: BLE001 — boxed per leg
                for _, idxs, _ in group:
                    for i in idxs:
                        boxed[i] = e
                continue
            for (q, idxs, _), res in zip(group, results):
                _fan_out(runner, boxed, res, idxs, queries, query_ids)
    return boxed


def _split(cl, maxq, table) -> list:
    """A cluster's legs, in order, as groups of at most `maxq` legs whose
    multi-leg kernel legs' arguments fit one launch's parameter block."""
    groups, cur, words = [], [], 0
    for item in cl:
        plan = item[2]
        w = rowgen.multi_layout([fused_reduce.program(plan, table)])[1] \
            if plan.fused_reason is None else 0
        if cur and (len(cur) == maxq or words + w > rowgen.MAX_MULTI_WORDS):
            groups.append(cur)
            cur, words = [], 0
        cur.append(item)
        words += w
    return groups + [cur]


def _window_clusters(fused):
    """Partition fusable legs into overlap clusters: a leg joins a
    cluster only while one union-window pass costs no more than ~1.3x
    the legs' own windowed passes. Legs with no pruned segments come
    back in the second list (the single-query path). Greedy over
    span-sorted legs, so a repeated workload meets the same
    compositions."""
    spans, alone = [], []
    for item in fused:
        plan = item[2]
        ids = plan.pruned_ids if not plan.empty else []
        if not ids:
            alone.append(item)
            continue
        spans.append((min(ids), max(ids) + 1, item))
    spans.sort(key=lambda s: (s[0], s[1]))
    clusters = []
    cur, cur_lo, cur_hi, cur_sum = [], 0, 0, 0
    for lo, hi, item in spans:
        if cur:
            u_lo, u_hi = min(cur_lo, lo), max(cur_hi, hi)
            if (len(cur) + 1) * (u_hi - u_lo) \
                    <= 1.3 * (cur_sum + hi - lo):
                cur.append(item)
                cur_lo, cur_hi = u_lo, u_hi
                cur_sum += hi - lo
                continue
            clusters.append(cur)
        cur, cur_lo, cur_hi, cur_sum = [item], lo, hi, hi - lo
    if cur:
        clusters.append(cur)
    return clusters, alone


def _fan_out(runner, boxed, res, idxs, queries, query_ids):
    """The first duplicate gets the computed result; the rest share its
    rows (the pass ran once) under their own QueryResult and their own
    history record, with their own query id."""
    boxed[idxs[0]] = res
    for i in idxs[1:]:
        m = {**res.metrics, "batch_dedup": True}
        m["query_id"] = query_ids[i] or runner.tracer.new_query_id()
        runner.record(m)
        boxed[i] = QueryResult(queries[i], res.rows, res.druid, m)


# ------------------------------------------------------------- fused pass


def _run_fused(runner, table, group, query_ids):
    """group: >= 2 unique dense aggregate legs against one table. One
    pass over the union window, one copy back, then finalize and
    assemble per leg, under one `shared-scan` span with a `leg` span
    per statement."""
    from tpu_olap_torch.executor.results import (agg_specs_by_name,
                                                 eval_post_aggs,
                                                 finalize_aggs,
                                                 theta_raw_fields)
    t_start = time.perf_counter()
    plans = [p for _, _, p in group]
    n_logical = sum(len(idxs) for _, idxs, _ in group)
    batch_id = runner._next_batch_id()
    runner._m_batch.observe(n_logical)
    # per-leg workload fingerprints: fused legs attribute to their own
    # templates (record() consumes `_wl`, the cache store reuses them)
    leg_fps = [runner.fingerprint(q, table.name) for q, _, _ in group]
    metrics_list = [{"query_type": q.query_type, "datasource": table.name,
                     "route": "batch", "batch_id": batch_id,
                     "batch_size": n_logical, "batch_legs": len(group),
                     "_wl": fp}
                    for (q, _, _), fp in zip(group, leg_fps)]
    for (_, idxs, _), m in zip(group, metrics_list):
        if query_ids[idxs[0]]:
            m["query_id"] = query_ids[idxs[0]]

    def dispatch():
        with runner._pipeline_slot():
            return _shared_pass(runner, table, plans, metrics_list)

    # retry-based recovery as on the single-query path (leg 0's metrics
    # carry any retry_errors), under the same deadline and wedge guard
    with _span("shared-scan", batch_id=batch_id, batch_legs=len(group),
               batch_size=n_logical) as ssp:
        partials_list, shared, shared_ms, n_kernel = \
            runner._guarded_dispatch(dispatch, metrics_list[0], table.name)
        ssp.set(scan_ms_shared=round(shared_ms, 3), fused_batch=n_kernel)
        # per-leg attribution by scanned-work weight (columns read x
        # segments kept x aggregations): an estimate, one launch cannot be
        # timed per leg
        w = [max(1, (len(p.columns) + 1) * max(1, len(p.pruned_ids))
                 * (len(p.agg_plans) + 1)) for p in plans]
        agg_ms = [shared_ms * wi / sum(w) for wi in w]

        results = []
        for leg_i, ((q, idxs, plan), m, partials, leg_ms) in enumerate(
                zip(group, metrics_list, partials_list, agg_ms)):
            t0 = time.perf_counter()
            try:
                with ssp.span("leg") as lsp:
                    # per-leg fault site: a leg that fails here is served
                    # alone by the single-query path, the others keep their
                    # answers
                    maybe_inject(runner.config, "batch-leg", leg_i)
                    specs = agg_specs_by_name(q.aggregations)
                    arrays = finalize_aggs(
                        partials, plan.agg_plans, specs,
                        theta_raw_fields(q.post_aggregations))
                    eval_post_aggs(arrays, q.post_aggregations)
                    res = runner._assemble_agg(q, plan, arrays)
                    lsp.set(query_type=q.query_type, agg_ms=round(leg_ms, 3),
                            duplicates=len(idxs))
            except Exception as e:  # noqa: BLE001 — the leg re-runs alone
                with use_query_id(m.get("query_id")):
                    res = runner._execute_guarded(q, table)
                res.metrics["batch_leg_error"] = f"{type(e).__name__}: {e}"
                results.append(res)
                continue
            m.update(scan_ms_shared=shared_ms, agg_ms=leg_ms,
                     execute_ms=shared_ms, fused_batch=n_kernel,
                     host_copies=shared["host_copies"],
                     host_bytes=shared["host_bytes"])
            for k in ("pipelined", "lock_wait_ms", "transfer_ms"):
                if k in shared:
                    m[k] = shared[k]
            m["assemble_ms"] = (time.perf_counter() - t0) * 1000
            m["total_ms"] = (time.perf_counter() - t_start) * 1000
            res.metrics = m
            runner.record(m)
            runner._store_full_cache(q, table, res, leg_fps[leg_i])
            results.append(res)
        return results


def _shared_pass(runner, table, plans, metrics_list):
    """The device half of a fused group, in two stages: stage 1 (under
    the enqueue lock) prepares every leg over the union window, launches
    and queues the one copy of every leg's partials (under a mesh: one
    per device); stage 2 waits for it (them). Returns (per-leg partials,
    the copy's metrics, its wall in ms, the legs in the multi-leg
    kernel); under a mesh each leg's partials are the broker's merge of
    its D tables."""
    shared = {"host_copies": 0}
    fired = {}

    def launch():
        per_device = _launch_legs(runner, table, plans, metrics_list, fired)
        return [{f"{i}\0{n}": t for i, out in enumerate(outs)
                 for n, t in out.items()} for outs in per_device]
    flats = runner._staged_fetch_all(launch, shared)
    per_device = []
    for flat in flats:
        partials_list = [{} for _ in plans]
        for name, a in flat.items():
            i, n = name.split("\0", 1)
            partials_list[int(i)][n] = a
        per_device.append(partials_list)
    if len(per_device) == 1:
        partials_list = per_device[0]
    else:
        with _span("broker-merge", num_shards=len(per_device)):
            partials_list = [
                sh.broker_merge([dev[i] for dev in per_device],
                                plan.agg_plans)
                for i, plan in enumerate(plans)]
    shared_ms = (time.perf_counter() - fired["t"]) * 1000
    return partials_list, shared, shared_ms, fired["kernel_legs"]


def _launch_legs(runner, table, plans, metrics_list, fired) -> list:
    """Stage 1 of the shared pass: every leg's env, then the legs over
    the union window on the device, or on every mesh device over its own
    shards (`_legs_on_device`). Returns, per device, each leg's partials
    as device tensors; `fired` gets the launch time and the kernel
    legs."""
    envs, seg_masks, consts = [], [], []
    valid = None
    # the union of the legs' working sets stays pinned in the ledger
    # until the launch: one leg's env build must not evict another's
    pinned = runner.pins(plans)
    for plan, m in zip(plans, metrics_list):
        t0 = time.perf_counter()
        env, valid, seg_mask, c = runner._prepare(plan, m, pinned)
        m["prepare_ms"] = (time.perf_counter() - t0) * 1000
        m["fused"] = plan.fused_reason is None
        if plan.fused_reason is not None:
            m["fused_reason"] = plan.fused_reason
        envs.append(env)
        seg_masks.append(seg_mask)
        consts.append(c)
    mesh = runner.mesh
    D = mesh.size if mesh is not None else 1
    win = _union_window(plans, len(seg_masks[0][0]) if mesh is not None
                        else len(seg_masks[0]), mesh)
    if win is not None:
        for m in metrics_list:
            m["segments_window"] = win[1] * D
            if mesh is not None:
                m["segments_window_per_chip"] = win[1]
    fired["t"] = time.perf_counter()
    fired["kernel_legs"] = sum(p.fused_reason is None for p in plans)
    if mesh is None:
        return [_legs_on_device(table, plans, envs, valid, seg_masks,
                                consts, win)]
    outs = []
    for c, dev in enumerate(mesh.devices):
        with sh.on_device(dev):
            outs.append(_legs_on_device(
                table, plans,
                [{kind: {n: a[c] for n, a in env[kind].items()}
                  for kind in ("cols", "nulls")} for env in envs],
                valid[c], [s[c] for s in seg_masks],
                [cs[c] for cs in consts], win))
    runner._note_chip_dispatch(mesh.local_ids)
    return outs


def _legs_on_device(table, plans, envs, valid, seg_masks, consts, win):
    """Every leg on one device over the window `win` of its stacks: the
    multi-leg kernel for the legs the fused reduce takes and
    group_reduce_batch for the rest. Returns each leg's partials."""
    if win is not None:
        lo, W = win
        sl = slice(lo, lo + W)
        buffers, layouts = _buffer_layout(envs)
        # one slice per resident stream: legs that read a column share
        # the same tensor
        buffers = [b[sl] for b in buffers]
        envs = [{kind: {n: buffers[j] for n, j in spec[kind].items()}
                 for kind in ("cols", "nulls")} for spec in layouts]
        valid = valid[sl]
        seg_masks = [s[sl] for s in seg_masks]
    kernel_legs = [i for i, p in enumerate(plans) if p.fused_reason is None]
    other_legs = [i for i, p in enumerate(plans) if p.fused_reason is not None]
    outs: list = [None] * len(plans)
    if kernel_legs:
        progs = [fused_reduce.program(plans[i], table) for i in kernel_legs]
        got = fused_reduce.fused_reduce_multi(
            progs, [fused_reduce.program_inputs(p, envs[i])
                    for p, i in zip(progs, kernel_legs)],
            valid, [seg_masks[i] for i in kernel_legs],
            [plans[i].total_groups for i in kernel_legs])
        for i, (sums, mins) in zip(kernel_legs, got):
            outs[i] = fused_reduce.partials(plans[i], sums, mins)
    if other_legs:
        legs = []
        for i in other_legs:
            plan = plans[i]
            flat = {kind: {n: a.reshape(-1) for n, a in envs[i][kind].items()}
                    for kind in ("cols", "nulls")}
            base = (valid & seg_masks[i][:, None]).reshape(-1)
            key, mask, fenv = plan.front_half(flat, base, consts[i])
            legs.append((key, mask, fenv, plan.agg_plans, plan.total_groups))
        for i, out in zip(other_legs, group_reduce_batch(
                legs, [consts[i] for i in other_legs])):
            outs[i] = out
    return outs


def _union_window(plans, n_segments, mesh=None):
    """(lo, W) covering every leg's pruned segments, or None: the batch
    counterpart of QueryRunner._segment_window. A leg whose own pruned
    set is smaller still reads only the union window; its segment mask
    zeroes the rest. Under a mesh, `n_segments` is each device's count
    and the window is the per-device local one (logical [lo, hi) is
    local [lo // D, ceil(hi / D)) on every device)."""
    ids = sorted({i for p in plans if not p.empty for i in p.pruned_ids})
    if not ids:
        return None
    if mesh is not None:
        return sh.local_window(ids, mesh.size, n_segments)
    lo, hi = ids[0], ids[-1] + 1
    W = _next_pow2(hi - lo)
    if 4 * W >= 3 * n_segments:
        return None
    return min(lo, n_segments - W), W


def _buffer_layout(envs):
    """Unique env tensors -> one buffer list + per-leg {name: index}
    specs. A tensor several legs read (the same resident column or
    derived stream) appears ONCE."""
    buffers, index, layouts = [], {}, []
    for env in envs:
        spec = {"cols": {}, "nulls": {}}
        for kind in ("cols", "nulls"):
            for name, arr in env[kind].items():
                j = index.get(id(arr))
                if j is None:
                    j = index[id(arr)] = len(buffers)
                    buffers.append(arr)
                spec[kind][name] = j
        layouts.append(spec)
    return buffers, layouts


# -------------------------------------------------------------- coalescer


class _Pending:
    __slots__ = ("query", "table", "event", "result", "error")

    def __init__(self, query, table):
        self.query = query
        self.table = table
        self.event = threading.Event()
        self.result = None
        self.error = None


class Coalescer:
    """Micro-batching window: the first concurrent caller leads, waits
    batch_window_ms for companions, and dispatches everyone who arrived
    as ONE run_batch call under the runner's dispatch lock. Followers
    block on an event; per-query failures propagate to their own caller
    only. A caller arriving after a leader has cut its batch becomes the
    next leader, so windows pipeline under sustained load."""

    def __init__(self, runner, window_s: float):
        self.runner = runner
        self.window_s = window_s
        self._mu = threading.Lock()
        self._queue: list = []
        self._collecting = False

    def submit(self, query, table):
        me = _Pending(query, table)
        with self._mu:
            self._queue.append(me)
            lead = not self._collecting
            if lead:
                self._collecting = True
        if not lead:
            me.event.wait()
            if me.error is not None:
                raise me.error
            return me.result
        # an async exception in the leader (KeyboardInterrupt mid-window)
        # must still reset _collecting, drain the queue and wake every
        # follower, or the coalescer wedges for the life of the process
        batch: list = []
        try:
            try:
                if self.window_s > 0:
                    time.sleep(self.window_s)
            finally:
                with self._mu:
                    batch, self._queue = self._queue, []
                    self._collecting = False
            by_table: dict = {}
            for it in batch:
                by_table.setdefault(id(it.table), []).append(it)
            for items in by_table.values():
                try:
                    boxed = self.runner._execute_batch_boxed(
                        [it.query for it in items], items[0].table)
                except Exception as e:  # noqa: BLE001 — fanned out
                    boxed = [e] * len(items)
                for it, b in zip(items, boxed):
                    if isinstance(b, BaseException):
                        it.error = b
                    else:
                        it.result = b
        finally:
            for it in batch:
                if it.result is None and it.error is None:
                    it.error = InternalError(
                        "batch leader exited without a result")
                it.event.set()
        if me.error is not None:
            raise me.error
        return me.result

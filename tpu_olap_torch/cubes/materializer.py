"""Cube materializer + registry — Druid ingest-time rollup, generalized.

`CubeRegistry.create` materializes a `CubeSpec` by running its rollup
GroupBy over the base table ON THE DEVICE (`QueryRunner.compute_partials`
rides the ordinary lowering and dispatch: on the card, one launch of the
fused reduce or of the generic reduce for sketch plans, and one copy)
and keeping the result as *unfinalized partials*:

* scalar state (row counts, sums, min/max folds, per-aggregate non-null
  counts) lands in an ordinary time-partitioned segment table registered
  in the catalog as `__cube_<name>` — queryable with plain SQL, visible
  in sys.tables/sys.segments, sized by the normal bytes accounting;
* sketch state (HLL register files, theta hash tables) is kept as
  row-aligned sidecar arrays on the cube entry (`__cube_row` in the
  table is the correlation key), exactly the register/hash layout
  `kernels.groupby.group_reduce` emits — so rewrite-time merges use the
  same algebra the per-segment cache already trusts (sums add, min/max
  fold, HLL max-merges, theta re-merges losslessly).

Every build stamps the base table's ingest generation. A cube whose
base generation moved is STALE: the rewrite pass refuses it at
generation-check time (the result cache's contract: a stale entry is
unservable before any purge runs) and the background maintainer, a
periodic graph of the runner's stage scheduler, rebuilds it through
`compute_partials` (an admission slot, the breaker check,
dispatch_lock and the retry layer). A build that fails is
recorded on the entry (status "error") and is never retried at the same
generation; nothing builds it on the host instead. `register_table` /
`drop_table` cascade through `on_table_registered` / `on_table_dropped`.

Observability, as in the JAX package: `cube_rewrite_total{result}`,
`cube_builds_total{result}` and the `cubes_registered` gauge in the
engine's metrics registry, the `cube_build`, `cube_error` and
`cube_drop` events, and `snapshot()` behind sys.cubes and GET
/debug/cubes. The registry also keeps its rewrite outcomes and builds
in the dicts `rewrites` and `builds`.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np

from tpu_olap_torch.cubes.spec import (CUBE_TIME_COL, CubeSpec, CubeSpecError,
                                 agg_signature)
from tpu_olap_torch.resilience.errors import UserError

__all__ = ["CubeData", "CubeEntry", "CubeRegistry", "CubeBuildError"]


class CubeBuildError(RuntimeError):
    """The rollup could not be materialized (shape over budget, base
    table gone mid-build, device refusal). Recorded on the entry."""


class StoredAgg:
    """One materialized aggregation's serve-time identity: signature,
    merge kind, theta width. (The partial VALUES ride next to it in
    CubeData.aggs; the storage table's m<i>/__nn_m<i> columns are the
    durable/queryable copy of the same arrays, not a serve input.)"""

    __slots__ = ("sig", "kind", "theta_k")

    def __init__(self, sig, kind, theta_k=0):
        self.sig = sig
        self.kind = kind          # count | sum | min | max | hll | theta
        self.theta_k = theta_k


class CubeData:
    """Immutable serve-time view of one build: cube rows as flat arrays
    in `__cube_row` order. Swapped atomically on refresh, so a serve
    that grabbed a reference keeps a consistent snapshot."""

    __slots__ = ("times", "ends", "rows", "dims", "aggs", "base_tmax",
                 "n_rows", "sketch_bytes")

    def __init__(self, times, ends, rows, dims, aggs, base_tmax):
        self.times = times          # [N] int64 bucket starts (ms)
        self.ends = ends            # [N] int64 bucket ends (exclusive)
        self.rows = rows            # [N] int64 base rows rolled up
        # {col: ("codes", int32 base-dict codes) |
        #       ("values", ndarray, null mask | None)}
        self.dims = dims
        self.aggs = aggs            # {sig: (StoredAgg, values, nn, sketch)}
        self.base_tmax = base_tmax  # base table max __time at build
        self.n_rows = len(times)
        self.sketch_bytes = sum(
            int(sk.nbytes) for _, _, _, sk in aggs.values()
            if sk is not None)


class CubeEntry:
    """Registry entry: spec + mutable build state."""

    def __init__(self, spec: CubeSpec):
        self.spec = spec
        self.status = "building"    # building | ready | error
        # serializes (re)builds of THIS cube: create(), refresh_now(),
        # and the maintainer tick must never run two device rollups of
        # one cube concurrently (interleaved register_table calls could
        # pair one build's storage table with the other's serve arrays)
        self.build_lock = threading.Lock()
        # generation of the base table the LAST build attempt (success
        # or failure) saw: a deterministically-failing spec is retried
        # only when the base data actually changes, not every tick
        self.attempted_generation: int | None = None
        self.error: str | None = None
        self.base_generation: int | None = None
        self.config_sig: tuple | None = None
        self.data: CubeData | None = None
        self.build_ms = 0.0
        self.build_rows_scanned = 0
        self.last_refresh_ms = 0    # wall-clock ms of last (re)build
        self.refreshes = 0
        self.serves = 0
        self.storage_bytes = 0      # registered segment table bytes
        self.build_metrics: dict = {}  # the last build's runner metrics

    @property
    def ready(self) -> bool:
        return self.status == "ready" and self.data is not None

    def snapshot_row(self, engine) -> dict:
        base = engine.catalog.maybe(self.spec.datasource)
        # SEALED-scope generation (docs/INGEST.md): delta-only appends
        # do not stale a cube — serves fold the delta remainder through
        # the base path (planner.cuberewrite)
        base_gen = base.segments.sealed_generation \
            if base is not None and base.is_accelerated else None
        data = self.data  # one read: a concurrent failed replace nulls it
        return {
            "name": self.spec.name,
            "base_table": self.spec.datasource,
            "table": self.spec.table_name,
            "dims": ",".join(self.spec.dimensions),
            "granularity": self.spec.granularity,
            "status": self.status,
            "rows": data.n_rows if data is not None else None,
            "base_generation": base_gen,
            "cube_generation": self.base_generation,
            "stale": (base_gen is not None
                      and base_gen != self.base_generation),
            "last_refresh_ms": self.last_refresh_ms,
            "build_ms": round(self.build_ms, 3),
            "refreshes": self.refreshes,
            "serve_count": self.serves,
            "storage_bytes": self.storage_bytes,
            "sketch_bytes": (data.sketch_bytes
                             if data is not None else 0),
            "error": self.error,
        }


class CubeRegistry:
    """All cubes of one engine + the background refresh maintainer."""

    def __init__(self, engine):
        self.engine = engine
        self._cubes: dict[str, CubeEntry] = {}
        self._lock = threading.RLock()
        # the refresh maintainer: a background graph of the stage
        # scheduler (executor.stages.register_periodic) that runs every
        # cube_refresh_interval_s, or on an ingest of a cube's base —
        # this is its PeriodicHandle
        self._handle = None
        self._stopped = False
        # rewrite attempts by outcome (served / refused / stale /
        # no_cube / error) and builds by outcome (ok / refresh / error)
        self.rewrites: dict[str, int] = {}
        self.builds: dict[str, int] = {}
        m = engine.metrics
        self._m_req = m.counter(
            "cube_rewrite_total",
            "Aggregate-rewrite attempts against materialized cubes by "
            "outcome (served / refused / stale / no_cube / error).",
            ("result",))
        self._m_builds = m.counter(
            "cube_builds_total",
            "Cube materializations by outcome.", ("result",))
        self._m_cubes = m.gauge(
            "cubes_registered", "Materialized rollup cubes registered.")

    def _bump(self, counts: dict, result: str):
        with self._lock:
            counts[result] = counts.get(result, 0) + 1

    # ------------------------------------------------------------- admin

    @property
    def active(self) -> bool:
        """Cheap pre-check on the per-query hot path: is there anything
        the rewrite pass could possibly serve from?"""
        return bool(self._cubes) \
            and bool(self.engine.config.cube_rewrite_enabled)

    def names(self):
        with self._lock:
            return sorted(self._cubes)

    def get(self, name: str) -> CubeEntry | None:
        with self._lock:
            return self._cubes.get(name)

    def count_request(self, result: str):
        self._bump(self.rewrites, result)
        self._m_req.inc(result=result)

    def note_serve(self, entry: CubeEntry):
        with self._lock:
            entry.serves += 1

    def serveable(self, datasource: str, generation: int) -> list:
        """(entry, CubeData, config_sig) triples for ready, generation-
        current cubes over `datasource`, smallest first — the rewrite
        pass probes them in order and takes the first cover (fewest
        cube rows scanned). The data reference is SNAPSHOT under the
        lock together with the generation check: a concurrent refresh
        swapping `entry.data` mid-serve cannot hand the fold a mix of
        two builds."""
        with self._lock:
            out = [(e, e.data, e.config_sig)
                   for e in self._cubes.values()
                   if e.spec.datasource == datasource and e.ready
                   and e.base_generation == generation]
        out.sort(key=lambda t: (t[1].n_rows, t[0].spec.name))
        return out

    def snapshot(self) -> list[dict]:
        with self._lock:
            entries = list(self._cubes.values())
        return [e.snapshot_row(self.engine)
                for e in sorted(entries, key=lambda e: e.spec.name)]

    # ------------------------------------------------------ create / drop

    def create(self, spec, replace: bool = True) -> CubeEntry:
        """Validate + materialize a cube synchronously. `spec` is a
        CubeSpec or its JSON dict. Build failures mark the entry and
        re-raise so DDL/API callers see the reason; the entry stays
        registered (the maintainer retries it when the base generation
        moves)."""
        if not isinstance(spec, CubeSpec):
            spec = CubeSpec.from_json(spec)
        with self._lock:
            if spec.name in self._cubes and not replace:
                raise UserError(f"cube {spec.name!r} already exists")
            entry = CubeEntry(spec)
            self._cubes[spec.name] = entry
            self._m_cubes.set(len(self._cubes))
        try:
            self._build(entry)
        except Exception:
            with self._lock:
                # a replace that failed must not keep serving the OLD
                # spec's data under the new spec's name
                entry.data = None
            raise
        self._ensure_maintainer()
        return entry

    def drop(self, name: str) -> bool:
        with self._lock:
            entry = self._cubes.pop(name, None)
            self._m_cubes.set(len(self._cubes))
        if entry is None:
            return False
        self._drop_storage(entry.spec.table_name)
        self.engine.runner.events.emit("cube_drop", cube=name)
        return True

    def _drop_storage(self, table_name: str):
        eng = self.engine
        if eng.catalog.maybe(table_name) is not None:
            with eng.device_lock:
                eng.runner.clear_cache(table_name)
            eng.catalog.drop(table_name)

    # ------------------------------------------------- catalog cascades

    def on_table_dropped(self, name: str):
        """DROP cascades: a cube over a dropped base is dropped too."""
        with self._lock:
            victims = [n for n, e in self._cubes.items()
                       if e.spec.datasource == name]
        for n in victims:
            self.drop(n)

    def on_table_registered(self, name: str):
        """Re-ingest cascade: cubes over `name` are now stale (their
        recorded generation no longer matches — the rewrite pass stops
        serving them instantly); wake the maintainer to rebuild.
        _ensure_maintainer honors a cube_auto_refresh flag flipped ON
        after the cubes were created (the thread starts lazily)."""
        with self._lock:
            stale = any(e.spec.datasource == name
                        for e in self._cubes.values())
        if stale:
            self._ensure_maintainer()
            h = self._handle
            if h is not None:
                h.wake()

    # -------------------------------------------------------- maintenance

    def stale_cubes(self) -> list[CubeEntry]:
        eng = self.engine
        out = []
        with self._lock:
            entries = list(self._cubes.values())
        for e in entries:
            if e.status == "building":
                # an in-progress create() is not stale — a maintainer
                # tick racing it would launch a SECOND device rollup of
                # the same cube (the per-entry build_lock still guards
                # the narrower refresh_now-vs-maintainer overlap)
                continue
            base = eng.catalog.maybe(e.spec.datasource)
            if base is None or not base.is_accelerated:
                continue  # base gone: on_table_dropped handles real drops
            # sealed scope: a delta-only append must NOT queue a cube
            # rebuild — only registration/compaction moves this
            gen = base.segments.sealed_generation
            if e.status == "error" and e.attempted_generation == gen:
                # the last attempt at THIS generation already failed;
                # retrying every tick would re-run a device pass to the
                # same refusal forever — wait for the data to change
                continue
            if gen != e.base_generation:
                out.append(e)
        return out

    def refresh_now(self) -> dict:
        """Synchronously rebuild every stale cube. Returns
        {cube: "ok" | error string} — the `REFRESH DRUID CUBES` verb's
        payload and the deterministic hook tests drive instead of
        waiting on the maintainer thread."""
        results: dict = {}
        for e in self.stale_cubes():
            try:
                self._build(e, refresh=True)
                results[e.spec.name] = "ok"
            except Exception as ex:  # noqa: BLE001 — per-cube isolation
                results[e.spec.name] = f"{type(ex).__name__}: {ex}"
        return results

    def _ensure_maintainer(self):
        """Register the `cube-maintain` background graph on the stage
        scheduler (lazily — honors a cube_auto_refresh flag flipped on
        at runtime; re-registers after Engine.close cancelled it)."""
        if not self.engine.config.cube_auto_refresh or self._stopped:
            return
        with self._lock:
            h = self._handle
            if h is not None and not h.cancelled:
                return
            self._handle = self.engine.runner.stages.register_periodic(
                "cube-maintain",
                lambda: self.engine.config.cube_refresh_interval_s,
                self._maintain_pass)

    def stop(self, join: bool = False):
        """Cancel the maintainer graph; `join=True` (Engine.close)
        blocks until an in-progress pass exits, so that shutdown leaves
        no work behind."""
        self._stopped = True
        h = self._handle
        if h is not None:
            h.cancel(join_timeout=10.0 if join else None)

    def _maintain_pass(self):
        """One background-graph tick: rebuild stale cubes one at a time,
        on the scheduler's background pool every cube_refresh_interval_s
        (or on an ingest wake). Builds go through compute_partials, i.e.
        the same admission slot and breaker check as foreground queries:
        an open breaker or a shed means 'retry next tick', never a dead
        graph."""
        for e in self.stale_cubes():
            if self._stopped:
                return
            try:
                self._build(e, refresh=True)
            except Exception:  # noqa: BLE001 — retried next tick
                pass

    # --------------------------------------------------------------- build

    def _build(self, entry: CubeEntry, refresh: bool = False):
        with entry.build_lock:
            if refresh:
                # the racer we queued behind may already have rebuilt
                # to the current generation — re-check under the lock
                base = self.engine.catalog.maybe(entry.spec.datasource)
                if base is not None and base.is_accelerated \
                        and entry.status == "ready" \
                        and entry.base_generation \
                        == base.segments.sealed_generation:
                    return
            self._build_locked(entry, refresh)

    def _is_current(self, entry: CubeEntry) -> bool:
        """True while `entry` still owns its name in the registry — a
        DROP or a replacing CREATE displaces it, and a displaced
        entry's in-flight build must not (re)register the storage
        table the displacer just dropped or now owns."""
        with self._lock:
            return self._cubes.get(entry.spec.name) is entry

    def _build_locked(self, entry: CubeEntry, refresh: bool):
        eng = self.engine
        spec = entry.spec
        t0 = time.perf_counter()
        try:
            if not self._is_current(entry):
                return
            base = eng.catalog.maybe(spec.datasource)
            if base is None or not base.is_accelerated:
                raise CubeSpecError(
                    f"cube base table {spec.datasource!r} is not a "
                    "registered accelerated datasource")
            # build over the SEALED scope only (docs/INGEST.md): the
            # cube's partials must never swallow delta rows the
            # compactor will later fold into a new sealed set — serves
            # cover the delta remainder through the base path instead.
            # With no delta this IS the live snapshot (zero cost).
            table = base.segments.sealed_view()  # generation-consistent
            entry.attempted_generation = table.generation
            query = spec.build_query(eng)
            plan, present, compact, metrics = \
                eng.runner.compute_partials(query, table)
            data, frame = _decode_build(plan, query, present,
                                        compact, table)
            if not self._is_current(entry):
                return  # dropped/replaced while the rollup computed
            # the scalar half becomes an ordinary time-partitioned
            # segment table in the catalog (queryable, sys.* visible)
            eng.register_table(spec.table_name, frame,
                               time_column=CUBE_TIME_COL,
                               time_partition="auto")
            cube_tbl = eng.catalog.get(spec.table_name)
            storage = sum(
                int(a.nbytes)
                for s in cube_tbl.segments.segments
                for a in s.columns.values()) + sum(
                int(a.nbytes)
                for s in cube_tbl.segments.segments
                for a in s.null_masks.values())
            from tpu_olap_torch.executor.resultcache import _config_sig
            with self._lock:
                entry.data = data
                entry.base_generation = table.generation
                entry.config_sig = _config_sig(eng.config)
                entry.status = "ready"
                entry.error = None
                entry.build_ms = (time.perf_counter() - t0) * 1000
                entry.build_rows_scanned = int(
                    metrics.get("rows_scanned") or table.num_rows)
                entry.last_refresh_ms = int(time.time() * 1000)
                entry.refreshes += 1 if refresh else 0
                entry.storage_bytes = storage
            if not self._is_current(entry):
                # displaced between register_table and the swap: the
                # storage table we just recreated is orphaned — clean
                # it up (idempotent vs the displacer's own drop)
                self._drop_storage(spec.table_name)
                return
            self._bump(self.builds, "refresh" if refresh else "ok")
            self._m_builds.inc(result="refresh" if refresh else "ok")
            entry.build_metrics = metrics
            eng.runner.events.emit(
                "cube_build", cube=spec.name, base=spec.datasource,
                refresh=refresh, rows=data.n_rows,
                base_generation=table.generation,
                rows_scanned=entry.build_rows_scanned,
                build_ms=round(entry.build_ms, 3),
                storage_bytes=storage,
                sketch_bytes=data.sketch_bytes)
        except Exception as e:
            with self._lock:
                entry.status = "error"
                entry.error = f"{type(e).__name__}: {e}"
                entry.build_ms = (time.perf_counter() - t0) * 1000
                entry.last_refresh_ms = int(time.time() * 1000)
            self._bump(self.builds, "error")
            self._m_builds.inc(result="error")
            eng.runner.events.emit(
                "cube_error", cube=spec.name, base=spec.datasource,
                refresh=refresh, error=str(e)[:300])
            raise


# ----------------------------------------------------------- build decode

def _bucket_ends(plan, bucket_ids: np.ndarray, table) -> np.ndarray:
    """Exclusive end timestamp of each present bucket, from the build
    plan's bucket layout (the serve-time interval-containment bound)."""
    bp = plan.bucket_plan
    starts = np.asarray(bp.starts, np.int64)
    if bp.kind == "all":
        return np.full(len(bucket_ids), table.time_boundary[1] + 1,
                       np.int64)
    if bp.kind == "uniform":
        step = int(plan.pool.consts[bp.step_name])
        return starts[bucket_ids] + step
    bs = np.asarray(plan.pool.consts[bp.boundaries_name], np.int64)
    return bs[bucket_ids + 1]


def _decode_build(plan, query, present, compact, table):
    """(plan, present flat ids, compact partials) -> (CubeData, pandas
    frame for the segment table). Present ids decode via the plan's
    mixed-radix layout (bucket first, dims in order) — the same
    arithmetic as QueryRunner._decode_groups."""
    import pandas as pd

    from tpu_olap_torch.executor.dimplan import DimPlan  # noqa: F401 (doc)

    order = np.argsort(present, kind="stable")
    present = np.asarray(present, np.int64)[order]
    compact = {k: np.asarray(v)[order] for k, v in compact.items()}

    sizes = plan.sizes
    rem = present
    radix_vals = []
    for s in sizes[::-1]:
        radix_vals.append(rem % s)
        rem = rem // s
    radix_vals = radix_vals[::-1]
    bucket_ids = radix_vals[0].astype(np.int64)
    starts = np.asarray(plan.bucket_plan.starts, np.int64)
    times = starts[bucket_ids]
    ends = _bucket_ends(plan, bucket_ids, table)

    n = len(present)
    frame_cols: dict = {CUBE_TIME_COL: pd.to_datetime(times, unit="ms")}
    dims: dict = {}
    for dp, ids in zip(plan.dim_plans, radix_vals[1:]):
        ids = ids.astype(np.int64)
        if dp.kind == "codes":
            # plan ids for a string Default dim ARE the base dictionary
            # codes — keep them for exact serve-time remapping
            dims[dp.source_col] = ("codes", ids.astype(np.int32))
            frame_cols[dp.source_col] = dp.labels[ids]
        elif dp.kind == "numeric":
            vals = np.zeros(n, np.int64)
            nz = ids > 0
            if nz.any():
                vals[nz] = np.asarray(
                    [int(v) for v in dp.labels[ids[nz]]], np.int64)
            nulls = ~nz if (~nz).any() else None
            dims[dp.source_col] = ("values", vals, nulls)
            col = dp.labels[ids]  # object: None for the null slot
            frame_cols[dp.source_col] = col
        else:  # pragma: no cover — build dims are Default specs only
            raise CubeBuildError(
                f"cannot materialize dimension plan kind {dp.kind!r}")

    frame_cols["__rows"] = compact["_rows"].astype(np.int64)
    vexprs = {v.name: v.expression for v in query.virtual_columns}
    aggs: dict = {}
    for i, (spec, p) in enumerate(zip(query.aggregations,
                                      plan.agg_plans)):
        sig = agg_signature(spec, vexprs)
        if sig in aggs:
            continue
        col = f"m{i}"
        nn_key = f"_nn_{p.name}"
        nn = compact[nn_key].astype(np.int64) \
            if nn_key in compact else None
        if p.kind in ("count", "sum", "min", "max"):
            vals = compact[p.name]
            frame_cols[col] = vals
            if nn is not None:
                frame_cols[f"__nn_{col}"] = nn
            aggs[sig] = (StoredAgg(sig, p.kind), vals, nn, None)
        elif p.kind == "hll":
            # register files as a row-aligned sidecar (int8: rho <= 32)
            sk = np.ascontiguousarray(compact[p.name]).astype(np.int8)
            aggs[sig] = (StoredAgg(sig, "hll"), None, None, sk)
        elif p.kind == "theta":
            sk = np.ascontiguousarray(compact[p.name], np.float64)
            aggs[sig] = (StoredAgg(sig, "theta", theta_k=p.theta_k),
                         None, None, sk)
        else:  # pragma: no cover
            raise CubeBuildError(f"unmergeable agg kind {p.kind!r}")

    frame_cols["__cend"] = ends
    frame_cols["__cube_row"] = np.arange(n, dtype=np.int64)
    frame = pd.DataFrame(frame_cols)
    data = CubeData(times, ends, compact["_rows"].astype(np.int64),
                    dims, aggs, table.time_boundary[1])
    return data, frame

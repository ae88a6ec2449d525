"""Advisor -> materializer bridge: workload profile to cube specs.

`recommend_rollups` (obs.workload) ranks (datasource, dim-set,
finest-grain) groups by wall spent — the DEMAND signal. This module
turns each ranked group into a `CubeSpec` the materializer accepts
verbatim, by mining the group's member templates (the profiler keeps
the literal-masked query-IR template) for everything a covering cube
needs that the demand key alone doesn't say:

* **filter dimensions** — a cube can only serve filters over its own
  dims, so the dims of a spec are the union of the group's GROUPING
  dims and every column its templates FILTER on (the masked literals
  don't matter: the dim column must be present whatever the literal);
* **aggregations + virtual columns** — kept verbatim from the template
  IR (only WHERE/HAVING literals are masked there), renamed per
  template so same-named virtual columns with different expressions
  never collide; deduped by `agg_signature`;
* **grain** — the group's finest requested grain; groups at grain
  'all' floor to 'year' so calendar-interval dashboards (year(t)=Y
  windows over an all-grain template) stay servable.

Specs whose dense group-space estimate exceeds the engine budgets split
into per-template specs; anything still over budget is skipped with a
recorded reason (the emit never silently drops demand).
"""

from __future__ import annotations

import hashlib
import json
import re

from tpu_olap_torch.cubes.spec import CubeSpec, CubeSpecError, spec_period
from tpu_olap_torch.obs.workload import recommend_rollups
from tpu_olap_torch.segments.segment import ColumnType, TIME_COLUMN
from tpu_olap_torch.utils import timeutil

__all__ = ["cube_specs_from_workload"]

_IDENT_RE = re.compile(r"[A-Za-z_]\w*")

# coarse per-bucket millis for group-count estimation (calendar periods
# estimated, not exact — this sizes a budget check, not a result)
_PERIOD_EST_MS = {"P1M": 2_629_800_000, "P3M": 7_889_400_000,
                  "P1Y": 31_557_600_000}


def _grain_label(g: str) -> str:
    """Group grain -> spec granularity; 'all' floors to 'year' (an
    all-grain cube can only serve whole-table intervals; a year-grain
    one also serves the year(t)=Y dashboard windows)."""
    g = (g or "all").lower()
    return "year" if g == "all" else g


def _filter_columns(node, schema) -> set:
    """Dimension columns a (masked) filter JSON tree touches. Expression
    filters carry a masked rendered string — identifiers intersected
    with the schema are the best-effort column set."""
    cols: set = set()
    if isinstance(node, dict):
        d = node.get("dimension")
        if isinstance(d, str):
            cols.add(d)
        ds = node.get("dimensions")
        if isinstance(ds, (list, tuple)):
            cols.update(x for x in ds if isinstance(x, str))
        ex = node.get("expression")
        if isinstance(ex, str):
            cols.update(t for t in _IDENT_RE.findall(ex) if t in schema)
        for v in node.values():
            cols |= _filter_columns(v, schema)
    elif isinstance(node, (list, tuple)):
        for v in node:
            cols |= _filter_columns(v, schema)
    return cols


def _rename_template_refs(aggs, vcols, tag):
    """Per-template rename of virtual columns (+ references from aggs
    and filtered-agg filters) so unioned templates can't alias each
    other's v0/v1 names."""
    names = {v.get("name") for v in vcols}

    def fix_filter(node):
        if isinstance(node, dict):
            d = node.get("dimension")
            if isinstance(d, str) and d in names:
                node["dimension"] = f"{tag}_{d}"
            for v in node.values():
                fix_filter(v)
        elif isinstance(node, list):
            for v in node:
                fix_filter(v)

    def fix_agg(a):
        f = a.get("fieldName")
        if f in names:
            a["fieldName"] = f"{tag}_{f}"
        fs = a.get("fieldNames")
        if fs:
            a["fieldNames"] = [f"{tag}_{x}" if x in names else x
                               for x in fs]
        if a.get("type") == "filtered":
            fix_filter(a.get("filter"))
            fix_agg(a["aggregator"])

    out_v = []
    for v in vcols:
        v = json.loads(json.dumps(v))
        v["name"] = f"{tag}_{v['name']}"
        out_v.append(v)
    out_a = []
    for a in aggs:
        a = json.loads(json.dumps(a))
        fix_agg(a)
        out_a.append(a)
    return out_a, out_v


def _template_parts(template: str, table):
    """One template -> (dims, filter dims, agg JSON, vcol JSON) or
    (None, reason) when its queries cannot be cube-served anyway."""
    if not template or not template.startswith("ir:"):
        return None, "fallback-path template (no query IR)"
    q = json.loads(template[3:])
    schema = table.schema
    dims: list = []
    specs = list(q.get("dimensions") or ())
    if q.get("dimension") is not None:
        specs.append(q["dimension"])
    for d in specs:
        if not isinstance(d, dict):
            d = {"dimension": str(d)}
        col = d.get("dimension")
        fn = d.get("extractionFn")
        if col == TIME_COLUMN and isinstance(fn, dict):
            continue  # time-derived dim: the grain covers it
        if col not in schema:
            return None, f"dimension {col!r} is not a base column"
        if schema[col] is ColumnType.DOUBLE:
            return None, f"dimension {col!r} is DOUBLE (not rollable)"
        dims.append(col)
    fcols = _filter_columns(q.get("filter"), schema)
    fcols.discard(TIME_COLUMN)
    for c in fcols:
        if c not in schema or schema[c] is ColumnType.DOUBLE:
            return None, f"filter column {c!r} is not a rollable dim"
    aggs = list(q.get("aggregations") or ())
    if not aggs:
        return None, "no aggregations"
    vcols = list(q.get("virtualColumns") or ())
    return (dims, sorted(fcols), aggs, vcols), None


def _dim_cardinality(table, col) -> int | None:
    typ = table.schema.get(col)
    if typ is ColumnType.STRING:
        d = table.dictionaries.get(col)
        return (d.size + 1) if d is not None else None
    if typ is ColumnType.LONG:
        md = table.column_metadata([col]).get(col, {})
        lo, hi = md.get("min"), md.get("max")
        if lo is None:
            return 1
        return int(hi) - int(lo) + 2
    return None


def _estimate_groups(table, dims, granularity) -> int:
    """FD-aware group-space estimate: a dim functionally determined by
    the OTHER dims (declared star FDs — c_city -> c_nation, p_brand1 ->
    p_category, ...) contributes no combinatorial factor, so a cube
    that carries both the filter column and its determinant isn't
    over-counted into a budget refusal."""
    star = getattr(table, "star", None)
    free = list(dims)
    if star is not None and len(dims) > 1:
        # greedy: keep a dim only when the dims kept so far don't
        # already determine it (cycle-safe — the first member of a
        # mutual pair is always kept)
        free = []
        for c in dims:
            if c not in star.fd_closure(set(free)):
                free.append(c)
    total = 1
    for c in free:
        card = _dim_cardinality(table, c)
        if card is None:
            return 1 << 62
        total *= max(1, card)
        if total > (1 << 62):
            return 1 << 62
    period = spec_period(granularity)
    if period is not None:
        t0, t1 = table.time_boundary
        try:
            ms = timeutil.period_millis(period)
        except ValueError:
            ms = _PERIOD_EST_MS.get(period, _PERIOD_EST_MS["P1M"])
        total *= max(1, int((t1 - t0) // ms) + 1)
    return total


# sparse builds discover the TRUE present-group count at runtime and
# refuse legibly past sparse_group_budget; the advisor's estimate only
# bounds what is worth ATTEMPTING. Estimates up to this factor past the
# budget still try (FD-correlated dim sets routinely present far fewer
# groups than any product bound), at the cost of one refused device
# pass when the estimate was right after all.
_SPARSE_TRY_FACTOR = 4


def _spec_fits(table, dims, granularity, config) -> str | None:
    """None when the rollup's group space is worth materializing under
    the engine's build budgets (dense, or sparse within the attempt
    band), else why."""
    est = _estimate_groups(table, dims, granularity)
    if est <= config.dense_group_budget:
        return None
    present = min(est, table.num_rows)
    if present <= config.sparse_group_budget * _SPARSE_TRY_FACTOR:
        return None
    return (f"~{est} dense groups (~{present} present) exceed the "
            f"dense/sparse build budgets")


def cube_specs_from_workload(rows, engine, top: int = 8):
    """Workload-profile rows (WorkloadProfiler.snapshot) -> ranked cube
    specs + per-group notes. Returns (specs: [CubeSpec], notes: [str]).
    The specs are exactly what `Engine.create_cube` /
    `CREATE DRUID CUBES FROM '<file>'` accept."""
    by_tid = {r["template_id"]: r for r in rows}
    specs: list[CubeSpec] = []
    notes: list[str] = []
    seen_names: set = set()
    for rec in recommend_rollups(rows, top=top):
        ds = rec["datasource"]
        entry = engine.catalog.maybe(ds)
        if entry is None or not entry.is_accelerated:
            notes.append(f"{ds}: not an accelerated datasource")
            continue
        table = entry.segments
        grain = _grain_label(rec.get("granularity"))
        try:
            spec_period(grain)
        except CubeSpecError:
            notes.append(f"{ds}@{rec.get('granularity')}: "
                         "unsupported grain")
            continue
        parts, t_notes = [], []
        for tid in rec.get("templates") or ():
            row = by_tid.get(tid)
            got, why = _template_parts(
                (row or {}).get("template"), table)
            if got is None:
                t_notes.append(f"{tid}: {why}")
                continue
            parts.append((tid, got))
        notes.extend(f"{ds}: skipped template {n}" for n in t_notes)
        if not parts:
            continue

        def build(name_seed, members):
            dims: list = []
            aggs: list = []
            vcols: list = []
            tids: list = []
            for ti, (tid, (tdims, tfcols, taggs, tvcols)) \
                    in enumerate(members):
                for c in list(tdims) + list(tfcols):
                    if c not in dims:
                        dims.append(c)
                ra, rv = _rename_template_refs(taggs, tvcols, f"t{ti}")
                aggs.extend(ra)
                vcols.extend(rv)
                tids.append(tid)
            name = "cube_" + re.sub(r"\W+", "_", ds) + "_" + \
                hashlib.sha1(name_seed.encode()).hexdigest()[:8]
            return CubeSpec(
                name=name, datasource=ds, dimensions=tuple(dims),
                granularity=grain, aggregations=tuple(aggs),
                virtual_columns=tuple(vcols), source="advisor",
                templates=tuple(tids))

        union = build("|".join(t for t, _ in parts), parts)
        fit = _spec_fits(table, union.dimensions, grain, engine.config)
        candidates = [union] if fit is None else []
        if fit is not None:
            notes.append(f"{union.name}: split per-template ({fit})")
            for tid, got in parts:
                one = build(tid, [(tid, got)])
                f1 = _spec_fits(table, one.dimensions, grain,
                                engine.config)
                if f1 is None:
                    candidates.append(one)
                else:
                    notes.append(f"{ds}/{tid}: skipped ({f1})")
        for c in candidates:
            if c.name not in seen_names:
                seen_names.add(c.name)
                specs.append(c)
    return specs, notes

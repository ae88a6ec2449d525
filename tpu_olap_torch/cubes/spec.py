"""Cube specs — the rollup contract between advisor, DDL, and builder.

A `CubeSpec` names a (datasource, dimension subset, time granularity,
aggregation set) rollup — exactly the cuboid coordinates of the data-cube
materialization literature (PAPERS.md 1709.10072: each cuboid is a
group-by over a dimension subset) restricted to the single cuboid the
workload actually demands (obs.workload.recommend_rollups ranks them).
Specs arrive from three places and normalize identically:

* `CREATE DRUID CUBE` DDL (api.engine) — dims/grain/agg clauses;
* advisor emission (cubes.advisor) — JSON with IR-shaped
  aggregations;
* direct API (`Engine.create_cube(dict)`).

Aggregations may be SQL aggregate expressions ("sum(x * y)",
"approx_count_distinct(c)") or Druid-shaped aggregation JSON (with
optional `virtualColumns`). SQL strings ride through the planner's
ordinary aggregate translation (AVG splits into sum+count, COUNT
DISTINCT lowers to HLL), so a cube spec never needs its own aggregate
dialect.

`agg_signature` is the identity under which partial-aggregate columns
are stored and matched at rewrite time: the aggregation JSON minus its
output name, with virtual-column field references replaced by their
rendered expressions (two queries spelling `sum(a*b)` through
differently-named virtual columns must match one stored partial).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

from tpu_olap_torch.ir.granularity import (AllGranularity, PeriodGranularity,
                                     _SIMPLE)
from tpu_olap_torch.resilience.errors import UserError

__all__ = ["CubeSpec", "CubeSpecError", "agg_signature",
           "period_contains", "spec_period"]

CUBE_TIME_COL = "__ctime"
CUBE_TABLE_PREFIX = "__cube_"


class CubeSpecError(UserError):
    """Malformed or un-materializable cube spec (HTTP 400 shaped)."""


_NAME_RE = re.compile(r"^[A-Za-z_]\w*$")

# ISO period strings the containment ladder understands. Calendar
# periods nest (every month starts on a day boundary, every year on a
# month/quarter boundary); weeks are whole days but do NOT align to
# month/quarter/year starts, so they only contain the sub-day chain.
_CHAIN_RANK = {"PT1S": 0, "PT1M": 1, "PT1H": 2, "P1D": 3,
               "P1M": 4, "P3M": 5, "P1Y": 6}
_WEEK_FINE = {"P1D", "PT1H", "PT1M", "PT1S"}


def spec_period(granularity: str) -> str | None:
    """Spec granularity label -> ISO period (None = 'all'). Accepts the
    simple names ('month', ...) and raw ISO periods ('P1M')."""
    g = (granularity or "all").strip()
    if g.lower() == "all":
        return None
    period = _SIMPLE.get(g.lower(), g)
    if period not in _CHAIN_RANK and period != "P1W":
        raise CubeSpecError(
            f"unsupported cube granularity {granularity!r} (use all, "
            f"{', '.join(sorted(_SIMPLE))}, or an ISO period)")
    return period


def period_contains(coarse: str, fine: str) -> bool:
    """True when every `coarse` bucket is a union of whole `fine`
    buckets under natural calendar alignment (same timezone). This is
    the re-rollup eligibility rule: a query at `coarse` grain can be
    served exactly from partials materialized at `fine` grain."""
    if coarse == fine:
        return True
    if fine == "P1W":
        return False  # weeks don't align to month/quarter/year starts
    if coarse == "P1W":
        return fine in _WEEK_FINE
    rc, rf = _CHAIN_RANK.get(coarse), _CHAIN_RANK.get(fine)
    return rc is not None and rf is not None and rc > rf


@dataclass
class CubeSpec:
    """Normalized rollup-cube specification."""

    name: str
    datasource: str
    dimensions: tuple = ()
    granularity: str = "all"          # "all" | simple name | ISO period
    aggregations: tuple = ()          # SQL strings and/or agg-spec JSON
    virtual_columns: tuple = ()       # vcol JSON for JSON aggregations
    source: str = "api"               # api | ddl | advisor (provenance)
    templates: tuple = ()             # advisor: template ids this serves

    def __post_init__(self):
        if not _NAME_RE.match(self.name or ""):
            raise CubeSpecError(f"invalid cube name {self.name!r}")
        if not self.datasource:
            raise CubeSpecError("cube spec needs a datasource")
        self.dimensions = tuple(dict.fromkeys(self.dimensions))
        self.aggregations = tuple(self.aggregations)
        self.virtual_columns = tuple(self.virtual_columns)
        spec_period(self.granularity)  # validate eagerly

    @property
    def period(self) -> str | None:
        return spec_period(self.granularity)

    @property
    def table_name(self) -> str:
        """Catalog name of the cube's backing segment table."""
        return CUBE_TABLE_PREFIX + self.name

    def to_json(self) -> dict:
        return {"name": self.name, "datasource": self.datasource,
                "dimensions": list(self.dimensions),
                "granularity": self.granularity,
                "aggregations": list(self.aggregations),
                **({"virtualColumns": list(self.virtual_columns)}
                   if self.virtual_columns else {}),
                "source": self.source,
                **({"templates": list(self.templates)}
                   if self.templates else {})}

    @staticmethod
    def from_json(d: dict) -> "CubeSpec":
        if not isinstance(d, dict):
            raise CubeSpecError(f"cube spec must be an object, got "
                                f"{type(d).__name__}")
        unknown = set(d) - {"name", "datasource", "dimensions",
                            "granularity", "aggregations",
                            "virtualColumns", "source", "templates"}
        if unknown:
            raise CubeSpecError(
                f"unknown cube spec keys {sorted(unknown)}")
        try:
            return CubeSpec(
                name=str(d.get("name") or ""),
                datasource=str(d.get("datasource") or ""),
                dimensions=tuple(d.get("dimensions") or ()),
                granularity=str(d.get("granularity") or "all"),
                aggregations=tuple(d.get("aggregations") or ()),
                virtual_columns=tuple(d.get("virtualColumns") or ()),
                source=str(d.get("source") or "api"),
                templates=tuple(d.get("templates") or ()))
        except TypeError as e:
            raise CubeSpecError(f"malformed cube spec: {e}") from e

    # ------------------------------------------------------- build query

    def build_query(self, engine):
        """The rollup's materialization query: a GroupByQuerySpec over
        the WHOLE base table (no filter, eternity intervals) grouping by
        the cube dims (+ the grain's time buckets) with the spec's
        aggregations. SQL aggregate strings translate through the
        planner so AVG/COUNT DISTINCT/filtered forms lower exactly like
        user queries; JSON aggregations deserialize directly."""
        from tpu_olap_torch.ir.aggregations import aggregation_from_json
        from tpu_olap_torch.ir.dimensions import (DefaultDimensionSpec,
                                            VirtualColumn)
        from tpu_olap_torch.ir.query import GroupByQuerySpec
        from tpu_olap_torch.segments.segment import TIME_COLUMN

        entry = engine.catalog.maybe(self.datasource)
        if entry is None or not entry.is_accelerated:
            raise CubeSpecError(
                f"cube base table {self.datasource!r} is not a "
                "registered accelerated datasource")
        table = entry.segments
        for dcol in self.dimensions:
            if dcol == TIME_COLUMN or dcol == entry.time_column:
                raise CubeSpecError(
                    f"dimension {dcol!r} is the time column — model it "
                    "with the GRANULARITY clause instead")
            if dcol not in table.schema:
                raise CubeSpecError(
                    f"unknown cube dimension {dcol!r} on "
                    f"{self.datasource!r}")
        if not self.aggregations:
            raise CubeSpecError("cube spec needs at least one "
                                "aggregation")

        aggs: list = []
        vcols = [VirtualColumn.from_json(v)
                 for v in self.virtual_columns]
        sql_aggs = [a for a in self.aggregations if isinstance(a, str)]
        for a in self.aggregations:
            if not isinstance(a, str):
                aggs.append(aggregation_from_json(a))
        if sql_aggs:
            sql = (f"SELECT {', '.join(sql_aggs)} "
                   f"FROM {self.datasource}")
            plan = engine.planner.plan(sql)
            if not plan.rewritten:
                raise CubeSpecError(
                    f"cube aggregation list is not device-rewritable: "
                    f"{plan.fallback_reason}")
            # the rewriter's post-aggs (AVG quotients, sketch
            # estimates) belong to SERVING queries; the cube stores
            # only the mergeable aggregation state
            aggs.extend(plan.query.aggregations)
            vcols.extend(plan.query.virtual_columns)

        # dedupe by signature (two spellings of one partial store once)
        vexprs = {v.name: v.expression for v in vcols}
        seen, uniq = set(), []
        for a in aggs:
            sig = agg_signature(a, vexprs)
            if sig not in seen:
                seen.add(sig)
                uniq.append(a)

        period = self.period
        gran = AllGranularity() if period is None else \
            PeriodGranularity(period, engine.config.time_zone)
        return GroupByQuerySpec(
            data_source=self.datasource,
            intervals=(),
            dimensions=tuple(DefaultDimensionSpec(d, d)
                             for d in self.dimensions),
            granularity=gran,
            aggregations=tuple(uniq),
            virtual_columns=tuple(vcols))


# ----------------------------------------------------------- signatures

def _sig_json(j: dict, vexprs: dict) -> dict:
    """Aggregation JSON -> canonical identity: output name dropped,
    virtual-column field references replaced by rendered expressions.
    Filtered aggregations keep their filter verbatim (filter literals
    change the partials, so they MUST fragment the identity) plus the
    rendered expressions of any virtual columns the filter reads."""
    from tpu_olap_torch.planner.exprutil import render
    out = {k: v for k, v in j.items() if k != "name"}
    if out.get("type") == "filtered":
        out["aggregator"] = _sig_json(dict(out["aggregator"]), vexprs)
        cols = _filter_json_columns(out.get("filter"))
        vrefs = sorted(c for c in cols if c in vexprs)
        if vrefs:
            out["filterVirtuals"] = {c: render(vexprs[c]) for c in vrefs}
        return out
    f = out.get("fieldName")
    if f in vexprs:
        out["fieldName"] = "expr:" + render(vexprs[f])
    fs = out.get("fieldNames")
    if fs:
        out["fieldNames"] = ["expr:" + render(vexprs[c])
                             if c in vexprs else c for c in fs]
    return out


def _filter_json_columns(node) -> set:
    cols: set = set()
    if isinstance(node, dict):
        d = node.get("dimension")
        if isinstance(d, str):
            cols.add(d)
        for v in node.values():
            cols |= _filter_json_columns(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            cols |= _filter_json_columns(v)
    return cols


def agg_signature(spec, vexprs: dict | None = None) -> str:
    """Stable identity of an aggregation's PARTIAL STATE: equal
    signatures merge from one stored cube column; differing ones never
    alias. `vexprs` maps virtual-column names to expressions for the
    query/spec the aggregation came from."""
    return json.dumps(_sig_json(spec.to_json(), vexprs or {}),
                      sort_keys=True, default=str)

"""Materialized rollup cubes (docs/CUBES.md describes the JAX package's).

The Druid ingest-time-rollup analog, generalized: background-materialize
coarse-grained (dim subset x time granularity) rollups as unfinalized
partial-aggregate tables, and let the planner rewrite covered aggregate
queries onto them (planner.cuberewrite) so repeated dashboard grains
cost a few thousand cube rows instead of a full base-table scan.
"""

from tpu_olap_torch.cubes.advisor import cube_specs_from_workload
from tpu_olap_torch.cubes.materializer import (CubeBuildError, CubeEntry,
                                         CubeRegistry)
from tpu_olap_torch.cubes.spec import (CUBE_TABLE_PREFIX, CUBE_TIME_COL,
                                 CubeSpec, CubeSpecError, agg_signature,
                                 period_contains)

__all__ = [
    "CUBE_TABLE_PREFIX", "CUBE_TIME_COL", "CubeBuildError", "CubeEntry",
    "CubeRegistry", "CubeSpec", "CubeSpecError", "agg_signature",
    "cube_specs_from_workload", "period_contains",
]

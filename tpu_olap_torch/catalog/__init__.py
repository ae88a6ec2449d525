"""Catalog — the analog of the reference's L4 relation/metadata layer
(SURVEY.md §3.4): table registration with per-table options, star-schema
declarations with functional dependencies (StarSchemaInfo), and the
table registry, and the `sys.*` virtual tables over the engine's own
state (catalog.systables).
"""

from tpu_olap_torch.catalog.star import StarSchema, StarDimension, FunctionalDependency  # noqa: F401
from tpu_olap_torch.catalog.catalog import Catalog, TableEntry  # noqa: F401
from tpu_olap_torch.catalog.systables import (SysTableProvider,  # noqa: F401
                                              stmt_uses_sys)

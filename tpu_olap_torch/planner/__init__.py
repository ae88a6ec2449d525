"""Planner — the analog of the reference's L6 rewrite layer (SURVEY.md
§3.2): SQL text parses to a logical SELECT tree; rewrite rules in the
reference's order (join collapse → project/filter pushdown + interval
extraction → aggregate translation → limit/topN selection) compile it into
a QuerySpec via the QueryBuilder accumulator. A statement the rules do not
rewrite runs in the pandas fallback interpreter (`planner.fallback`).
"""

from tpu_olap_torch.planner.sqlparse import parse_sql  # noqa: F401
from tpu_olap_torch.planner.plan import (DruidPlanner, PlanResult,  # noqa: F401
                                         RewriteError)

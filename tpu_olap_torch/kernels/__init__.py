"""Device kernels — the replacement for Druid's segment scan/agg engine
(SURVEY.md §3.7: "the actual scan+aggregate hot loop").

- Filters lower to vectorized torch mask math; string predicates become
  boolean lookup tables over the global dictionary built on the host, so
  selector/in/regex/like are one gather on device (filtereval).
- GROUP BY lowers to a mixed-radix dense group key + a segmented reduce:
  the generic torch one (groupby) or the CUDA kernel generated per plan
  (fused_reduce, csrc/fused_reduce_gen.cuh, rowgen), which also runs the
  row front half — the same closures, traced into a row program
  (rowprog). A Scan/Select/Search row mask runs the same way in its own
  generated kernel (row_mask, csrc/row_mask_gen.cuh).
- Time bucketing is integer math for uniform periods and a searchsorted
  over host-computed calendar boundaries otherwise (timebucket).
- Query literals ride in a ConstPool, shipped to the device once per plan.
"""

from tpu_olap_torch.kernels.filtereval import ConstPool, compile_filter  # noqa: F401
from tpu_olap_torch.kernels.exprs import eval_expr  # noqa: F401
from tpu_olap_torch.kernels.timebucket import BucketPlan, compile_granularity  # noqa: F401
from tpu_olap_torch.kernels.groupby import AggPlan, compile_aggregations, group_reduce  # noqa: F401

"""tpu_olap_torch — the PyTorch/CUDA port of the OLAP engine.

A second package beside the JAX one, with the same layout and module
names so each counterpart is easy to find. SQL in, Druid-shaped results
out: the planner (`planner`) rewrites SQL into the query IR (`ir`), which
lowers (`executor.lowering`) to torch tensor code over dictionary-encoded
columnar segments (`segments`) kept resident on the card
(`executor.dataset`). Filter, group key and grouped reduce run in one
CUDA kernel for Hopper generated per plan (`kernels.fused_reduce`,
`kernels.rowprog`, `kernels.rowgen`, `csrc/fused_reduce_gen.cuh`); a
scan's row mask runs in a generated kernel of its own
(`kernels.row_mask`, `csrc/row_mask_gen.cuh`). Statements the planner
does not rewrite run in the pandas fallback interpreter
(`planner.fallback`); parquet datasets stream into segments row group
by row group (`segments.ingest`).

The package imports torch and never JAX. Entry points run on ``cuda``
unless the caller asks for the CPU (``EngineConfig(device="cpu")``); on
a missing card they raise rather than carry on on the CPU.

Layer map:
  L7 API                -> tpu_olap_torch.api
  L6 planner/rules      -> tpu_olap_torch.planner
  L5 query IR (DSL)     -> tpu_olap_torch.ir
  L4 relation/metadata  -> tpu_olap_torch.catalog
  L3 execution/dispatch -> tpu_olap_torch.executor
  L1 storage/scan       -> tpu_olap_torch.segments + tpu_olap_torch.kernels
"""

__version__ = "0.1.0"

__all__ = ["Engine", "EngineConfig", "__version__"]


def __getattr__(name):
    if name == "Engine":
        from tpu_olap_torch.api.engine import Engine
        return Engine
    if name == "EngineConfig":
        from tpu_olap_torch.executor.config import EngineConfig
        return EngineConfig
    raise AttributeError(name)

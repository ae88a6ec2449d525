"""Benchmark workloads. `ssb` is the Star-Schema Benchmark — the
reference's target workload (BASELINE.json:2: SSB SF100 Q1.1–Q4.3)."""

from tpu_olap_torch.bench.ssb import (QUERIES, denormalize, generate_tables,  # noqa: F401
                                      register_ssb, register_ssb_parquet,
                                      star_schema, write_ssb_parquet)
from tpu_olap_torch.bench.parity import (assert_frame_parity, check_query,  # noqa: F401
                                         run_both)

__all__ = ["QUERIES", "denormalize", "generate_tables", "register_ssb",
           "register_ssb_parquet", "star_schema", "write_ssb_parquet",
           "assert_frame_parity", "check_query", "run_both"]

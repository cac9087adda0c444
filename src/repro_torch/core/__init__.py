"""The port's core: tables, user-defined aggregates and their local
engines, the planner subset of the OLS slice, and execution tracing.

- Table / GroupedView — named columns on one device, the memoized
  partitioning sort and the group-aligned block layout
- Aggregate / FusedAggregate / run_many — the (init, transition, merge,
  final) pattern and the shared scan
- run_local / run_grouped / segment_fold — the local and grouped engines
- ScanAgg / GroupedScanAgg / plan / execute — logical statements and the
  planner that fuses them
- trace_execution — count scans, sorts and kernel dispatches
"""

from .aggregates import (  # noqa: F401
    MERGE_MAX, MERGE_MIN, MERGE_SUM, Aggregate, FusedAggregate,
    probe_segment_ops, run_grouped, run_local, run_many, segment_block_size,
    segment_block_update, segment_fold,
)
from .plan import (  # noqa: F401
    GroupedScanAgg, PhysicalPlan, ScanAgg, execute, plan,
)
from .table import GroupedView, Table, synthetic_regression_table  # noqa: F401
from .trace import Trace, record, trace_execution  # noqa: F401

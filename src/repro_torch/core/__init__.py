"""The port's core: tables, user-defined aggregates and their local and
sharded engines, the planner, the session front end, templated
aggregates, and execution tracing.

- Table / GroupedView — named columns on one device, the memoized
  partitioning sort, the group-aligned block layout, and a distributed
  table's segments (``distribute``, ``pad_to``, ``sharded_blocks``)
- make_mesh — a single-controller mesh of segments (a device may repeat)
- Aggregate / FusedAggregate / run_many — the (init, transition, merge,
  final) pattern and the shared scan
- run_local / run_sharded / run_grouped / segment_fold /
  merge_group_states — the local, sharded and grouped engines; segment
  states merge as a left fold in segment order
- run_stream — the out-of-core fold over host-side row blocks, copied to
  the card while the previous block folds
- IterativeTask / fit / fit_grouped / fit_stream / FitResult — the
  §3.1.2 driver pattern: one host loop around a UDA pass per round, solo,
  streamed or one model per group; host_driver / device_driver /
  counted_driver for step functions with no table scan
- ConvexProgram / gradient_descent / newton / sgd / parallel_sgd /
  conjugate_gradient — the §5.1 convex layer: a model is a
  sum-decomposable loss, the solvers run under the executor
- ScanAgg / GroupedScanAgg / JoinedGroupedScanAgg / IterativeFit /
  StreamAgg / plan / execute / explain — logical statements, the planner
  that fuses them, and EXPLAIN; ENGINE_CAPS / scan_cost /
  select_scan_engine — its engine choice
- calibration — measured cost tables; when one is active the planner
  ranks by measured seconds and sizes segment blocks by measurement
- Join — the device-side sort-merge equi-join of a star schema
- MaterializedHandle / materialize — living views (delta refresh)
- AnalyticsServer / ServerHandle — cross-session admission windows,
  dedup and the version-keyed result cache
- Session / Handle — batch statements; one run() plans them together
- ProfileAggregate / map_columns / one_hot_encode — templated queries
- trace_execution — count scans, sorts and kernel dispatches; span —
  the statement path's ranges for torch.profiler (statement, plan,
  fold, dispatch, final)
"""

from .aggregates import (  # noqa: F401
    MERGE_MAX, MERGE_MIN, MERGE_SUM, Aggregate, FusedAggregate,
    merge_group_states, probe_segment_ops, run_grouped, run_local,
    run_many, run_sharded, run_stream, segment_block_size,
    segment_block_update, segment_fold,
)
from .compat import make_mesh  # noqa: F401
from .convex import (  # noqa: F401
    ConvexProgram, GradientAggregate, HessianAggregate, conjugate_gradient,
    gradient_descent, newton, parallel_sgd, sgd,
)
from .driver import (  # noqa: F401
    IterationResult, counted_driver, device_driver, host_driver,
)
from .iterative import (  # noqa: F401
    FitResult, IterativeTask, PassRunner, fit, fit_grouped, fit_stream,
    relative_change,
)
from .join import Join, JoinResolution  # noqa: F401
from .materialize import MaterializedHandle, materialize  # noqa: F401
from .plan import (  # noqa: F401
    ENGINE_CAPS, GroupedScanAgg, IterativeFit, JoinedGroupedScanAgg,
    PhysicalPlan, ScanAgg, StreamAgg, execute, explain, plan, scan_cost,
    select_scan_engine,
)
from .server import AnalyticsServer, ServerHandle  # noqa: F401
from .session import Handle, Session  # noqa: F401
from .table import (  # noqa: F401
    GroupedView, Table, synthetic_classification_table,
    synthetic_regression_table,
)
from .templates import (  # noqa: F401
    ProfileAggregate, map_columns, one_hot_encode,
)
from .trace import Trace, record, span, trace_execution  # noqa: F401

"""The ``column_stats`` kernels' share of their roofline: the least time
the card could take for every ``column_stats`` launch of the window, over
the device time of the ``column_stats`` kernels in the trace, in %.

The count is the benchmark's own: a launch over ``n`` rows of ``K``
columns (K = 1 for a 1-D column, the product of the trailing dimensions
otherwise) reads the column's ``4 n K`` float32 bytes and the ``n`` bytes
of its bool mask once.  Its bound is those bytes at the HBM peak
(``harness/peaks.json``).  A program without a ``column_stats`` kernel
(no registry entry) gives nothing to read: ``install`` wraps nothing and
``read`` returns None."""

import json
import math
from pathlib import Path

PEAKS = json.loads((Path(__file__).parents[1] / "harness" /
                    "peaks.json").read_text())
KERNELS = r"column_stats_\w*kernel"
NAME = "column_stats"


def launch_bound_s(col_shape: tuple) -> float:
    n = col_shape[0]
    k = math.prod(col_shape[1:])
    return (4 * n * k + n) / PEAKS["hbm_bytes_per_s"]


def install(ctx):
    from repro_torch.kernels import registry
    if NAME in registry.available():
        ctx.spans.wrap_kernel(NAME)


def read(ctx):
    shapes = ctx.spans.shapes.get(NAME, [])
    if ctx.trace is None or not shapes:
        return None
    device_s = ctx.trace.kernel_seconds(KERNELS)
    if device_s <= 0:
        return None
    bound = sum(launch_bound_s(s[0]) for s in shapes)
    return 100.0 * bound / device_s

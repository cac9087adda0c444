"""The ``xtx`` kernels' share of their roofline: the least time the
card could take for every ``xtx`` launch of the window, over the device
time of the ``xtx`` kernels in the trace, in %.

The count is the benchmark's own: a launch over ``n`` rows of ``K``
columns and ``y`` sums the upper triangle of the (K + 1) x (K + 1) Gram
matrix, ``n (K + 1) (K + 2)`` float32 operations (a multiply and an
add per entry and row), and reads ``n (K + 1)`` float32 values once.
Its bound is the larger of the operations at the float32 peak and the
bytes at the HBM peak (``harness/peaks.json``)."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parents[1] / "harness" /
                    "peaks.json").read_text())
KERNELS = r"xtx_\w*kernel"


def launch_bound_s(n: int, k: int) -> float:
    ops = n * (k + 1) * (k + 2)
    nbytes = 4 * n * (k + 1)
    return max(ops / PEAKS["f32_flops_per_s"],
               nbytes / PEAKS["hbm_bytes_per_s"])


def install(ctx):
    ctx.spans.wrap_kernel("xtx")


def read(ctx):
    shapes = ctx.spans.shapes.get("xtx", [])
    if ctx.trace is None or not shapes:
        return None
    device_s = ctx.trace.kernel_seconds(KERNELS)
    if device_s <= 0:
        return None
    bound = sum(launch_bound_s(*s[0]) for s in shapes)
    return 100.0 * bound / device_s

"""The 95th percentile of the latency of every statement answered in the
window, from its submission to its answer after a synchronize, in ms."""

from harness.stats import percentile


def read(ctx):
    p = percentile([r.latency for r in ctx.answered], 95)
    return None if p is None else p * 1e3

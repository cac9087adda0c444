"""Kernels on the card (the profiler's device kernels, copies and sets
left out) per statement answered in the traced window."""


def read(ctx):
    if ctx.trace is None or not ctx.answered:
        return None
    return len(ctx.trace.kernels) / len(ctx.answered)

"""Device idle time under the front end and the planner, in ms per
statement answered in the traced window: the idle gaps whose innermost
program span is ``statement`` (the Session's or ``execute``'s own host
work, such as running the plan's passes and assembling the results) or
``plan``.  Read from the program's ``madlib::*`` ranges in the
profiler's trace (``harness/program_spans.py``); nothing when the
program has none."""

from harness.program_spans import idle_ms_per_stmt


def read(ctx):
    return idle_ms_per_stmt(ctx, "plan")

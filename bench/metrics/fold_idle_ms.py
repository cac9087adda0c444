"""Device idle time under the engines' fold, in ms per statement
answered in the traced window: the idle gaps whose innermost program
span is ``fold`` or ``dispatch`` (init, transitions, merges, a kernel's
host side).  Read from the program's ``madlib::*`` ranges in the
profiler's trace (``harness/program_spans.py``); nothing when the
program has none."""

from harness.program_spans import idle_ms_per_stmt


def read(ctx):
    return idle_ms_per_stmt(ctx, "fold")

"""Statements answered in the window over the window's seconds (from its
start to its last answer).  A statement is one answer an analyst waits
for; ``profile`` counts as one."""

def read(ctx):
    return len(ctx.answered) / ctx.window.seconds

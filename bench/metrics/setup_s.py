"""Seconds from the process's start to the window's first statement:
imports, the kernel library (built on a checkout's first run), the table
made on the card, and the warm-up."""


def read(ctx):
    return ctx.setup_s

"""Seconds from the start of the process to the first timed iteration:
imports, weights, the engine's kernel load and graph captures, the
settle."""


def read(ctx):
    return ctx.setup_s

"""Seconds from the process's start to the window's: imports, the program's
kernels from its build cache, weights, inputs and the warm-up."""


def read(ctx):
    return ctx.setup_s

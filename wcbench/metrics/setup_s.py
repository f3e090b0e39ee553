"""Seconds from the start of the process to the start of the window: imports,
the kernel library's load (its build on a checkout's first run), the models
and their weights, the inputs and the warm-up."""


def read(ctx):
    return ctx.setup_s

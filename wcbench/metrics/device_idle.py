"""The share of the traced window, in %, in which no kernel ran on the card:
one less the union of the kernels' intervals (not the sum of their lengths)
over the window."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)

"""Device kernels a step in the traced part of the window (torch.profiler's
kernel events over the steps traced): where the host paces a cell, each
launch costs host time."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or not ctx.traced_steps:
        return None
    return len(ctx.trace.kernels) / ctx.traced_steps

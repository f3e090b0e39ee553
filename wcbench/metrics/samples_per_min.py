"""Samples a minute over the whole window: the images of the sampler calls
done, over the time up to the window's closing synchronize."""


def read(ctx):
    work = ctx.work.get("samples")
    return None if work is None else work / ctx.window_s * 60.0

"""Guided translations a minute over the whole window: each chain step of the
batch counts batch / num_steps translations; the time runs to the window's
closing synchronize."""


def read(ctx):
    work = ctx.work.get("translations")
    return None if work is None else work / ctx.window_s * 60.0

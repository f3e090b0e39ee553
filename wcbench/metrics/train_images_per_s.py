"""Images a second over the whole window: batch x train steps, over the time
up to the window's closing synchronize."""


def read(ctx):
    work = ctx.work.get("images")
    return None if work is None else work / ctx.window_s

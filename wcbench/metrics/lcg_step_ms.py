"""Milliseconds of one LCG step of the chain on the device: the mean over the
traced one-step segments of the span between CUDA events recorded before and
after the segment."""


def read(ctx):
    spans = ctx.spans.get("lcg")
    return sum(spans) / len(spans) if spans else None

"""The flash-attention kernels' share of their roofline, in %: the least time
their launches in the traced part could take at their shapes (each input
read once, each output written once, the products at the published peaks;
yardstick.py), over the time the device spent in them. Nothing where no
flash kernel ran."""

from wcbench import yardstick


def read(ctx):
    if ctx.trace is None or ctx.flash_bound_s is None:
        return None
    spent = ctx.trace.kernel_time_s(yardstick.flash_kernel)
    return None if spent <= 0 else 100.0 * ctx.flash_bound_s / spent

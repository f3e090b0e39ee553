"""The whole step's share of the card's peak, in %: the FLOPs of a step
(torch.utils.flop_counter on the plain reference at the cell's shapes) over
the window's time a step outside the traced part, times the f32-product
peak (yardstick.py)."""

from wcbench import yardstick


def read(ctx):
    if ctx.peak is None or not ctx.flops_per_step or not ctx.step_s:
        return None
    return 100.0 * ctx.flops_per_step / (ctx.step_s * ctx.peak[yardstick.F32_PRODUCT_PEAK])

"""The yardsticks at known shapes: FLOP counts, kernel bounds, peaks, and the
reduction of a trace to busy time, idle gaps and the breakdown."""

from __future__ import annotations

import pytest
import torch

from wcbench import yardstick
from wcbench.trace import Trace, union

PEAK = yardstick.PEAKS["H100 80GB HBM3"]


def test_count_flops_of_a_matmul_and_a_convolution():
    a, b = torch.zeros(64, 32), torch.zeros(32, 16)
    assert yardstick.count_flops(lambda: a @ b) == 2 * 64 * 32 * 16
    x, w = torch.zeros(2, 3, 8, 8), torch.zeros(5, 3, 3, 3)
    assert yardstick.count_flops(lambda: torch.nn.functional.conv2d(x, w, padding=1)) == 2 * 2 * 5 * 8 * 8 * 3 * 9


@pytest.mark.parametrize("shape", [(16, 4, 4096, 64), (16, 4, 1024, 32), (4, 4, 4096, 16)])
def test_flash_bounds_at_known_shapes(shape):
    b, h, n, d = shape
    heads = b * h
    assert yardstick.k1_f32_bound_s(*shape, PEAK) == pytest.approx(4 * heads * n * n * d / 494.7e12)
    assert yardstick.k3_f32_bound_s(*shape, PEAK) == pytest.approx(10 * heads * n * n * d / 494.7e12)
    assert yardstick.k2_f32_bound_s(*shape, PEAK) == pytest.approx(
        2 * heads * n * n * d / 1979e12 + 2 * heads * n * n * d / 494.7e12)
    assert yardstick.quantizer_bound_s(*shape, PEAK) == pytest.approx(10 * heads * n * d / 3.35e12)


def test_peaks_are_the_published_ones_and_unknown_cards_have_none():
    assert yardstick.peaks("NVIDIA H100 80GB HBM3") == PEAK
    assert PEAK["tf32"] == 494.7e12 and PEAK["hbm"] == 3.35e12
    assert yardstick.peaks("cpu") is None
    assert yardstick.flash_kernel("void flash_fwd_f32_wgmma_kernel<64>(...)")
    assert yardstick.flash_kernel("quantize_qk_kernel") and not yardstick.flash_kernel("cudnn_conv")


def test_trace_busy_time_is_the_union_and_gaps_name_the_host_op():
    kernels = [("k1", 10.0, 20.0), ("k2", 15.0, 30.0), ("k3", 50.0, 60.0)]
    host = [("outer", 0.0, 100.0), ("aten::item", 32.0, 48.0)]
    t = Trace(kernels, host, 0.0, 100.0)
    assert union([(1, 3), (2, 4), (6, 7)]) == [(1, 4), (6, 7)]
    assert t.busy_s == pytest.approx(30e-6)
    assert t.window_s == pytest.approx(100e-6)
    assert t.gaps() == [(0.0, 10.0), (30.0, 50.0), (60.0, 100.0)]
    idle = t.idle_by_host()
    assert idle["aten::item"] == pytest.approx(20e-6) and idle["outer"] == pytest.approx(50e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k2", pytest.approx(15e-6)] and len(b["idle_gaps"]) == 2
    assert t.kernel_time_s(lambda n: n != "k3") == pytest.approx(25e-6)

"""The benchmark's yardsticks: the card's published peaks, the least time a
flash-attention kernel can take at its shapes, and the FLOPs of a step.

Peaks are NVIDIA's data sheet for the H100 SXM (80 GB HBM3), dense, at the
full 700 W. An f32 product counts at the dense TF32 rate, 494.7 TFLOP/s:
no method that keeps f32's accuracy runs its products faster on this card
(the port's 3xTF32 kernels issue three TF32 products for each; cuDNN's f32
convolutions without TF32 run on the FMA units at 67 TFLOP/s), so neither a
kernel's roofline share nor a step's MFU can pass 100 % when a later change
swaps a kernel. Exponentials are left out of the kernels' bounds: the
special-function rate depends on the SM clock, which the card sets itself
(boost to 1.98 GHz), and a bound that assumed a lower clock could read
above 100 %. Leaving a term out only lowers a bound.
"""

from __future__ import annotations

import subprocess

PEAKS = {
    "H100 80GB HBM3": dict(hbm=3.35e12, tf32=494.7e12, int8=1979e12, bf16=989e12, f32=67e12),
}
F32_PRODUCT_PEAK = "tf32"


def peaks(card: str) -> dict | None:
    return next((v for k, v in PEAKS.items() if k in card), None)


def power_limit_w() -> float | None:
    """The card's power limit in W (nvidia-smi), None where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _bound(seconds: dict[str, float]) -> float:
    return max(seconds.values())


def quantizer_bound_s(b: int, h: int, n: int, d: int, peak: dict) -> float:
    """The int8 quantizer on f32 q and k: both read once, both written once as int8."""
    return (8 + 2) * b * h * n * d / peak["hbm"]


def k2_f32_bound_s(b: int, h: int, n: int, d: int, peak: dict) -> float:
    """K2-f32's forward on quantized q8, k8 and f32 V: Q K^T at the int8 rate
    and P V at the f32-product rate (one tensor unit: the times add), or
    q8, k8, V read and O written once."""
    flops = 2 * b * h * n * n * d
    return _bound({"tensor": flops / peak["int8"] + flops / peak[F32_PRODUCT_PEAK],
                   "hbm": (1 + 1 + 4 + 4) * b * h * n * d / peak["hbm"]})


def k1_f32_bound_s(b: int, h: int, n: int, d: int, peak: dict) -> float:
    """K1-f32's forward: two products of 2 N^2 D a head, q, k, v read, o and l written."""
    return _bound({"tensor": 4 * b * h * n * n * d / peak[F32_PRODUCT_PEAK],
                   "hbm": (16 * b * h * n * d + 4 * b * h * n) / peak["hbm"]})


def k3_f32_bound_s(b: int, h: int, n: int, d: int, peak: dict) -> float:
    """K3-f32, the backward: five products of 2 N^2 D a head (S, dP, dV, dQ,
    dK); q, k, v, o, dO and l read, dq, dk, dv written."""
    return _bound({"tensor": 10 * b * h * n * n * d / peak[F32_PRODUCT_PEAK],
                   "hbm": (32 * b * h * n * d + 4 * b * h * n) / peak["hbm"]})


def flash_kernel(name: str) -> bool:
    """Whether a device kernel's name is one of the port's flash-attention
    kernels or their quantizer (csrc/flash_*.cu, csrc/quantize_i8.cu)."""
    return "flash_fwd" in name or "flash_bwd" in name or "quantize_qk" in name


def count_flops(fn) -> int:
    """The FLOPs torch.utils.flop_counter counts while fn() runs (matrix
    products and convolutions, forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as mode:
        fn()
    return int(mode.get_total_flops())

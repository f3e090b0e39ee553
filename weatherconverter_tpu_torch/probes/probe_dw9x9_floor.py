"""H100 micro-probe K5: the FMA floor of a 9x9 depthwise conv against the
SRGAN's tail layer (port of scripts/probe_dw9x9_floor.py).

`dw_fma81` is the kernel (csrc/probe_dw9x9.cu): for every element, 81
sequential f32 multiply-adds of x * w[i], cast back to x's dtype. That is a
9x9 depthwise conv's FMA work with the shifts left out, so its time is a
floor for any hand-written depthwise 9x9 kernel. A CPU tensor takes
`dw_fma81_plain`. The probe runs it over the tail's input, (8, 256, 256, 64)
bf16, and compares it with what the port's SRGAN runs for that layer:
`SeparableConv(64, 3, 9, 1, 4)` (`models/srgan.Generator.final_conv`), a
cuDNN depthwise 9x9 and a 1x1 conv, at (8, 64, 256, 256) bf16. The script
compared the TPU's shift-packed tail, which has no counterpart here.

    python -m weatherconverter_tpu_torch.probes.probe_dw9x9_floor     # on a machine with a CUDA card
"""

from __future__ import annotations

import sys

import torch

from weatherconverter_tpu_torch.models.srgan import SeparableConv
from weatherconverter_tpu_torch.ops import cuda_build
from weatherconverter_tpu_torch.probes import common

B, HW, C = 8, 256, 64
K = 9
TAPS = K * K
DTYPES = (torch.bfloat16, torch.float16)


def taps() -> torch.Tensor:
    """The script's weights: 81 f32 values from 0.9 to 1.1."""
    return torch.linspace(0.9, 1.1, TAPS, dtype=torch.float32)


def dw_fma81_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K5's plain version, `dw_vpu_kernel` in PyTorch: acc = acc + x * w[i]
    in f32 for i = 0..80, cast to x's dtype."""
    w = w.to(x.device, torch.float32)
    xf = x.float()
    acc = torch.zeros_like(xf)
    for i in range(TAPS):
        acc = acc + xf * w[i]
    return acc.to(x.dtype)


def dw_fma81(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K5, forward only: x of any shape, w 81 f32 weights -> x's shape and
    dtype. A CPU tensor x takes `dw_fma81_plain`; a CUDA tensor launches the
    kernel (bf16/f16, numel % 8 == 0) or raises. The weights travel in the
    launch's arguments: a w on the card is copied to the host first, which
    waits for the card."""
    common.refuse_grad("dw_fma81", x)
    if x.device.type == "cpu":
        return dw_fma81_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"dw_fma81: the kernel runs on CUDA tensors, got {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"dw_fma81: dtype must be one of {DTYPES}, got {x.dtype}")
    if w.numel() != TAPS:
        raise ValueError(f"dw_fma81: w must hold {TAPS} weights, got {w.numel()}")
    if x.numel() % 8 != 0 or x.numel() == 0:
        raise ValueError(f"dw_fma81: the element count {x.numel()} is not a positive multiple of 8")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("dw_fma81: x must be 16-byte aligned")
    w_host = w.detach().to("cpu", torch.float32).contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = cuda_build.library().wc_probe_dw_fma81(
            x.data_ptr(), out.data_ptr(), x.numel(), w_host.data_ptr(), int(x.dtype == torch.float16),
            cuda_build.stream(x.device))
    cuda_build.check_launch("dw_fma81", err)
    dw_fma81.launches += 1
    return out


dw_fma81.launches = 0


def ulp(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One ulp of `dtype` at each value of x (f32)."""
    _, exp = torch.frexp(x.float())
    return torch.ldexp(torch.full_like(x, torch.finfo(dtype).eps, dtype=torch.float32), exp - 1)


def _inputs(device):
    g = torch.Generator(device=device).manual_seed(0)
    return torch.randn((B, HW, HW, C), generator=g, device=device).to(torch.bfloat16), taps()


def check(device) -> float:
    """The kernel against its plain version at the probe's shape: within one
    bf16 ulp everywhere (the kernel fuses each multiply-add, the plain
    version rounds twice). Returns the max abs error."""
    x, w = _inputs(device)
    out = dw_fma81(x, w)
    torch.cuda.synchronize()
    ref = dw_fma81_plain(x, w)
    diff = (out.float() - ref.float()).abs()
    if not (bool((diff <= ulp(ref)).all()) and torch.isfinite(out.float()).all().item()):
        raise AssertionError(f"dw_fma81: differs from its plain version by more than one bf16 ulp "
                             f"(max abs {diff.max().item()}) or not finite")
    return diff.max().item()


@torch.no_grad()
def run(device, card: str) -> dict:
    """The probe: the FMA floor, the cuDNN tail layer and its depthwise half,
    and the verdict. Returns the kernel's, the plain version's and the tail
    layer's ms."""
    x, w = _inputs(device)
    t_fma = common.time_ms(lambda: dw_fma81(x, w), reps=10, inner=5)
    gflop = B * HW * HW * C * TAPS * 2 / 1e9
    common.log(f"FMA depthwise bound (81-FMA CUDA kernel, NHWC): {t_fma:.4f} ms  "
               f"({gflop / t_fma:.1f} TFLOP/s f32 FMA rate) [{card}]")

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tail = SeparableConv(C, 3, K, 1, K // 2).to(device, torch.bfloat16)
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    x_cl = x.permute(0, 3, 1, 2)  # an NCHW view with channels-last strides
    t_tail = common.time_ms(lambda: tail(x_nchw), reps=10, inner=5)
    t_dw = common.time_ms(lambda: tail.depthwise(x_nchw), reps=10, inner=5)
    t_dw_cl = common.time_ms(lambda: tail.depthwise(x_cl), reps=10, inner=5)
    common.log(f"cuDNN full tail layer (SeparableConv 64->3, 9x9 depthwise + 1x1, NCHW): {t_tail:.4f} ms; "
               f"its 9x9 depthwise alone {t_dw:.4f} ms (on channels-last input {t_dw_cl:.4f} ms)")
    common.log(f"verdict: FMA bound {'EXCEEDS' if t_fma > t_tail else 'is below'} the tail layer's cost on cuDNN -> "
               f"a hand-written depthwise 9x9 kernel {'REFUTED' if t_fma > t_tail else 'still plausible'}")

    plain = common.time_ms(lambda: dw_fma81_plain(x, w), reps=3, warmup=1)
    peak = common.peaks(card)
    nbytes = 2 * x.numel() * x.element_size()
    floors = ("not known for this card" if peak is None else
              f"{gflop * 1e9 / peak['f32'] * 1e3:.4f} ms for the FMAs at the published f32 rate, "
              f"{nbytes / peak['hbm'] * 1e3:.4f} ms for the bytes")
    common.log(f"floors: {gflop / 2:.2f} G FMA, {nbytes / 1e6:.1f} MB read and written: {floors}; "
               f"plain PyTorch {plain:.4f} ms")
    # no single PyTorch call computes the 81-FMA chain (cuDNN's 9x9 conv is another function)
    return dict(ms=t_fma, plain_ms=plain, tail_ms=t_tail, dw_ms=t_dw, dw_cl_ms=t_dw_cl, library_ms=None,
                **common.roofline(peak, nbytes, f32=gflop * 1e9))


def main() -> int:
    if not common.require_cuda("probe_dw9x9_floor"):
        return 2
    card = common.card_line()
    common.log(card)
    common.log(common.setup())
    device = torch.device("cuda")
    common.log(f"dw_fma81 within one bf16 ulp of its plain version: max abs err {check(device):.3e}")
    run(device, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

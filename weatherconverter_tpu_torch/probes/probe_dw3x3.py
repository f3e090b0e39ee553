"""H100 micro-probe K6: a 3x3 depthwise conv, NHWC, against the SRGAN
residual block's cuDNN depthwise conv (port of scripts/probe_dw3x3.py).

`dw3x3` is the kernel (csrc/probe_dw3x3.cu: a 16 x 32 pixel tile with its
halo staged in shared memory, the taps in registers, a thread walking down
the tile's rows); a CPU tensor takes `dw3x3_plain`. The probe runs it at
the residual blocks' (8, 128, 128, 64)
bf16 against what the port's SRGAN runs for the same layer, the depthwise
`nn.Conv2d(64, 64, 3, padding=1, groups=64, bias=False)` of
`models/srgan.ConvBlock` on cuDNN, in NCHW (the SRGAN's layout) and in
channels-last. The kernel takes NHWC, so it is timed alone and with the
NCHW -> NHWC -> NCHW transposes the SRGAN would need around it.

    python -m weatherconverter_tpu_torch.probes.probe_dw3x3     # on a machine with a CUDA card

The script padded W to 136 for the TPU's sublane tiling; the kernel's copies
fill zeros where the halo leaves the image, so the port pads nothing.
"""

from __future__ import annotations

import itertools
import sys

import torch
import torch.nn.functional as F

from weatherconverter_tpu_torch.models.srgan import SeparableConv
from weatherconverter_tpu_torch.ops import cuda_build
from weatherconverter_tpu_torch.probes import common

B, H, W, C = 8, 128, 128, 64
TAP_SCALE = 0.2  # the script's k = N(0, 1) * 0.2
DTYPES = (torch.bfloat16, torch.float16)
# against the plain version, bf16 outputs of O(1): the kernel fuses each
# multiply-add, the plain version rounds twice, so a few entries round to the
# neighbouring bf16 value (2^-8 at |out| < 1, 2^-7 below 2)
TOL = 1e-2
# distinct input copies cycled through while timing: 4 x 16.8 MB exceeds the
# 50 MB L2, so each launch reads its input from device memory
ROTATE = 4


def dw3x3_plain(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """K6's plain version: x (B, H, W, C), k (3, 3, 1, C) HWIO; zero padding
    1, no bias, f32 accumulation of x * k in tap order (dh, dw), cast to x's
    dtype."""
    h, w = x.shape[1:3]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    kf = k.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for dh in range(3):
        for dw in range(3):
            acc = acc + xp[:, dh:dh + h, dw:dw + w, :] * kf[dh, dw, 0]
    return acc.to(x.dtype)


def dw3x3(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """K6, forward only: x (B, H, W, C) NHWC, k (3, 3, 1, C) -> (B, H, W, C)
    in x's dtype. A CPU tensor takes `dw3x3_plain`; a CUDA tensor launches
    the kernel (bf16/f16, k in x's dtype, C % 8 == 0) or raises."""
    common.refuse_grad("dw3x3", x, k)
    if x.device.type == "cpu":
        return dw3x3_plain(x, k)
    if x.device.type != "cuda" or k.device != x.device:
        raise ValueError(f"dw3x3: the kernel runs on CUDA tensors on one device, got {x.device}, {k.device}")
    if x.dim() != 4 or k.shape != (3, 3, 1, x.shape[-1]):
        raise ValueError(f"dw3x3: x must be (B, H, W, C) and k (3, 3, 1, C), got {tuple(x.shape)}, {tuple(k.shape)}")
    if x.dtype not in DTYPES or k.dtype != x.dtype:
        raise ValueError(f"dw3x3: dtype must be one of {DTYPES} for both x and k, got {x.dtype}, {k.dtype}")
    b, h, w, c = x.shape
    if c % 8 != 0:
        raise ValueError(f"dw3x3: C={c} is not a multiple of 8")
    x, taps = x.contiguous(), k.reshape(9, c).contiguous()
    if x.data_ptr() % 16 or taps.data_ptr() % 16:
        raise ValueError("dw3x3: x and k must be 16-byte aligned")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = cuda_build.library().wc_probe_dw3x3(
            x.data_ptr(), taps.data_ptr(), out.data_ptr(), b, h, w, c, int(x.dtype == torch.float16),
            cuda_build.stream(x.device))
    cuda_build.check_launch("dw3x3", err)
    dw3x3.launches += 1
    return out


dw3x3.launches = 0


def _inputs(device):
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((B, H, W, C), generator=g, device=device).to(torch.bfloat16)
    k = (torch.randn((3, 3, 1, C), generator=g, device=device) * TAP_SCALE).to(torch.bfloat16)
    return x, k


def check(device) -> float:
    """The kernel against its plain version at the probe's shape; returns the
    max abs error, raises above TOL or on a non-finite output."""
    x, k = _inputs(device)
    out = dw3x3(x, k)
    torch.cuda.synchronize()
    err = (out.float() - dw3x3_plain(x, k).float()).abs().max().item()
    if not (err <= TOL and torch.isfinite(out.float()).all().item()):
        raise AssertionError(f"dw3x3: max abs err {err} > {TOL} or not finite")
    return err


def _rotating(fn, inputs):
    it = itertools.cycle(inputs)
    return lambda: fn(next(it))


@torch.no_grad()
def run(device, card: str) -> dict:
    """The probe: the kernel's and cuDNN's error against an f32 conv, then
    their times, each cycling over ROTATE input copies. Returns the
    kernel's, the plain version's and cuDNN's ms."""
    x, k = _inputs(device)
    conv = SeparableConv(C, C, 3, 1, 1, bias=False).depthwise.to(device, torch.bfloat16)
    conv.weight.copy_(k.permute(3, 2, 0, 1))
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    with torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=False, allow_tf32=False):
        ref = F.conv2d(x_nchw.float(), conv.weight.float(), padding=1, groups=C).permute(0, 2, 3, 1)
    out = dw3x3(x, k)
    common.log(f"max|diff| vs cuDNN f32 conv: {(out.float() - ref).abs().max().item():.3e} "
               f"(cuDNN bf16: {(conv(x_nchw).float().permute(0, 2, 3, 1) - ref).abs().max().item():.3e})")

    xs = [x] + [x.clone() for _ in range(ROTATE - 1)]
    xs_nchw = [t.permute(0, 3, 1, 2).contiguous() for t in xs]
    xs_cl = [t.permute(0, 3, 1, 2) for t in xs]  # NCHW views with channels-last strides
    cases = (
        ("CUDA dw3x3 (NHWC)", _rotating(lambda t: dw3x3(t, k), xs)),
        ("CUDA dw3x3 with NCHW<->NHWC transposes",
         _rotating(lambda t: dw3x3(t.permute(0, 2, 3, 1).contiguous(), k).permute(0, 3, 1, 2).contiguous(),
                   xs_nchw)),
        ("cuDNN grouped dw3x3 (NCHW, the SRGAN's layer)", _rotating(conv, xs_nchw)),
        ("cuDNN grouped dw3x3 (channels-last)", _rotating(conv, xs_cl)),
    )
    # ROTATE calls a sample: their wrappers' host time (some 40 us a call) stays under the ~0.3 ms that
    # the device spins before a sample, so a kernel shorter than its wrapper still reads its device time
    times = {name: common.time_ms(fn, reps=25, inner=ROTATE) for name, fn in cases}
    plain = common.time_ms(lambda: dw3x3_plain(x, k), reps=3, warmup=1)
    for name, ms in times.items():
        common.log(f"{name}: {ms:.4f} ms/iter")
    common.log(f"plain PyTorch dw3x3: {plain:.4f} ms/iter")
    nbytes = 2 * x.numel() * x.element_size()
    peak = common.peaks(card)
    floor = "not known for this card" if peak is None else f"{nbytes / peak['hbm'] * 1e3:.4f} ms"
    kernel = times["CUDA dw3x3 (NHWC)"]
    library = times["cuDNN grouped dw3x3 (channels-last)"]
    common.log(f"floor: {nbytes / 1e6:.1f} MB read and written, {9 * x.numel() / 1e6:.1f} M FMA; at the card's "
               f"published bandwidth {floor}; kernel {nbytes / (kernel * 1e-3) / 1e12:.2f} TB/s, "
               f"{kernel / library:.2f}x the time of cuDNN's channels-last conv ({nbytes / (library * 1e-3) / 1e12:.2f} "
               f"TB/s) [{card}]")
    # the one library call on the same NHWC memory is cuDNN's channels-last conv
    return dict(ms=kernel, plain_ms=plain, cudnn_ms=times["cuDNN grouped dw3x3 (NCHW, the SRGAN's layer)"],
                cudnn_cl_ms=times["cuDNN grouped dw3x3 (channels-last)"],
                library_ms=library,
                **common.roofline(peak, nbytes, f32=2 * 9 * x.numel()),
                transposed_ms=times["CUDA dw3x3 with NCHW<->NHWC transposes"])


def main() -> int:
    if not common.require_cuda("probe_dw3x3"):
        return 2
    card = common.card_line()
    common.log(card)
    common.log(common.setup())
    device = torch.device("cuda")
    common.log(f"dw3x3 against its plain version: max abs err {check(device):.3e} (tol {TOL})")
    run(device, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

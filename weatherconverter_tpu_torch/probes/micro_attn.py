"""H100 micro-probe K4: the exp2 form of the clamped-softmax flash forward
against K1 (port of scripts/micro_attn.py).

K1 (`ops.attention.flash_attention`) scales every (query, key) score,
clamps it on both sides and exponentiates it. The exp2 form folds the scale
and log2(e) into q, rounded back to q's dtype (D multiplies per query row
instead of N), clamps from above only and calls exp2:

    q2 = cast(q * D^-1/2 * log2 e);  p = exp2(min(q2 K^T, 60 log2 e));  O = cast(p) V / l

`exp2_attention` is its kernel (csrc/probe_exp2_attn.cu); a CPU tensor takes
`exp2_attention_plain`. The kernel stands on K1's design (wgmma, the cp.async
tile ring, the same schedule) and keeps the scaled q in registers as the A
operand of Q K^T, where K1 reads its Q tile from shared memory. So the probe
asks, on equal designs: do the folded scale, the one-sided clamp and a
register Q pay? It runs both forms at the production UNet's two N=4096
attention shapes, (8, 4, 4096, 64) and (8, 4, 4096, 16), bf16, and prints
each one's error against softmax attention and its time.

    python -m weatherconverter_tpu_torch.probes.micro_attn     # on a machine with a CUDA card

The script's TPU-only `block_q=512` variant was a Mosaic tile knob and has
no counterpart here.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from weatherconverter_tpu_torch.ops import attention as A
from weatherconverter_tpu_torch.ops import cuda_build
from weatherconverter_tpu_torch.probes import common

LOG2E = 1.4426950408889634
CLAMP2 = 60.0 * LOG2E  # the upper clamp in the exp2 domain (micro_attn.py:40)
SHAPES = [(8, 4, 4096, 64), (8, 4, 4096, 16)]
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations (K1 also has 192)
# against the plain version, bf16 outputs of O(0.1-1): K1's bound (one bf16
# ulp is <= 2^-8 there; the two differ in f32 summation order and exp2 rounding)
TOL = 1e-2
# and max |err| / max |ref|: at N = 4096 the outputs are about 0.03, where the
# absolute bound alone would pass an output that lacks a whole key tile; the
# two round nearly equal f32 values, so they differ by one bf16 ulp at most,
# 2^-7 of the value
REL_TOL = 1e-2


def exp2_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K4's plain version, `_exp2_kernel` in PyTorch: q2 rounded to q's dtype,
    f32 scores, p cast to v's dtype before PV, O normalised after PV and cast
    to q's dtype."""
    scale = 1.0 / q.shape[-1] ** 0.5
    with common.full_f32_matmul():
        q2 = (q.float() * (scale * LOG2E)).to(q.dtype)
        s2 = torch.matmul(q2.float(), k.float().transpose(-1, -2))
        p = torch.exp2(s2.clamp_max(CLAMP2))
        l = p.sum(dim=-1, keepdim=True)
        return (torch.matmul(p.to(v.dtype).float(), v.float()) / l).to(q.dtype)


def exp2_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K4, forward only, (B, H, N, D) -> O in q's dtype. A CPU tensor takes
    `exp2_attention_plain`; a CUDA tensor launches the kernel (what K1 takes:
    bf16/f16, D in {16, 32, 64, 128}, N % 64 == 0) or raises."""
    common.refuse_grad("exp2_attention", q, k, v)
    if q.device.type == "cpu":
        return exp2_attention_plain(q, k, v)
    A.check_kernel_inputs("exp2_attention", q, k, v)
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"exp2_attention: head dim {q.shape[-1]} not in {HEAD_DIMS}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("exp2_attention: q, k, v must share one dtype")
    b, h, n, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = cuda_build.library().wc_probe_exp2_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, n, d,
            int(q.dtype == torch.float16), LOG2E / d**0.5, cuda_build.stream(q.device))
    cuda_build.check_launch("exp2_attention", err)
    exp2_attention.launches += 1
    return o


exp2_attention.launches = 0


def _inputs(shape, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device).to(torch.bfloat16) for _ in range(3)]


def check(device) -> float:
    """The kernel against its plain version at the probe's shapes; returns
    the largest max abs error, raises above TOL, above REL_TOL of the plain
    version's largest value, or on a non-finite output."""
    worst = 0.0
    for shape in SHAPES:
        q, k, v = _inputs(shape, device)
        out = exp2_attention(q, k, v)
        torch.cuda.synchronize()
        ref = exp2_attention_plain(q, k, v).float()
        err = (out.float() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        if not (err <= TOL and rel <= REL_TOL and torch.isfinite(out.float()).all().item()):
            raise AssertionError(f"exp2_attention {shape}: max abs err {err} > {TOL}, max|err|/max|ref| {rel} > "
                                 f"{REL_TOL}, or not finite")
        common.log(f"exp2_attention {shape}: max abs err {err:.3e} (tol {TOL}), max|err|/max|ref| {rel:.3e} "
                   f"(tol {REL_TOL})")
        worst = max(worst, err)
    return worst


def _ms(x) -> str:
    return "not known" if x is None else f"{x:8.3f}"


def run(device, card: str) -> dict:
    """The probe: both forms' error against softmax attention, and their
    times in turns (K1, K4, K4, K1), at each shape. Returns the sums over
    the shapes of K4's, K1's and the plain version's ms, of the roofline
    bound, and of `scaled_dot_product_attention`'s ms (timed as a yardstick;
    the port never calls it)."""
    total = dict(ms=0.0, k1_ms=0.0, plain_ms=0.0, library_ms=0.0)
    bounds = []
    for shape in SHAPES:
        b, h, n, d = shape
        q, k, v = _inputs(shape, device)
        with common.full_f32_matmul():
            ref = A.attention_reference(q.float(), k.float(), v.float())
        e2 = exp2_attention(q, k, v).float()
        base = A.flash_attention(q, k, v).float()
        common.log(f"D={d} max|exp2-ref|={(e2 - ref).abs().max().item():.3e} "
                   f"max|base-ref|={(base - ref).abs().max().item():.3e}")
        t = {"base": [], "exp2": []}
        for name in ("base", "exp2", "exp2", "base"):
            fn = A.flash_attention if name == "base" else exp2_attention
            t[name].append(common.time_ms(lambda: fn(q, k, v), reps=15, inner=5))
        k1, k4 = sum(t["base"]) / 2, sum(t["exp2"]) / 2
        plain = common.time_ms(lambda: exp2_attention_plain(q, k, v), reps=3, warmup=1)
        common.log(f"{f'base  D={d}':34s} {k1:8.3f} ms/layer  (K1; runs {t['base'][0]:.3f}, {t['base'][1]:.3f})")
        common.log(f"{f'exp2  D={d}':34s} {k4:8.3f} ms/layer  (K4; runs {t['exp2'][0]:.3f}, {t['exp2'][1]:.3f}; "
                   f"{100 * (k4 - k1) / k1:+.1f}% against K1)")
        tflops = 4 * b * h * n * n * d / (k4 * 1e-3) / 1e12
        common.log(f"{f'exp2 plain D={d}':34s} {plain:8.3f} ms/layer  (PyTorch, f32 scores) "
                   f"[B*H={b * h} N={n}; {tflops:.1f} TFLOP/s of QK^T+PV in K4] [{card}]")
        library = common.time_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps=15, inner=5)
        bound = common.attention_roofline(common.peaks(card), shape)
        bounds.append(bound)
        common.log(f"{f'bound D={d}':34s} {_ms(bound['bound_ms'])} ms/layer  ({bound['binds']} binds); "
                   f"scaled_dot_product_attention {library:.3f} ms/layer (a yardstick the port never calls)")
        total["ms"] += k4
        total["k1_ms"] += k1
        total["plain_ms"] += plain
        total["library_ms"] += library
    return {**total, **common.add_rooflines(*bounds)}


def main() -> int:
    if not common.require_cuda("micro_attn"):
        return 2
    card = common.card_line()
    common.log(card)
    common.log(common.setup())
    device = torch.device("cuda")
    common.log(f"exp2_attention against its plain version: max abs err {check(device):.3e} (tol {TOL})")
    run(device, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

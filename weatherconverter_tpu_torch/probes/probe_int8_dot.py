"""H100 micro-probe K7: the raw QK^T product, int8 -> int32 against
bf16 -> f32, with the whole (N, N) written out (port of
scripts/probe_int8_dot.py).

`qk_dot_i8` and `qk_dot_bf16` are the two entry points of one kernel source
(csrc/probe_qk_dot.cu); a CPU tensor takes `qk_dot_i8_plain` /
`qk_dot_bf16_plain`. The probe times both at (1, 4096, 64) and prints each
time beside the bytes written, the operations done and the least time
either would take at the card's published peak.

    python -m weatherconverter_tpu_torch.probes.probe_int8_dot     # on a machine with a CUDA card

The int8 inputs are N(0, 1) bf16 values times 40, clamped to +-127 and
truncated toward zero (`to_int8`). The script's `(x * 40).astype(int8)`
leaves out-of-range values to XLA, which does not define them.
"""

from __future__ import annotations

import sys

import torch

from weatherconverter_tpu_torch.ops import cuda_build
from weatherconverter_tpu_torch.probes import common

B, N, D = 1, 4096, 64
INT8_SCALE = 40.0
HEAD_DIMS = (32, 64, 128)
BLOCK = 64  # N must be a multiple of the kernel's 64 x 64 output tile
# bf16 against its plain version: |err| <= BF16_RTOL * max |S|. Products of
# bf16 values are exact in f32; the tensor cores and cuBLAS add them in other
# orders. int8 is exact in both.
BF16_RTOL = 1e-5


def to_int8(x: torch.Tensor, scale: float = INT8_SCALE) -> torch.Tensor:
    """int8(x * scale), clamped to +-127 and truncated toward zero."""
    return (x.float() * scale).clamp(-127.0, 127.0).to(torch.int8)


def qk_dot_i8_plain(q8: torch.Tensor, k8: torch.Tensor) -> torch.Tensor:
    """int32 Q K^T of int8 (B, N, D) tensors, as an f32 product: every partial
    sum is an integer below 127^2 * D < 2^24 for D <= 1040, so it is exact."""
    with common.full_f32_matmul():
        return torch.matmul(q8.float(), k8.float().transpose(-1, -2)).to(torch.int32)


def qk_dot_bf16_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 Q K^T of bf16 (B, N, D) tensors, in full f32 (no TF32)."""
    with common.full_f32_matmul():
        return torch.matmul(q.float(), k.float().transpose(-1, -2))


def _check(name: str, q: torch.Tensor, k: torch.Tensor, dtype: torch.dtype) -> None:
    if q.device.type != "cuda" or k.device != q.device:
        raise ValueError(f"{name}: the kernel runs on CUDA tensors on one device, got {q.device}, {k.device}")
    if q.dim() != 3 or q.shape != k.shape:
        raise ValueError(f"{name}: q and k must share one (B, N, D) shape, got {tuple(q.shape)}, {tuple(k.shape)}")
    if q.dtype != dtype or k.dtype != dtype:
        raise ValueError(f"{name}: dtype must be {dtype}, got {q.dtype}, {k.dtype}")
    b, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if n % BLOCK != 0 or not 0 < b <= 65535:
        raise ValueError(f"{name}: N={n} must be a multiple of {BLOCK} and B={b} in 1..65535")


def _launch(name: str, fn, q: torch.Tensor, k: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    b, n, d = q.shape
    q, k = q.contiguous(), k.contiguous()
    s = torch.empty((b, n, n), device=q.device, dtype=out_dtype)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), s.data_ptr(), b, n, d, cuda_build.stream(q.device))
    cuda_build.check_launch(name, err)
    return s


def qk_dot_i8(q8: torch.Tensor, k8: torch.Tensor) -> torch.Tensor:
    """K7, int8: (B, N, D) int8 x2 -> (B, N, N) int32. A CPU tensor takes
    `qk_dot_i8_plain`; a CUDA tensor launches the kernel (D in {32, 64,
    128}, N % 64 == 0) or raises."""
    if q8.device.type == "cpu":
        return qk_dot_i8_plain(q8, k8)
    _check("qk_dot_i8", q8, k8, torch.int8)
    s = _launch("qk_dot_i8", cuda_build.library().wc_probe_qk_i8, q8, k8, torch.int32)
    qk_dot_i8.launches += 1
    return s


def qk_dot_bf16(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """K7, bf16: (B, N, D) bf16 x2 -> (B, N, N) f32. A CPU tensor takes
    `qk_dot_bf16_plain`; a CUDA tensor launches the kernel (D in {32, 64,
    128}, N % 64 == 0) or raises. Forward only."""
    common.refuse_grad("qk_dot_bf16", q, k)
    if q.device.type == "cpu":
        return qk_dot_bf16_plain(q, k)
    _check("qk_dot_bf16", q, k, torch.bfloat16)
    s = _launch("qk_dot_bf16", cuda_build.library().wc_probe_qk_bf16, q, k, torch.float32)
    qk_dot_bf16.launches += 1
    return s


qk_dot_i8.launches = 0
qk_dot_bf16.launches = 0


def _inputs(device):
    g = torch.Generator(device=device).manual_seed(0)
    qf, kf = (torch.randn((B, N, D), generator=g, device=device).to(torch.bfloat16) for _ in range(2))
    return qf, kf, to_int8(qf), to_int8(kf)


def check(device) -> float:
    """Both kernels against their plain versions at the probe's shape: int8
    exactly equal, bf16 within BF16_RTOL * max |S|. Returns the largest abs
    error (of bf16; int8's is 0), raises on a disagreement."""
    qf, kf, q8, k8 = _inputs(device)
    s8 = qk_dot_i8(q8, k8)
    torch.cuda.synchronize()
    if not torch.equal(s8, qk_dot_i8_plain(q8, k8)):
        raise AssertionError("qk_dot_i8 differs from its plain version")
    sb = qk_dot_bf16(qf, kf)
    torch.cuda.synchronize()
    ref = qk_dot_bf16_plain(qf, kf)
    err = (sb - ref).abs().max().item()
    bound = BF16_RTOL * ref.abs().max().item()
    if not err <= bound:
        raise AssertionError(f"qk_dot_bf16: max abs err {err} > {bound}")
    return err


def run(device, card: str) -> dict:
    """The probe: each form's time, its bytes and operations, the time at
    the card's peaks, and the int8/bf16 speed-up. Returns the sums of the
    two kernels' and the two plain versions' ms, and each kernel's ms."""
    qf, kf, q8, k8 = _inputs(device)
    t8 = common.time_ms(lambda: qk_dot_i8(q8, k8), reps=15, inner=10)
    tb = common.time_ms(lambda: qk_dot_bf16(qf, kf), reps=15, inner=10)
    p8 = common.time_ms(lambda: qk_dot_i8_plain(q8, k8), reps=5)
    pb = common.time_ms(lambda: qk_dot_bf16_plain(qf, kf), reps=5)
    lib8, libb, libb_why = library_ms(qf, kf, q8, k8)
    ops = 2 * B * N * N * D
    peak = common.peaks(card)
    bounds = []
    for label, ms, in_bytes, rate in (("int8", t8, 1, "int8"), ("bf16", tb, 2, "bf16")):
        written = 4 * B * N * N
        read = 2 * B * N * D * in_bytes
        bounds.append(common.roofline(peak, written + read, **{rate: ops}))
        if peak is None:
            at_peak = "peaks of this card not known"
        else:
            t_bytes = (written + read) / peak["hbm"] * 1e3
            t_ops = ops / peak[rate] * 1e3
            at_peak = (f"at the card's published peaks {t_bytes:.4f} ms for the bytes, {t_ops:.4f} ms for the "
                       f"operations ({'bytes' if t_bytes > t_ops else 'operations'}-bound, "
                       f"{100 * max(t_bytes, t_ops) / ms:.1f}% of that roofline)")
        rate_tbs, rate_tops = (written + read) / (ms * 1e-3) / 1e12, ops / (ms * 1e-3) / 1e12
        common.log(f"  {label}: {written / 2**20:.1f} MiB written, {read / 2**20:.2f} MiB read, "
                   f"{ops / 1e9:.2f} G operations; {rate_tbs:.2f} TB/s, {rate_tops:.1f} TOP/s; {at_peak}")
    common.log(f"int8 QK^T ({B}x{N}x{N}, D={D}): {t8:.4f} ms -- COMPILES AND RUNS [{card}]")
    common.log(f"bf16 QK^T same shape: {tb:.4f} ms")
    common.log(f"speedup int8/bf16: {tb / t8:.2f}x   (plain versions: int8 {p8:.4f} ms, bf16 {pb:.4f} ms)")
    common.log(f"library: torch._int_mm (int8 -> int32) {lib8:.4f} ms; bf16 -> f32 "
               + (f"torch.mm(out_dtype=torch.float32) {libb:.4f} ms" if libb is not None else f"none: {libb_why}"))
    return dict(ms=t8 + tb, plain_ms=p8 + pb, int8_ms=t8, bf16_ms=tb, int8_library_ms=lib8, bf16_library_ms=libb,
                library_ms=None if libb is None else lib8 + libb, **common.add_rooflines(*bounds))


def library_ms(qf, kf, q8, k8) -> tuple[float, float | None, str | None]:
    """The one PyTorch call computing each form on the same inputs, timed as the kernels are (a yardstick the
    port never calls): `torch._int_mm` for int8 -> int32, and `torch.mm(..., out_dtype=torch.float32)` for bf16 ->
    f32 where this torch takes that argument. Returns (int8 ms, bf16 ms or None, why None)."""
    mats = [(q8[i], k8[i].t()) for i in range(B)]
    t8 = common.time_ms(lambda: [torch._int_mm(a, b) for a, b in mats], reps=15, inner=10)
    fmats = [(qf[i], kf[i].t()) for i in range(B)]
    try:
        torch.mm(*fmats[0], out_dtype=torch.float32)
    except (TypeError, RuntimeError) as err:
        return t8, None, f"torch {torch.__version__} has no torch.mm(out_dtype=torch.float32) for bf16 ({err})"
    return t8, common.time_ms(lambda: [torch.mm(a, b, out_dtype=torch.float32) for a, b in fmats], reps=15,
                              inner=10), None


def main() -> int:
    if not common.require_cuda("probe_int8_dot"):
        return 2
    card = common.card_line()
    common.log(card)
    common.log(common.setup())
    device = torch.device("cuda")
    common.log(f"qk_dot_i8 equal to its plain version; qk_dot_bf16 max abs err {check(device):.3e} "
               f"(tol {BF16_RTOL} x max |S|)")
    run(device, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What the micro-probes share: the card line, CUDA-event timing, the card's
published peaks, the probes' backend settings, the forward-only check and
the quality checks' Pearson correlation."""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import sys

import torch

# Published dense peaks (NVIDIA's data sheet) at the full power limit, by a
# substring of the card's name: HBM bytes/s, bf16 FLOP/s, int8 OP/s, TF32
# FLOP/s (half the bf16 rate), f32 FLOP/s outside the tensor cores. The H100
# SXM part's name carries "HBM3".
# `ex2` is the special-function rate (exp2, reciprocal): 16 a clock on each of
# 132 SMs at 1.83 GHz.
PEAKS = {
    "H100 80GB HBM3": dict(hbm=3.35e12, bf16=989e12, int8=1979e12, tf32=494.7e12, f32=67e12, ex2=16 * 132 * 1.83e9),
}


def log(*args):
    print(*args, flush=True)


def pearson(a: torch.Tensor, b: torch.Tensor) -> float:
    """Pearson correlation of two tensors' values, in float64."""
    a, b = a.double().flatten(), b.double().flatten()
    a, b = a - a.mean(), b - b.mean()
    return float((a @ b) / (a.norm() * b.norm()))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(card: str) -> dict | None:
    """The published peaks of the card named in `card`, or None if unknown."""
    return next((v for k, v in PEAKS.items() if k in card), None)


# clocks the device spins before each timed sample (~0.3 ms on an H100)
RUN_AHEAD_CYCLES = 500_000


def time_ms(fn, reps: int, warmup: int = 2, inner: int = 1) -> float:
    """Median device time of one fn() over `reps` samples, each of `inner`
    back-to-back calls between two CUDA events. The device spins
    RUN_AHEAD_CYCLES clocks before the first event of a sample, so the host
    has queued the calls by the time it fires: a launch shorter than its
    wrapper's host time is timed on the device alone."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(RUN_AHEAD_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def require_cuda(name: str) -> bool:
    """True if a CUDA card is present; else say so on stderr and return False."""
    if torch.cuda.is_available():
        return True
    print(f"{name}: no CUDA device; this probe runs on a card and has no CPU mode", file=sys.stderr)
    return False


def _bound(times: dict) -> dict:
    binds = max(times, key=times.get)
    return dict(bound_ms=times[binds] * 1e3, bound_by="bytes" if binds == "hbm" else "operations", binds=binds)


def roofline(peak: dict | None, nbytes: float, **ops: float) -> dict:
    """The least time the card could take: the larger of `nbytes` over its
    memory rate and each count in `ops` (keyed by its rate in PEAKS) over
    that rate. Returns bound_ms, bound_by ("bytes" or "operations") and
    `binds` (the key of the binding rate); all None for an unknown card."""
    if peak is None:
        return dict(bound_ms=None, bound_by=None, binds=None)
    return _bound({"hbm": nbytes / peak["hbm"], **{k: v / peak[k] for k, v in ops.items()}})


def attention_roofline(peak: dict | None, shape, backward: bool = False, qk_int8: bool = False,
                       f32: bool = False) -> dict:
    """`roofline` of one clamped-softmax attention call on 16-bit (B, H, N, D)
    inputs. Forward: Q K^T and P V (2 N^2 D FLOPs a head each; with `qk_int8`
    Q K^T runs at the int8 rate and the two tensor times add; with `f32`, on
    f32 inputs, both in 3xTF32, three TF32 products each, K1-f32's design),
    N^2 exponentials, Q, K, V read and O written. Backward: what the function
    needs, the five products of a one-pass backward (10 N^2 D) and one
    exponential a score (N^2), with Q, K, V, O, dO and l read and dQ, dK, dV
    written; a two-pass backward spends seven products and 2 N^2
    exponentials against this bound. With `f32` the backward's inputs and
    outputs are f32 and each of its five products is three TF32 products
    (K3-f32's design). With `qk_int8` and `f32` (K2-f32, quantizer included:
    f32 Q, K, V read and O written), Q K^T at the int8 rate and P V in
    3xTF32, the two tensor times added."""
    if peak is None:
        return roofline(None, 0)
    b, h, n, d = shape
    bh = b * h
    product = 2 * bh * n * n * d
    ex2 = bh * n * n / peak["ex2"]
    if backward and f32:
        return _bound({"hbm": bh * n * (8 * d * 4 + 4) / peak["hbm"], "tf32x3": 3 * 5 * product / peak["tf32"],
                       "ex2": ex2})
    if backward:
        return _bound({"hbm": bh * n * (8 * d * 2 + 4) / peak["hbm"], "bf16": 5 * product / peak["bf16"], "ex2": ex2})
    if f32 and qk_int8:
        return _bound({"hbm": bh * n * 4 * d * 4 / peak["hbm"],
                       "int8+tf32x3": product / peak["int8"] + 3 * product / peak["tf32"], "ex2": ex2})
    if f32:
        return _bound({"hbm": bh * n * 4 * d * 4 / peak["hbm"], "tf32x3": 3 * 2 * product / peak["tf32"], "ex2": ex2})
    if qk_int8:
        tensor = {"int8+bf16": product / peak["int8"] + product / peak["bf16"]}
    else:
        tensor = {"bf16": 2 * product / peak["bf16"]}
    return _bound({"hbm": bh * n * 4 * d * 2 / peak["hbm"], **tensor, "ex2": ex2})


def f32_fma_ms(peak: dict | None, shape) -> float | None:
    """The time the f32 forward's two products (4 N^2 D FLOPs a head) take
    as f32 FMAs outside the tensor cores: K1-f32's first design's bound,
    kept beside the 3xTF32 one; None for an unknown card."""
    if peak is None:
        return None
    b, h, n, d = shape
    return 4 * b * h * n * n * d / peak["f32"] * 1e3


def quantizer_roofline(peak: dict | None, shape, scales: int = 1, elem_bytes: int = 2) -> dict:
    """`roofline` of quantizing (B, H, N, D) q and k of `elem_bytes` bytes an
    element (2: bf16/f16; 4: f32) to int8 with `scales` f32 score scales (1
    per tensor, B per batch row): each read once and written once as int8,
    and the scales. Bytes bind."""
    b, h, n, d = shape
    return roofline(peak, 2 * b * h * n * d * (elem_bytes + 1) + 4 * scales)


def add_rooflines(*parts: dict) -> dict:
    """The roofline of several calls timed as one sum: the bounds add; the
    sum is bound by whatever binds the largest part."""
    if any(p["bound_ms"] is None for p in parts):
        return dict(bound_ms=None, bound_by=None, binds=None)
    largest = max(parts, key=lambda p: p["bound_ms"])
    return dict(bound_ms=sum(p["bound_ms"] for p in parts), bound_by=largest["bound_by"], binds=largest["binds"])


def setup() -> str:
    """The settings every probe runs under (chip_smoke.py's): full-f32
    matmuls and convolutions, cuDNN's autotuner on. Returns them as a line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    return "settings: cuda.matmul.allow_tf32=False cudnn.allow_tf32=False cudnn.benchmark=True"


@contextlib.contextmanager
def full_f32_matmul():
    """f32 matmuls in full f32 (no TF32) inside the block, whatever the caller set."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """The probes' kernels are forward-only: raise, on every device, for
    inputs that require grad under grad mode, rather than return an output
    that silently carries no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name} is a forward-only probe kernel")

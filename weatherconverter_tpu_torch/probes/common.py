"""What the micro-probes share: the card line, CUDA-event timing, the card's
published peaks, the probes' backend settings and the forward-only check."""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import sys

import torch

# Published dense peaks (NVIDIA's data sheet) at the full power limit, by a
# substring of the card's name: HBM bytes/s, bf16 FLOP/s, int8 OP/s, f32
# FLOP/s outside the tensor cores. The H100 SXM part's name carries "HBM3".
PEAKS = {
    "H100 80GB HBM3": dict(hbm=3.35e12, bf16=989e12, int8=1979e12, f32=67e12),
}


def log(*args):
    print(*args, flush=True)


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


def time_ms(fn, reps: int, warmup: int = 2, inner: int = 1) -> float:
    """Median device time of one fn() over `reps` samples, each of `inner`
    back-to-back calls between two CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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

"""f32 arithmetic on the card, as the CPU computes it.

PyTorch runs cuDNN's f32 convolutions in TF32 by default
(`torch.backends.cudnn.allow_tf32`), which keeps 10 bits of mantissa, and
lets `torch.set_float32_matmul_precision` do the same to matmuls. A run that
asks for f32 (JAX's inference commands, `training.dtype` float32) wants the
f32 result, which the CPU tests hold against JAX's: `f32_arithmetic` turns
TF32 off for both inside its block, on CUDA, and restores the settings after
the last block open in the process has ended.

Both settings are process-wide, not per thread: the server's micro-batchers
run their chains on worker threads, two at once (translate and sample), and
a block opened and closed on one thread must not switch TF32 back on under a
chain still running on another. So the blocks are counted: the first to open
saves and sets, the last to close restores.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_open = 0
_saved: tuple[str, bool] | None = None


@contextlib.contextmanager
def f32_arithmetic(device):
    """Inside the block, f32 work on a CUDA `device` (a torch.device or its
    type name) computes in f32: cuDNN's convolutions without TF32 and matmuls
    at "highest" precision. Nothing changes on the CPU. Blocks nest and may
    overlap across threads (see the module's note)."""
    if torch.device(device).type != "cuda":
        yield
        return
    global _open, _saved
    with _lock:
        if _open == 0:
            _saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
            torch.set_float32_matmul_precision("highest")
            torch.backends.cudnn.allow_tf32 = False
        _open += 1
    try:
        yield
    finally:
        with _lock:
            _open -= 1
            if _open == 0:
                torch.set_float32_matmul_precision(_saved[0])
                torch.backends.cudnn.allow_tf32 = _saved[1]

"""The plain reference of the benchmark: f32 PyTorch with TF32 off, written
apart from the program under test and importing nothing of it."""

import contextlib

import torch


@contextlib.contextmanager
def arithmetic(tf32: bool = False):
    """f32 matmuls and convolutions in full f32 (`tf32` False: the
    reference) or in TF32 (True: the control, one precision below), restored
    after the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

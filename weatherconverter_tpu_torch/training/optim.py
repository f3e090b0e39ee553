"""Optimizers (port of the DDPM half of weatherconverter_tpu/training/optim.py).

`adam` is the reference's Adam(lr) for DDPM training. torch.optim.Adam with
betas (0.9, 0.999) and eps 1e-8 is optax.adam's update: eps is added outside
the square root of the bias-corrected second moment in both. The SGD param
groups and the PolyLR/StepLR schedules of segmentation training come with
that slice.
"""

from __future__ import annotations

from typing import Iterable

import torch


def adam(params: Iterable[torch.nn.Parameter], lr: float = 1e-4) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))

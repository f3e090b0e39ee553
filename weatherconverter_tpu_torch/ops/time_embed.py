"""Sinusoidal timestep embedding (port of weatherconverter_tpu/ops/time_embed.py)."""

from __future__ import annotations

import torch


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) int timesteps -> (B, dim) f32 [sin(t/f), cos(t/f)] with
    f = 10000 ** (arange(dim/2) / (dim/2))."""
    if dim % 2 != 0:
        raise ValueError(f"time embedding dimension must be even, got {dim}")
    half = dim // 2
    factor = 10000.0 ** (torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] / factor[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)

"""Sinusoidal embeddings (port of weatherconverter_tpu/ops/time_embed.py):
`timestep_embedding` of integer timesteps (the DDPM UNet) and
`alpha_plane_embedding` of a scalar per example (the legacy UNet)."""

from __future__ import annotations

import math

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


def alpha_plane_embedding(value: torch.Tensor, image_size: int, dim: int = 32) -> torch.Tensor:
    """(B,) or (B, 1, 1, 1) scalars (the legacy UNet's 1 - alpha_bar[t]) ->
    (B, image_size, image_size, dim) f32, NHWC as in JAX: [sin(2 pi f v),
    cos(2 pi f v)] with f = exp(linspace(log 1, log 1000, dim / 2)),
    broadcast over the plane (an expanded view; the model permutes it).
    The exponents are the f32 grid XLA computes for jnp.linspace(0, log
    1000, dim / 2): i * (log 1000 * (1 / (dim / 2 - 1))), each product and
    the reciprocal rounded to f32, the end point exact (torch.linspace puts
    10 of 16 points one ulp away, and 2 pi * 1000 magnifies that to 1e-3)."""
    half = dim // 2
    f32 = dict(dtype=torch.float32, device=value.device)
    stop = torch.tensor(math.log(1000.0), **f32)
    step = stop * (torch.tensor(1.0, **f32) / torch.tensor(float(half - 1), **f32))
    freqs = torch.exp(torch.cat([torch.arange(half - 1, **f32) * step, stop.reshape(1)]))
    ang = (2.0 * math.pi * freqs) * value.reshape(-1, 1, 1, 1).float()
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)  # (B, 1, 1, dim)
    return emb.expand(emb.shape[0], image_size, image_size, dim)

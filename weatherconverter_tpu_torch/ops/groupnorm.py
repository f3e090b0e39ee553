"""GroupNorm(+SiLU) for NCHW activations (port of weatherconverter_tpu/ops/groupnorm.py).

Plain PyTorch: on the TPU this was XLA's work, not a kernel. The statistics
are single-pass in f32 (sum and sum of squares), the variance is clamped at
0, and gamma/beta fold into one affine, as in the JAX function; torch's
nn.GroupNorm takes a two-pass variance and is not used. The JAX module's
`group_norm_silu` is an alias of this function with silu=True, so it has
no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def group_norm_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    silu: bool = False,
) -> torch.Tensor:
    """Per-sample, per-group statistics over (C/G, H, W); output in x's dtype."""
    n, c, h, w = x.shape
    g = num_groups
    xf = x.float().reshape(n, g, c // g, h * w)
    count = (c // g) * h * w
    s1 = xf.sum(dim=(2, 3), keepdim=True)
    s2 = (xf * xf).sum(dim=(2, 3), keepdim=True)
    mean = s1 / count
    var = (s2 / count - mean * mean).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    scale = inv * gamma.float().reshape(1, g, c // g, 1)
    shift = beta.float().reshape(1, g, c // g, 1) - mean * scale
    out = (xf * scale + shift).reshape(n, c, h, w)
    if silu:
        out = F.silu(out)
    return out.to(x.dtype)

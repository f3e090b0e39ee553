"""Image primitives on NCHW tensors (port of the parts of
weatherconverter_tpu/ops/image.py that guided translation uses)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (align_corners=False), no antialias."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize that samples at half-pixel centres, as
    `jax.image.resize(method="nearest")` does: output index i reads input
    index floor((i + 0.5) * n_in / n_out), so a 2x reduction takes 2i + 1 and
    12 -> 3 takes 2, 6, 10. (`F.interpolate(mode="nearest")` would take 2i.)
    The indices are computed in f32 in JAX's order of operations."""

    def index(n_in: int, n_out: int) -> torch.Tensor:
        centres = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) * n_in / n_out
        return centres.floor().long()

    return x.index_select(2, index(x.shape[2], size[0])).index_select(3, index(x.shape[3], size[1]))


def avg_pool(x: torch.Tensor, window: int, stride: int | None = None) -> torch.Tensor:
    """Average pool over VALID windows."""
    return F.avg_pool2d(x, kernel_size=window, stride=stride or window)


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """AdaptiveAvgPool2d(1): the mean over H and W."""
    return x.mean(dim=(2, 3), keepdim=keepdims)


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth-to-space in torch's channel order (c_out, fh, fw)."""
    return F.pixel_shuffle(x, factor)


def normalize(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Channel-wise (x - mean) / std."""
    m = torch.as_tensor(mean, dtype=x.dtype, device=x.device).reshape(1, -1, 1, 1)
    s = torch.as_tensor(std, dtype=x.dtype, device=x.device).reshape(1, -1, 1, 1)
    return (x - m) / s

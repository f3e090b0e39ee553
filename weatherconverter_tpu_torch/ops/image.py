"""Image primitives on NCHW tensors (port of weatherconverter_tpu/ops/image.py:
the parts that guided translation uses, and `center_crop` and `denormalize`).

The four resampling and pooling helpers take part in torch's function
override protocol (`handle_torch_function`), so that a TorchFunctionMode
can run them another way: parallel.spatial.SpatialContext computes them on
maps split along H. Without such a mode they are the plain calls below.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function_unary


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (align_corners=False), no antialias."""
    if has_torch_function_unary(x):
        return handle_torch_function(resize_bilinear, (x,), x, size)
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize that samples at half-pixel centres, as
    `jax.image.resize(method="nearest")` does: output index i reads input
    index floor((i + 0.5) * n_in / n_out), so a 2x reduction takes 2i + 1 and
    12 -> 3 takes 2, 6, 10. (`F.interpolate(mode="nearest")` would take 2i.)
    The indices are computed in f32 in JAX's order of operations."""
    if has_torch_function_unary(x):
        return handle_torch_function(resize_nearest, (x,), x, size)

    def index(n_in: int, n_out: int) -> torch.Tensor:
        centres = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) * n_in / n_out
        return centres.floor().long()

    return x.index_select(2, index(x.shape[2], size[0])).index_select(3, index(x.shape[3], size[1]))


def avg_pool(x: torch.Tensor, window: int, stride: int | None = None) -> torch.Tensor:
    """Average pool over VALID windows."""
    if has_torch_function_unary(x):
        return handle_torch_function(avg_pool, (x,), x, window, stride)
    return F.avg_pool2d(x, kernel_size=window, stride=stride or window)


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """AdaptiveAvgPool2d(1): the mean over H and W."""
    if has_torch_function_unary(x):
        return handle_torch_function(global_avg_pool, (x,), x, keepdims)
    return x.mean(dim=(2, 3), keepdim=keepdims)


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth-to-space in torch's channel order (c_out, fh, fw)."""
    return F.pixel_shuffle(x, factor)


def normalize(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Channel-wise (x - mean) / std."""
    m = torch.as_tensor(mean, dtype=x.dtype, device=x.device).reshape(1, -1, 1, 1)
    s = torch.as_tensor(std, dtype=x.dtype, device=x.device).reshape(1, -1, 1, 1)
    return (x - m) / s


def denormalize(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Channel-wise x * std + mean: the inverse of `normalize`."""
    m = torch.as_tensor(mean, dtype=x.dtype, device=x.device).reshape(1, -1, 1, 1)
    s = torch.as_tensor(std, dtype=x.dtype, device=x.device).reshape(1, -1, 1, 1)
    return x * s + m


def center_crop(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """The centre (th, tw) window of (N, C, H, W) `x`, a view. torchvision's
    CenterCrop offset, int(round((in - out) / 2)), with Python's rounding of
    halves to even, as the JAX op takes it: one pixel less than
    (in - out + 1) // 2 where (in - out) % 4 == 1, and one more than
    (in - out) // 2 where it is 3."""
    th, tw = size
    top = int(round((x.shape[2] - th) / 2.0))
    left = int(round((x.shape[3] - tw) / 2.0))
    return x[:, :, top:top + th, left:left + tw]

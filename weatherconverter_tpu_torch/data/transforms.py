"""Batched on-device augmentation for DDPM training (port of the diffusion
subset of weatherconverter_tpu/data/transforms.py).

Images are (B, H, W, C), the JAX package's NHWC layout, on the device the
train step runs on. Random offsets and flips are drawn from a
`torch.Generator` on that device; `offsets=` and `flip=` take them
explicitly instead, so a test can replay the JAX draws.

  to_float               <- ToTensor without the layout change
  to_diffusion_range     <- Lambda(x * 2 - 1)
  random_crop            <- RandomCrop, one offset per example
  random_hflip           <- RandomHorizontalFlip(p), one draw per example
  diffusion_train_augment <- RandomCrop -> RandomHorizontalFlip -> [0,1] -> [-1,1]
"""

from __future__ import annotations

from typing import Optional

import torch


def to_float(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1]."""
    return x.float() / 255.0


def to_diffusion_range(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1]."""
    return x * 2.0 - 1.0


def random_crop(
    images: torch.Tensor,
    size: tuple[int, int],
    generator: Optional[torch.Generator] = None,
    offsets: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """(B, H, W, C) -> (B, th, tw, C), example i cropped at rows
    ys[i] .. ys[i] + th and columns xs[i] .. xs[i] + tw, with (ys, xs) drawn
    uniformly from the valid range or given as `offsets`."""
    b, h, w = images.shape[:3]
    th, tw = size
    if th > h or tw > w:
        raise ValueError(
            f"random_crop {size} exceeds image extent {(h, w)}: resize the source larger or pad "
            "first (torchvision RandomCrop raises here too)"
        )
    dev = images.device
    if offsets is None:
        ys = torch.randint(0, h - th + 1, (b,), generator=generator, device=dev)
        xs = torch.randint(0, w - tw + 1, (b,), generator=generator, device=dev)
    else:
        ys, xs = (torch.as_tensor(o, device=dev).long() for o in offsets)
    rows = (ys[:, None] + torch.arange(th, device=dev))[:, :, None]  # (B, th, 1)
    cols = (xs[:, None] + torch.arange(tw, device=dev))[:, None, :]  # (B, 1, tw)
    return images[torch.arange(b, device=dev)[:, None, None], rows, cols]


def random_hflip(
    images: torch.Tensor,
    p: float = 0.5,
    generator: Optional[torch.Generator] = None,
    flip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flip example i left-right where flip[i]; flip ~ U[0, 1) < p unless given."""
    if flip is None:
        flip = torch.rand((images.shape[0],), generator=generator, device=images.device) < p
    flip = torch.as_tensor(flip, device=images.device).bool()
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def diffusion_train_augment(
    images_u8: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    crop: int = 128,
    *,
    offsets: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    flip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The DDPM train transform: uint8 (B, H, W, C) -> random crop (crop,
    crop) -> random horizontal flip (p 0.5) -> [-1, 1] f32. Crop and flip
    move uint8 values, so they run before the conversion, on a quarter of
    the bytes; the result is the JAX chain's."""
    x = random_crop(images_u8, (crop, crop), generator, offsets)
    x = random_hflip(x, 0.5, generator, flip)
    return to_diffusion_range(to_float(x))

"""Image grids, process strips and PNG output (port of
weatherconverter_tpu/utils/images.py).

`to_uint8_image`, `make_grid`, `save_images` and `save_strip` take NHWC (or
HWC) images as torch tensors or numpy arrays and do their arithmetic in
numpy f32, the JAX module's order of operations, so the bytes of a saved PNG
equal the JAX package's for the same values. PIL is used only at the file
boundary. `forward_process_strip`, `backward_process_strip` and
`augmentation_galleries` are the `visualize` command's panels (reference:
visualizer.py:39-109, 160-191).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _f32(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def to_uint8_image(x, from_range: str = "pm1") -> np.ndarray:
    """(H, W, C) or (B, H, W, C) float -> uint8, truncated. from_range: 'pm1'
    ([-1, 1], the diffusion convention) or 'unit' ([0, 1])."""
    x = _f32(x)
    if from_range == "pm1":
        x = (np.clip(x, np.float32(-1.0), np.float32(1.0)) + np.float32(1.0)) / np.float32(2.0)
    else:
        x = np.clip(x, np.float32(0.0), np.float32(1.0))
    return (x * np.float32(255.0)).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 4, pad: int = 2) -> np.ndarray:
    """(B, H, W, C) uint8 -> one tiled image, `nrow` images a row, `pad`
    black pixels around each (torchvision's make_grid layout)."""
    b, h, w, c = images.shape
    rows = (b + nrow - 1) // nrow
    grid = np.zeros((rows * (h + pad) + pad, nrow * (w + pad) + pad, c), dtype=np.uint8)
    for i in range(b):
        r, col = divmod(i, nrow)
        y, x = r * (h + pad) + pad, col * (w + pad) + pad
        grid[y:y + h, x:x + w] = images[i]
    return grid


def save_images(images, path: str, nrow: int = 4, from_range: str = "pm1") -> str:
    """Save a batch (or one image) as one PNG grid at `path`; returns the path."""
    from PIL import Image

    arr = to_uint8_image(images, from_range)
    if arr.ndim == 3:
        arr = arr[None]
    grid = make_grid(arr, nrow=nrow)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(grid.squeeze()).save(path)
    return path


def forward_process_strip(sched, x0: torch.Tensor, generator=None, every: int = 100,
                          noise=None) -> torch.Tensor:
    """Snapshots of q(x_t | x_0) at t = 0, every, 2 every, ... < T of one
    image x0 (H, W, C), all with one N(0, I) draw from the generator (or
    `noise` (H, W, C) replayed). Returns (S, H, W, C) on x0's device."""
    from weatherconverter_tpu_torch.diffusion.schedule import q_sample

    x0 = torch.as_tensor(x0, dtype=torch.float32)
    ts = torch.arange(0, sched.T, every, device=x0.device)
    if noise is None:
        noise = torch.randn(tuple(x0.shape), generator=generator, device=x0.device)
    noise = torch.as_tensor(noise, dtype=torch.float32).to(x0.device)
    frames = x0[None].expand(len(ts), *x0.shape)
    return q_sample(sched, frames, noise[None].expand_as(frames), ts)


def backward_process_strip(traj, index: int = 0):
    """One sample's reverse-trajectory snapshots, (S, H, W, C), from a
    sampler run with return_trajectory_every=k (its frames (S, B, H, W, C))."""
    return traj[:, index]


def save_strip(images, path: str, from_range: str = "pm1") -> str:
    """Save a (S, H, W, C) strip as one PNG row; returns the path."""
    from PIL import Image

    arr = to_uint8_image(images, from_range)
    s, h, w, c = arr.shape
    row = arr.transpose(1, 0, 2, 3).reshape(h, s * w, c)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(row.squeeze()).save(path)
    return path


def augmentation_galleries(image, generator=None, *, factors=None) -> dict:
    """The photometric and geometric augmentation galleries of one image
    (H, W, 3) in [0, 1], each a (5, H, W, 3) strip led by the original, built
    from the training pipelines' own transforms: brightness, contrast and
    saturation jitter at 0.5 and hue at 0.3 (draws from the generator, or
    `factors` = (brightness, contrast, saturation, hue), each (1,),
    replayed), and the affine at 30 degrees, a (0.2, 0.2) shift, scale 1.5
    and a 50 degree shear."""
    from weatherconverter_tpu_torch.data.transforms import apply_affine, color_jitter, hue_jitter

    x = torch.as_tensor(image, dtype=torch.float32)[None]
    if factors is None:
        jitter, hue = [None] * 3, None
    else:
        fb, fc, fs, hue = (torch.as_tensor(f, dtype=torch.float32, device=x.device) for f in factors)
        one = torch.ones(1, device=x.device)
        jitter = [(fb, one, one), (one, fc, one), (one, one, fs)]
    photo = [x] + [color_jitter(x, *amp, generator=generator, factors=f)
                   for amp, f in zip(((0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.0, 0.0, 0.5)), jitter)]
    photo.append(hue_jitter(x, 0.3, generator, factor=hue))
    geo = [x] + [apply_affine(x, **kw)[0] for kw in (dict(angle=30.0), dict(translate=(0.2, 0.2)), dict(scale=1.5),
                                                       dict(shear=50.0))]
    return {"photometric": torch.cat(photo, dim=0), "geometric": torch.cat(geo, dim=0)}

"""Image grids and PNG output (port of the grid half of
weatherconverter_tpu/utils/images.py).

`to_uint8_image`, `make_grid` and `save_images` take NHWC (or HWC) images as
torch tensors or numpy arrays and do their arithmetic in numpy f32, the JAX
module's order of operations, so the bytes of a saved PNG equal the JAX
package's for the same values. PIL is used only at the file boundary. The
forward/backward process strips and the augmentation galleries come with the
`visualize` command (ROADMAP Queue 1 item 19).
"""

from __future__ import annotations

import os

import numpy as np


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

"""Tensor dumps for a chain's intermediates (port of
weatherconverter_tpu/utils/debug.py): the counterpart of the original
code's `debug_tensor` (translation.py:17-39) and its per-step chain dumps
(translation.py:58-92). `translate --debug-dir` runs the guided chain in
segments (guidance/translate.sample_with_sgg's xt_init / t_offset,
bit-identical to one call) and dumps the latent between them.

numpy and PIL only; torch tensors are copied to the host first.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _host(arr) -> np.ndarray:
    if hasattr(arr, "detach"):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def debug_tensor(arr, path: str, title: Optional[str] = None, from_range: str = "pm1") -> str:
    """Print shape, min, max and dtype of `arr` and save a picture of it at
    `path`: an integer (H, W) or (B, H, W) label map of train ids colorized
    with the Cityscapes palette (255 black), a float (H, W, C) or (B, H, W,
    C) image with C in (1, 3) clamped from `from_range` ('pm1' or 'unit')
    and tiled four a row; anything else as an .npy file beside `path`.
    Returns the path written."""
    from PIL import Image

    from weatherconverter_tpu_torch.data.labels import decode_target
    from weatherconverter_tpu_torch.utils.images import make_grid, to_uint8_image

    x = _host(arr)
    if title:
        print(title)
    print(f"Tensor shape: {tuple(x.shape)}")
    if x.size:
        print(f"Tensor min: {x.min()}")
        print(f"Tensor max: {x.max()}")
    print(f"Tensor dtype: {x.dtype}")

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    is_label = np.issubdtype(x.dtype, np.integer) or np.issubdtype(x.dtype, np.bool_)
    if is_label and x.ndim in (2, 3):
        print(f"Tensor unique values: {np.unique(x).tolist()[:32]}")
        rgb = decode_target(x)
        if rgb.ndim == 3:
            rgb = rgb[None]
        grid = make_grid(rgb.astype(np.uint8), nrow=min(4, rgb.shape[0]))
        Image.fromarray(grid).save(path)
    elif not is_label and x.ndim in (3, 4) and x.shape[-1] in (1, 3):
        arr8 = to_uint8_image(x.astype(np.float32), from_range)
        if arr8.ndim == 3:
            arr8 = arr8[None]
        grid = make_grid(arr8, nrow=min(4, arr8.shape[0]))
        Image.fromarray(grid.squeeze()).save(path)
    else:
        path = os.path.splitext(path)[0] + ".npy"
        np.save(path, x)

    print(f"Image saved to {path}")
    print("-" * 50)
    return path

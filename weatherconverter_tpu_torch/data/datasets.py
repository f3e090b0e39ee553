"""Filesystem dataset of the diffusion flavour: an image glob.

Port of `DiffusionImageDataset`, `load_image_resized` and `_glob_images`
from weatherconverter_tpu/data/datasets.py, with the same discovery rules:
{root}/{condition}/{train,val,test}/**/*.jpg|png, recursively, sorted within
each folder, plus BDD/DAWN-style trees merged by `add_images`. Decoding is
numpy and PIL on the host; the random crop, flip and [-1, 1] scaling run on
the device (data/transforms.py). The JAX package's optional C++ decoder has
no port: every image goes through PIL, its documented fallback. The paired
image+label dataset of the segmentation flavour comes with segmentation
training.

PIL is imported here, so import this module where a dataset is built
(`training.loop_diffusion.build_dataset`), not at package import.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image


def _glob_images(folder: str) -> list[str]:
    """Recursive *.jpg/*.png discovery (the '*.[jp][pn]g' character-class pattern)."""
    pattern = os.path.join(folder, "**", "*.[jp][pn]g")
    return sorted(glob.glob(pattern, recursive=True))


def load_image_resized(
    path: str, smaller_side: int, out_wh: Optional[tuple[int, int]] = None
) -> np.ndarray:
    """Decode and resize bilinearly with the smaller side pinned and the
    aspect kept (torchvision Resize(int) semantics). With `out_wh` = (H, W),
    also center-crop or edge-pad to that fixed box, so batches stack.
    Returns HWC uint8."""
    img = Image.open(path).convert("RGB")
    w, h = img.size
    if h <= w:
        nh, nw = smaller_side, max(1, round(w * smaller_side / h))
    else:
        nw, nh = smaller_side, max(1, round(h * smaller_side / w))
    img = img.resize((nw, nh), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.uint8)
    if out_wh is None:
        return arr
    th, tw = out_wh
    # center-crop any excess, edge-pad any deficit (rare: near-square inputs)
    y0 = max(0, (arr.shape[0] - th) // 2)
    x0 = max(0, (arr.shape[1] - tw) // 2)
    arr = arr[y0 : y0 + th, x0 : x0 + tw]
    pad_h, pad_w = th - arr.shape[0], tw - arr.shape[1]
    if pad_h or pad_w:
        arr = np.pad(arr, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
    return arr


class DiffusionImageDataset:
    """Image-only dataset: HWC uint8 at the fixed pre-crop box (`resize_to`,
    round(`resize_to` * `aspect`)), out of which the train step takes its
    random square crop on the device."""

    def __init__(
        self,
        root_dir: str,
        selected_conditions: Sequence[str] = ("rain", "fog", "night"),
        splits: Sequence[str] = ("train", "val", "test"),
        resize_to: int = 128,
        aspect: float = 16 / 9,
    ):
        self.root_dir = root_dir
        self.selected_conditions = list(selected_conditions)
        self.resize_to = resize_to
        self.out_wh = (resize_to, int(round(resize_to * aspect)))
        self.img_paths: list[str] = []
        for condition in self.selected_conditions:
            for split in splits:
                self.img_paths.extend(_glob_images(os.path.join(root_dir, condition, split)))

    def add_images(self, image_dir: str) -> None:
        """Merge a BDD/DAWN-style tree: {dir}/{condition}/**.png."""
        for condition in self.selected_conditions:
            self.img_paths.extend(_glob_images(os.path.join(image_dir, condition)))

    def __len__(self) -> int:
        return len(self.img_paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        return load_image_resized(self.img_paths[idx], self.resize_to, self.out_wh)

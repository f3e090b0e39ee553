"""Filesystem datasets: an image glob (diffusion) and image+label pairs
(segmentation).

Port of `DiffusionImageDataset`, `SegPairedDataset`, `load_image_resized`,
`load_image_exact` and `_glob_images` from
weatherconverter_tpu/data/datasets.py, with the same discovery rules:
{root}/{condition}/{train,val,test}/**/*.jpg|png, recursively, sorted within
each folder, plus BDD/DAWN-style trees merged by `add_images`; and the ACDC
pairs {root}/{images}/{condition}/{split}/**/*_rgb_anon.* with
{root}/{labels}/.../*_gt_labelIds.*. Decoding is numpy and PIL on the host;
the random crops, flips, jitter and the rest run on the device
(data/transforms.py). As in JAX, images take the native C++ decoder first
(data/native.py: `__getitem__` one file, `get_batch` a whole batch on C++
threads) and PIL where it is unavailable; labels always go through PIL with
NEAREST (ids are never interpolated, and the native decoder makes RGB).

PIL is imported here, so import this module where a dataset is built
(`training.loop_diffusion.build_dataset`,
`training.loop_segmentation.build_datasets`), not at package import.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from weatherconverter_tpu_torch.data.labels import encode_target


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


def load_image_exact(path: str, hw: tuple[int, int], resample=Image.BILINEAR) -> np.ndarray:
    """Decode as RGB and resize to exactly (H, W) = `hw`; HWC uint8."""
    img = Image.open(path).convert("RGB")
    return np.array(img.resize((hw[1], hw[0]), resample), dtype=np.uint8)


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
        from weatherconverter_tpu_torch.data import native

        arr = native.decode_box(self.img_paths[idx], self.resize_to, self.out_wh)
        if arr is not None:
            return arr
        return load_image_resized(self.img_paths[idx], self.resize_to, self.out_wh)

    def get_batch(self, indices) -> Optional[np.ndarray]:
        """The batch fast path (data/loader.py): one native call decodes every
        file on C++ threads. None when the native decoder is unavailable, so
        the loader decodes the batch on its thread pool instead."""
        from weatherconverter_tpu_torch.data import native

        return native.decode_box_batch([self.img_paths[i] for i in indices], self.resize_to, self.out_wh)


class SegPairedDataset:
    """ACDC image+label pairs: (HWC uint8 image, HW uint8 train-id label),
    both at `resize_hw`, the image bilinear and the label NEAREST (ids are
    never interpolated), the label encoded from labelIds to train-ids."""

    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        weather: Sequence[str] | str = "all",
        images_dir: str = "rgb_anon",
        labels_dir: str = "gt",
        resize_hw: tuple[int, int] = (270, 480),
    ):
        self.root_dir = Path(root_dir)
        self.resize_hw = resize_hw
        if weather == "all":
            conditions = ["fog", "night", "rain", "snow"]
        elif isinstance(weather, str):
            conditions = [weather]  # a bare condition name, not its characters
        else:
            conditions = list(weather)
        self.image_paths: list[Path] = []
        self.label_paths: list[Path] = []
        for condition in conditions:
            rgb_dir = self.root_dir / images_dir / condition / split
            gt_dir = self.root_dir / labels_dir / condition / split
            for image_path in sorted(rgb_dir.glob("**/*_rgb_anon.*")):
                rel = image_path.relative_to(rgb_dir)
                label_path = gt_dir / rel.parent / image_path.name.replace("_rgb_anon", "_gt_labelIds")
                if label_path.exists():
                    self.image_paths.append(image_path)
                    self.label_paths.append(label_path)

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        from weatherconverter_tpu_torch.data import native

        h, w = self.resize_hw
        img = native.decode_exact(str(self.image_paths[idx]), (h, w))
        if img is None:
            img = load_image_exact(str(self.image_paths[idx]), (h, w))
        lbl = Image.open(self.label_paths[idx]).resize((w, h), Image.NEAREST)
        return img, encode_target(np.asarray(lbl, dtype=np.uint8))

"""The one generator of inputs: every traffic file's parameters become
tensors here, on the device, from the seed. Nothing is read from disk.

- `images`: (B, H, W, 3) f32 in [-1, 1], smooth scenes: a coarse N(0, 1)
  field (one value per `coarse` pixels) upsampled bilinearly, plus fine
  N(0, 0.1) detail, squashed by tanh.
- `labels`: (B, L, L) int64 train-ids: `regions` seed points a label, each
  the centre of a Voronoi cell; the first `present` cells take the image's
  `present` classes (drawn without replacement from `num_classes`), the rest
  a class of those at random, and `ignore_regions` more points mark cells of
  255 (ignored). Every one of the `present` classes has a cell.
- `raw_images`: (B, H, W, 3) uint8, uniform over 0..255, as a decoder hands
  the train step its batches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def images(p: dict, gen: torch.Generator, device) -> torch.Tensor:
    b, h, w = p["batch"], p["image_size"], p["image_size"]
    coarse = max(1, int(p.get("coarse", 16)))
    low = torch.randn((b, 3, -(-h // coarse), -(-w // coarse)), generator=gen, device=device)
    x = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    x = x + 0.1 * torch.randn((b, 3, h, w), generator=gen, device=device)
    return torch.tanh(x).permute(0, 2, 3, 1).contiguous()


def labels(p: dict, gen: torch.Generator, device) -> torch.Tensor:
    b, size, k, n_cls = p["batch"], p["label_size"], p["present"], p["num_classes"]
    regions, ignore = p["regions"], p.get("ignore_regions", 0)
    if regions < k:
        raise ValueError(f"{regions} regions cannot hold {k} classes")
    classes = torch.rand((b, n_cls), generator=gen, device=device).argsort(dim=1)[:, :k]  # (B, k) distinct
    pick = torch.randint(0, k, (b, regions), generator=gen, device=device)
    pick[:, :k] = torch.arange(k, device=device)
    ids = classes.gather(1, pick)  # (B, regions): every present class has a cell
    ids = torch.cat([ids, torch.full((b, ignore), 255, dtype=ids.dtype, device=device)], dim=1)
    points = torch.rand((b, regions + ignore, 2), generator=gen, device=device) * size
    coords = torch.arange(size, device=device, dtype=torch.float32) + 0.5
    dy = (coords[None, None, :] - points[:, :, 0:1]) ** 2  # (B, P, L)
    dx = (coords[None, None, :] - points[:, :, 1:2]) ** 2
    nearest = (dy[:, :, :, None] + dx[:, :, None, :]).argmin(dim=1)  # (B, L, L)
    return ids.gather(1, nearest.reshape(b, -1)).reshape(b, size, size).long()


def raw_images(p: dict, gen: torch.Generator, device) -> torch.Tensor:
    shape = (p["batch"], p["raw_height"], p["raw_width"], 3)
    return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)

"""Batched on-device augmentation for DDPM and segmentation training (port
of weatherconverter_tpu/data/transforms.py but its geometric legs).

Images are (B, H, W, C), the JAX package's NHWC layout, labels (B, H, W)
train-ids, on the device the train step runs on. Every random function
draws from a `torch.Generator` on that device, or takes its draws
explicitly (`offsets=`, `flip=`, `factors=`, `std=`/`noise=`,
`apply=`/`gumbel=`, `SegDraws`), so a test can replay the JAX draws. Paired
transforms move image and label together; labels are never interpolated,
and what a transform blanks out gets label 255 (ignore), never 0 (road).

  to_float               <- ToTensor without the layout change
  to_diffusion_range     <- Lambda(x * 2 - 1)
  random_crop            <- RandomCrop / ExtRandomCrop, one offset per example
  random_hflip           <- (Ext)RandomHorizontalFlip(p), one draw per example
  random_vflip           <- ExtRandomVerticalFlip(p)
  color_jitter           <- ExtColorJitter(brightness, contrast, saturation)
  add_gaussian_noise     <- AddGaussianNoise(mean, std_range)
  class_wise_masking     <- ClassWiseMasking(p, num_classes_to_keep)
  normalize              <- ExtNormalize
  diffusion_train_augment <- RandomCrop -> RandomHorizontalFlip -> [0,1] -> [-1,1]
  seg_train_augment      <- crop -> hflip -> jitter -> noise -> masking -> normalize
  seg_eval_preprocess    <- center crop -> normalize

The geometric legs of the seg chain (random_scale_crop, random_rotation,
hue_jitter, pad_to_multiple, apply_affine) are off in the shipped config and
not ported yet (ROADMAP Queue 1 item 13); seg_train_augment refuses them by
name.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import torch

# The train-ids ClassWiseMasking may keep (road, building, traffic light,
# traffic sign, vegetation, terrain, sky, person, car, truck, bus, motorcycle,
# bicycle), and its fallback pool: every train-id and the 255 bucket
# (weatherconverter_tpu/data/transforms.py:34-45)
CLASSWISE_ALLOWED = (0, 2, 6, 7, 8, 9, 10, 11, 13, 14, 15, 17, 18)
CLASSWISE_CANDIDATES = tuple(range(19)) + (255,)


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
    labels: Optional[torch.Tensor] = None,
):
    """(B, H, W, C) -> (B, th, tw, C), example i cropped at rows
    ys[i] .. ys[i] + th and columns xs[i] .. xs[i] + tw, with (ys, xs) drawn
    uniformly from the valid range or given as `offsets`. With `labels`
    (B, H, W), returns (images, labels) cut at the same offsets."""
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
    index = (torch.arange(b, device=dev)[:, None, None], rows, cols)
    return images[index] if labels is None else (images[index], labels[index])


def _random_flip(images, dim, p, generator, flip, labels):
    """Flip example i along image dim `dim` (1 rows, 2 columns) where flip[i];
    flip ~ U[0, 1) < p unless given; labels (B, H, W) with it."""
    if flip is None:
        flip = torch.rand((images.shape[0],), generator=generator, device=images.device) < p
    flip = torch.as_tensor(flip, device=images.device).bool()
    out = torch.where(flip[:, None, None, None], images.flip(dim), images)
    return out if labels is None else (out, torch.where(flip[:, None, None], labels.flip(dim), labels))


def random_hflip(
    images: torch.Tensor,
    p: float = 0.5,
    generator: Optional[torch.Generator] = None,
    flip: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
):
    """Flip example i left-right where flip[i]; flip ~ U[0, 1) < p unless given."""
    return _random_flip(images, 2, p, generator, flip, labels)


def random_vflip(
    images: torch.Tensor,
    p: float = 0.5,
    generator: Optional[torch.Generator] = None,
    flip: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
):
    """Flip example i upside down where flip[i]; flip ~ U[0, 1) < p unless given."""
    return _random_flip(images, 1, p, generator, flip, labels)


def _uniform(shape, lo, hi, generator, device):
    return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo


def _gray(x: torch.Tensor) -> torch.Tensor:
    return 0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]


def color_jitter(
    images: torch.Tensor,
    brightness: float = 0.2,
    contrast: float = 0.2,
    saturation: float = 0.2,
    generator: Optional[torch.Generator] = None,
    factors: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Per-example brightness, contrast (about the image's gray mean) and
    saturation (about each pixel's gray) in that order, then a clip to
    [0, 1]; each factor ~ U[max(0, 1 - a), 1 + a], torchvision's semantics,
    or `factors` = (brightness, contrast, saturation), each (B,). A factor
    whose amplitude is 0 is skipped. Images f32 in [0, 1]."""
    b = images.shape[0]
    if factors is None:
        factors = [_uniform((b,), max(0.0, 1.0 - a), 1.0 + a, generator, images.device)
                   for a in (brightness, contrast, saturation)]
    fb, fc, fs = (torch.as_tensor(f, device=images.device).reshape(b, 1, 1, 1) for f in factors)
    out = images
    if brightness:
        out = out * fb
    if contrast:
        mean = _gray(out).mean(dim=(1, 2), keepdim=True)
        out = (out - mean) * fc + mean
    if saturation:
        gray = _gray(out)
        out = (out - gray) * fs + gray
    return out.clamp(0.0, 1.0)


def add_gaussian_noise(
    images: torch.Tensor,
    mean: float = 0.1,
    std_range: tuple[float, float] = (0.0, 0.05),
    generator: Optional[torch.Generator] = None,
    std: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """images + (N(0, 1) * std + mean), clipped to [0, 1]: std ~ U[std_range]
    per example and the standard normal `noise` of the images' shape, drawn
    or given. The mean is an additive offset, as in AddGaussianNoise."""
    b, dev = images.shape[0], images.device
    if std is None:
        std = _uniform((b,), std_range[0], std_range[1], generator, dev)
    if noise is None:
        noise = torch.randn(images.shape, generator=generator, device=dev)
    std = torch.as_tensor(std, device=dev).reshape(b, 1, 1, 1)
    return (images + (torch.as_tensor(noise, device=dev) * std + mean)).clamp(0.0, 1.0)


def class_wise_masking(
    images: torch.Tensor,
    labels: torch.Tensor,
    p: float = 0.1,
    num_classes_to_keep: int = 1,
    allowed: Sequence[int] = CLASSWISE_ALLOWED,
    ignore_index: int = 255,
    generator: Optional[torch.Generator] = None,
    apply: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
):
    """ClassWiseMasking: with probability p per example (`apply`), keep
    `num_classes_to_keep` classes drawn without replacement from the allowed
    classes present in the label (all present classes when fewer allowed
    ones are), black out every other pixel and label it `ignore_index`.
    The draw is a Gumbel top-k over CLASSWISE_CANDIDATES: `gumbel` (B, 20)
    scores -log(-log(u)), u ~ U[1e-6, 1), drawn or given. Labels are uint8
    train-ids (0-18 and 255)."""
    b, dev = images.shape[0], images.device
    cand = _constant(CLASSWISE_CANDIDATES, torch.int64, dev)
    flat = labels.reshape(b, -1).long()
    present = torch.zeros((b, 256), dtype=torch.bool, device=dev).scatter_(1, flat, True)[:, cand]
    is_allowed = torch.isin(cand, _constant(tuple(allowed), torch.int64, dev))
    allowed_present = present & is_allowed
    fallback = allowed_present.sum(1) < num_classes_to_keep
    pool = torch.where(fallback[:, None], present, allowed_present)
    if apply is None:
        apply = torch.rand((b,), generator=generator, device=dev) < p
    if gumbel is None:
        gumbel = -torch.log(-torch.log(_uniform((b, cand.numel()), 1e-6, 1.0, generator, dev)))
    scores = torch.where(pool, torch.as_tensor(gumbel, device=dev), float("-inf"))
    # a -inf pick (a pool smaller than k) names a class with no pixels
    kept = cand[scores.topk(num_classes_to_keep, dim=1).indices]  # (B, k)
    keep_lut = torch.zeros((b, 256), dtype=torch.bool, device=dev).scatter_(1, kept, True)
    keep = keep_lut.gather(1, flat).reshape(labels.shape)
    keep = keep | ~torch.as_tensor(apply, device=dev).bool()[:, None, None]
    return images * keep[..., None].to(images.dtype), torch.where(keep, labels, ignore_index).to(labels.dtype)


def normalize(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Channel-last (x - mean) / std."""
    return (x - _constant(tuple(mean), x.dtype, x.device)) / _constant(tuple(std), x.dtype, x.device)


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant tensor, copied to `device` once: a copy from the host
    inside the train step would make the host wait for it every step."""
    return torch.tensor(values, dtype=dtype, device=device)


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


class SegDraws(NamedTuple):
    """The draws of one seg_train_augment call, in the JAX chain's order:
    crop offsets (ys, xs), flip (B,), jitter factors (brightness, contrast,
    saturation), noise std (B,) and noise (B, th, tw, C), masking's apply
    (B,) and Gumbel scores (B, 20)."""

    offsets: tuple
    flip: torch.Tensor
    jitter: tuple
    noise_std: torch.Tensor
    noise: torch.Tensor
    mask_apply: torch.Tensor
    gumbel: torch.Tensor


def seg_train_augment(
    images_u8: torch.Tensor,
    labels: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    crop: tuple[int, int] = (256, 256),
    hflip_p: float = 0.5,
    jitter: tuple[float, float, float] = (0.2, 0.2, 0.2),
    noise_mean: float = 0.1,
    noise_std_range: tuple[float, float] = (0.0, 0.05),
    masking_p: float = 0.1,
    num_classes_to_keep: int = 1,
    mean: Sequence[float] = (0.485, 0.456, 0.406),
    std: Sequence[float] = (0.229, 0.224, 0.225),
    scale_range: Optional[tuple[float, float]] = None,
    rotation_degrees: float = 0.0,
    hue: float = 0.0,
    *,
    draws: Optional[SegDraws] = None,
):
    """The seg train chain on uint8 (B, H, W, C) images and (B, H, W)
    train-id labels: random crop -> hflip -> color jitter -> gaussian noise
    -> class-wise masking -> ImageNet normalize; returns (f32 images,
    labels). Crop and flip move uint8 values, so they run before the
    conversion to f32. `draws` replays given draws instead of the generator."""
    for name, value in (("scale_range", scale_range), ("rotation_degrees", rotation_degrees), ("hue", hue)):
        if value:
            raise NotImplementedError(f"seg_train_augment: {name}={value!r} needs the geometric legs of the seg "
                                      "augment, which are ROADMAP Queue 1 item 13, not ported yet")
    d = draws
    x, y = random_crop(images_u8, crop, generator, None if d is None else d.offsets, labels=labels)
    x, y = random_hflip(x, hflip_p, generator, None if d is None else d.flip, labels=y)
    x = color_jitter(to_float(x), *jitter, generator=generator, factors=None if d is None else d.jitter)
    x = add_gaussian_noise(x, noise_mean, noise_std_range, generator,
                           *((None, None) if d is None else (d.noise_std, d.noise)))
    x, y = class_wise_masking(x, y, masking_p, num_classes_to_keep, generator=generator,
                              **({} if d is None else dict(apply=d.mask_apply, gumbel=d.gumbel)))
    return normalize(x, mean, std), y


def seg_eval_preprocess(
    images_u8: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    crop: tuple[int, int] = (256, 256),
    mean: Sequence[float] = (0.485, 0.456, 0.406),
    std: Sequence[float] = (0.229, 0.224, 0.225),
):
    """Center crop -> [0, 1] -> normalize (the val transform); labels cut alike."""
    h, w = images_u8.shape[1], images_u8.shape[2]
    th, tw = crop
    y0, x0 = (h - th) // 2, (w - tw) // 2
    x = normalize(to_float(images_u8[:, y0:y0 + th, x0:x0 + tw, :]), mean, std)
    return x if labels is None else (x, labels[:, y0:y0 + th, x0:x0 + tw])

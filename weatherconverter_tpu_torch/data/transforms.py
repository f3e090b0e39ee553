"""Batched on-device augmentation for DDPM and segmentation training (port
of weatherconverter_tpu/data/transforms.py).

Images are (B, H, W, C), the JAX package's NHWC layout, labels (B, H, W)
train-ids, on the device the train step runs on. Every random function
draws from a `torch.Generator` on that device, or takes its draws
explicitly (`offsets=`, `flip=`, `factors=`, `std=`/`noise=`,
`apply=`/`gumbel=`, `scale=`/`crop=`, `angle=`, `hue=`, `SegDraws`), so a
test can replay the JAX draws. Under data parallelism the generator is a
parallel.sharding.GlobalDraws, which draws for the global batch and hands
back this rank's rows (`_draw`). Paired
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
  random_scale_crop      <- ExtRandomScale + ExtRandomCrop, fused
  random_rotation        <- ExtRandomRotation (expand=False)
  pad_to_multiple        <- ExtPad
  hue_jitter             <- ColorJitter's hue leg
  apply_affine           <- RandomAffine's transform family, deterministic
  seg_train_augment      <- [scale+]crop -> [rotation] -> hflip -> jitter [-> hue] -> noise -> masking -> normalize
  seg_eval_preprocess    <- center crop -> normalize

The geometric legs resample on a fixed canvas (`_paired_gather`): bilinear
for images with the coordinates clamped to the edge inside the half-pixel
border band, nearest (half to even, as jnp.round) for labels, and the fill
(0 for images, 255 for labels) outside the source. They are off in the
shipped config.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence

import torch

from weatherconverter_tpu_torch.parallel.sharding import GlobalDraws

# The train-ids ClassWiseMasking may keep (road, building, traffic light,
# traffic sign, vegetation, terrain, sky, person, car, truck, bus, motorcycle,
# bicycle), and its fallback pool: every train-id and the 255 bucket
# (weatherconverter_tpu/data/transforms.py:34-45)
CLASSWISE_ALLOWED = (0, 2, 6, 7, 8, 9, 10, 11, 13, 14, 15, 17, 18)
CLASSWISE_CANDIDATES = tuple(range(19)) + (255,)


def _draw(fn, shape, generator, device, **kw) -> torch.Tensor:
    """fn(shape, generator=, device=, **kw), the draw of these rows: through
    a GlobalDraws, this rank's rows of the global batch's draw."""
    if isinstance(generator, GlobalDraws):
        return generator.draw(fn, shape, device, **kw)
    return fn(shape, generator=generator, device=device, **kw)


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
        ys = _draw(functools.partial(torch.randint, 0, h - th + 1), (b,), generator, dev)
        xs = _draw(functools.partial(torch.randint, 0, w - tw + 1), (b,), generator, dev)
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
        flip = _draw(torch.rand, (images.shape[0],), generator, images.device) < p
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
    return _draw(torch.rand, shape, generator, device) * (hi - lo) + lo


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
        noise = _draw(torch.randn, images.shape, generator, dev)
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
        apply = _draw(torch.rand, (b,), generator, dev) < p
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


def _paired_gather(images, labels, ys, xs, img_fill=0.0, lbl_fill=255):
    """Sample (B, H', W') float source coordinates from (B, H, W, C) images,
    bilinearly, and from (B, H, W) labels, at the nearest pixel (never
    interpolated); outside [-0.5, size - 0.5] the fill. Inside the border
    band the coordinates are clamped to the edge (PIL's convention)."""
    b, h, w = images.shape[:3]
    valid = (ys >= -0.5) & (ys <= h - 0.5) & (xs >= -0.5) & (xs <= w - 0.5)
    y = ys.clamp(0.0, h - 1.0)
    x = xs.clamp(0.0, w - 1.0)
    y0, x0 = y.floor(), x.floor()
    wy, wx = (y - y0)[..., None], (x - x0)[..., None]
    y0i, x0i = y0.long().clamp(0, h - 1), x0.long().clamp(0, w - 1)
    y1i, x1i = (y0i + 1).clamp(0, h - 1), (x0i + 1).clamp(0, w - 1)
    bi = torch.arange(b, device=images.device)[:, None, None]
    v = (images[bi, y0i, x0i] * (1 - wy) * (1 - wx) + images[bi, y0i, x1i] * (1 - wy) * wx
         + images[bi, y1i, x0i] * wy * (1 - wx) + images[bi, y1i, x1i] * wy * wx)
    v = torch.where(valid[..., None], v, torch.as_tensor(img_fill, dtype=v.dtype, device=v.device))
    if labels is None:
        return v, None
    yn, xn = torch.round(y).long().clamp(0, h - 1), torch.round(x).long().clamp(0, w - 1)
    out_l = torch.where(valid, labels[bi, yn, xn], torch.as_tensor(lbl_fill, dtype=labels.dtype, device=labels.device))
    return v, out_l


def random_scale_crop(
    images: torch.Tensor,
    size: tuple[int, int],
    labels: Optional[torch.Tensor] = None,
    scale_range: tuple[float, float] = (0.5, 2.0),
    generator: Optional[torch.Generator] = None,
    img_fill: float = 0.0,
    lbl_fill: int = 255,
    *,
    scale: Optional[torch.Tensor] = None,
    crop: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Scale s ~ U(scale_range) per example, a virtual resize to
    (floor(H s), floor(W s)) and a `size` crop at u * (scaled - size) with
    u = (u_y, u_x) ~ U[0, 1) (`scale=` (B,) and `crop=` replay them); crop
    pixels past the scaled extent take the fill. Images f32 (B, H, W, C)."""
    b, h, w = images.shape[:3]
    th, tw = size
    dev = images.device
    if scale is None:
        scale = _uniform((b,), scale_range[0], scale_range[1], generator, dev)
    if crop is None:
        crop = (_draw(torch.rand, (b,), generator, dev), _draw(torch.rand, (b,), generator, dev))
    s = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    u_y, u_x = (torch.as_tensor(u, dtype=torch.float32, device=dev) for u in crop)
    sh, sw = torch.floor(h * s), torch.floor(w * s)
    y0 = u_y * torch.clamp(sh - th, min=0.0)
    x0 = u_x * torch.clamp(sw - tw, min=0.0)
    ii = torch.arange(th, dtype=torch.float32, device=dev)
    jj = torch.arange(tw, dtype=torch.float32, device=dev)
    # half-pixel centres of the virtual (H s, W s) plane mapped back to the source
    ys = (y0[:, None] + ii[None, :] + 0.5) / s[:, None] - 0.5
    xs = (x0[:, None] + jj[None, :] + 0.5) / s[:, None] - 0.5
    ys = torch.where((y0[:, None] + ii[None, :]) >= sh[:, None], -1e6, ys)
    xs = torch.where((x0[:, None] + jj[None, :]) >= sw[:, None], -1e6, xs)
    return _paired_gather(images, labels, ys[:, :, None].expand(b, th, tw), xs[:, None, :].expand(b, th, tw),
                          img_fill, lbl_fill)


def _rotation_coords(angle_rad, h, w, dev):
    """Source coordinates of a rotation by `angle_rad` (B,) about the centre:
    the inverse rotation of each output pixel."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dy = (torch.arange(h, dtype=torch.float32, device=dev) - cy)[None, :, None]
    dx = (torch.arange(w, dtype=torch.float32, device=dev) - cx)[None, None, :]
    cos, sin = torch.cos(angle_rad)[:, None, None], torch.sin(angle_rad)[:, None, None]
    return cos * dy + sin * dx + cy, -sin * dy + cos * dx + cx


def random_rotation(
    images: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    degrees: float | tuple[float, float] = 10.0,
    generator: Optional[torch.Generator] = None,
    img_fill: float = 0.0,
    lbl_fill: int = 255,
    *,
    angle: Optional[torch.Tensor] = None,
):
    """Rotation by angle ~ U(-degrees, degrees) (or U(degrees) for a pair)
    degrees per example about the image centre, on the same canvas;
    `angle=` (B,) in degrees replays the draw. Labels fill with 255: they are
    train-ids here, where 0 is road."""
    lo, hi = (-degrees, degrees) if isinstance(degrees, (int, float)) else degrees
    b, h, w = images.shape[:3]
    dev = images.device
    if angle is None:
        angle = _uniform((b,), lo, hi, generator, dev)
    ys, xs = _rotation_coords(torch.as_tensor(angle, dtype=torch.float32, device=dev) * (math.pi / 180.0), h, w, dev)
    return _paired_gather(images, labels, ys.expand(b, h, w), xs.expand(b, h, w), img_fill, lbl_fill)


def pad_to_multiple(
    images: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    diviser: int = 32,
    img_fill: float = 0.0,
    lbl_fill: int = 255,
):
    """Centred padding of (B, H, W, C) images (and (B, H, W) labels) up to the
    next multiple of `diviser` on both sides (the argument is honoured)."""
    h, w = images.shape[1], images.shape[2]
    ph = 0 if h % diviser == 0 else (h // diviser + 1) * diviser - h
    pw = 0 if w % diviser == 0 else (w // diviser + 1) * diviser - w
    pads = (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)
    out_i = torch.nn.functional.pad(images, (0, 0) + pads, value=img_fill)
    out_l = None if labels is None else torch.nn.functional.pad(labels, pads, value=lbl_fill)
    return out_i, out_l


def _rgb_to_hsv(x: torch.Tensor):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx, mn = x.amax(dim=-1), x.amin(dim=-1)
    d = mx - mn
    safe = torch.where(d == 0, 1.0, d)
    h = torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),  # floor-mod, as jnp's %
                    torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = torch.where(d == 0, 0.0, h) / 6.0
    s = torch.where(mx == 0, 0.0, d / torch.where(mx == 0, 1.0, mx))
    return h, s, mx


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.int(), 6).long()
    table = torch.stack([torch.stack(c, dim=-1) for c in ((v, q, p, p, t, v), (t, v, v, q, p, p),
                                                          (p, p, t, v, v, q))], dim=-2)  # (..., 3, 6)
    return table.gather(-1, i[..., None, None].expand(*i.shape, 3, 1))[..., 0]


def hue_jitter(
    images: torch.Tensor,
    hue: float = 0.1,
    generator: Optional[torch.Generator] = None,
    *,
    factor: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """torchvision's adjust_hue with factor ~ U[-hue, hue] per example
    (`factor=` (B,) replays it): the HSV hue shifted cyclically, saturation
    and value kept. Images f32 in [0, 1]."""
    b = images.shape[0]
    if factor is None:
        factor = _uniform((b,), -hue, hue, generator, images.device)
    f = torch.as_tensor(factor, dtype=torch.float32, device=images.device).reshape(b, 1, 1)
    h, s, v = _rgb_to_hsv(images.clamp(0.0, 1.0))
    return _hsv_to_rgb(torch.remainder(h + f, 1.0), s, v)


def apply_affine(
    images: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    *,
    angle: float = 0.0,
    translate: tuple[float, float] = (0.0, 0.0),
    scale: float = 1.0,
    shear: float = 0.0,
    img_fill: float = 0.0,
    lbl_fill: int = 255,
):
    """A deterministic affine about the image centre (rotation degrees,
    translation as a fraction of H/W, isotropic scale, x-shear degrees):
    each output pixel samples R(-angle) Shear^-1 (dst - c - t) / scale + c."""
    b, h, w = images.shape[:3]
    dev = images.device

    def f32(v: float) -> torch.Tensor:  # JAX keeps a Python scalar as a weak f32 value
        return torch.tensor(v, dtype=torch.float32, device=dev)

    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ty, tx = translate[0] * h, translate[1] * w
    dy = ((torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy - ty) / f32(scale)).expand(h, w)
    dx = ((torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx - tx) / f32(scale)).expand(h, w)
    dx = dx - torch.tan(f32(shear * math.pi / 180.0)) * dy
    th = f32(angle * math.pi / 180.0)
    cos, sin = torch.cos(th), torch.sin(th)
    ys = cos * dy + sin * dx + cy
    xs = -sin * dy + cos * dx + cx
    return _paired_gather(images, labels, ys.expand(b, h, w), xs.expand(b, h, w), img_fill, lbl_fill)


class SegDraws(NamedTuple):
    """The draws of one seg_train_augment call, in the JAX chain's order:
    crop offsets (ys, xs), flip (B,), jitter factors (brightness, contrast,
    saturation), noise std (B,) and noise (B, th, tw, C), masking's apply
    (B,) and Gumbel scores (B, 20); and for the geometric legs, where they
    are on, the scale (B,) and crop fractions (u_y, u_x) of
    random_scale_crop (which then replaces `offsets`), the rotation angle
    (B,) in degrees and the hue factor (B,)."""

    offsets: Optional[tuple]
    flip: torch.Tensor
    jitter: tuple
    noise_std: torch.Tensor
    noise: torch.Tensor
    mask_apply: torch.Tensor
    gumbel: torch.Tensor
    scale: Optional[torch.Tensor] = None
    crop: Optional[tuple] = None
    angle: Optional[torch.Tensor] = None
    hue: Optional[torch.Tensor] = None


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
    train-id labels, in JAX's order: random crop, or with `scale_range`
    random_scale_crop on f32 images instead -> [random_rotation] -> hflip ->
    color jitter -> [hue_jitter] -> gaussian noise -> class-wise masking ->
    ImageNet normalize; returns (f32 images, labels). Without the scale leg,
    crop and flip move uint8 values and run before the conversion to f32 (on
    a quarter of the bytes; the result is the same). `draws` replays given
    draws instead of the generator."""
    d = draws
    if scale_range is not None:
        x, y = random_scale_crop(to_float(images_u8), crop, labels, tuple(scale_range), generator,
                                 **({} if d is None else dict(scale=d.scale, crop=d.crop)))
    else:
        x, y = random_crop(images_u8, crop, generator, None if d is None else d.offsets, labels=labels)
    if rotation_degrees:
        x, y = random_rotation(x if x.is_floating_point() else to_float(x), y, rotation_degrees, generator,
                               angle=None if d is None else d.angle)
    x, y = random_hflip(x, hflip_p, generator, None if d is None else d.flip, labels=y)
    x = color_jitter(x if x.is_floating_point() else to_float(x), *jitter, generator=generator,
                     factors=None if d is None else d.jitter)
    if hue:
        x = hue_jitter(x, hue, generator, factor=None if d is None else d.hue)
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

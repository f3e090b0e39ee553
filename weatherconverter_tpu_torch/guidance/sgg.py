"""Semantic gradient guidance, NCHW (port of weatherconverter_tpu/guidance/sgg.py):
the global operator (GSG) and the local class-wise one (LCG).

    mu_hat(x_t, t) = mu(x_t, t) + lambda * sigma_t * ||d L_CE(g(sr(x_t)), y) / d sr(x_t)||
    x_t            = mu_hat + sigma_t * z   ('fixed')   or   mu_hat + sigma_t   ('reference')
    LCG:  x_t^c from the image and label masked to class c,  x_t = sum_c m_c * x_t^c

`seg_fn` maps an NCHW image to NCHW logits with frozen parameters; the
gradient is taken with respect to the input only. Neither operator holds a
hand-written kernel: the seg model runs on cuDNN/cuBLAS, as XLA ran it.

Under a parallel.spatial.SpatialContext the high-resolution tensors (the
upscale, the labels, the seg maps and the input gradient) are this rank's H
rows: the per-image CE sum and valid-pixel count are summed over 'space',
the field is pooled on the rank's rows and then gathered, and LCG's class
masks are downsampled on the rank's rows and gathered for the recombine,
which runs at the latent on every rank alike.
"""

from __future__ import annotations

from typing import Callable

import torch

from weatherconverter_tpu_torch.ops.image import avg_pool, resize_nearest
from weatherconverter_tpu_torch.parallel import spatial
from weatherconverter_tpu_torch.training.losses import _per_pixel_ce

IMAGENET_STD = (0.229, 0.224, 0.225)

SegFn = Callable[[torch.Tensor], torch.Tensor]


def seg_ce_per_image(seg_fn: SegFn, x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Sum over the batch of each image's mean CE (ignore 255). Each image's
    gradient is then the one it would get alone, at any batch size; a
    batch-mean CE would divide it by the batch size."""
    ce, valid = _per_pixel_ce(seg_fn(x), gt, 255)
    dims = tuple(range(1, ce.dim()))
    ce_sum, count = ce.sum(dim=dims), valid.sum(dim=dims)
    ctx = spatial.current()
    if ctx is not None:  # this rank's rows: the image's sums are over every shard
        ce_sum = ctx.sum_over_space(ce_sum, differentiable=True)
        count = ctx.sum_over_space(count, differentiable=False)
    return (ce_sum / count.clamp_min(1)).sum()


def seg_input_gradients(seg_fn: SegFn, x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """d seg_ce_per_image / d x, by autograd with respect to x alone."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(seg_ce_per_image(seg_fn, x, gt), x)
    return grad


def gradient_magnitude(grads: torch.Tensor, denormalize: bool = True, norm: bool = False) -> torch.Tensor:
    """L2 norm over channels, (B, C, H, W) -> (B, 1, H, W) f32. `denormalize`
    first MULTIPLIES by the ImageNet std (sgg.py:92-95): the chain rule
    through (x - mean) / std."""
    g = grads.float()
    if denormalize:
        g = g * torch.as_tensor(IMAGENET_STD, dtype=torch.float32, device=g.device).reshape(1, -1, 1, 1)
    mag = torch.sqrt((g * g).sum(dim=1, keepdim=True))
    if norm:
        mn = mag.amin(dim=(1, 2, 3), keepdim=True)
        mx = mag.amax(dim=(1, 2, 3), keepdim=True)
        mag = (mag - mn) / (mx - mn).clamp_min(1e-12)
    return mag


def _hr_rows(sr_xt: torch.Tensor) -> int:
    """The upscale's height: its global height under a SpatialContext."""
    ctx = spatial.current()
    return sr_xt.shape[2] if ctx is None else ctx.global_rows(sr_xt.shape[2])


def guidance_field(seg_fn: SegFn, sr_xt: torch.Tensor, gt: torch.Tensor, pool: int = 4) -> torch.Tensor:
    """Input gradient -> average-pooled by `pool` -> denormalized magnitude,
    (B, 1, h, w) at latent resolution."""
    grads = seg_input_gradients(seg_fn, sr_xt, gt)
    mag = gradient_magnitude(avg_pool(grads, pool, pool), denormalize=True, norm=False)
    ctx = spatial.current()
    return mag if ctx is None else ctx.gather_rows(mag)


def apply_gsg(
    seg_fn: SegFn,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    sr_xt: torch.Tensor,
    gt: torch.Tensor,
    lam: float,
    noise: torch.Tensor | None = None,
    mode: str = "fixed",
    noise_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """One GSG update. The pool factor is the ratio of `sr_xt`'s height to
    `mu`'s. `noise_scale` is the std of the added noise where it differs from
    the guidance scale `sigma` (a strided sampler's own sigma); None: sigma."""
    mag = guidance_field(seg_fn, sr_xt, gt, pool=_hr_rows(sr_xt) // mu.shape[2])
    mu_hat = mu + lam * sigma * mag
    ns = sigma if noise_scale is None else noise_scale
    if mode == "reference" or noise is None:
        return mu_hat + ns
    return mu_hat + ns * noise


def present_class_ids(gt: torch.Tensor, k: int, num_classes: int = 19) -> torch.Tensor:
    """Each image's `k` largest classes by pixel count, (B, H, W) train-ids ->
    (B, k) int32, padded with -1 where fewer are present.

    A class absent from an image has an all-zero mask and adds exactly nothing
    to LCG's recombine, so sweeping only the present ones is the same result
    at ~19 / n_present of the cost. The ids come back sorted ASCENDING with
    the -1s last, so the packed recombine adds its terms in the full sweep's
    order and equals it bit for bit when k covers every present class. 255
    and any id >= num_classes count as no class. Ties between equal counts go
    to the smaller id (a stable sort, as `jnp.argsort` is)."""
    if not 1 <= int(k) <= num_classes:
        raise ValueError(f"lcg_present_k out of range 1..{num_classes}: {k}")
    flat = gt.reshape(gt.shape[0], -1).long().clamp(0, num_classes)
    counts = torch.zeros((gt.shape[0], num_classes + 1), dtype=torch.long, device=gt.device)
    counts = counts.scatter_add_(1, flat, torch.ones_like(flat))[:, :num_classes]
    top = torch.argsort(-counts, dim=1, stable=True)[:, :k]
    ids = torch.where(counts.gather(1, top) > 0, top, num_classes)  # absent -> sentinel, which sorts last
    ids = ids.sort(dim=1).values
    return torch.where(ids >= num_classes, -1, ids).to(torch.int32)


def apply_lcg(
    seg_fn: SegFn,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    sr_xt: torch.Tensor,
    gt: torch.Tensor,
    lam: float,
    num_classes: int = 19,
    noise: torch.Tensor | None = None,
    mode: str = "fixed",
    class_chunk: int = 4,
    noise_scale: torch.Tensor | None = None,
    class_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """One LCG update: for each class c the image and the label are masked by
    m_c = (gt == c) (label 0 outside the class, so class 0's CE sees the
    masked-out pixels as class 0), the guidance field of the masked pair
    gives x_t^c, and x_t = sum_c m_c * x_t^c with the masks downsampled
    (nearest) to the latent's resolution.

    `class_chunk` masked copies of the batch go through one seg forward and
    backward together. That is exact because `seg_ce_per_image` sums
    per-image means: each copy's gradient is the one it would get alone. The
    sweep is padded to a whole number of chunks, so every seg call has one
    batch size; a pad slot (an id >= num_classes, or -1) has an all-zero
    mask and its result is dropped. The chunks run in a Python loop and each
    one's autograd graph is freed before the next starts.

    `class_ids` ((B, K) or (K,) int, -1 = empty slot; `present_class_ids`)
    replaces the sweep over all classes with K per-image slots. The terms are
    added in slot order, one after the other, so with ascending ids the packed
    sweep equals the full one bit for bit when K covers every present class
    (an absent class's term is +-0, and x + 0 == x).

    `mode` 'reference' returns sum_c m_c * (mu_hat_c + ns), with no noise and
    nothing at pixels no mask covers; otherwise those pixels (255, or classes
    a small K dropped) take the unguided mu + ns * z. `noise_scale` as in
    `apply_gsg`."""
    b = sr_xt.shape[0]
    h, w = mu.shape[2:]
    pool = _hr_rows(sr_xt) // h
    if class_ids is None:
        n_slots = num_classes
    else:
        ids = class_ids if class_ids.dim() == 2 else class_ids[None]
        n_slots = ids.shape[1]
    g = max(1, min(class_chunk, n_slots))
    num_padded = -(-n_slots // g) * g
    if class_ids is None:
        slots = torch.arange(num_padded, device=gt.device).reshape(-1, 1)  # (K', 1): shared by the batch
    else:
        slots = torch.nn.functional.pad(ids.t().to(gt.device), (0, 0, 0, num_padded - n_slots), value=-1)  # (K', B or 1)

    mags, masks = [], []
    for cs in slots.split(g):
        mc = (gt[None] == cs[:, :, None, None]).to(sr_xt.dtype)  # (g, B, H, W)
        # One memory layout for every chunk, whatever strides sr_xt came with and however the mask
        # broadcast: over a blacked-out region the seg model's max-pool sees ties, and which element of a
        # tie takes the gradient depends on the layout the pooling kernel is handed.
        xm = (sr_xt[None] * mc[:, :, None]).flatten(0, 1).contiguous()  # (g * B, 3, H, W)
        gm = gt[None] * mc.to(gt.dtype)
        mag = guidance_field(seg_fn, xm, gm.flatten(0, 1), pool=pool)
        mags.append(mag.reshape(g, b, *mag.shape[1:]))
        masks.append(mc)
    mags = torch.cat(mags)[:n_slots]  # (K, B, 1, h, w)
    masks = torch.cat(masks)[:n_slots]  # (K, B, H, W)

    ns = sigma if noise_scale is None else noise_scale
    xt_c = mu + lam * sigma * mags
    xt_c = xt_c + (ns if mode == "reference" or noise is None else ns * noise)
    ctx = spatial.current()
    mc_small = resize_nearest(masks.reshape(-1, 1, *masks.shape[2:]), (h if ctx is None else ctx.local_rows(h), w))
    mc_small = (mc_small if ctx is None else ctx.gather_rows(mc_small)).reshape(n_slots, b, 1, h, w)
    terms = xt_c * mc_small
    xt = terms[0]
    for c in range(1, n_slots):  # in slot order: what makes the packed sweep bit-equal to the full one
        xt = xt + terms[c]
    if mode != "reference":
        covered = mc_small.sum(dim=0).clamp(0.0, 1.0)
        base = mu + (ns * noise if noise is not None else ns)
        xt = xt + (1.0 - covered) * base
    return xt

"""Global semantic gradient guidance (GSG), NCHW (port of the GSG half of
weatherconverter_tpu/guidance/sgg.py):

    mu_hat(x_t, t) = mu(x_t, t) + lambda * sigma_t * ||d L_CE(g(sr(x_t)), y) / d sr(x_t)||
    x_t            = mu_hat + sigma_t * z   ('fixed')   or   mu_hat + sigma_t   ('reference')

`seg_fn` maps an NCHW image to NCHW logits with frozen parameters; the
gradient is taken with respect to the input only. Local class-wise guidance
(LCG) is ROADMAP work.
"""

from __future__ import annotations

from typing import Callable

import torch

from weatherconverter_tpu_torch.ops.image import avg_pool
from weatherconverter_tpu_torch.training.losses import _per_pixel_ce

IMAGENET_STD = (0.229, 0.224, 0.225)

SegFn = Callable[[torch.Tensor], torch.Tensor]


def seg_ce_per_image(seg_fn: SegFn, x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Sum over the batch of each image's mean CE (ignore 255). Each image's
    gradient is then the one it would get alone, at any batch size; a
    batch-mean CE would divide it by the batch size."""
    ce, valid = _per_pixel_ce(seg_fn(x), gt, 255)
    dims = tuple(range(1, ce.dim()))
    return (ce.sum(dim=dims) / valid.sum(dim=dims).clamp_min(1)).sum()


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


def guidance_field(seg_fn: SegFn, sr_xt: torch.Tensor, gt: torch.Tensor, pool: int = 4) -> torch.Tensor:
    """Input gradient -> average-pooled by `pool` -> denormalized magnitude,
    (B, 1, h, w) at latent resolution."""
    grads = seg_input_gradients(seg_fn, sr_xt, gt)
    return gradient_magnitude(avg_pool(grads, pool, pool), denormalize=True, norm=False)


def apply_gsg(
    seg_fn: SegFn,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    sr_xt: torch.Tensor,
    gt: torch.Tensor,
    lam: float,
    noise: torch.Tensor | None = None,
    mode: str = "fixed",
) -> torch.Tensor:
    """One GSG update. The pool factor is the ratio of `sr_xt`'s height to `mu`'s."""
    mag = guidance_field(seg_fn, sr_xt, gt, pool=sr_xt.shape[2] // mu.shape[2])
    mu_hat = mu + lam * sigma * mag
    if mode == "reference" or noise is None:
        return mu_hat + sigma
    return mu_hat + sigma * noise

"""Semantic-guided translation steps in plain f32 PyTorch, NCHW: the global
operator (GSG), the class-wise one (LCG) and the guided DDPM step that
alternates them, as the port's `guidance/sgg.py` and
`guidance/translate.sample_with_sgg` define them (written out again;
nothing of the port is imported).

    mu_hat = mu + lam * sigma_t * |d CE(seg(sr(x_t)), y) / d sr(x_t)|, pooled to the latent
    x_t    = mu_hat + sigma_t * z                                     ('fixed' mode)
    LCG:   x_t = sum_c m_c * x_t^c + (1 - sum_c m_c) * (mu + sigma_t z)

The CE is each image's mean over its valid pixels (255 ignored), summed over
the batch. LCG sweeps each image's K largest classes, `class_chunk` masked
copies of the batch a seg call; each masked copy is made contiguous before
the seg model sees it, so that the max-pool's ties take the gradient at the
element the port's layout gives them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wcbench.reference.diffusion import Schedule, posterior_mean, posterior_sigma

IMAGENET_STD = (0.229, 0.224, 0.225)


def seg_ce(seg, x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """The sum over the batch of each image's mean CE over its valid pixels."""
    valid = gt != 255
    logz = F.log_softmax(seg(x), dim=1)
    ce = -logz.gather(1, torch.where(valid, gt, torch.zeros_like(gt)).long().unsqueeze(1)).squeeze(1)
    ce = torch.where(valid, ce, torch.zeros_like(ce))
    return (ce.sum(dim=(1, 2)) / valid.sum(dim=(1, 2)).clamp_min(1)).sum()


def seg_input_gradient(seg, x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(seg_ce(seg, x, gt), x)
    return grad


def guidance_field(seg, sr_xt: torch.Tensor, gt: torch.Tensor, pool: int) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 1, H / pool, W / pool): the input gradient pooled,
    times the ImageNet std (the chain rule through the seg model's
    normalisation), its L2 norm over channels."""
    g = F.avg_pool2d(seg_input_gradient(seg, sr_xt, gt), pool, pool)
    g = g * torch.as_tensor(IMAGENET_STD, dtype=g.dtype, device=g.device).reshape(1, -1, 1, 1)
    return torch.sqrt((g * g).sum(dim=1, keepdim=True))


def present_class_ids(gt: torch.Tensor, k: int, num_classes: int) -> torch.Tensor:
    """Each image's k largest classes by pixel count, ascending, -1 for a slot
    no present class fills; ties to the smaller id."""
    flat = gt.reshape(gt.shape[0], -1).long().clamp(0, num_classes)
    counts = torch.zeros((gt.shape[0], num_classes + 1), dtype=torch.long, device=gt.device)
    counts = counts.scatter_add_(1, flat, torch.ones_like(flat))[:, :num_classes]
    top = torch.argsort(-counts, dim=1, stable=True)[:, :k]
    ids = torch.where(counts.gather(1, top) > 0, top, num_classes).sort(dim=1).values
    return torch.where(ids >= num_classes, -1, ids)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest neighbour at half-pixel centres: output i reads floor((i + 0.5) * n_in / n_out)."""
    def index(n_in, n_out):
        return ((torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) * n_in / n_out).floor().long()

    return x.index_select(2, index(x.shape[2], size[0])).index_select(3, index(x.shape[3], size[1]))


def gsg(seg, mu, sigma, sr_xt, gt, lam, z):
    mag = guidance_field(seg, sr_xt, gt, sr_xt.shape[2] // mu.shape[2])
    return mu + lam * sigma * mag + sigma * z


def lcg(seg, mu, sigma, sr_xt, gt, lam, z, class_ids: torch.Tensor, class_chunk: int):
    b, (h, w) = sr_xt.shape[0], mu.shape[2:]
    pool = sr_xt.shape[2] // h
    n = class_ids.shape[1]
    g = max(1, min(class_chunk, n))
    slots = F.pad(class_ids.t(), (0, 0, 0, -(-n // g) * g - n), value=-1)  # (K', B)
    mags, masks = [], []
    for cs in slots.split(g):
        mc = (gt[None] == cs[:, :, None, None]).to(sr_xt.dtype)  # (g, B, H, W)
        xm = (sr_xt[None] * mc[:, :, None]).flatten(0, 1).contiguous()
        gm = (gt[None] * mc.to(gt.dtype)).flatten(0, 1)
        mags.append(guidance_field(seg, xm, gm, pool).reshape(g, b, 1, h, w))
        masks.append(mc)
    mags, masks = torch.cat(mags)[:n], torch.cat(masks)[:n]
    xt_c = mu + lam * sigma * mags + sigma * z
    mc_small = resize_nearest(masks.reshape(-1, 1, *masks.shape[2:]), (h, w)).reshape(n, b, 1, h, w)
    terms = xt_c * mc_small
    xt = terms[0]
    for c in range(1, n):
        xt = xt + terms[c]
    covered = mc_small.sum(dim=0).clamp(0.0, 1.0)
    return xt + (1.0 - covered) * (mu + sigma * z)


@torch.no_grad()
def guided_steps(unet, seg, sr, s: Schedule, xt: torch.Tensor, gt: torch.Tensor, generator: torch.Generator,
                 t_offset: int, num_steps: int, lam: float, class_ids: torch.Tensor, class_chunk: int,
                 num_classes: int):
    """Steps i = t_offset + num_steps - 1 .. t_offset of the 'alternate',
    'fixed', 'sr'-space chain from x_t (NCHW), each drawing its z from
    `generator` (one N(0, I) draw of x_t's shape a step, before the update).
    LCG on even i, GSG on odd i, no guidance at i = 0. Returns (x, the largest
    guidance term of any step: max |x_step - (mu + sigma z)|)."""
    guide_max = xt.new_zeros(())
    for i in range(t_offset + num_steps - 1, t_offset - 1, -1):
        eps = unet(xt, torch.full((xt.shape[0],), i, dtype=torch.long, device=xt.device))
        mu, sigma = posterior_mean(s, xt, eps, i), posterior_sigma(s, i)
        z = torch.randn(xt.shape, generator=generator, device=xt.device, dtype=xt.dtype)
        if i == 0:
            xt = mu
            continue
        if i % 2 == 0:
            new = lcg(seg, mu, sigma, sr(xt), gt, lam, z, class_ids, class_chunk)
        else:
            new = gsg(seg, mu, sigma, sr(xt), gt, lam, z)
        guide_max = torch.maximum(guide_max, (new - (mu + sigma * z)).abs().amax())
        xt = new
    return xt, guide_max

"""The DDPM train step in plain f32 PyTorch: the on-device augmentation of
raw uint8 images (random crop, random horizontal flip, [-1, 1]), t ~ U[0, T)
and noise ~ N(0, I), the q-sample, the eps-MSE, Adam (betas 0.9 / 0.999,
eps 1e-8 outside the square root, bias-corrected) and the EMA
e <- decay * e + (1 - decay) * p, as the port's `data/transforms.py`,
`training/diffusion.py` and `training/optim.py` define them (written out
again; nothing of the port is imported). Draws come from one generator in
the port's order: crop rows, crop columns, flips, t, noise."""

from __future__ import annotations

import torch

from wcbench.reference.diffusion import Schedule


def augment(images_u8: torch.Tensor, generator: torch.Generator, crop: int) -> torch.Tensor:
    b, h, w = images_u8.shape[:3]
    dev = images_u8.device
    ys = torch.randint(0, h - crop + 1, (b,), generator=generator, device=dev)
    xs = torch.randint(0, w - crop + 1, (b,), generator=generator, device=dev)
    rows = (ys[:, None] + torch.arange(crop, device=dev))[:, :, None]
    cols = (xs[:, None] + torch.arange(crop, device=dev))[:, None, :]
    x = images_u8[torch.arange(b, device=dev)[:, None, None], rows, cols]
    flip = torch.rand((b,), generator=generator, device=dev) < 0.5
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    return (x.float() / 255.0) * 2.0 - 1.0


def loss(unet, s: Schedule, images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """images (B, H, W, C) in [-1, 1] -> the eps-MSE of one draw of t and noise."""
    b = images.shape[0]
    t = torch.randint(0, s.T, (b,), generator=generator, device=images.device)
    noise = torch.randn(images.shape, generator=generator, device=images.device, dtype=images.dtype)
    xt = s.sqrt_acp[t].reshape(-1, 1, 1, 1) * images + s.sqrt_1m_acp[t].reshape(-1, 1, 1, 1) * noise
    pred = unet(xt.permute(0, 3, 1, 2).contiguous(), t)
    return torch.mean(torch.square(pred - noise.permute(0, 3, 1, 2).contiguous()))


class Adam:
    def __init__(self, params: dict[str, torch.Tensor], lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1**self.t, 1.0 - self.b2**self.t
        for n, p in self.params.items():
            g = grads[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + self.eps))


def train_steps(unet, s: Schedule, batches: list[torch.Tensor], generator: torch.Generator, crop: int, lr: float,
                ema_decay: float):
    """Steps from the module's parameters, one a raw batch. Returns (losses,
    the first step's gradients, the EMA after the last step)."""
    params = dict(unet.named_parameters())
    opt = Adam({n: p.data for n, p in params.items()}, lr)
    ema = {n: p.detach().clone() for n, p in params.items()}
    losses, first_grads = [], None
    for raw in batches:
        value = loss(unet, s, augment(raw, generator, crop), generator)
        grads = torch.autograd.grad(value, list(params.values()))
        grads = dict(zip(params, grads))
        if first_grads is None:
            first_grads = {n: g.clone() for n, g in grads.items()}
        opt.step(grads)
        with torch.no_grad():
            for n, p in params.items():
                ema[n].mul_(ema_decay).add_(p, alpha=1.0 - ema_decay)
        losses.append(value.detach())
    return losses, first_grads, ema

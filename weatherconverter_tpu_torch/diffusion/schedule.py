"""DDPM noise schedules: tables plus pure functions of (tables, tensors, t).

Port of weatherconverter_tpu/diffusion/schedule.py. `t` may be a Python int,
a 0-d tensor or a (B,) tensor of per-example timesteps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch

VarianceMode = Literal["posterior", "beta"]


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Precomputed DDPM tables, each (T,) f32 on one device."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alpha_cum_prod: torch.Tensor
    sqrt_alpha_cum_prod: torch.Tensor
    one_minus_cum_prod: torch.Tensor
    sqrt_one_minus_alpha_cum_prod: torch.Tensor
    num_timesteps: int

    @property
    def T(self) -> int:
        return self.num_timesteps

    @property
    def device(self) -> torch.device:
        return self.betas.device


def linear_schedule(
    num_timesteps: int = 1000, beta_start: float = 1e-4, beta_end: float = 0.02, device=None
) -> NoiseSchedule:
    betas = torch.linspace(beta_start, beta_end, num_timesteps, dtype=torch.float32, device=device)
    return _from_betas(betas, num_timesteps)


def cosine_schedule(num_timesteps: int = 1000, s: float = 0.008, device=None) -> NoiseSchedule:
    """Cosine schedule (Nichol & Dhariwal 2021)."""
    steps = torch.arange(num_timesteps + 1, dtype=torch.float32, device=device)
    f = torch.cos(((steps / num_timesteps) + s) / (1 + s) * math.pi / 2) ** 2
    acp = f / f[0]
    betas = (1.0 - acp[1:] / acp[:-1]).clamp(0.0, 0.999)
    return _from_betas(betas, num_timesteps)


def make_schedule(
    schedule: str = "linear",
    num_timesteps: int = 1000,
    beta_start: float = 1e-4,
    beta_end: float = 0.02,
    device=None,
) -> NoiseSchedule:
    if schedule == "linear":
        return linear_schedule(num_timesteps, beta_start, beta_end, device=device)
    if schedule == "cosine":
        return cosine_schedule(num_timesteps, device=device)
    raise ValueError(f"unknown schedule {schedule!r}")


def _from_betas(betas: torch.Tensor, num_timesteps: int) -> NoiseSchedule:
    alphas = 1.0 - betas
    acp = torch.cumprod(alphas, dim=0)
    return NoiseSchedule(
        betas=betas,
        alphas=alphas,
        alpha_cum_prod=acp,
        sqrt_alpha_cum_prod=torch.sqrt(acp),
        one_minus_cum_prod=1.0 - acp,
        sqrt_one_minus_alpha_cum_prod=torch.sqrt(1.0 - acp),
        num_timesteps=num_timesteps,
    )


def _at(table: torch.Tensor, t, like: torch.Tensor) -> torch.Tensor:
    """table[t], shaped to broadcast over `like`: a scalar t gives a 0-d
    tensor, a (B,) t gives (B, 1, ..., 1). A Python int indexes without a
    host-to-device copy, so a sampling loop never waits on the device."""
    v = table[t] if isinstance(t, int) else table[torch.as_tensor(t, device=table.device)]
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim())) if v.dim() else v


def q_sample(sched: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
    """Forward q(x_t | x_0) sample."""
    return _at(sched.sqrt_alpha_cum_prod, t, x0) * x0 + _at(sched.sqrt_one_minus_alpha_cum_prod, t, x0) * noise


def predict_x0(sched: NoiseSchedule, xt: torch.Tensor, eps: torch.Tensor, t) -> torch.Tensor:
    """x_0 estimate from the eps-prediction."""
    return (xt - _at(sched.sqrt_one_minus_alpha_cum_prod, t, xt) * eps) / _at(sched.sqrt_alpha_cum_prod, t, xt)


def posterior_mean(sched: NoiseSchedule, xt: torch.Tensor, eps: torch.Tensor, t) -> torch.Tensor:
    """mu(x_t, eps, t) = (x_t - beta_t / sqrt(1 - acp_t) * eps) / sqrt(alpha_t)."""
    beta = _at(sched.betas, t, xt)
    soc = _at(sched.sqrt_one_minus_alpha_cum_prod, t, xt)
    alpha = _at(sched.alphas, t, xt)
    return (xt - beta * eps / soc) / torch.sqrt(alpha)


def posterior_sigma(sched: NoiseSchedule, t, mode: VarianceMode = "posterior") -> torch.Tensor:
    """Reverse-step standard deviation, shaped like t.

    'posterior': sqrt((1 - acp[t-1]) / (1 - acp[t]) * beta_t), guarded to 0 at
    t == 0 where acp[t-1] does not exist; 'beta': sqrt(beta_t).
    """
    if isinstance(t, int):  # the sampling loop's case: no host-to-device copy
        if mode == "beta":
            return torch.sqrt(sched.betas[t])
        if t == 0:
            return torch.zeros((), device=sched.device)
        acp = sched.alpha_cum_prod
        return torch.sqrt((1.0 - acp[t - 1]) / (1.0 - acp[t]) * sched.betas[t])
    t = torch.as_tensor(t, device=sched.device)
    if mode == "beta":
        var = sched.betas[t]
    else:
        prev = sched.alpha_cum_prod[(t - 1).clamp_min(0)]
        var = (1.0 - prev) / (1.0 - sched.alpha_cum_prod[t]) * sched.betas[t]
        var = torch.where(t > 0, var, torch.zeros_like(var))
    return torch.sqrt(var)

"""DDPM schedule, the ancestral posterior step and DPM-Solver++(2M), plain
f32 PyTorch (the algorithms of the port's `diffusion/schedule.py` and
`diffusion/sampling.py`, written out again; nothing of the port is
imported). Tables are (T,) f32 on one device; t is a Python int."""

from __future__ import annotations

import numpy as np
import torch


class Schedule:
    """The linear beta schedule's tables."""

    def __init__(self, num_timesteps: int, beta_start: float, beta_end: float, device):
        self.T = num_timesteps
        self.betas = torch.linspace(beta_start, beta_end, num_timesteps, dtype=torch.float32, device=device)
        self.alphas = 1.0 - self.betas
        self.acp = torch.cumprod(self.alphas, dim=0)
        self.sqrt_acp = torch.sqrt(self.acp)
        self.sqrt_1m_acp = torch.sqrt(1.0 - self.acp)


def q_sample(s: Schedule, x0, noise, t: int):
    return s.sqrt_acp[t] * x0 + s.sqrt_1m_acp[t] * noise


def predict_x0(s: Schedule, xt, eps, t: int):
    return (xt - s.sqrt_1m_acp[t] * eps) / s.sqrt_acp[t]


def posterior_mean(s: Schedule, xt, eps, t: int):
    return (xt - s.betas[t] * eps / s.sqrt_1m_acp[t]) / torch.sqrt(s.alphas[t])


def posterior_sigma(s: Schedule, t: int):
    if t == 0:
        return torch.zeros((), device=s.betas.device)
    return torch.sqrt((1.0 - s.acp[t - 1]) / (1.0 - s.acp[t]) * s.betas[t])


def strided_taus(T: int, S: int) -> tuple[list[int], list[int]]:
    """An S-step descending grid over [0, T): the f32 linspace (i * ((T - 1)
    * (1 / (S - 1))), each step rounded to f32, the end point exact), rounded
    half to even; tau_prev is the grid shifted by one with -1 last."""
    f32 = np.float32
    scale = f32(T - 1) * (f32(1.0) / f32(S - 1))
    grid = np.concatenate([np.arange(S - 1, dtype=f32) * scale, np.array([T - 1], dtype=f32)])
    taus = [int(t) for t in np.round(grid)][::-1]
    return taus, taus[1:] + [-1]


def dpm_2m_update(s: Schedule, xt, x0, x0_prev, h_prev, t: int, tp: int, use_2m: bool):
    """One DPM-Solver++(2M) transition x_t -> x_tp in data-prediction form
    (Lu et al. 2022); first order where `use_2m` is False. Returns (x_tp, h)."""
    acp_t = s.acp[t]
    acp_p = s.acp[tp] if tp >= 0 else s.acp.new_ones(())
    a_t, s_t = torch.sqrt(acp_t), torch.sqrt(1.0 - acp_t)
    a_p, s_p = torch.sqrt(acp_p), torch.sqrt(torch.clamp_min(1.0 - acp_p, 0.0))
    h = 0.5 * torch.log(acp_p / torch.clamp_min(1.0 - acp_p, 1e-20)) - 0.5 * torch.log(acp_t / (1.0 - acp_t))
    if use_2m:
        r = h_prev / torch.where(h == 0.0, torch.ones_like(h), h)
        coef = 1.0 / (2.0 * torch.where(r == 0.0, torch.ones_like(r), r))
        d = (1.0 + coef) * x0 - coef * x0_prev
    else:
        d = x0
    e_mh = (s_p * a_t) / (a_p * s_t)
    return (s_p / s_t) * xt - a_p * (e_mh - 1.0) * d, h


@torch.no_grad()
def dpm_sample(unet, s: Schedule, x_init: torch.Tensor, num_steps: int) -> torch.Tensor:
    """DPM-Solver++(2M) from x_init (NCHW) over `num_steps` strided steps,
    x0-pred clipped to [-1, 1], first order at the first and the last step."""
    taus, tau_prev = strided_taus(s.T, num_steps)
    xt = x_init
    x0_prev, h_prev = torch.zeros_like(xt), xt.new_ones(())
    for k, (t, tp) in enumerate(zip(taus, tau_prev)):
        eps = unet(xt, torch.full((xt.shape[0],), t, dtype=torch.long, device=xt.device))
        x0 = predict_x0(s, xt, eps, t).clamp(-1.0, 1.0)
        xt, h_prev = dpm_2m_update(s, xt, x0, x0_prev, h_prev, t, tp, k > 0 and tp >= 0)
        x0_prev = x0
    return xt

"""DDPM, DDIM and DPM-Solver++(2M) samplers (port of
weatherconverter_tpu/diffusion/sampling.py).

The JAX scan becomes a Python loop over Python-int timesteps, so every table
lookup indexes without a host-to-device copy. The samplers run under
`torch.no_grad()`. Public shapes are the JAX package's, NHWC; `apply_fn`
(the port's `Unet`) takes and returns NCHW. Noise comes from a
torch.Generator on the schedule's device, or from a sequence of them, one a
batch row (`Generators`), so that each row's draws are those of a batch-1
run under its own generator, whatever shares the batch (the server's
per-request seeds); `noise=` replays given draws instead, in the order the
JAX sampler draws from its key (`init` for the initial x, then one `z` a
step), so a test can hold a sampler against the JAX scan step for step.
`ddpm_sample_legacy` is the loop of the legacy UNet (models/unet_legacy.py),
conditioned on 1 - alpha_bar[t] instead of t.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from weatherconverter_tpu_torch.diffusion.schedule import NoiseSchedule, VarianceMode, ddpm_step, predict_x0, q_sample

# (x_t NCHW, t (B,)) -> eps NCHW
ApplyFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# (x_init (B, H, W, C), z_steps (S, B, H, W, C)): the draws of a sampler that adds noise every step
Noise = tuple[torch.Tensor, torch.Tensor]
# one generator for the batch, or one a batch row
Generators = Union[torch.Generator, Sequence[torch.Generator], None]


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def strided_taus(T: int, S: int) -> tuple[list[int], list[int]]:
    """(taus, tau_prev) of an S-step subsequence of [0, T), as Python ints:
    taus descend from T - 1 (the chain starts at the top of the span; at
    S = 1 that is [T - 1]), tau_prev is taus shifted by one with -1 last.
    The grid is the f32 `jnp.linspace(0, T - 1, S)` as XLA computes it, then
    rounded half to even: XLA turns (T - 1) * (i / (S - 1)) into
    i * ((T - 1) * (1 / (S - 1))), each product and the reciprocal rounded to
    f32, which can put a grid point that is exactly k + 1/2 one ulp off it
    (T = 333, S = 25 gives 125 where the exact grid rounds to 124). Host
    arithmetic in numpy's f32 (each operation correctly rounded, as XLA's
    and torch's are), so a traced program (`cli export-hlo`) holds the grid
    as constants."""
    if S >= 2:
        f32 = np.float32
        scale = f32(T - 1) * (f32(1.0) / f32(S - 1))
        grid = np.concatenate([np.arange(S - 1, dtype=f32) * scale, np.array([T - 1], dtype=f32)])
        taus = [int(t) for t in np.round(grid)][::-1]
    else:
        taus = [T - 1]
    return taus, taus[1:] + [-1]


def acp_prev(sched: NoiseSchedule, tp: int) -> torch.Tensor:
    """alpha_bar at tp, and 1 at tp = -1 (the step past the end of the chain)."""
    return sched.alpha_cum_prod[tp] if tp >= 0 else sched.alpha_cum_prod.new_ones(())


def _per_row(generator: Generators, rows: int) -> bool:
    if isinstance(generator, (list, tuple)):
        if len(generator) != rows:
            raise ValueError(f"{len(generator)} generators for a batch of {rows} rows")
        return True
    return False


def randn(shape: Sequence[int], generator: Generators, device, dtype=torch.float32) -> torch.Tensor:
    """N(0, I) of `shape`; with a sequence of generators, row i is drawn from
    generator i alone, the draw a batch-1 run under it makes. That is one
    small launch a row where one generator makes one launch: B more a draw,
    against the ~1,800-5,800 kernels a chain step already launches."""
    if _per_row(generator, shape[0]):
        return torch.cat([torch.randn((1, *shape[1:]), generator=g, device=device, dtype=dtype) for g in generator])
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)


def randint(high: int, rows: int, generator: Generators, device) -> torch.Tensor:
    """(rows,) integers in [0, high), one per row from its own generator when given a sequence."""
    if _per_row(generator, rows):
        return torch.cat([torch.randint(0, high, (1,), generator=g, device=device) for g in generator])
    return torch.randint(0, high, (rows,), generator=generator, device=device)


def draw_or_replay(generator: Generators, like: torch.Tensor, given: Optional[torch.Tensor]) -> torch.Tensor:
    """A N(0, I) draw shaped like the NCHW `like`, on its device: `given`
    (NHWC, replayed) or, if None, drawn from the generator(s)."""
    if given is not None:
        return nchw(given).to(like.device, like.dtype)
    return randn(like.shape, generator, like.device, like.dtype)


def _init_x(sched: NoiseSchedule, shape: Sequence[int], generator: Generators,
            init: Optional[torch.Tensor]) -> torch.Tensor:
    """The initial N(0, I) draw, NCHW f32 on the schedule's device."""
    if init is not None:
        return nchw(init).to(sched.device, torch.float32)
    b, h, w, c = shape
    return randn((b, c, h, w), generator, sched.device)


def step_noise(generator: Generators, like: torch.Tensor, noise: Optional[Noise], s: int) -> torch.Tensor:
    """Step s's draw: noise[1][s] replayed, or drawn from the generator."""
    return draw_or_replay(generator, like, None if noise is None else noise[1][s])


def _timesteps(xt: torch.Tensor, t: int) -> torch.Tensor:
    return torch.full((xt.shape[0],), t, dtype=torch.long, device=xt.device)


def strided_posterior_step(
    sched: NoiseSchedule, xt: torch.Tensor, eps: torch.Tensor, t: int, tp: int, noise: torch.Tensor
) -> torch.Tensor:
    """The ancestral transition q(x_tp | x_t, x0-pred) of a strided
    subsequence (eta = 1 DDIM variance, no x0 clipping): the DDPM posterior
    step at stride 1. No noise where tp < 0."""
    acp_t, acp_p = sched.alpha_cum_prod[t], acp_prev(sched, tp)
    x0 = predict_x0(sched, xt, eps, t)
    sigma2 = (1 - acp_p) / (1 - acp_t) * torch.clamp_min(1 - acp_t / acp_p, 0.0)
    mean = torch.sqrt(acp_p) * x0 + torch.sqrt(torch.clamp_min(1.0 - acp_p - sigma2, 0.0)) * eps
    return mean + torch.sqrt(sigma2) * noise if tp >= 0 else mean


def ddpm_sample(
    apply_fn: ApplyFn,
    sched: NoiseSchedule,
    shape: Sequence[int],
    generator: Generators = None,
    num_steps: Optional[int] = None,
    mode: VarianceMode = "posterior",
    return_trajectory_every: int = 0,
    noise: Optional[Noise] = None,
):
    """Ancestral sampling from x_T ~ N(0, I) to x_0 in [-1, 1], unclamped
    (`to_uint8` clamps), of NHWC `shape`.

    `num_steps` < T runs a strided subsequence of the full [0, T) span
    (`strided_taus`) with `strided_posterior_step`, and only in 'posterior'
    mode. With `return_trajectory_every` = k > 0 it returns (x_0,
    frames), frames being x after steps 0, k, 2k, ... of the loop, written
    into a preallocated (ceil(S / k), *shape) buffer. `noise` = (x_init,
    z_steps (S, *shape)) replays the draws."""
    T = sched.T
    S = num_steps if num_steps is not None else T
    strided = S != T
    if strided and mode != "posterior":
        raise ValueError(f"strided ddpm_sample (num_steps={S} != T={T}) defines its own subsequence posterior; "
                         f"variance mode {mode!r} is only meaningful at stride 1")
    if strided:
        taus, tau_prev = strided_taus(T, S)
    else:
        taus = list(range(T - 1, -1, -1))
        tau_prev = [t - 1 for t in taus]
    k = int(return_trajectory_every)
    with torch.no_grad():
        xt = _init_x(sched, shape, generator, None if noise is None else noise[0])
        frames = xt.new_zeros((-(-S // k),) + tuple(shape)) if k else None
        for s, (t, tp) in enumerate(zip(taus, tau_prev)):
            eps = apply_fn(xt, _timesteps(xt, t))
            z = step_noise(generator, xt, noise, s)
            xt = strided_posterior_step(sched, xt, eps, t, tp, z) if strided else ddpm_step(sched, xt, eps, t, z, mode)
            if k and s % k == 0:
                frames[s // k] = nhwc(xt)
    return (nhwc(xt), frames) if k else nhwc(xt)


def ddpm_sample_legacy(
    apply_fn: ApplyFn,
    sched: NoiseSchedule,
    shape: Sequence[int],
    generator: Generators = None,
    num_steps: Optional[int] = None,
    noise: Optional[Noise] = None,
) -> torch.Tensor:
    """The legacy checkpoint's sampling loop (reference:
    sample_integrated.py:40-67): `apply_fn` (the legacy UNet) takes the
    scalar 1 - alpha_bar[t] per row, and the reverse step at stride 1 has
    sigma^2 = beta_t. `num_steps` < T strides the whole span like
    `ddpm_sample`, with the subsequence posterior (beta-variance has no
    strided form), not a truncated chain. Returns x_0 (NHWC). `noise` =
    (x_init, z_steps (S, *shape)) replays the draws in the JAX split order."""
    T = sched.T
    S = num_steps if num_steps is not None else T
    strided = S != T
    if strided:
        taus, tau_prev = strided_taus(T, S)
    else:
        taus = list(range(T - 1, -1, -1))
        tau_prev = [t - 1 for t in taus]
    with torch.no_grad():
        xt = _init_x(sched, shape, generator, None if noise is None else noise[0])
        for s, (t, tp) in enumerate(zip(taus, tau_prev)):
            cond = sched.one_minus_cum_prod[t].expand(xt.shape[0])
            eps = apply_fn(xt, cond)
            z = step_noise(generator, xt, noise, s)
            if strided:
                xt = strided_posterior_step(sched, xt, eps, t, tp, z)
            else:
                xt = ddpm_step(sched, xt, eps, t, z, "beta")
    return nhwc(xt)


def ddim_sample(
    apply_fn: ApplyFn,
    sched: NoiseSchedule,
    shape: Sequence[int],
    generator: Generators = None,
    num_steps: int = 50,
    eta: float = 0.0,
    noise: Optional[Noise] = None,
) -> torch.Tensor:
    """Strided DDIM (Song et al. 2020) over an even stride of [0, T): eta = 0
    is the deterministic ODE (no step draws noise), eta = 1 the ancestral
    variance on the subsequence. x0-pred is clipped to [-1, 1]. `noise` =
    (x_init, z_steps (num_steps, *shape)) replays the draws; the JAX sampler
    draws a z every step, also at eta = 0."""
    taus, tau_prev = strided_taus(sched.T, num_steps)
    with torch.no_grad():
        xt = _init_x(sched, shape, generator, None if noise is None else noise[0])
        for s, (t, tp) in enumerate(zip(taus, tau_prev)):
            eps = apply_fn(xt, _timesteps(xt, t))
            acp_t, acp_p = sched.alpha_cum_prod[t], acp_prev(sched, tp)
            x0 = predict_x0(sched, xt, eps, t).clamp(-1.0, 1.0)
            # no guard at 0 inside the second root, as in JAX (acp_t < acp_p on a descending grid)
            sigma = eta * torch.sqrt((1 - acp_p) / (1 - acp_t)) * torch.sqrt(1 - acp_t / acp_p)
            xt = torch.sqrt(acp_p) * x0 + torch.sqrt(torch.clamp_min(1.0 - acp_p - sigma**2, 0.0)) * eps
            if eta != 0:
                xt = xt + sigma * step_noise(generator, xt, noise, s)
    return nhwc(xt)


def dpm_2m_update(
    sched: NoiseSchedule,
    xt: torch.Tensor,
    x0: torch.Tensor,
    x0_prev: torch.Tensor,
    h_prev: torch.Tensor,
    t: int,
    tp: int,
    use_2m: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One DPM-Solver++(2M) transition x_t -> x_tp in data-prediction form
    (Lu et al. 2022, arXiv:2211.01095), shared by the unconditional sampler
    and the guided translation. With logSNR lambda = log(alpha / sigma) and
    h = lambda_tp - lambda_t:
        D    = (1 + 1/(2r)) x0 - 1/(2r) x0_prev,    r = h_prev / h
        x_tp = (sigma_tp / sigma_t) x_t - alpha_tp (e^{-h} - 1) D
    `use_2m` False (the first step, or the terminal one, where sigma_tp = 0
    drives h to infinity) is the first-order update, DDIM at eta = 0.
    Returns (x_tp, h). The coefficients are f32 0-d tensors, in the JAX
    order of operations: at tp = -1, lambda_tp = log(1 / 1e-20) / 2 and
    e^{-h} is exactly 0."""
    acp_t, acp_p = sched.alpha_cum_prod[t], acp_prev(sched, tp)
    a_t, s_t = torch.sqrt(acp_t), torch.sqrt(1.0 - acp_t)
    a_p, s_p = torch.sqrt(acp_p), torch.sqrt(torch.clamp_min(1.0 - acp_p, 0.0))
    lam_t = 0.5 * torch.log(acp_t / (1.0 - acp_t))
    lam_p = 0.5 * torch.log(acp_p / torch.clamp_min(1.0 - acp_p, 1e-20))
    h = lam_p - lam_t
    if use_2m:
        r = h_prev / torch.where(h == 0.0, torch.ones_like(h), h)
        coef = 1.0 / (2.0 * torch.where(r == 0.0, torch.ones_like(r), r))
        d = (1.0 + coef) * x0 - coef * x0_prev
    else:
        d = x0
    e_mh = (s_p * a_t) / (a_p * s_t)
    return (s_p / s_t) * xt - a_p * (e_mh - 1.0) * d, h


def dpm_solver_pp_2m_sample(
    apply_fn: ApplyFn,
    sched: NoiseSchedule,
    shape: Sequence[int],
    generator: Generators = None,
    num_steps: int = 20,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DPM-Solver++(2M): the deterministic second-order multistep sampler,
    one UNet evaluation a step, x0-pred clipped to [-1, 1]. The first and
    the final step are first order (`lower_order_final`). It draws only the
    initial x; `noise` (*shape) replays that draw."""
    taus, tau_prev = strided_taus(sched.T, num_steps)
    with torch.no_grad():
        xt = _init_x(sched, shape, generator, noise)
        x0_prev, h_prev = torch.zeros_like(xt), xt.new_ones(())
        for s, (t, tp) in enumerate(zip(taus, tau_prev)):
            eps = apply_fn(xt, _timesteps(xt, t))
            x0 = predict_x0(sched, xt, eps, t).clamp(-1.0, 1.0)
            xt, h_prev = dpm_2m_update(sched, xt, x0, x0_prev, h_prev, t, tp, s > 0 and tp >= 0)
            x0_prev = x0
    return nhwc(xt)


def partial_forward_then_reverse(
    apply_fn: ApplyFn,
    sched: NoiseSchedule,
    x0: torch.Tensor,
    start_t: int,
    generator: Generators = None,
    mode: VarianceMode = "posterior",
    noise: Optional[Noise] = None,
) -> torch.Tensor:
    """q-sample x0 (B, H, W, C) to `start_t`, then run the ancestral chain
    from there to 0: `sample_with_sgg` without guidance. `noise` = (the
    q-sample's draw, z_steps (start_t + 1, B, H, W, C)) replays the draws."""
    x = nchw(x0).to(sched.device, torch.float32)
    with torch.no_grad():
        xt = q_sample(sched, x, draw_or_replay(generator, x, None if noise is None else noise[0]), start_t)
        for s, t in enumerate(range(start_t, -1, -1)):
            eps = apply_fn(xt, _timesteps(xt, t))
            xt = ddpm_step(sched, xt, eps, t, step_noise(generator, xt, noise, s), mode)
    return nhwc(xt)


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 [0, 255]: clamp, then (x + 1) * 127.5 truncated."""
    return ((x.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)

"""The PyTorch port's samplers (diffusion/sampling.py, schedule.ddpm_step)
against the JAX package, on the CPU, in f32.

Each test draws jax.random's stream in JAX, in the split order of the JAX
function, and replays it into the port through `noise=`
(tests/sampling_parity.py). The unconditional samplers are held against JAX
with an analytic eps-model (the same function on both sides: the sampler's
arithmetic is what is compared) and once with the tiny UNet of
tests/torch_parity.py (its 32x32 layers attend at N = 1024 through the flash
path). The fast guided translations are tests/test_torch_fast_translate.py,
the int8 quality check tests/test_torch_int8_quality.py.

Tolerances: the sampler arithmetic agrees to 2e-5 (f32 scalars in JAX's order
of operations; XLA may fuse a multiply-add); chains through the tiny models
take tests/test_torch_translate.py's 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sampling_parity import (B, CHAIN_ATOL, CHAIN_RTOL, LATENT, SAMPLER_ATOL, SAMPLER_RTOL, SCHED_ARGS, SHAPE, STEPS,
                             build_models)
from sampling_parity import jax_draws as _jax_draws
from torch_parity import nhwc_to_nchw

from weatherconverter_tpu.diffusion import sampling as JSa
from weatherconverter_tpu.diffusion import schedule as JS
from weatherconverter_tpu_torch.diffusion import sampling as PSa
from weatherconverter_tpu_torch.diffusion import schedule as PS


def analytic_eps(xt, t):
    """A nonlinear, t-dependent eps-model, elementwise (so NHWC and NCHW alike), in either framework."""
    lib = jnp if isinstance(xt, jax.Array) else torch
    tt = t.reshape(-1, 1, 1, 1).astype(jnp.float32) if lib is jnp else t.reshape(-1, 1, 1, 1).float()
    return 0.3 * lib.tanh(xt) + 0.002 * tt


# --- schedule.ddpm_step ---

@pytest.mark.parametrize("batched_t", [False, True], ids=["int-t", "per-example-t"])
@pytest.mark.parametrize("mode", ["posterior", "beta"])
def test_ddpm_step_matches_jax(mode, batched_t):
    rng = np.random.default_rng(0)
    xt, eps, z = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(3))
    js, ps = JS.linear_schedule(*SCHED_ARGS), PS.linear_schedule(*SCHED_ARGS)
    for t in ([0, 7], [19, 0]) if batched_t else (0, 1, 10, 19):
        ref = JS.ddpm_step(js, jnp.asarray(xt), jnp.asarray(eps), jnp.asarray(t), jnp.asarray(z), mode=mode)
        out = PS.ddpm_step(ps, nhwc_to_nchw(xt), nhwc_to_nchw(eps), torch.tensor(t) if batched_t else t,
                           nhwc_to_nchw(z), mode=mode)
        np.testing.assert_allclose(PSa.nhwc(out).numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
        if not batched_t and t == 0:  # no noise at t == 0
            assert torch.equal(out, PS.posterior_mean(ps, nhwc_to_nchw(xt), nhwc_to_nchw(eps), 0))


# --- strided_taus: exactly JAX's integers ---

@pytest.mark.parametrize("T", [7, 20, 40, 333, 500, 1000, 4001])
def test_strided_taus_equal_jax(T):
    for S in sorted({1, 2, 3, 4, 5, 7, 8, 10, 15, 16, 20, 25, 30, 33, 49, 50, 64, 100, 128, 250, 333, 999, T}):
        if S > T:
            continue
        taus, prev = PSa.strided_taus(T, S)
        jt, jp = JSa.strided_taus(T, S)
        assert taus == np.asarray(jt).tolist() and prev == np.asarray(jp).tolist(), (T, S)
        assert all(isinstance(v, int) for v in taus + prev) and taus[0] == T - 1 and prev[-1] == -1


# --- the unconditional samplers ---

@pytest.mark.parametrize("case", ["stride1", "stride1-beta", "strided", "trajectory", "strided-trajectory"])
def test_ddpm_sample_matches_jax(case):
    T = SCHED_ARGS[0]
    num_steps = 6 if "strided" in case else None
    mode = "beta" if case.endswith("beta") else "posterior"
    every = 3 if "trajectory" in case else 0
    key = jax.random.PRNGKey(1)
    ref = JSa.ddpm_sample(analytic_eps, JS.linear_schedule(*SCHED_ARGS), key, SHAPE, num_steps=num_steps, mode=mode,
                          return_trajectory_every=every)
    noise = _jax_draws(key, SHAPE, num_steps or T)
    out = PSa.ddpm_sample(analytic_eps, PS.linear_schedule(*SCHED_ARGS), SHAPE, num_steps=num_steps, mode=mode,
                          return_trajectory_every=every, noise=noise)
    if every:
        (ref, ref_traj), (out, traj) = ref, out
        assert traj.shape == (-(-(num_steps or T) // every),) + SHAPE
        np.testing.assert_allclose(traj.numpy(), np.asarray(ref_traj), rtol=SAMPLER_RTOL, atol=SAMPLER_ATOL)
    assert out.shape == SHAPE
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=SAMPLER_RTOL, atol=SAMPLER_ATOL)


def test_strided_ddpm_sample_refuses_beta_mode():
    with pytest.raises(ValueError, match="only meaningful at stride 1"):
        PSa.ddpm_sample(analytic_eps, PS.linear_schedule(40), (1, 8, 8, 3), num_steps=10, mode="beta")


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_sample_matches_jax(eta):
    key = jax.random.PRNGKey(2)
    ref = JSa.ddim_sample(analytic_eps, JS.linear_schedule(*SCHED_ARGS), key, SHAPE, num_steps=7, eta=eta)
    out = PSa.ddim_sample(analytic_eps, PS.linear_schedule(*SCHED_ARGS), SHAPE, num_steps=7, eta=eta,
                          noise=_jax_draws(key, SHAPE, 7))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=SAMPLER_RTOL, atol=SAMPLER_ATOL)
    if eta:  # the noise is what is compared: eta = 1 moves the output
        det = PSa.ddim_sample(analytic_eps, PS.linear_schedule(*SCHED_ARGS), SHAPE, num_steps=7,
                              noise=_jax_draws(key, SHAPE, 7))
        assert np.abs(out.numpy() - det.numpy()).max() > 1e3 * SAMPLER_ATOL


@pytest.mark.parametrize("T, steps", [(20, 5), (1000, 8), (1000, 20)])
def test_dpm_solver_pp_2m_sample_matches_jax(T, steps):
    """The terminal step's logSNR at alpha_bar = 1 (1 / 1e-20) and the first-order fallbacks, in f32."""
    key = jax.random.PRNGKey(3)
    ref = JSa.dpm_solver_pp_2m_sample(analytic_eps, JS.linear_schedule(T), key, SHAPE, num_steps=steps)
    x_init, _ = _jax_draws(key, SHAPE, 0)
    out = PSa.dpm_solver_pp_2m_sample(analytic_eps, PS.linear_schedule(T), SHAPE, num_steps=steps, noise=x_init)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=SAMPLER_RTOL, atol=SAMPLER_ATOL)


def test_partial_forward_then_reverse_matches_jax():
    key = jax.random.PRNGKey(4)
    x0 = np.random.default_rng(4).uniform(-1, 1, SHAPE).astype(np.float32)
    start_t = 12
    ref = JSa.partial_forward_then_reverse(analytic_eps, JS.linear_schedule(*SCHED_ARGS), key, jnp.asarray(x0), start_t)
    noise = _jax_draws(key, SHAPE, start_t + 1)
    out = PSa.partial_forward_then_reverse(analytic_eps, PS.linear_schedule(*SCHED_ARGS), torch.from_numpy(x0), start_t,
                                           noise=noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=SAMPLER_RTOL, atol=SAMPLER_ATOL)


def test_to_uint8_equals_jax():
    x = np.concatenate([np.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0], np.float32),
                        np.random.default_rng(5).uniform(-1.2, 1.2, 500).astype(np.float32)])
    out = PSa.to_uint8(torch.from_numpy(x))
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), np.asarray(JSa.to_uint8(jnp.asarray(x))))


def test_generator_drives_the_samplers_reproducibly():
    sched = PS.linear_schedule(*SCHED_ARGS)
    for fn, kw in ((PSa.ddpm_sample, dict(num_steps=5)), (PSa.ddim_sample, dict(num_steps=5, eta=1.0)),
                   (PSa.dpm_solver_pp_2m_sample, dict(num_steps=5))):
        runs = [fn(analytic_eps, sched, SHAPE, torch.Generator().manual_seed(s), **kw) for s in (1, 1, 2)]
        assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


# --- the solver's properties (tests/test_sampling.py:214, 227, ported) ---

def _delta_oracle(sched, x0_star):
    """Exact eps-predictor for data concentrated at x0_star: a correct deterministic sampler returns x0_star."""
    def apply_fn(xt, t):
        return (xt - sched.sqrt_alpha_cum_prod[t].reshape(-1, 1, 1, 1) * x0_star) / \
            sched.sqrt_one_minus_alpha_cum_prod[t].reshape(-1, 1, 1, 1)
    return apply_fn


def _gaussian_oracle(sched, m, c):
    """Exact eps-predictor for x0 ~ N(m, c^2) per pixel: linear in x, curved in t."""
    def apply_fn(xt, t):
        a = sched.sqrt_alpha_cum_prod[t].reshape(-1, 1, 1, 1)
        s = sched.sqrt_one_minus_alpha_cum_prod[t].reshape(-1, 1, 1, 1)
        e_x0 = (a * c * c * xt + s * s * m) / (a * a * c * c + s * s)
        return (xt - a * e_x0) / s
    return apply_fn


def test_dpm_solver_pp_2m_exact_on_delta_oracle():
    sched = PS.linear_schedule(1000)
    out = PSa.dpm_solver_pp_2m_sample(_delta_oracle(sched, 0.37), sched, (2, 8, 8, 3), torch.Generator().manual_seed(0),
                                      num_steps=8)
    np.testing.assert_allclose(out.numpy(), 0.37, rtol=0, atol=1e-4)


def test_dpm_solver_pp_2m_beats_ddim_at_equal_steps():
    """At 15 steps on the curved Gaussian oracle DPM-Solver++(2M) lands closer to the 1000-step DDIM solution
    than 15-step DDIM does, by a margin (the JAX test measured ~0.56x)."""
    sched = PS.linear_schedule(1000)
    oracle = _gaussian_oracle(sched, m=0.3, c=0.2)
    x_init = torch.randn((2, 8, 8, 3), generator=torch.Generator().manual_seed(7))
    noise = (x_init, torch.zeros((1000, 2, 8, 8, 3)))  # eta = 0: DDIM draws no step noise
    ref = PSa.ddim_sample(oracle, sched, (2, 8, 8, 3), num_steps=1000, noise=noise)
    err_ddim = (PSa.ddim_sample(oracle, sched, (2, 8, 8, 3), num_steps=15, noise=noise) - ref).square().mean().sqrt()
    err_dpm = (PSa.dpm_solver_pp_2m_sample(oracle, sched, (2, 8, 8, 3), num_steps=15, noise=x_init) - ref
               ).square().mean().sqrt()
    assert err_dpm < 0.7 * err_ddim, (err_dpm, err_ddim)


# --- the slice: ddpm_sample with the tiny UNet ---

@pytest.fixture(scope="module")
def models():
    return build_models()


def test_ddpm_sample_with_the_unet_matches_jax(models):
    """A strided 4-step sample of the 20-step schedule through the tiny UNet."""
    diff_fn = models["jax_fns"][0]
    shape = (B, LATENT, LATENT, 3)
    key = jax.random.PRNGKey(6)
    ref = JSa.ddpm_sample(diff_fn, JS.linear_schedule(*SCHED_ARGS), key, shape, num_steps=STEPS)
    out = PSa.ddpm_sample(models["port"][0], PS.linear_schedule(*SCHED_ARGS), shape, num_steps=STEPS,
                          noise=_jax_draws(key, shape, STEPS))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=CHAIN_RTOL, atol=CHAIN_ATOL)

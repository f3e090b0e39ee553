"""The PyTorch port's samplers (diffusion/sampling.py, schedule.ddpm_step),
its fast guided translations (guidance/translate.sample_with_sgg_ddim and
sample_with_sgg_dpm) and the int8 quality check (probes/int8_quality.py)
against the JAX package, on the CPU, in f32.

jax.random's stream cannot be drawn in torch, so each test draws it in JAX,
in the split order of the JAX function, and replays it into the port through
`noise=`. The unconditional samplers are held against JAX with an analytic
eps-model (the same function on both sides: the sampler's arithmetic is what
is compared) and once with the tiny UNet of tests/torch_parity.py (its 32x32
layers attend at N = 1024 through the flash path). The guided translations
run the tiny UNet, DeepLabV3+/ResNet-18 and a 2x Swift-SRGAN with the same
perturbed weights on both sides. The SRGAN's output saturates to exactly 1.0
over parts of the image, where the seg model's max-pool sees ties that XLA
and ATen break differently, so both sides' seg function adds one fixed
low-amplitude pattern to its input (tests/test_torch_lcg.py does the same for
LCG's blacked-out regions).

Tolerances: the sampler arithmetic agrees to 2e-5 (f32 scalars in JAX's order
of operations; XLA may fuse a multiply-add); chains through the tiny models
take tests/test_torch_translate.py's 1e-4.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TINY_UNET, generator_pair, jax_fns, nhwc_to_nchw, seg_pair, tiny_unet_pair

from weatherconverter_tpu.diffusion import sampling as JSa
from weatherconverter_tpu.diffusion import schedule as JS
from weatherconverter_tpu.guidance import translate as JT
from weatherconverter_tpu_torch.core.config import UnetModelConfig
from weatherconverter_tpu_torch.diffusion import sampling as PSa
from weatherconverter_tpu_torch.diffusion import schedule as PS
from weatherconverter_tpu_torch.guidance import translate as PT
from weatherconverter_tpu_torch.models.unet import Unet
from weatherconverter_tpu_torch.probes import int8_quality as IQ

SHAPE = (2, 8, 8, 3)
B, LATENT, HR, STEPS = 2, 32, 64, 4
SCHED_ARGS = (20, 1e-3, 0.2)  # a short schedule whose steps carry real noise
LAM = 0.5
# under 'alternate': in some of LCG's masked copies a ReLU sits within rounding of 0 and opens in one framework
# only (tests/test_torch_lcg.py, SWEEP_REL_TOL), which a chain at LAM carries into the output; at this weight the
# chains agree to CHAIN_ATOL and LCG still moves the output by over 100 times it
LCG_LAM = 0.02
DITHER = 1e-2
SAMPLER_RTOL, SAMPLER_ATOL = 2e-5, 2e-5
CHAIN_RTOL, CHAIN_ATOL = 1e-4, 1e-4


def analytic_eps(xt, t):
    """A nonlinear, t-dependent eps-model, elementwise (so NHWC and NCHW alike), in either framework."""
    lib = jnp if isinstance(xt, jax.Array) else torch
    tt = t.reshape(-1, 1, 1, 1).astype(jnp.float32) if lib is jnp else t.reshape(-1, 1, 1, 1).float()
    return 0.3 * lib.tanh(xt) + 0.002 * tt


def _jax_draws(key, shape, n_steps, split3=False):
    """(x_init, z_steps) as a JAX sampler draws them: `key, init = split(key)` (or the translation's 3-way split),
    then `key, z = split(key)` a step."""
    if split3:
        key, _tkey, ikey = jax.random.split(key, 3)
    else:
        key, ikey = jax.random.split(key)
    x_init = jax.random.normal(ikey, shape)
    zs = []
    for _ in range(n_steps):
        key, zkey = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(zkey, shape)))
    return torch.from_numpy(np.array(x_init)), torch.from_numpy(np.stack(zs) if zs else np.zeros((0, *shape)))


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


# --- the slice: ddpm_sample with the tiny UNet, and the fast guided translations ---

@pytest.fixture(scope="module")
def models():
    junet, uparams, port_unet = tiny_unet_pair()
    port_unet_i8 = Unet(UnetModelConfig(**TINY_UNET), qk_int8=True).eval()
    port_unet_i8.load_state_dict(port_unet.state_dict())
    jseg, seg_vars, port_seg = seg_pair("deeplabv3plus_resnet18", HR)
    jgen, gen_vars, port_gen = generator_pair(2, hw=LATENT)
    port_seg.requires_grad_(False)
    diff_fn, seg_fn, sr_fn = jax_fns(junet, uparams, jseg, seg_vars, jgen, gen_vars)
    dither = (DITHER * np.random.default_rng(HR).standard_normal((1, HR, HR, 3))).astype(np.float32)
    port_dither = nhwc_to_nchw(dither)
    return dict(jax_fns=(diff_fn, lambda x: seg_fn(x + dither), sr_fn),
                port=(port_unet, lambda x: port_seg(x + port_dither), port_gen), port_unet_i8=port_unet_i8)


def test_ddpm_sample_with_the_unet_matches_jax(models):
    """A strided 4-step sample of the 20-step schedule through the tiny UNet."""
    diff_fn = models["jax_fns"][0]
    shape = (B, LATENT, LATENT, 3)
    key = jax.random.PRNGKey(6)
    ref = JSa.ddpm_sample(diff_fn, JS.linear_schedule(*SCHED_ARGS), key, shape, num_steps=STEPS)
    out = PSa.ddpm_sample(models["port"][0], PS.linear_schedule(*SCHED_ARGS), shape, num_steps=STEPS,
                          noise=_jax_draws(key, shape, STEPS))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=CHAIN_RTOL, atol=CHAIN_ATOL)


def _blocky_gt(rng, classes, block=8):
    small = rng.choice(np.asarray(classes), size=(B, HR // block, HR // block))
    return small.repeat(block, 1).repeat(block, 2).astype(np.int32)


def _translation_inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, LATENT, LATENT, 3)) * 0.2).astype(np.float32)
    gt = _blocky_gt(rng, [0, 3, 8, 12, 17])
    gt[:, :8, :8] = 255  # an ignored patch
    return x, gt


FAST = {"ddim": (JT.sample_with_sgg_ddim, PT.sample_with_sgg_ddim), "dpm": (JT.sample_with_sgg_dpm, PT.sample_with_sgg_dpm)}


def _fast_chain(models, sampler, seed=0, eta=0.0, **kw):
    """(JAX output, the port's output, the port's unguided output), NHWC."""
    jfn, pfn = FAST[sampler]
    x, gt = _translation_inputs(seed)
    key = jax.random.PRNGKey(seed)
    kw = dict(lam=LCG_LAM if kw.get("guidance_style") == "alternate" else LAM, num_steps=STEPS, num_classes=19,
              lcg_class_chunk=4, **kw)
    if sampler == "ddim":
        kw["eta"] = eta
    ref = jfn(*models["jax_fns"][:1], JS.linear_schedule(*SCHED_ARGS), *models["jax_fns"][1:], jnp.asarray(x),
              jnp.asarray(gt), key, **kw)
    x_init, zs = _jax_draws(key, (B, LATENT, LATENT, 3), STEPS)
    noise = (x_init, zs) if sampler == "ddim" else x_init
    args = (models["port"][0], PS.linear_schedule(*SCHED_ARGS), *models["port"][1:], torch.from_numpy(x),
            torch.from_numpy(gt).long())
    out = pfn(*args, noise=noise, **kw)
    unguided = pfn(*args, noise=noise, **dict(kw, guidance_style="none"))
    return np.asarray(ref), out.numpy(), unguided.numpy()


@pytest.mark.parametrize("sampler, style", [(sampler, style) for sampler in ("ddim", "dpm") for style in
                                            ("gsg", "alternate" if sampler == "ddim" else "alternate-present-k",
                                             "none", "reference")])
def test_fast_guided_translation_matches_jax(models, sampler, style):
    """Four steps over the default span (min(500, T) = 20): steps i = 3..1 guided (under 'alternate' i = 2 takes
    LCG: over all 19 classes for DDIM, over 3 packed slots an image for DPM), i = 0 not; 'none' and mode
    'reference' are the unguided chain."""
    kw = dict(guidance_style=style.split("-")[0])
    if style == "reference":
        kw = dict(guidance_style="gsg", mode="reference")
    if style == "alternate-present-k":
        kw["lcg_present_k"] = 3
    ref, out, unguided = _fast_chain(models, sampler, **kw)
    assert out.shape == (B, HR, HR, 3) and np.isfinite(out).all() and 0.0 <= out.min() and out.max() <= 1.0
    np.testing.assert_allclose(out, ref, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
    if style in ("none", "reference"):
        np.testing.assert_array_equal(out, unguided)
    else:  # the guidance term is what is compared: it moves the output
        assert np.abs(out - unguided).max() > 100 * CHAIN_ATOL


def test_ddim_translation_with_noise_matches_jax(models):
    """eta = 1: sigma_ddim * z is the added noise, the posterior sigma stays the guidance scale."""
    ref, out, _ = _fast_chain(models, "ddim", seed=1, eta=1.0, guidance_style="gsg")
    np.testing.assert_allclose(out, ref, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_fast_translation_takes_the_jax_signature(sampler):
    """Every keyword but `key` (a torch.Generator, or replayed `noise`, stands for it), with JAX's defaults;
    DEFAULT_TRANSLATE_SPAN is JAX's."""
    jfn, pfn = FAST[sampler]
    jax_params, port_params = inspect.signature(jfn).parameters, inspect.signature(pfn).parameters
    for name, p in jax_params.items():
        if name == "key":
            assert name not in port_params
            continue
        assert name in port_params and port_params[name].default == p.default, name
    assert set(port_params) - set(jax_params) == {"generator", "noise"}
    assert PT.DEFAULT_TRANSLATE_SPAN == JT.DEFAULT_TRANSLATE_SPAN
    with pytest.raises(ValueError, match="unknown guidance_style"):
        pfn(None, PS.linear_schedule(4), None, None, torch.zeros(1, 8, 8, 3), torch.zeros(1, 16, 16),
            guidance_style="both")


# --- probes/int8_quality, tiny, on the CPU (plain K1 and K2) ---

def _numpy_statistics(outs, n_floor):
    """scripts/int8_quality_check.py:131-161, transcribed."""
    a, pa = outs["bf16"][0].numpy(), outs["bf16"][1].numpy()

    def against_bf16(name):
        b, pb = outs[name][0].numpy(), outs[name][1].numpy()
        return float(np.corrcoef(a.ravel(), b.ravel())[0, 1]), float((pa == pb).mean())

    corr_i8, agree_i8 = against_bf16("int8")
    floor = [against_bf16(f"bf16-pert{s}") for s in range(1, n_floor + 1)]
    floor_corr, floor_agree = np.asarray([c for c, _ in floor]), np.asarray([g for _, g in floor])
    cm, cs = float(floor_corr.mean()), float(floor_corr.std(ddof=1))
    gm, gs = float(floor_agree.mean()), float(floor_agree.std(ddof=1))
    ok = agree_i8 > 0.97 and corr_i8 >= cm - 2.0 * cs and agree_i8 >= gm - 2.0 * gs
    return corr_i8, agree_i8, (cm, cs), (gm, gs), ok


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_int8_quality_probe_statistics_and_verdict(models, sampler):
    x, gt = _translation_inputs(9)
    port = models["port"]
    run_models = (port[0], models["port_unet_i8"], port[1], port[2])
    n_floor = 3
    # lam 60 drives every x0-pred of the tiny models to the clip at +-1, and all chains end alike
    artifact, outs = IQ.run(run_models, PS.linear_schedule(*SCHED_ARGS), torch.from_numpy(x),
                            torch.from_numpy(gt).long(), sampler, STEPS, n_floor, lam=LAM)
    assert set(outs) == {"bf16", "bf16-repeat", "int8", "bf16-pert1", "bf16-pert2", "bf16-pert3"}
    for out, pred, launches in outs.values():
        assert out.shape == (B, HR, HR, 3) and pred.shape == (B, HR, HR) and launches == (0, 0, 0)  # CPU: plain
    corr, agree, (cm, cs), (gm, gs), ok = _numpy_statistics(outs, n_floor)
    np.testing.assert_allclose(artifact["int8"]["pearson"], corr, rtol=0, atol=1e-9)
    assert artifact["int8"]["seg_agree"] == agree
    np.testing.assert_allclose([artifact["chaos_floor"]["pearson"]["mean"], artifact["chaos_floor"]["pearson"]["std"],
                                artifact["chaos_floor"]["seg_agree"]["mean"],
                                artifact["chaos_floor"]["seg_agree"]["std"]], [cm, cs, gm, gs], rtol=1e-9, atol=1e-12)
    assert artifact["pass"] == ok
    # the plain K2 path differs from K1 (int8 rounding), and an identical rerun does not
    assert artifact["int8"]["max_abs_diff"] > 0 and artifact["bf16_repeat"]["max_abs_diff"] == 0
    # the verdict rule itself, on made-up statistics
    fake = dict(outs, int8=(1.0 - outs["bf16"][0], outs["bf16"][1], (0, 0, 0)))  # anti-correlated
    assert IQ.statistics(fake, n_floor)["pass"] is False and _numpy_statistics(fake, n_floor)[-1] is False

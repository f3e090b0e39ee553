"""The guided chain cut into segments (guidance/translate.sample_with_sgg's
xt_init / t_offset / final_sr, and translate_entry) on the CPU, in f32.

Three segments equal the single call bit for bit, under a generator (its
state carries from one segment to the next) and under `noise=` replay (each
segment takes its slice of z_steps). They also match JAX's segmented call
(translate.py:83-85, 165-181, 254), its key stream drawn in JAX and
replayed, at tests/test_torch_translate.py's chain tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import generator_pair, jax_fns, seg_pair, tiny_unet_pair

from weatherconverter_tpu.diffusion import schedule as JS
from weatherconverter_tpu.guidance import translate as JT
from weatherconverter_tpu_torch.diffusion import schedule as PS
from weatherconverter_tpu_torch.guidance import translate as PT

B, LATENT, HR, STEPS = 2, 32, 64, 4
SCHED_ARGS = (STEPS, 1e-3, 0.2)
LAM = 0.5
# (t_offset, num_steps) of the three segments, in chain order: i = 3 | 2, 1 | 0
SEGMENTS = ((3, 1), (1, 2), (0, 1))
# f32 through four UNet steps, the guidance gradients and the final SRGAN
# pass, each summing in another order than XLA (tests/test_torch_translate.py)
CHAIN_RTOL, CHAIN_ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def models():
    junet, uparams, port_unet = tiny_unet_pair()
    jseg, seg_vars, port_seg = seg_pair("deeplabv3plus_resnet18", HR)
    jgen, gen_vars, port_gen = generator_pair(2, hw=LATENT)
    port_seg.requires_grad_(False)
    return dict(jax_fns=jax_fns(junet, uparams, jseg, seg_vars, jgen, gen_vars), port=(port_unet, port_seg, port_gen))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, LATENT, LATENT, 3)) * 0.2).astype(np.float32)
    gt = rng.integers(0, 19, (B, HR, HR)).astype(np.int32)
    gt[:, :8, :8] = 255
    return torch.from_numpy(x), torch.from_numpy(gt).long()


def _jax_noise(key):
    """The draws of a chain from `key`, in sample_with_sgg's split order."""
    shape = (B, LATENT, LATENT, 3)
    key, _tkey, nkey = jax.random.split(key, 3)
    noise0 = jax.random.normal(nkey, shape)
    zs = []
    for _ in range(STEPS):
        key, zkey = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(zkey, shape)))
    return torch.from_numpy(np.array(noise0)), torch.from_numpy(np.stack(zs))


def _port_segmented(models, x, gt, generator=None, noise=None, **kw):
    """The port's chain in SEGMENTS: (each segment's latent, the output)."""
    unet, seg, gen = models["port"]
    sched = PS.linear_schedule(*SCHED_ARGS)
    xt = PT.translate_entry(sched, x, STEPS, generator, kw.get("start_t"), None if noise is None else noise[0])
    latents = []
    for n_seg, (lo, n) in enumerate(SEGMENTS):
        last = n_seg == len(SEGMENTS) - 1
        # step s of the chain is i = STEPS - 1 - s: this segment's i = lo + n - 1 .. lo
        seg_noise = None if noise is None else (None, noise[1][STEPS - lo - n:STEPS - lo])
        xt = PT.sample_with_sgg(unet, sched, seg, gen, x, gt, generator, num_steps=n, xt_init=xt, t_offset=lo,
                                final_sr=last, noise=seg_noise, **kw)
        latents.append(xt)
    return latents[:-1], latents[-1]


@pytest.mark.parametrize("draws, style", [("generator", "gsg"), ("replay", "alternate")])
def test_three_segments_equal_the_single_call_bit_for_bit(models, draws, style):
    unet, seg, gen = models["port"]
    x, gt = _inputs(1)
    kw = dict(lam=LAM, mode="fixed", guidance_style=style, guidance_space="sr" if style == "gsg" else "latent")
    if draws == "generator":
        single = PT.sample_with_sgg(unet, PS.linear_schedule(*SCHED_ARGS), seg, gen, x, gt,
                                    torch.Generator().manual_seed(3), num_steps=STEPS, **kw)
        _, out = _port_segmented(models, x, gt, torch.Generator().manual_seed(3), **kw)
    else:
        noise = _jax_noise(jax.random.PRNGKey(2))
        single = PT.sample_with_sgg(unet, PS.linear_schedule(*SCHED_ARGS), seg, gen, x, gt, noise=noise,
                                    num_steps=STEPS, start_t=STEPS - 1, **kw)
        _, out = _port_segmented(models, x, gt, noise=noise, start_t=STEPS - 1, **kw)
    assert single.shape == (B, HR, HR, 3) and torch.isfinite(single).all()
    assert torch.equal(out, single)


def test_segments_match_jax_segments(models):
    """The inputs and key of tests/test_torch_translate.py's chain tests,
    where its tolerance was set. (At other inputs the guided chain in 'sr'
    space can already sit 4e-4 from JAX in one call, segments or not: f32
    rounding in the perturbed seg model's logits, 7e-3 apart, amplified by
    the guidance; ROADMAP lists it.)"""
    diff_fn, seg_fn, sr_fn = models["jax_fns"]
    x, gt = _inputs(0)
    key = jax.random.PRNGKey(0)
    kw = dict(lam=LAM, mode="fixed", guidance_style="gsg")
    sched = JS.linear_schedule(*SCHED_ARGS)
    # JAX's entry as its CLI's --debug-dir replicates it (cli/commands.py:217-222), then its segments
    jkey, _tkey, nkey = jax.random.split(key, 3)
    xj = jnp.asarray(x.numpy())
    xt = JS.q_sample(sched, xj, jax.random.normal(nkey, xj.shape), jnp.full((B,), STEPS - 1, jnp.int32))
    ref_latents = []
    for n_seg, (lo, n) in enumerate(SEGMENTS):
        out = JT.sample_with_sgg(diff_fn, sched, seg_fn, sr_fn, xj, jnp.asarray(gt.numpy()), jkey, num_steps=n,
                                 xt_init=xt, t_offset=jnp.int32(lo), final_sr=n_seg == len(SEGMENTS) - 1, **kw)
        if n_seg < len(SEGMENTS) - 1:
            xt, jkey = out
            ref_latents.append(np.asarray(xt))
        else:
            ref = np.asarray(out)
    latents, got = _port_segmented(models, x, gt, noise=_jax_noise(key), start_t=STEPS - 1, **kw)
    for a, r in zip(latents, ref_latents):
        np.testing.assert_allclose(a.numpy(), r, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)

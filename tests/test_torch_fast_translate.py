"""The PyTorch port's fast guided translations
(guidance/translate.sample_with_sgg_ddim and sample_with_sgg_dpm) against the
JAX package, on the CPU, in f32: JAX's key stream replayed as `noise=`, the
tiny UNet, DeepLabV3+/ResNet-18 and a 2x Swift-SRGAN with the same perturbed
weights on both sides, the seg input dithered (tests/sampling_parity.py).

Tolerance: tests/test_torch_translate.py's 1e-4 for chains through the tiny
models.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sampling_parity import (B, CHAIN_ATOL, CHAIN_RTOL, HR, LAM, LATENT, LCG_LAM, SCHED_ARGS, STEPS, build_models,
                             jax_draws, translation_inputs)

from weatherconverter_tpu.diffusion import schedule as JS
from weatherconverter_tpu.guidance import translate as JT
from weatherconverter_tpu_torch.diffusion import schedule as PS
from weatherconverter_tpu_torch.guidance import translate as PT


@pytest.fixture(scope="module")
def models():
    return build_models()


FAST = {"ddim": (JT.sample_with_sgg_ddim, PT.sample_with_sgg_ddim), "dpm": (JT.sample_with_sgg_dpm, PT.sample_with_sgg_dpm)}


def _fast_chain(models, sampler, seed=0, eta=0.0, **kw):
    """(JAX output, the port's output, the port's unguided output), NHWC."""
    jfn, pfn = FAST[sampler]
    x, gt = translation_inputs(seed)
    key = jax.random.PRNGKey(seed)
    kw = dict(lam=LCG_LAM if kw.get("guidance_style") == "alternate" else LAM, num_steps=STEPS, num_classes=19,
              lcg_class_chunk=4, **kw)
    if sampler == "ddim":
        kw["eta"] = eta
    ref = jfn(*models["jax_fns"][:1], JS.linear_schedule(*SCHED_ARGS), *models["jax_fns"][1:], jnp.asarray(x),
              jnp.asarray(gt), key, **kw)
    x_init, zs = jax_draws(key, (B, LATENT, LATENT, 3), STEPS)
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

"""The `alternate` and `lcg` schedules of the port's `sample_with_sgg`, with
the present-class packing, against the JAX package on the CPU, in f32 (the
operators are in tests/test_torch_lcg.py; the two files split the time of
one). The models, their dither and the sizes are tests/lcg_parity.py's; the
JAX noise stream is drawn in JAX and replayed into the port. Tolerance: the
GSG chain tests'.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from lcg_parity import CLASSES, HR, LAM, LATENT, SCHED_ARGS, STEPS, B, blocky_gt, build_models

from weatherconverter_tpu.diffusion import schedule as JS
from weatherconverter_tpu.guidance import translate as JT
from weatherconverter_tpu_torch.diffusion import schedule as PS
from weatherconverter_tpu_torch.guidance import translate as PT

# a chain: tests/test_torch_translate.py's CHAIN_RTOL / CHAIN_ATOL
CHAIN_RTOL, CHAIN_ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def models():
    return build_models()


def _jax_noise(key, num_steps):
    shape = (B, LATENT, LATENT, 3)
    key, _tkey, nkey = jax.random.split(key, 3)
    noise0 = jax.random.normal(nkey, shape)
    zs = []
    for _ in range(num_steps):
        key, zkey = jax.random.split(key)
        zs.append(jax.random.normal(zkey, shape))
    return torch.from_numpy(np.array(noise0)), torch.from_numpy(np.stack([np.asarray(z) for z in zs]))


def _chain_inputs(seed, classes=range(CLASSES)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, LATENT, LATENT, 3)) * 0.2).astype(np.float32)
    gt = blocky_gt(rng, list(classes))
    gt[:, :8, :8] = 255
    return x, gt


@pytest.mark.parametrize("style, space, present_k", [("alternate", "sr", None), ("lcg", "latent", None),
                                                     ("alternate", "latent", 3)])
def test_sample_with_sgg_lcg_styles_match_jax(models, style, space, present_k):
    """Four steps: under 'alternate' i = 3 and 1 take GSG, i = 2 LCG, i = 0
    nothing; under 'lcg' all three take LCG."""
    diff_fn, seg_fn, sr_fn = models["jax_fns"]
    x, gt = _chain_inputs(10, classes=[0, 3, 8, 12] if present_k else range(CLASSES))
    key = jax.random.PRNGKey(10)
    kw = dict(lam=LAM, num_steps=STEPS, num_classes=CLASSES, mode="fixed", start_t=STEPS - 1, guidance_every=1,
              guidance_style=style, guidance_space=space, lcg_class_chunk=4, lcg_present_k=present_k)
    ref = np.asarray(JT.sample_with_sgg(diff_fn, JS.linear_schedule(*SCHED_ARGS), seg_fn, sr_fn, jnp.asarray(x),
                                        jnp.asarray(gt), key, **kw))
    sched, noise = PS.linear_schedule(*SCHED_ARGS), _jax_noise(key, STEPS)
    args = (*models["port"][:1], sched, *models["port"][1:], torch.from_numpy(x), torch.from_numpy(gt).long())
    out = PT.sample_with_sgg(*args, noise=noise, **kw).numpy()
    assert out.shape == (B, HR, HR, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
    # LCG is what is compared: the chain differs from the all-GSG one by far more than the tolerance (least at
    # latent resolution, where lam is divided by pool^2)
    gsg = PT.sample_with_sgg(*args, noise=noise, **dict(kw, guidance_style="gsg")).numpy()
    assert np.abs(out - gsg).max() > 30 * CHAIN_ATOL


def test_sample_with_sgg_present_k_bit_identical_end_to_end(models):
    """`lcg_present_k` with enough slots gives the full sweep's chain bit for
    bit, through `make_translate_fn`, with every step guided."""
    x, gt = _chain_inputs(11, classes=[1, 6, 14])
    noise = _jax_noise(jax.random.PRNGKey(11), STEPS)
    outs = []
    for present_k in (None, 4):
        fn = PT.make_translate_fn(*models["port_modules"][:1], PS.linear_schedule(*SCHED_ARGS),
                                  *models["port_modules"][1:],
                                  lam=LAM, num_steps=STEPS, start_t=STEPS - 1, guidance_style="alternate",
                                  guidance_space="sr", lcg_class_chunk=4, lcg_present_k=present_k)
        outs.append(fn(torch.from_numpy(x), torch.from_numpy(gt).long(), noise=noise))
    assert torch.equal(outs[0], outs[1])


def test_sample_with_sgg_takes_every_keyword_of_the_jax_signature():
    """But `key` (a torch.Generator, or replayed noise, stands for it).
    `xt_init` / `t_offset`, the chain's segments, are ported too
    (tests/test_torch_segments.py). The defaults agree too."""
    jax_params = inspect.signature(JT.sample_with_sgg).parameters
    port_params = inspect.signature(PT.sample_with_sgg).parameters
    for name, p in jax_params.items():
        if name == "key":
            assert name not in port_params
            continue
        assert name in port_params, name
        assert port_params[name].default == p.default, name
    assert port_params["guidance_style"].default == "alternate"
    kw = {name: p.default for name, p in jax_params.items() if p.default is not inspect.Parameter.empty}
    kw.update(num_steps=2, start_t=1, lcg_present_k=2, num_classes=3)
    seg = lambda img: torch.cat([img, img.sum(1, keepdim=True)], dim=1)[:, :3]  # noqa: E731
    sr = lambda lat: torch.nn.functional.interpolate(lat, scale_factor=2).mul(0.5).add(0.5).clamp(0, 1)  # noqa: E731
    out = PT.sample_with_sgg(lambda xt, t: torch.zeros_like(xt), PS.linear_schedule(4), seg, sr,
                             torch.zeros(1, 8, 8, 3), torch.randint(0, 3, (1, 16, 16)),
                             torch.Generator().manual_seed(0), **kw)
    assert out.shape == (1, 16, 16, 3) and torch.isfinite(out).all()


def test_unknown_guidance_style_raises_as_in_jax():
    x = torch.zeros(1, 8, 8, 3)
    with pytest.raises(ValueError, match="unknown guidance_style"):
        PT.sample_with_sgg(None, PS.linear_schedule(4), None, None, x, torch.zeros(1, 16, 16), guidance_style="both")
    with pytest.raises(ValueError, match="lcg_present_k out of range"):
        PT.sample_with_sgg(None, PS.linear_schedule(4), None, None, x, torch.zeros(1, 16, 16), lcg_present_k=0)

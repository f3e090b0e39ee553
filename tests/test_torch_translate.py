"""The PyTorch port's guidance operators and guided translation against the
JAX package, on the CPU, in f32: the slice as a whole.

The models are the tiny UNet (its 32x32 layers attend at N=1024 through the
flash path), DeepLabV3+/ResNet-18 and a 2x Swift-SRGAN generator, with the
same perturbed weights on both sides. jax.random's stream cannot be drawn
in torch, so the tests draw it in JAX (split as translate.py:171-177, 185,
189) and replay it into the port through `noise=`.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import generator_pair, jax_fns, nhwc_to_nchw, seg_pair, tiny_unet_pair

from weatherconverter_tpu.diffusion import schedule as JS
from weatherconverter_tpu.guidance import sgg as JG
from weatherconverter_tpu.guidance import translate as JT
from weatherconverter_tpu.training import losses as JL
from weatherconverter_tpu_torch.diffusion import schedule as PS
from weatherconverter_tpu_torch.guidance import sgg as PG
from weatherconverter_tpu_torch.guidance import translate as PT
from weatherconverter_tpu_torch.training import losses as PL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, LATENT, HR, STEPS = 2, 32, 64, 4
# A 4-step schedule, so the steps the chain takes (t = 3..0) carry real
# noise; and a guidance weight large enough that the guidance term moves the
# output by far more than the comparison's tolerance (checked below)
SCHED_ARGS = (STEPS, 1e-3, 0.2)
LAM = 0.5


@pytest.fixture(scope="module")
def models():
    junet, uparams, port_unet = tiny_unet_pair()
    jseg, seg_vars, port_seg = seg_pair("deeplabv3plus_resnet18", HR)
    jgen, gen_vars, port_gen = generator_pair(2, hw=LATENT)
    port_seg.requires_grad_(False)
    return dict(
        jax_models=(junet, uparams, jseg, seg_vars, jgen, gen_vars),
        jax_fns=jax_fns(junet, uparams, jseg, seg_vars, jgen, gen_vars),
        port=(port_unet, port_seg, port_gen),
    )


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, LATENT, LATENT, 3)) * 0.2).astype(np.float32)
    gt = rng.integers(0, 19, (B, HR, HR)).astype(np.int32)
    gt[:, :8, :8] = 255  # an ignored patch
    return x, gt


def _jax_noise(key, num_steps):
    """The draws sample_with_sgg makes from `key`, in its split order."""
    shape = (B, LATENT, LATENT, 3)
    key, _tkey, nkey = jax.random.split(key, 3)
    noise0 = jax.random.normal(nkey, shape)
    zs = []
    for _ in range(num_steps):
        key, zkey = jax.random.split(key)
        zs.append(jax.random.normal(zkey, shape))
    return torch.from_numpy(np.array(noise0)), torch.from_numpy(np.stack([np.asarray(z) for z in zs]))


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 8, 8, 19)).astype(np.float32) * 3
    labels = rng.integers(0, 19, (2, 8, 8)).astype(np.int32)
    labels[0, :4] = 255
    port_logits = nhwc_to_nchw(logits)
    for red in ("mean", "sum", "none"):
        np.testing.assert_allclose(PL.cross_entropy_loss(port_logits, torch.from_numpy(labels), reduction=red),
                                   JL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), reduction=red),
                                   rtol=1e-5, atol=1e-5)
    everything_ignored = torch.full((2, 8, 8), 255)
    assert PL.cross_entropy_loss(port_logits, everything_ignored).item() == 0.0


def test_seg_input_gradients_match_jax(models):
    _, seg_fn, _ = models["jax_fns"]
    port_seg = models["port"][1]
    x, gt = _inputs(1)
    img = (x.repeat(2, 1).repeat(2, 2) + 1.0) / 2.0  # an HR image in [0, 1]
    ref = JG.seg_input_gradients(seg_fn, jnp.asarray(img), jnp.asarray(gt))
    grad = PG.seg_input_gradients(port_seg, nhwc_to_nchw(img), torch.from_numpy(gt).long())
    ref = np.asarray(ref)
    # f32 through ResNet-18's forward and backward, sums in another order
    np.testing.assert_allclose(grad.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-3,
                               atol=1e-4 * float(np.abs(ref).max()))
    assert all(p.grad is None for p in port_seg.parameters())  # input-only gradient


@pytest.mark.parametrize("mode", ["fixed", "reference"])
def test_apply_gsg_matches_jax(models, mode):
    _, seg_fn, _ = models["jax_fns"]
    port_seg = models["port"][1]
    x, gt = _inputs(2)
    rng = np.random.default_rng(3)
    sr_xt = rng.uniform(0, 1, (B, HR, HR, 3)).astype(np.float32)
    mu = rng.standard_normal((B, LATENT, LATENT, 3)).astype(np.float32)
    z = rng.standard_normal((B, LATENT, LATENT, 3)).astype(np.float32)
    ref = JG.apply_gsg(seg_fn, jnp.asarray(mu), jnp.float32(0.3), jnp.asarray(sr_xt), jnp.asarray(gt), LAM,
                       noise=jnp.asarray(z), mode=mode)
    out = PG.apply_gsg(port_seg, nhwc_to_nchw(mu), torch.tensor(0.3), nhwc_to_nchw(sr_xt),
                       torch.from_numpy(gt).long(), LAM, noise=nhwc_to_nchw(z), mode=mode)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def _chain(models, space, every, style="gsg", seed=0):
    """(JAX output, port output, port output with guidance off), NHWC."""
    diff_fn, seg_fn, sr_fn = models["jax_fns"]
    port_unet, port_seg, port_gen = models["port"]
    x, gt = _inputs(seed)
    key = jax.random.PRNGKey(seed)
    kw = dict(lam=LAM, num_steps=STEPS, mode="fixed", start_t=STEPS - 1, guidance_every=every,
              guidance_space=space)
    ref = JT.sample_with_sgg(diff_fn, JS.linear_schedule(*SCHED_ARGS), seg_fn, sr_fn, jnp.asarray(x),
                             jnp.asarray(gt), key, guidance_style=style, **kw)
    noise = _jax_noise(key, STEPS)
    sched = PS.linear_schedule(*SCHED_ARGS)
    gt_t = torch.from_numpy(gt).long()
    out = PT.sample_with_sgg(port_unet, sched, port_seg, port_gen, torch.from_numpy(x), gt_t,
                             guidance_style=style, noise=noise, **kw)
    unguided = PT.sample_with_sgg(port_unet, sched, port_seg, port_gen, torch.from_numpy(x), gt_t,
                                  guidance_style="none", noise=noise, **kw)
    return np.asarray(ref), out.numpy(), unguided.numpy()


# f32 through four UNet steps, up to three guidance gradients and the final
# SRGAN pass, each summing in another order than XLA
CHAIN_RTOL, CHAIN_ATOL = 1e-4, 1e-4


@pytest.mark.parametrize("every", [1, 2])
@pytest.mark.parametrize("space", ["sr", "latent"])
def test_sample_with_sgg_matches_jax(models, space, every):
    ref, out, unguided = _chain(models, space, every)
    assert out.shape == (B, HR, HR, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
    # the guidance term is what is being compared: it moves the output
    assert np.abs(out - unguided).max() > 100 * CHAIN_ATOL


def test_unguided_chain_matches_jax(models):
    ref, out, _ = _chain(models, "sr", 1, style="none", seed=4)
    np.testing.assert_allclose(out, ref, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)


def test_make_translate_fn_matches_jax(models):
    """The slice as a user drives it, in its headline setting: guidance every
    2nd step at latent resolution, with the dose-preserving lam."""
    junet, uparams, jseg, seg_vars, jgen, gen_vars = models["jax_models"]
    kw = dict(lam=2 * LAM, num_steps=STEPS, mode="fixed", start_t=STEPS - 1, guidance_style="gsg",
              guidance_every=2, guidance_space="latent")
    j_translate = JT.make_translate_fn(junet, uparams, JS.linear_schedule(*SCHED_ARGS), jseg, seg_vars,
                                       jgen, gen_vars, **kw)
    p_translate = PT.make_translate_fn(*models["port"][:1], PS.linear_schedule(*SCHED_ARGS),
                                       *models["port"][1:], **kw)
    x, gt = _inputs(5)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(j_translate(jnp.asarray(x), jnp.asarray(gt), key))
    out = p_translate(torch.from_numpy(x), torch.from_numpy(gt).long(), noise=_jax_noise(key, STEPS))
    assert out.shape == (B, HR, HR, 3) and out.dtype == torch.float32
    assert 0.0 <= out.min().item() and out.max().item() <= 1.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)


def test_reference_mode_is_the_overwritten_chain(models):
    """mode='reference' discards the guided x_t for mu + sigma: the unguided
    chain with every z = 1 (sigma is 0 at t = 0)."""
    port_unet, port_seg, port_gen = models["port"]
    x, gt = _inputs(6)
    sched = PS.linear_schedule(*SCHED_ARGS)
    noise0 = torch.randn(B, LATENT, LATENT, 3, generator=torch.Generator().manual_seed(0))
    kw = dict(lam=LAM, num_steps=STEPS, start_t=STEPS - 1, final_sr=False)
    ref_mode = PT.sample_with_sgg(port_unet, sched, port_seg, port_gen, torch.from_numpy(x),
                                  torch.from_numpy(gt).long(), guidance_style="gsg", mode="reference",
                                  noise=(noise0, torch.zeros(STEPS, B, LATENT, LATENT, 3)), **kw)
    ones = PT.sample_with_sgg(port_unet, sched, port_seg, port_gen, torch.from_numpy(x),
                              torch.from_numpy(gt).long(), guidance_style="none",
                              noise=(noise0, torch.ones(STEPS, B, LATENT, LATENT, 3)), **kw)
    assert ref_mode.shape == (B, LATENT, LATENT, 3)
    torch.testing.assert_close(ref_mode, ones, rtol=1e-6, atol=1e-6)


def test_generator_drives_the_chain_reproducibly(models):
    port_unet, port_seg, port_gen = models["port"]
    x, gt = _inputs(7)
    translate = PT.make_translate_fn(port_unet, PS.linear_schedule(*SCHED_ARGS), port_seg, port_gen,
                                     lam=LAM, num_steps=STEPS, guidance_style="gsg", guidance_every=2,
                                     guidance_space="latent")
    runs = [translate(torch.from_numpy(x), torch.from_numpy(gt).long(), torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("kw", [dict(guidance_style="alternate"), dict(guidance_style="lcg"),
                                dict(guidance_style="gsg", lcg_present_k=4),
                                dict(guidance_style="gsg")])
def test_parts_not_ported_raise(kw):
    """Spatial sharding is the part of `sample_with_sgg` still to port: it
    raises under every style (LCG, the alternate schedule and
    `lcg_present_k` are ported; tests/test_torch_lcg.py)."""
    x = torch.zeros(1, 8, 8, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PT.sample_with_sgg(None, PS.linear_schedule(4), None, None, x, torch.zeros(1, 16, 16),
                           spatial_mesh=object(), **kw)


def test_port_imports_no_jax():
    """Every module of weatherconverter_tpu_torch, and chip_smoke (imported,
    not run), imports in a fresh process without loading jax, jaxlib, flax or
    anything of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import weatherconverter_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 20, names\n"
        "assert 'weatherconverter_tpu_torch.data.datasets' in names and 'weatherconverter_tpu_torch.compat.from_jax' in names\n"
        "import chip_smoke\n"
        "assert callable(chip_smoke.main)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'weatherconverter_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr

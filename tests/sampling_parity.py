"""Shared pieces of the port's sampler and fast-translation parity tests
(tests/test_torch_sampling.py, the samplers; tests/test_torch_fast_translate.py,
the fast guided translations; tests/test_torch_int8_quality.py, the int8
quality check): the sizes, the schedule, the tolerances, JAX's key stream
replayed as `noise=`, the dithered models and the translation inputs.

jax.random's stream cannot be drawn in torch, so each test draws it in JAX,
in the split order of the JAX function, and replays it into the port through
`noise=`. The guided translations run the tiny UNet, DeepLabV3+/ResNet-18 and
a 2x Swift-SRGAN with the same perturbed weights on both sides. The SRGAN's
output saturates to exactly 1.0 over parts of the image, where the seg
model's max-pool sees ties that XLA and ATen break differently, so both
sides' seg function adds one fixed low-amplitude pattern to its input
(tests/lcg_parity.py does the same for LCG's blacked-out regions).
"""

import jax
import numpy as np
import torch
from torch_parity import TINY_UNET, generator_pair, jax_fns, nhwc_to_nchw, seg_pair, tiny_unet_pair

from weatherconverter_tpu_torch.core.config import UnetModelConfig
from weatherconverter_tpu_torch.models.unet import Unet

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


def jax_draws(key, shape, n_steps, split3=False):
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


def build_models():
    """The JAX functions and the port's models (also the tiny UNet with K2's plain path), each file's
    module-scoped `models` fixture."""
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


def blocky_gt(rng, classes, block=8):
    small = rng.choice(np.asarray(classes), size=(B, HR // block, HR // block))
    return small.repeat(block, 1).repeat(block, 2).astype(np.int32)


def translation_inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, LATENT, LATENT, 3)) * 0.2).astype(np.float32)
    gt = blocky_gt(rng, [0, 3, 8, 12, 17])
    gt[:, :8, :8] = 255  # an ignored patch
    return x, gt

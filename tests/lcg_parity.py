"""Shared pieces of the port's LCG parity tests (tests/test_torch_lcg.py, the
operators; tests/test_torch_lcg_chains.py, the chains of sample_with_sgg):
the sizes, the guidance strength, the dithered models and the blocky labels.

The models are those of tests/test_torch_translate.py: the tiny UNet,
DeepLabV3+/ResNet-18 with 19 classes and a 2x Swift-SRGAN generator, the same
perturbed weights on both sides. LCG blacks out everything outside a class,
and over an exactly constant region the ResNet stem's max-pool sees windows
of equal values: which element of a tie takes the gradient differs between
XLA and ATen (measured here: 1 % of the input gradient, 6e-4 of an LCG
update, against 2e-6 once the ties are gone). That is no property of the
operators under test, so the seg function of both sides first adds one
fixed low-amplitude pattern (DITHER) to its input, which breaks the ties and
leaves d CE / d x as it is.
"""

import numpy as np
from torch_parity import generator_pair, jax_fns, nhwc_to_nchw, seg_pair, tiny_unet_pair

B, LATENT, HR, STEPS, CLASSES = 2, 32, 64, 4, 19
SCHED_ARGS = (STEPS, 1e-3, 0.2)
LAM = 0.05
DITHER = 1e-2  # against images in [0, 1]


def build_models():
    """The JAX functions and the port's models, each file's module-scoped `models` fixture."""
    junet, uparams, port_unet = tiny_unet_pair()
    jseg, seg_vars, port_seg = seg_pair("deeplabv3plus_resnet18", HR)
    jgen, gen_vars, port_gen = generator_pair(2, hw=LATENT)
    port_seg.requires_grad_(False)
    diff_fn, seg_fn, sr_fn = jax_fns(junet, uparams, jseg, seg_vars, jgen, gen_vars)
    dither = {hw: (DITHER * np.random.default_rng(hw).standard_normal((1, hw, hw, 3))).astype(np.float32)
              for hw in (LATENT, HR)}
    port_dither = {hw: nhwc_to_nchw(d) for hw, d in dither.items()}

    def jax_seg(x):
        return seg_fn(x + dither[x.shape[1]])

    def port_seg_fn(x):
        return port_seg(x + port_dither[x.shape[2]])

    return dict(jax_fns=(diff_fn, jax_seg, sr_fn), port=(port_unet, port_seg_fn, port_gen),
                port_modules=(port_unet, port_seg, port_gen))


def blocky_gt(rng, classes, size=HR, block=8):
    """(B, size, size) labels constant over block x block squares, drawn from `classes`."""
    small = rng.choice(np.asarray(classes), size=(B, size // block, size // block))
    return small.repeat(block, 1).repeat(block, 2).astype(np.int32)

"""Shared helpers of the port's JAX-parity tests (tests/test_torch_*.py):
JAX models with perturbed parameters, and the port's twins loaded from them
through compat/from_jax with strict=True."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from weatherconverter_tpu.core.config import UnetModelConfig as JUnetConfig
from weatherconverter_tpu.models.factory import make_seg_model as j_make_seg_model
from weatherconverter_tpu.models.srgan import Generator as JGenerator
from weatherconverter_tpu.models.unet import Unet as JUnet
from weatherconverter_tpu_torch.compat import from_jax
from weatherconverter_tpu_torch.core.config import UnetModelConfig
from weatherconverter_tpu_torch.models.factory import make_seg_model
from weatherconverter_tpu_torch.models.srgan import Generator
from weatherconverter_tpu_torch.models.unet import Unet

# A tiny UNet whose first down block and last up block attend at 32x32,
# N = 1024: the flash path, with D = 16
TINY_UNET = dict(
    im_size=32, down_channels=[32, 32, 48], mid_channels=[48, 48, 32], down_sample=[True, False],
    time_emb_dim=16, num_down_layers=1, num_mid_layers=1, num_up_layers=1, num_heads=2,
    attn_resolutions=[32],
)


def perturb(tree, seed):
    """Every leaf moved off its init; BatchNorm variances stay positive."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, dtype=np.float32)
        noise = rng.standard_normal(x.shape).astype(np.float32)
        if path and getattr(path[-1], "key", None) == "var":
            return x * np.exp(0.2 * noise)
        return x + 0.05 * noise

    return jax.tree_util.tree_map_with_path(leaf, tree)


def nhwc_to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def load_strict(module, state_dict):
    result = module.load_state_dict(state_dict, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    return module.eval()


def jax_fns(junet, uparams, jseg, seg_vars, jgen, gen_vars):
    """Jitted (diff_fn, seg_fn, sr_fn) of the JAX models, NHWC."""
    return (jax.jit(lambda x, t: junet.apply({"params": uparams}, x, t)),
            jax.jit(lambda x: jseg.apply(seg_vars, x)),
            jax.jit(lambda x: jgen.apply(gen_vars, x)))


def tiny_unet_pair(qk_int8=False):
    """(JAX Unet, its perturbed params, port Unet with those weights)."""
    junet = JUnet(config=JUnetConfig(**TINY_UNET), fused=True)
    params = jax.jit(junet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,), jnp.int32))["params"]
    params = perturb(params, 1)
    port = Unet(UnetModelConfig(**TINY_UNET), qk_int8=qk_int8)
    return junet, params, load_strict(port, from_jax.unet_state_dict(params, UnetModelConfig(**TINY_UNET)))


def seg_pair(name, hw, num_classes=19):
    jseg = j_make_seg_model(name, num_classes=num_classes)
    variables = jax.jit(jseg.init)(jax.random.PRNGKey(3), jnp.zeros((1, hw, hw, 3)))
    variables = {"params": perturb(variables["params"], 4), "batch_stats": perturb(variables["batch_stats"], 5)}
    port = make_seg_model(name, num_classes=num_classes)
    return jseg, variables, load_strict(port, from_jax.deeplab_state_dict(variables, name))


def seeded_leaves(shapes, seed):
    """numpy values for a tree of shapes: kernels at He scale (so activations
    keep their size through a deep network), BatchNorm scales near 1,
    statistics and biases moved off their init values."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        key = path[-1].key
        noise = rng.standard_normal(s.shape, dtype=np.float32)
        if key == "kernel":
            return noise * np.float32(np.sqrt(2.0 / np.prod(s.shape[:-1])))
        if key == "scale":
            return 1.0 + 0.1 * noise
        if key == "var":
            return np.exp(0.2 * noise)
        return 0.05 * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def seg_pair_from_shapes(name, hw, num_classes, seed=0, output_stride=16, separable=False):
    """(JAX model, variables, port in eval()) without JAX's init: parameters
    drawn with numpy (`seeded_leaves`). Much faster than `seg_pair` for the
    wide and grouped ResNets (no init compile, no torch init). `hw` is a
    side or (H, W)."""
    h, w = (hw, hw) if isinstance(hw, int) else hw
    jseg = j_make_seg_model(name, num_classes=num_classes, output_stride=output_stride, separable=separable)
    shapes = jax.eval_shape(lambda: jseg.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3))))
    variables = seeded_leaves(shapes, seed)
    with torch.device("meta"):
        port = make_seg_model(name, num_classes=num_classes, output_stride=output_stride, separable=separable)
    port.load_state_dict(from_jax.deeplab_state_dict(variables, name), strict=True, assign=True)
    return jseg, variables, port.eval()


def generator_pair(upscale, num_blocks=2, hw=16):
    jgen = JGenerator(upscale_factor=upscale, num_blocks=num_blocks)
    variables = jax.jit(jgen.init)(jax.random.PRNGKey(4), jnp.zeros((1, hw, hw, 3)))
    variables = {"params": perturb(variables["params"], 6), "batch_stats": perturb(variables["batch_stats"], 7)}
    port = Generator(upscale_factor=upscale, num_blocks=num_blocks)
    return jgen, variables, load_strict(port, from_jax.srgan_generator_state_dict(variables, num_blocks))

"""The PyTorch port's models against the JAX package's, on the CPU, in f32.

JAX parameters (perturbed from their init so that no bias, BatchNorm
statistic or PReLU slope sits at a trivial value) cross over through
compat/from_jax and load with strict=True; the same numpy inputs go through
both. The JAX UNet runs with fused=True, so its N=1024 attention layers take
the Pallas flash kernel in interpret mode, and the port's take K1's plain
version.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TINY_UNET, generator_pair, load_strict, nhwc_to_nchw, seg_pair, tiny_unet_pair, to_nhwc

from weatherconverter_tpu.core.config import UnetModelConfig as JUnetConfig
from weatherconverter_tpu.core.config import load_translation_config as j_load_translation_config
from weatherconverter_tpu.models.unet import Unet as JUnet
from weatherconverter_tpu_torch.compat import from_jax
from weatherconverter_tpu_torch.core.config import UnetModelConfig, load_translation_config
from weatherconverter_tpu_torch.models.factory import make_seg_model
from weatherconverter_tpu_torch.models.unet import Unet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def unet_pair():
    return tiny_unet_pair()


def test_tiny_unet_matches_jax(unet_pair):
    junet, params, port = unet_pair
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    t = np.array([3, 500], dtype=np.int32)
    ref = jax.jit(junet.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        out = port(nhwc_to_nchw(x), torch.from_numpy(t).long())
    assert out.dtype == torch.float32 and out.shape == (2, 3, 32, 32)
    # f32 through ~20 convs, norms and the two attention paths, each summing
    # in another order than XLA's
    np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_tiny_unet_scalar_t_broadcasts(unet_pair):
    port = unet_pair[2]
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(port(x, 7), port(x, torch.tensor([7, 7])), rtol=0, atol=0)


def test_tiny_unet_qk_int8_matches_jax_int8_path(unet_pair, monkeypatch):
    """Unet(qk_int8=True) is the JAX UNet under WCTPU_ATTN_QK_INT8=1."""
    junet, params, port_bf = unet_pair
    port = load_strict(Unet(UnetModelConfig(**TINY_UNET), qk_int8=True), port_bf.state_dict())
    x = np.random.default_rng(1).standard_normal((1, 32, 32, 3)).astype(np.float32)
    monkeypatch.setenv("WCTPU_ATTN_QK_INT8", "1")
    ref = jax.jit(junet.apply)({"params": params}, jnp.asarray(x), jnp.asarray([20], jnp.int32))
    with torch.no_grad():
        out = port(nhwc_to_nchw(x), torch.tensor([20]))
    # a last-bit f32 difference upstream can flip one q/k rounding at a .5
    # boundary: one int8 step moves a score by qs*ks*|k8|/sqrt(D) ~ 1e-2
    # and the output by up to ~1e-3 (measured 4e-4 on 9 of 3072 values)
    np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), rtol=1e-4, atol=1e-3)


def test_unet_production_ladder_loads_export_strict():
    """The production 128px UNet's JAX layout loads into the port, strict,
    with every parameter shape equal (params from shapes only: no init)."""
    cfg = JUnetConfig()
    shapes = jax.eval_shape(
        lambda: JUnet(config=cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)),
                                       jnp.zeros((1,), jnp.int32))
    )["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = from_jax.unet_state_dict(params, cfg)
    port = Unet(UnetModelConfig())
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {k: tuple(v.shape) for k, v in sd.items()}
    load_strict(port, sd)
    attn = [m for m in port.modules() if type(m).__name__ == "SelfAttention2D"]
    assert len(attn) == 2 * (3 + 2 + 3)  # downs at 64/32/16, two mids, ups at 16/32/64


@pytest.mark.parametrize("name", ["deeplabv3plus_resnet18", "deeplabv3plus_resnet101"])
def test_deeplab_matches_jax(name):
    jseg, variables, port = seg_pair(name, 64)
    x = np.random.default_rng(2).standard_normal((1, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(jseg.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        out = port(nhwc_to_nchw(x))
    assert out.dtype == torch.float32 and out.shape == (1, 19, 64, 64)
    # f32, eval-mode BatchNorm; ResNet-101's 100+ convs accumulate more
    # reassociation error than ResNet-18's, so the bound is relative to
    # the logits' scale
    ref = np.asarray(ref)
    np.testing.assert_allclose(to_nhwc(out), ref, rtol=1e-3, atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("upscale", [2, 4])
def test_srgan_generator_matches_jax(upscale):
    jgen, variables, port = generator_pair(upscale)
    x = np.random.default_rng(3).standard_normal((2, 16, 16, 3)).astype(np.float32) * 0.5
    ref = jax.jit(jgen.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        out = port(nhwc_to_nchw(x))
    assert out.dtype == torch.float32 and out.shape == (2, 3, 16 * upscale, 16 * upscale)
    np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), rtol=1e-4, atol=1e-5)


def _export_pairs():
    """(name, the JAX exporter's numpy dict, the port's tensor dict) for the
    tiny UNet, a DeepLabV3+/ResNet and the SRGAN generator."""
    from weatherconverter_tpu.compat import torch_export as J

    _, uparams, _ = tiny_unet_pair()
    cfg = JUnetConfig(**TINY_UNET)
    yield "unet", J.export_unet(uparams, cfg), from_jax.unet_state_dict(uparams, UnetModelConfig(**TINY_UNET))
    _, seg_vars, _ = seg_pair("deeplabv3plus_resnet18", 64)
    yield ("deeplab", J.export_deeplab_resnet(seg_vars["params"], seg_vars["batch_stats"], "resnet18"),
           from_jax.deeplab_state_dict(seg_vars, "deeplabv3plus_resnet18"))
    _, gen_vars, _ = generator_pair(2)
    yield ("srgan", J.export_srgan_generator(gen_vars["params"], gen_vars["batch_stats"], 2),
           from_jax.srgan_generator_state_dict(gen_vars, 2))


def test_from_jax_state_dicts_equal_the_jax_exporter():
    """The port's own exporters against the JAX package's compat/torch_export:
    the same keys in the same order, the same dtypes and shapes, and every
    array bit for bit (layout only, no arithmetic)."""
    from weatherconverter_tpu.compat.torch_export import to_torch_state_dict

    for name, ref, got in _export_pairs():
        assert list(got) == list(ref), name
        for key, want in to_torch_state_dict(ref).items():
            assert got[key].dtype == want.dtype and got[key].shape == want.shape, (name, key)
            assert got[key].numpy().tobytes() == want.numpy().tobytes(), (name, key)
    assert from_jax.RESNET_BASIC == {"resnet18", "resnet34"}
    from weatherconverter_tpu.compat.torch_import import RESNET_LAYERS

    assert all(RESNET_LAYERS[k] == v for k, v in from_jax.RESNET_LAYERS.items())


@pytest.mark.parametrize("path", [None, "configs/translation.yaml", "configs/translation_256.yaml"])
def test_translation_config_matches_jax(path):
    """The port's copy of the schema reads the repo's YAML files (and the
    defaults) into the same values as the JAX package's, section by section."""
    path = path and os.path.join(REPO, path)
    ref, port = j_load_translation_config(path), load_translation_config(path)
    for section in ("diffusion.diffusion", "diffusion.model", "seg.model", "srgan", "guidance"):
        r, p = ref, port
        for name in section.split("."):
            r, p = getattr(r, name), getattr(p, name)
        assert p.model_dump() == r.model_dump(), section


def test_factory_refuses_models_not_ported():
    for name in ("deeplabv3_resnet50", "deeplabv3plus_mobilenet", "deeplabv3plus_resnext50_32x4d"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_seg_model(name)

"""K2 and its quantizer at head dims 24 and 192, on the CPU: the plain versions
the wrappers take for CPU tensors, against JAX's int8 path
(weatherconverter_tpu/ops/attention.py `_flash_attention_fwd_i8_impl`, its
Pallas kernel in interpret mode), which takes any head dim. D = 24 is the
legacy UNet's attn_up2 (96 channels over 4 heads at 32 x 32), D = 192 the
256 px UNet's 768-channel layers.

At N = 1024, B = 2 with row 1 scaled 10x: q8, k8 and the score scales equal
JAX's bit for bit, per tensor (JAX's function called once on the batch) and
per row (under jax.vmap, as the JAX server runs it); the output is within
tests/test_torch_ops.py's flash tolerance. Then a UNet with a D = 24
flash-length layer, built with qk_int8, against the JAX UNet under
WCTPU_ATTN_QK_INT8=1: the port takes K2 there, where it took K1 before,
and K1's result is measurably off JAX's int8 one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import load_strict, nhwc_to_nchw, perturb, to_nhwc

from weatherconverter_tpu.core.config import UnetModelConfig as JUnetConfig
from weatherconverter_tpu.models.unet import Unet as JUnet
from weatherconverter_tpu.ops import attention as JA
from weatherconverter_tpu_torch.compat import from_jax
from weatherconverter_tpu_torch.core.config import UnetModelConfig
from weatherconverter_tpu_torch.models.unet import Unet
from weatherconverter_tpu_torch.ops import attention as PA

B, H, N = 2, 2, 1024
# tests/test_torch_ops.py: the same clamped softmax with sums in another order
FLASH_RTOL, FLASH_ATOL = 1e-5, 2e-6
# a tiny UNet whose two 32 x 32 layers (N = 1024) attend on 48 channels over 2 heads: D = 24
D24_UNET = dict(
    im_size=32, down_channels=[48, 48, 64], mid_channels=[64, 64, 48], down_sample=[True, False],
    time_emb_dim=16, num_down_layers=1, num_mid_layers=1, num_up_layers=1, num_heads=2,
    attn_resolutions=[32],
)


def _qkv(d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, N, d)).astype(np.float32) for _ in range(3))
    q[1] *= 10.0  # one scale for the batch is row 1's; per row, row 0 keeps its own
    k[1] *= 10.0
    return q, k, v


def _jax_quantization(q, k, per_item):
    """The quantization lines of `_flash_attention_fwd_i8_impl`
    (attention.py:173-179, 186-188): q8, k8 and qs * ks / sqrt(D), over the
    batch, or per row under jax.vmap."""
    d = q.shape[-1]

    def one(qx, kx):
        qs = jnp.maximum(jnp.max(jnp.abs(qx)), 1e-6) / 127.0
        ks = jnp.maximum(jnp.max(jnp.abs(kx)), 1e-6) / 127.0
        return (jnp.round(qx / qs).astype(jnp.int8), jnp.round(kx / ks).astype(jnp.int8),
                (qs * ks / (d**0.5)).astype(jnp.float32))

    out = (jax.vmap(one) if per_item else one)(jnp.asarray(q), jnp.asarray(k))
    return [np.asarray(a) for a in out]


def _jax_kernel(q, k, v, per_item):
    fn = lambda a, b, c: JA._flash_attention_fwd_i8_impl(a, b, c, block_q=256, interpret=True)  # noqa: E731
    if per_item:  # the server's jax.vmap over requests: one row a call
        return np.asarray(jax.vmap(lambda a, b, c: fn(a[None], b[None], c[None])[0])(q, k, v))
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("per_item", [False, True])
@pytest.mark.parametrize("d", [24, 192])
def test_plain_k2_and_quantizer_match_jax_int8_at_head_dims_24_and_192(d, per_item):
    q, k, v = _qkv(d, seed=d + per_item)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    q8, k8, scales = PA.quantize_qk_i8(tq, tk, per_item=per_item)
    jq8, jk8, jscales = _jax_quantization(q, k, per_item)
    assert scales.shape == ((B,) if per_item else (1,))
    np.testing.assert_array_equal(q8.numpy(), jq8)
    np.testing.assert_array_equal(k8.numpy(), jk8)
    np.testing.assert_array_equal(scales.numpy(), jscales.reshape(scales.shape))
    out = PA.flash_attention_qk_i8(tq, tk, tv, per_item=per_item)
    np.testing.assert_allclose(out.numpy(), _jax_kernel(q, k, v, per_item), rtol=FLASH_RTOL, atol=FLASH_ATOL)
    assert d in PA.QK_I8_HEAD_DIMS and PA.qk_int8_takes(d, True)


@pytest.fixture(scope="module")
def d24_pair():
    junet = JUnet(config=JUnetConfig(**D24_UNET), fused=True)
    params = jax.jit(junet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,), jnp.int32))["params"]
    params = perturb(params, 2)
    sd = from_jax.unet_state_dict(params, UnetModelConfig(**D24_UNET))
    return junet, params, sd


def test_qk_int8_unet_takes_k2_at_head_dim_24_as_jax_int8(d24_pair, monkeypatch):
    """Both 32 x 32 layers of the UNet attend at (1024, 24); with qk_int8 the
    port takes K2 there (it took K1 before this head dim was K2's) and the
    output is JAX's under WCTPU_ATTN_QK_INT8=1. Tolerance: that of
    tests/test_torch_models.py's qk_int8 test, atol 1e-3 (a last-bit f32
    difference upstream can flip one q/k rounding at a .5 boundary). K1's
    exact result, which the port gave at D = 24 before, is off JAX's int8 one
    by more than ten times that."""
    junet, params, sd = d24_pair
    port = load_strict(Unet(UnetModelConfig(**D24_UNET), qk_int8=True), sd)
    exact = load_strict(Unet(UnetModelConfig(**D24_UNET)), sd)
    flash = [(n, d, kind) for n, d, kind in port.attention_kernels(32) if n >= PA.FLASH_MIN_SEQ]
    assert flash == [(1024, 24, "K2")] * 2
    x = np.random.default_rng(1).standard_normal((1, 32, 32, 3)).astype(np.float32)
    monkeypatch.setenv("WCTPU_ATTN_QK_INT8", "1")
    ref = np.asarray(jax.jit(junet.apply)({"params": params}, jnp.asarray(x), jnp.asarray([20], jnp.int32)))
    with torch.no_grad():
        out = to_nhwc(port(nhwc_to_nchw(x), torch.tensor([20])))
        k1 = to_nhwc(exact(nhwc_to_nchw(x), torch.tensor([20])))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-3)
    assert np.abs(k1 - ref).max() > 1e-2

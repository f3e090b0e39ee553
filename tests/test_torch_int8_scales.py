"""K2 and its quantizer with one int8 scale a batch row (`per_item`), the
scales the JAX server's `jax.vmap` over requests gives its int8 kernel
(weatherconverter_tpu/serving/server.py:191-226), on the CPU: the plain
versions the wrappers take for CPU tensors, against JAX's
`_flash_attention_fwd_i8_impl` (attention.py:167-207) vmapped over the
batch rows, its Pallas kernel in interpret mode.

At a flash length (N = 1024), D in {16, 32}, B = 2 with row 1 scaled 100x:
q8 and k8 equal JAX's bit for bit, and so do the score scales; the output is
within tests/test_torch_ops.py's flash tolerance. Row 0 does not move with
row 1 per row, and does with one scale for the batch. The per-tensor mode
(the default) is bit-equal to the formula it had before the switch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherconverter_tpu.ops import attention as JA
from weatherconverter_tpu_torch.ops import attention as PA

B, H, N = 2, 2, 1024
# tests/test_torch_ops.py: the same clamped softmax with sums in another order
FLASH_RTOL, FLASH_ATOL = 1e-5, 2e-6


def _qkv(d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, N, d)).astype(np.float32) for _ in range(3))
    q[1] *= 100.0  # row 1's maxima 100x row 0's: a per-tensor scale is row 1's
    k[1] *= 100.0
    return q, k, v


def _jax_row_quantization(q, k):
    """The quantization lines of `_flash_attention_fwd_i8_impl`
    (attention.py:173-179, 186-188), jax.vmap'ed over the batch rows: each
    row's q8, k8 and qs * ks / sqrt(D)."""
    d = q.shape[-1]

    def one(qr, kr):
        qr, kr = qr.astype(jnp.float32), kr.astype(jnp.float32)
        qs = jnp.maximum(jnp.max(jnp.abs(qr)), 1e-6) / 127.0
        ks = jnp.maximum(jnp.max(jnp.abs(kr)), 1e-6) / 127.0
        return (jnp.round(qr / qs).astype(jnp.int8), jnp.round(kr / ks).astype(jnp.int8),
                (qs * ks / (d**0.5)).astype(jnp.float32))

    return [np.asarray(a) for a in jax.vmap(one)(jnp.asarray(q), jnp.asarray(k))]


def _jax_vmapped_kernel(q, k, v):
    """JAX's int8 forward once per batch row, as the server's vmap calls it."""
    fn = jax.vmap(lambda a, b, c: JA._flash_attention_fwd_i8_impl(a[None], b[None], c[None], block_q=256,
                                                                   interpret=True)[0])
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("d", [16, 32])
def test_per_row_quantizer_and_k2_match_jax_vmapped(d):
    q, k, v = _qkv(d, seed=d)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    q8, k8, scales = PA.quantize_qk_i8(tq, tk, per_item=True)
    jq8, jk8, jscales = _jax_row_quantization(q, k)
    assert q8.dtype == k8.dtype == torch.int8 and scales.shape == (B,)
    np.testing.assert_array_equal(q8.numpy(), jq8)
    np.testing.assert_array_equal(k8.numpy(), jk8)
    np.testing.assert_array_equal(scales.numpy(), jscales)
    out = PA.flash_attention_qk_i8(tq, tk, tv, per_item=True)
    np.testing.assert_allclose(out.numpy(), _jax_vmapped_kernel(q, k, v), rtol=FLASH_RTOL, atol=FLASH_ATOL)
    assert torch.equal(out, PA.flash_attention_qk_i8_plain(tq, tk, tv, per_item=True))


@pytest.mark.parametrize("per_item", [True, False])
def test_row_0_moves_with_row_1_only_under_one_scale_for_the_batch(per_item):
    """Per row, row 0's int8 values, scale and output are those of row 0
    alone, bit for bit, beside a row scaled 100x; under one scale for the
    batch (the planted fault for a server) they are not."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, seed=3))
    batch, alone = PA.quantize_qk_i8(q, k, per_item=per_item), PA.quantize_qk_i8(q[:1], k[:1], per_item=per_item)
    out, out_alone = (PA.flash_attention_qk_i8(q, k, v, per_item=per_item),
                      PA.flash_attention_qk_i8(q[:1], k[:1], v[:1], per_item=per_item))
    same = [torch.equal(batch[0][:1], alone[0]), torch.equal(batch[2][:1], alone[2]), torch.equal(out[:1], out_alone)]
    assert same == [per_item] * 3


def test_per_tensor_mode_is_bit_equal_to_the_formula_before_the_switch():
    """One scale per tensor stays the default, as JAX's CLI runs its kernel
    over the batch: the quantizer and K2's plain version give the bits of
    the formula they had before `per_item` (one amax, a (1,) score scale
    broadcast over the scores), here written out."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(32, seed=5))

    def before(x):
        xf = x.float()
        scale = xf.abs().amax().clamp_min(1e-6) / xf.new_full((), 127.0)
        return torch.round(xf / scale).to(torch.int8), scale

    (q8, qs), (k8, ks) = before(q), before(k)
    qk_scale = (qs * ks / qs.new_full((), q.shape[-1] ** 0.5)).reshape(1)
    s = torch.matmul(q8.float(), k8.float().transpose(-1, -2)) * qk_scale
    p = torch.exp(s.clamp(-60.0, 60.0))
    want = (torch.matmul(p.to(v.dtype).float(), v.float()) / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    got = PA.quantize_qk_i8(q, k)
    assert torch.equal(got[0], q8) and torch.equal(got[1], k8) and torch.equal(got[2], qk_scale)
    assert torch.equal(PA.flash_attention_qk_i8(q, k, v), want)
    assert torch.equal(PA.flash_attention_qk_i8_plain(q, k, v), want)

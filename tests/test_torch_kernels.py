"""The PyTorch port's CUDA attention kernels (K1, K2, K3) against their plain
PyTorch versions, and the wrappers' dispatch rules.

The kernel tests need a CUDA card: they are marked `gpu` and skip without
one. On a machine with a card: `python -m pytest tests/test_torch_kernels.py -m gpu`.
This file imports no JAX (the card's machine has none); the JAX parity of
the plain versions is in tests/test_torch_ops.py.
"""

import numpy as np
import pytest
import torch

from weatherconverter_tpu_torch.ops import attention as A

# (B*H, N, D) of every flash call in one production UNet forward at B=8,
# 4 heads (down1, down2, up1, up2), plus small shapes that reach every
# template instance and the grid's edges
PATH_SHAPES = [(8, 4, 4096, 64), (8, 4, 1024, 128), (8, 4, 1024, 32), (8, 4, 4096, 16)]
SMALL_SHAPES = [(1, 1, 64, 16), (2, 3, 128, 32), (1, 2, 192, 64), (3, 1, 64, 128)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(shape, dtype, device, seed=0, scale=1.0):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.standard_normal(shape, dtype=np.float32) * scale).to(device, dtype)
            for _ in range(3)]


# bf16 outputs of O(1): one ulp at |o| < 1 is 2^-8; the kernel and the plain
# version differ in f32 summation order and exp rounding, so a few entries
# round to the neighbouring bf16 value
BF16_ATOL = 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SMALL_SHAPES + PATH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = _qkv(shape, dtype, cuda)
    before = A.flash_attention.launches
    o, l = A.flash_attention(q, k, v, return_l=True)
    torch.cuda.synchronize()
    assert A.flash_attention.launches == before + 1
    ref_o, ref_l = A.flash_attention_plain(q, k, v, return_l=True)
    assert o.dtype == dtype and o.shape == q.shape and l.shape == shape[:3] + (1,)
    assert (o.float() - ref_o.float()).abs().max().item() <= BF16_ATOL
    torch.testing.assert_close(l, ref_l, rtol=1e-4, atol=0)


@pytest.mark.gpu
def test_flash_kernel_clamp_fires(cuda):
    """Scores far past +-60 take the clamp on both sides, as the plain version does."""
    q, k, v = _qkv((1, 2, 128, 64), torch.bfloat16, cuda, scale=6.0)
    o = A.flash_attention(q, k, v)
    ref = A.flash_attention_plain(q, k, v)
    assert torch.isfinite(o.float()).all()
    assert (o.float() - ref.float()).abs().max().item() <= 4 * BF16_ATOL


@pytest.mark.gpu
def test_flash_kernel_takes_strided_inputs(cuda):
    """Head-split views of a (B, N, 3C) projection, as the UNet passes them."""
    b, n, h, d = 2, 1024, 4, 32
    qkv = _qkv((b, n, 3 * h * d), torch.bfloat16, cuda)[0]
    q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    torch.testing.assert_close(A.flash_attention(q, k, v), A.flash_attention_plain(q, k, v),
                               rtol=0, atol=BF16_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SMALL_SHAPES + PATH_SHAPES)
def test_flash_qk_i8_kernel_matches_plain(cuda, shape):
    q, k, v = _qkv(shape, torch.bfloat16, cuda, seed=1)
    before = A.flash_attention_qk_i8.launches
    o = A.flash_attention_qk_i8(q, k, v)
    torch.cuda.synchronize()
    assert A.flash_attention_qk_i8.launches == before + 1
    ref = A.flash_attention_qk_i8_plain(q, k, v)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    # the int32 scores are exact in both, so the tolerance is K1's
    assert (o.float() - ref.float()).abs().max().item() <= BF16_ATOL


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v = _qkv((1, 1, 128, 64), torch.float32, cuda)
    with pytest.raises(ValueError, match="dtype"):
        A.flash_attention(q, k, v)
    q, k, v = _qkv((1, 1, 96, 64), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="multiple"):
        A.flash_attention_qk_i8(q, k, v)
    q, k, v = _qkv((1, 1, 128, 48), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention(q, k, v)
    q, k, v = _qkv((1, 1, 128, 64), torch.bfloat16, cuda)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        A.flash_attention_qk_i8(q, k, v)
    q, k, v = _qkv((1, 1, 128, 64), torch.float32, cuda)
    l = torch.ones((1, 1, 128, 1), device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        A.flash_attention_bwd(q, k, v, q, q, l)


# K3 against its plain version: max |err| / max |ref| of each gradient, the
# bound JAX's own bf16 backward tests use (tests/test_ops.py:466-470). The
# kernel folds 1/l into p and m before the cast, the plain version after it,
# so the two round at different places
BWD_REL_TOL = 2e-2


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-30)).item()


def _bwd_inputs(shape, dtype, device, seed=0, qk_scale=1.0):
    q, k, v = _qkv(shape, dtype, device, seed=seed)
    q, k = (q.float() * qk_scale).to(dtype), (k.float() * qk_scale).to(dtype)
    do = _qkv(shape, dtype, device, seed=seed + 100)[0]
    o, l = A.flash_attention_plain(q, k, v, return_l=True)
    return q, k, v, o, do, l


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SMALL_SHAPES + PATH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bwd_kernel_matches_plain(cuda, shape, dtype):
    args = _bwd_inputs(shape, dtype, cuda)
    before = A.flash_attention_bwd.launches
    got = A.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    assert A.flash_attention_bwd.launches == before + 1
    ref = A.flash_attention_bwd_plain(*args)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == dtype and g.shape == shape and torch.isfinite(g.float()).all(), name
        assert _rel_err(g, r) <= BWD_REL_TOL, (name, _rel_err(g, r))


@pytest.mark.gpu
def test_flash_bwd_kernel_at_the_clamp_rails(cuda):
    """q and k scaled by 8: most scores sit past +-60, so p is at its e^60
    ceiling and the gradient mask fires on both sides (bf16, whose range
    holds e^60; the plain version's f16 cast of p would overflow)."""
    args = _bwd_inputs((1, 2, 256, 32), torch.bfloat16, cuda, seed=3, qk_scale=8.0)
    s = torch.matmul(args[0].float(), args[1].float().transpose(-1, -2)) / 32**0.5
    assert (s > 60).any() and (s < -60).any()
    for name, g, r in zip(("dq", "dk", "dv"), A.flash_attention_bwd(*args), A.flash_attention_bwd_plain(*args)):
        assert torch.isfinite(g.float()).all(), name
        assert _rel_err(g, r) <= BWD_REL_TOL, (name, _rel_err(g, r))


@pytest.mark.gpu
def test_flash_bwd_kernel_takes_strided_inputs(cuda):
    """Head-split views of a (B, N, 3C) projection, as the UNet passes them."""
    b, n, h, d = 2, 1024, 4, 32
    qkv = _qkv((b, n, 3 * h * d), torch.bfloat16, cuda)[0]
    q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    do = _qkv((b, n, h * d), torch.bfloat16, cuda, seed=5)[0].reshape(b, n, h, d).transpose(1, 2)
    o, l = A.flash_attention_plain(q, k, v, return_l=True)
    for g, r in zip(A.flash_attention_bwd(q, k, v, o, do, l), A.flash_attention_bwd_plain(q, k, v, o, do, l)):
        assert _rel_err(g, r) <= BWD_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 2, 1024, 64), (1, 4, 1024, 128), (2, 2, 4096, 16)])
def test_flash_attention_autograd_matches_autograd_through_plain(cuda, shape):
    """The autograd Function (K1 forward, K3 backward) against torch's
    autograd through `flash_attention_plain`, bf16."""
    grads = []
    for fn in (A.flash_attention, A.flash_attention_plain):
        q, k, v = (t.requires_grad_(True) for t in _qkv(shape, torch.bfloat16, cuda, seed=9))
        g = _qkv(shape, torch.float32, cuda, seed=10)[0]
        before = (A.flash_attention.launches, A.flash_attention_bwd.launches)
        (fn(q, k, v).float() * g).sum().backward()
        if fn is A.flash_attention:
            assert (A.flash_attention.launches, A.flash_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
        grads.append((q.grad, k.grad, v.grad))
    for name, g, r in zip(("dq", "dk", "dv"), *grads):
        assert g.dtype == torch.bfloat16 and _rel_err(g, r) <= BWD_REL_TOL, (name, _rel_err(g, r))


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    q, k, v = _qkv((1, 2, 1024, 16), torch.float32, "cpu")
    before = (A.flash_attention.launches, A.flash_attention_qk_i8.launches)
    torch.testing.assert_close(A.flash_attention(q, k, v), A.flash_attention_plain(q, k, v),
                               rtol=0, atol=0)
    o, l = A.flash_attention(q, k, v, return_l=True)
    assert l.shape == (1, 2, 1024, 1) and l.dtype == torch.float32
    torch.testing.assert_close(A.flash_attention_qk_i8(q, k, v), A.flash_attention_qk_i8_plain(q, k, v),
                               rtol=0, atol=0)
    assert (A.flash_attention.launches, A.flash_attention_qk_i8.launches) == before
    before_bwd = A.flash_attention_bwd.launches
    for got, want in zip(A.flash_attention_bwd(q, k, v, o, q, l), A.flash_attention_bwd_plain(q, k, v, o, q, l)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert A.flash_attention_bwd.launches == before_bwd


def test_plain_flash_gradient_matches_softmax_attention_on_cpu():
    """Where no score clamps, the clamped softmax is the softmax, and so is
    its gradient (f32: 1e-5 relative)."""
    q, k, v = _qkv((1, 2, 64, 8), torch.float32, "cpu")
    grads = []
    for fn in (A.flash_attention_plain, A.attention_reference):
        x = q.clone().requires_grad_(True)
        (fn(x, k, v) ** 2).sum().backward()
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)


def test_quantize_per_tensor_rounds_half_to_even():
    x = torch.tensor([127.0, -63.5, 0.5, 1.5, -2.5, 0.0])
    q8, scale = A.quantize_per_tensor(x)
    assert scale.item() == pytest.approx(1.0)
    assert q8.tolist() == [127, -64, 0, 2, -2, 0]
    q8, scale = A.quantize_per_tensor(torch.zeros(4))
    assert scale.item() == pytest.approx(1e-6 / 127) and q8.abs().sum().item() == 0

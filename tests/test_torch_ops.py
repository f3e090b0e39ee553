"""The PyTorch port's ops and DDPM schedule against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both. The JAX Pallas
kernels run in interpret mode (as the JAX suite runs them); the port runs
its plain versions, which are what its CUDA kernels are held to on the card
(tests/test_torch_kernels.py). Everything is f32 unless a test says
otherwise; each tolerance is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherconverter_tpu.diffusion import schedule as JS
from weatherconverter_tpu.ops import attention as JA
from weatherconverter_tpu.ops import groupnorm as JG
from weatherconverter_tpu.ops import image as JI
from weatherconverter_tpu.ops import time_embed as JT
from weatherconverter_tpu_torch.diffusion import schedule as PS
from weatherconverter_tpu_torch.ops import attention as PA
from weatherconverter_tpu_torch.ops import groupnorm as PG
from weatherconverter_tpu_torch.ops import image as PI
from weatherconverter_tpu_torch.ops import time_embed as PT


def _rand(shape, seed=0, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _close(port, ref, rtol, atol):
    np.testing.assert_allclose(np.asarray(port, dtype=np.float32), np.asarray(ref, dtype=np.float32),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# time embedding, GroupNorm, image ops
# ---------------------------------------------------------------------------


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 17, 100, 999], dtype=np.int32)
    port = PT.timestep_embedding(torch.from_numpy(t), 128)
    # f32 sin/cos of arguments up to 999 rad: a 1-ulp difference in the
    # frequency moves the argument by ~6e-5
    _close(port, JT.timestep_embedding(jnp.asarray(t), 128), rtol=0, atol=2e-4)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_jax(dtype, silu):
    x = _rand((2, 8, 8, 32), scale=2.0) + 0.5
    gamma, beta = np.linspace(0.5, 1.5, 32, dtype=np.float32), np.linspace(-0.2, 0.2, 32, dtype=np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = JG.group_norm_reference(jnp.asarray(x, jdt), jnp.asarray(gamma), jnp.asarray(beta), 8, silu=silu)
    port = PG.group_norm_reference(_nchw(x).to(tdt), torch.from_numpy(gamma), torch.from_numpy(beta), 8,
                                   silu=silu)
    assert port.dtype == tdt
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2)
    if dtype == "float32":
        _close(port, ref, rtol=1e-5, atol=1e-5)  # f32 sums in another order
    else:
        # same f32 statistics, then one rounding to bf16: at most one bf16
        # ulp apart, 2^-6 for |y| < 4
        _close(port.float(), ref, rtol=0, atol=2.0**-6)


def test_group_norm_single_pass_variance_clamps_at_zero():
    """A constant group has s2/n - mean^2 <= 0 in f32; the clamp keeps rsqrt finite."""
    x = torch.full((1, 8, 4, 4), 3.0)
    out = PG.group_norm_reference(x, torch.ones(8), torch.zeros(8), 8)
    assert torch.isfinite(out).all() and out.abs().max().item() < 1e-2


@pytest.mark.parametrize("src,dst", [(8, 16), (1, 5), (16, 64)])
def test_resize_bilinear_matches_jax(src, dst):
    x = _rand((2, src, src, 3))
    ref = JI.resize_bilinear(jnp.asarray(x), (dst, dst))
    _close(PI.resize_bilinear(_nchw(x), (dst, dst)), np.asarray(ref).transpose(0, 3, 1, 2),
           rtol=1e-5, atol=1e-6)


def test_pooling_pixel_shuffle_normalize_match_jax():
    x = _rand((2, 16, 16, 12))
    pairs = [
        (PI.avg_pool(_nchw(x), 4), JI.avg_pool(jnp.asarray(x), 4)),
        (PI.avg_pool(_nchw(x), 2, 2), JI.avg_pool(jnp.asarray(x), 2, 2)),
        (PI.global_avg_pool(_nchw(x)), JI.global_avg_pool(jnp.asarray(x))),
        (PI.pixel_shuffle(_nchw(x), 2), JI.pixel_shuffle(jnp.asarray(x), 2)),
    ]
    x3 = x[..., :3]
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    pairs.append((PI.normalize(_nchw(x3), mean, std), JI.normalize(jnp.asarray(x3), mean, std)))
    for port, ref in pairs:
        _close(port, np.asarray(ref).transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-6)


# tests/test_ops.py's shapes (a 6 x 6 map cropped to 4 x 4), then offsets where
# the halves round to even: (in - out) = 3 -> 2 (not 1), 7 -> 4 (not 3), 5 -> 2, 1 -> 0
@pytest.mark.parametrize("shape, size", [((1, 6, 6, 1), (4, 4)), ((2, 9, 10, 3), (6, 7)),
                                         ((1, 13, 12, 2), (6, 5)), ((1, 5, 9, 1), (4, 4))])
def test_center_crop_matches_jax(shape, size):
    x = _rand(shape, seed=sum(shape))
    port, ref = PI.center_crop(_nchw(x), size), JI.center_crop(jnp.asarray(x), size)
    assert tuple(port.shape) == (shape[0], shape[3], *size)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref).transpose(0, 3, 1, 2))  # a window: exact


def test_denormalize_matches_jax_and_inverts_normalize():
    """At tests/test_ops.py's shape: (1, 4, 4, 3) with ImageNet's mean and std."""
    x = np.random.default_rng(5).uniform(size=(1, 4, 4, 3)).astype(np.float32)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    y = _rand((1, 4, 4, 3), seed=6)
    ref = np.asarray(JI.denormalize(jnp.asarray(y), mean, std)).transpose(0, 3, 1, 2)
    _close(PI.denormalize(_nchw(y), mean, std), ref, rtol=1e-6, atol=1e-7)
    _close(PI.denormalize(PI.normalize(_nchw(x), mean, std), mean, std), _nchw(x), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# attention: the reference path, K1's and K2's plain versions, the dispatch
# ---------------------------------------------------------------------------


def _qkv(shape, seed=0, scale=1.0):
    arrs = [_rand(shape, seed + i, scale) for i in range(3)]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def test_attention_reference_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _qkv((2, 4, 64, 16))
    _close(PA.attention_reference(tq, tk, tv), JA.attention_reference(jq, jk, jv), rtol=1e-5, atol=1e-6)


# f32: the same clamped softmax with sums in another order
FLASH_RTOL, FLASH_ATOL = 1e-5, 2e-6


@pytest.mark.parametrize("n,d,scale", [(256, 16, 1.0), (256, 64, 1.0), (1024, 16, 1.0), (1024, 64, 1.0),
                                       (256, 64, 6.0)])
def test_flash_plain_matches_jax_flash_attention(n, d, scale):
    """scale 6 puts most scores past +-60, so the clamp fires on both sides."""
    (jq, jk, jv), (tq, tk, tv) = _qkv((1, 2, n, d), seed=n + d, scale=scale)
    _close(PA.flash_attention(tq, tk, tv), JA.flash_attention(jq, jk, jv), rtol=FLASH_RTOL, atol=FLASH_ATOL)


def test_flash_plain_o_and_l_match_jax_streaming_forward():
    (jq, jk, jv), (tq, tk, tv) = _qkv((1, 2, 1024, 32), seed=3)
    ref_o, ref_l = JA._flash_stream_fwd_impl(jq, jk, jv, interpret=True)
    o, l = PA.flash_attention(tq, tk, tv, return_l=True)
    _close(o, ref_o, rtol=FLASH_RTOL, atol=FLASH_ATOL)
    _close(l, ref_l, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n,d", [(1024, 64), (256, 16)])
def test_flash_qk_i8_plain_matches_jax_kernel(n, d):
    """Same quantization bits, exact int32 scores: only exp and the f32 sums
    may differ in their last bits."""
    (jq, jk, jv), (tq, tk, tv) = _qkv((1, 2, n, d), seed=7)
    ref = JA._flash_attention_fwd_i8_impl(jq, jk, jv, block_q=256, interpret=True)
    _close(PA.flash_attention_qk_i8(tq, tk, tv), ref, rtol=FLASH_RTOL, atol=FLASH_ATOL)


@pytest.mark.parametrize("n,path", [(1023, "reference"), (1024, "flash"), (1152, "flash")])
def test_dispatch_thresholds_match_jax(n, path):
    """Scores scaled past the clamp make the two softmaxes differ, so the
    dispatch is visible in the output."""
    (jq, jk, jv), (tq, tk, tv) = _qkv((1, 2, n, 16), seed=n, scale=6.0)
    port = PA.multi_head_attention(tq, tk, tv)
    want = PA.attention_reference(tq, tk, tv) if path == "reference" else PA.flash_attention_plain(tq, tk, tv)
    torch.testing.assert_close(port, want, rtol=0, atol=0)
    _close(port, JA.multi_head_attention(jq, jk, jv), rtol=FLASH_RTOL, atol=FLASH_ATOL)


def test_qk_int8_dispatch_matches_jax_env_switch(monkeypatch):
    (jq, jk, jv), (tq, tk, tv) = _qkv((1, 2, 1024, 64), seed=11)
    monkeypatch.setenv("WCTPU_ATTN_QK_INT8", "1")
    ref = JA.multi_head_attention(jq, jk, jv)
    _close(PA.multi_head_attention(tq, tk, tv, qk_int8=True), ref, rtol=FLASH_RTOL, atol=FLASH_ATOL)
    # below the flash length qk_int8 changes nothing, as in JAX
    (_, _, _), (sq, sk, sv) = _qkv((1, 2, 256, 64), seed=12)
    torch.testing.assert_close(PA.multi_head_attention(sq, sk, sv, qk_int8=True),
                               PA.attention_reference(sq, sk, sv), rtol=0, atol=0)


def test_qk_int8_refuses_gradients_as_jax_does():
    """JAX has no VJP for the int8 path (jax.grad through it fails to
    linearize); the port raises instead of differentiating through the
    rounding and the per-tensor scale, on the CPU as on the card."""
    (_, _, _), (tq, tk, tv) = _qkv((1, 1, 1024, 16), seed=13)
    tq.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        PA.multi_head_attention(tq, tk, tv, qk_int8=True)
    with torch.no_grad():
        out = PA.multi_head_attention(tq, tk, tv, qk_int8=True)
    torch.testing.assert_close(out, PA.flash_attention_qk_i8_plain(tq.detach(), tk, tv), rtol=0, atol=0)


def _jax_quantize_qk(q, k):
    """The quantization lines of `_flash_attention_fwd_i8_impl` (attention.py:
    173-189, pv_int8=False), run with jnp as that function runs them."""
    d = q.shape[-1]
    qr, kr = q.astype(jnp.float32), k.astype(jnp.float32)
    qs = jnp.maximum(jnp.max(jnp.abs(qr)), 1e-6) / 127.0
    ks = jnp.maximum(jnp.max(jnp.abs(kr)), 1e-6) / 127.0
    return (jnp.round(qr / qs).astype(jnp.int8), jnp.round(kr / ks).astype(jnp.int8),
            (qs * ks / (d**0.5)).astype(jnp.float32))


def _quantizer_case(name):
    shape = (2, 2, 64, 32)
    q, k = _rand(shape, seed=21), _rand(shape, seed=22, scale=3.0)
    if name == "zero":  # an all-zero tensor: the 1e-6 floor of the scale
        q = np.zeros(shape, np.float32)
    elif name == "ties":  # max|x| = 127 makes the scale 1: multiples of 0.5 are exact ties
        q = (np.random.default_rng(23).integers(-254, 255, shape) * 0.5).astype(np.float32)
        q.flat[0] = 127.0
    elif name == "outlier":  # one huge value sends everything else to 0 or +-1
        q.flat[5] = 3.0e4
    return q, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "zero", "ties", "outlier"])
def test_quantize_qk_i8_matches_jax_quantization_exactly(case, dtype):
    """Tolerance: none. The int8 tensors and the f32 score scale of the port's
    quantizer (its plain version: these are CPU tensors) equal those of the
    JAX package's quantization lines bit for bit."""
    q, k = _quantizer_case(case)
    jq, jk = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (q, k))
    tq, tk = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k))
    ref = _jax_quantize_qk(jq, jk)
    before = PA.quantize_qk_i8.launches
    q8, k8, scale = PA.quantize_qk_i8(tq, tk)
    assert PA.quantize_qk_i8.launches == before  # the plain version on the CPU: nothing is counted
    assert q8.dtype == k8.dtype == torch.int8 and scale.dtype == torch.float32 and scale.shape == (1,)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(k8.numpy(), np.asarray(ref[1]))
    assert scale.item() == float(ref[2])
    if case == "zero":
        assert not q8.any() and scale.item() > 0
    if case == "ties":  # half to even, on both sides of zero
        np.testing.assert_array_equal(q8.numpy(), np.round(q).astype(np.int8))
        assert (np.abs(q) % 1 == 0.5).any()


def test_quantize_qk_i8_refuses_gradients():
    q, k = (torch.from_numpy(a) for a in _quantizer_case("random"))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        PA.quantize_qk_i8(q, k)
    with torch.no_grad():
        for got, want in zip(PA.quantize_qk_i8(q, k), PA.quantize_qk_i8_plain(q, k)):
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# attention backward: K3's plain version and the autograd Function
# ---------------------------------------------------------------------------

# f32 against f32, as tests/test_ops.py:519-527 holds the JAX backwards to
# each other: the same sums in another order
BWD_TOL = 3e-4
# (the last two: the default UNet's wide head dims, which the f32 flash backward, K3-f32, serves on the card)
BWD_SHAPES = [(1, 2, 1024, 32), (1, 2, 256, 16), (1, 1, 1024, 64), (1, 1, 1024, 128)]


def _bwd_case(shape, seed, qk_scale):
    """(jax q, k, v, dO), (torch q, k, v, dO); q and k scaled by qk_scale."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(shape, seed=seed)
    jq, jk, tq, tk = jq * qk_scale, jk * qk_scale, tq * qk_scale, tk * qk_scale
    g = _rand(shape, seed + 10)
    return (jq, jk, jv, jnp.asarray(g)), (tq, tk, tv, torch.from_numpy(g))


@pytest.mark.parametrize("qk_scale", [1.0, 8.0])
@pytest.mark.parametrize("variant", ["v1", "v2", "stream"])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_bwd_plain_matches_jax_backwards(monkeypatch, shape, variant, qk_scale):
    """The resident backward (v1; v2 through WCTPU_ATTN_BWD_V2=1) and the
    streaming backward (through WCTPU_ATTN_STREAM=1), in interpret mode.
    qk_scale 8 puts most scores past +-60: p sits at its e^60 ceiling and
    the gradient mask fires on both sides."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _bwd_case(shape, seed=shape[2] + shape[3], qk_scale=qk_scale)
    if qk_scale > 1:
        s = np.einsum("bhnd,bhmd->bhnm", np.asarray(jq), np.asarray(jk)) / shape[3] ** 0.5
        assert (s > 60).mean() > 0.1 and (s < -60).mean() > 0.1
    if variant == "stream":
        monkeypatch.setenv("WCTPU_ATTN_STREAM", "1")
        ref = jax.vjp(JA.flash_attention, jq, jk, jv)[1](jg)
    else:
        if variant == "v2":
            monkeypatch.setenv("WCTPU_ATTN_BWD_V2", "1")
        jo = JA.flash_attention(jq, jk, jv)
        ref = JA._flash_attention_bwd_impl(jq, jk, jv, jo, jg, block_q=JA._pick_bwd_block(shape[2], shape[3]),
                                           interpret=True)
    o, l = PA.flash_attention_plain(tq, tk, tv, return_l=True)
    for port, want in zip(PA.flash_attention_bwd(tq, tk, tv, o, tg, l), ref):
        _close(port, want, rtol=BWD_TOL, atol=BWD_TOL)


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_attention_autograd_matches_jax_vjp(shape):
    """`flash_attention` on inputs that require grad (the autograd Function:
    plain forward with l, K3's plain backward) against jax.vjp of JAX's
    `flash_attention` (custom_vjp, interpret mode)."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _bwd_case(shape, seed=21, qk_scale=1.0)
    ref_o, vjp = jax.vjp(JA.flash_attention, jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    before = PA.flash_attention_bwd.launches
    o = PA.flash_attention(*leaves)
    (o * tg).sum().backward()
    assert PA.flash_attention_bwd.launches == before  # CPU tensors: the plain version, uncounted
    _close(o.detach(), ref_o, rtol=FLASH_RTOL, atol=FLASH_ATOL)
    for leaf, want in zip(leaves, vjp(jg)):
        _close(leaf.grad, want, rtol=BWD_TOL, atol=BWD_TOL)


# ---------------------------------------------------------------------------
# DDPM schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["linear", "cosine"])
def test_schedule_tables_match_jax(kind):
    ref, port = JS.make_schedule(kind, 1000), PS.make_schedule(kind, 1000)
    for name in ("betas", "alphas", "alpha_cum_prod", "sqrt_alpha_cum_prod", "one_minus_cum_prod",
                 "sqrt_one_minus_alpha_cum_prod"):
        # f32 tables built in another order: the cosine betas are 1 - (a ratio
        # near 1), so they carry a few ulp of 1.0 (1.2e-7) of absolute error,
        # and a cumprod of 1000 such factors drifts by ~1000 x 1e-7 relative
        _close(getattr(port, name), getattr(ref, name), rtol=3e-4, atol=5e-7)
    assert port.T == ref.T == 1000


def test_schedule_functions_match_jax():
    ref, port = JS.linear_schedule(1000), PS.linear_schedule(1000)
    x0, eps, xt = _rand((4, 8, 8, 3), 1), _rand((4, 8, 8, 3), 2), _rand((4, 8, 8, 3), 3)
    tb = np.array([0, 1, 500, 999], dtype=np.int32)
    j = [jnp.asarray(a) for a in (x0, eps, xt)]
    p = [_nchw(a) for a in (x0, eps, xt)]
    for t_j, t_p in ((jnp.asarray(tb), torch.from_numpy(tb).long()), (jnp.asarray(7), 7)):
        pairs = [
            (PS.q_sample(port, p[0], p[1], t_p), JS.q_sample(ref, j[0], j[1], t_j)),
            (PS.predict_x0(port, p[2], p[1], t_p), JS.predict_x0(ref, j[2], j[1], t_j)),
            (PS.posterior_mean(port, p[2], p[1], t_p), JS.posterior_mean(ref, j[2], j[1], t_j)),
        ]
        for a, b in pairs:
            _close(a, np.asarray(b).transpose(0, 3, 1, 2), rtol=1e-4, atol=1e-5)
    for mode in ("posterior", "beta"):
        _close(PS.posterior_sigma(port, torch.from_numpy(tb).long(), mode),
               JS.posterior_sigma(ref, jnp.asarray(tb), mode), rtol=1e-4, atol=1e-7)
        for t in (0, 1, 999):
            _close(PS.posterior_sigma(port, t, mode), JS.posterior_sigma(ref, t, mode), rtol=1e-4, atol=1e-7)
    # the t = 0 guard: no variance, and no wrap to acp[-1]
    assert PS.posterior_sigma(port, 0).item() == 0.0
    assert PS.posterior_sigma(port, torch.tensor([0, 5]))[0].item() == 0.0

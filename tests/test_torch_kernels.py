"""The PyTorch port's CUDA kernels against their plain PyTorch versions: the
attention kernels (K1, K2, K3) and the micro-probes' kernels (K4-K7), and
the wrappers' dispatch rules.

The kernel tests need a CUDA card: they are marked `gpu` and skip without
one. On a machine with a card: `python -m pytest tests/test_torch_kernels.py -m gpu`.
This file imports no JAX (the card's machine has none); the JAX parity of
the plain versions is in tests/test_torch_ops.py and tests/test_torch_probes.py.
"""

import contextlib

import numpy as np
import pytest
import torch

from weatherconverter_tpu_torch.ops import attention as A

# (B*H, N, D) of every flash call in one production UNet forward at B=8,
# 4 heads (down1, down2, up1, up2), plus small shapes that reach every
# template instance and the grid's edges
PATH_SHAPES = [(8, 4, 4096, 64), (8, 4, 1024, 128), (8, 4, 1024, 32), (8, 4, 4096, 16)]
SMALL_SHAPES = [(1, 1, 64, 16), (2, 3, 128, 32), (1, 2, 192, 64), (3, 1, 64, 128)]
# N = 2048 at every head dim: between the two lengths of the path (32 tiles
# of 64 rows; SMALL_SHAPES hold one, two and three)
MID_SHAPES = [(1, 2, 2048, 16), (2, 1, 2048, 32), (1, 2, 2048, 64), (1, 1, 2048, 128)]
ALL_SHAPES = SMALL_SHAPES + MID_SHAPES + PATH_SHAPES
HEAD_DIMS = [16, 32, 64, 128]
# K1, K2 and K3 also take D = 192 (three 64-column panels a tile): the 256 px
# UNet's 768-channel layers at batch 2, and one, three and five tiles of it
# (K1's and K2's blocks of 128 rows: a half block at N = 64, 192 and 320)
D192_SHAPES = [(1, 2, 64, 192), (1, 2, 192, 192), (1, 2, 320, 192), (2, 4, 1024, 192)]
FLASH_SHAPES = ALL_SHAPES + D192_SHAPES
FLASH_HEAD_DIMS = HEAD_DIMS + [192]
# K1 alone also takes D = 24 (D = 32 tiles whose last 8 columns the copy
# zero-fills): the legacy UNet's attn_up2 at batch 8, 4 heads, and one, three
# and 32 tiles of it
D24_SHAPES = [(1, 1, 64, 24), (2, 3, 192, 24), (1, 2, 2048, 24), (8, 4, 1024, 24)]
K1_SHAPES = FLASH_SHAPES + D24_SHAPES
K1_HEAD_DIMS = FLASH_HEAD_DIMS + [24]


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
# and relative to the output's size, max |err| / max |ref|: at N = 4096 the
# outputs are about 0.03 and at most 0.1-0.2, where 1e-2 absolute would let a
# dropped key tile (1.5 % of the keys, 0.1 of max |O|) pass. Kernel and plain
# version round nearly equal f32 values, so they differ by at most one ulp of
# the output type, 2^-7 of the value in bf16
FWD_REL_TOL = 1e-2


def _within_forward_gate(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    return err <= BF16_ATOL and err / ref.float().abs().max().item() <= FWD_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K1_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = _qkv(shape, dtype, cuda)
    before = (A.flash_attention.launches, A.flash_attention.launches_by_head_dim.get(shape[-1], 0))
    o, l = A.flash_attention(q, k, v, return_l=True)
    torch.cuda.synchronize()
    assert (A.flash_attention.launches, A.flash_attention.launches_by_head_dim[shape[-1]]) == (before[0] + 1,
                                                                                             before[1] + 1)
    ref_o, ref_l = A.flash_attention_plain(q, k, v, return_l=True)
    assert o.dtype == dtype and o.shape == q.shape and l.shape == shape[:3] + (1,)
    assert _within_forward_gate(o, ref_o)
    # l is an f32 sum of the same exponentials in another order; at D = 192 (the l K3 reads in the 256 px UNet's
    # training step) held to 1e-5
    torch.testing.assert_close(l, ref_l, rtol=1e-5 if shape[-1] == 192 else 1e-4, atol=0)
    # no atomics on the forward's path: the same bits again
    again = A.flash_attention(q, k, v, return_l=True)
    assert torch.equal(o, again[0]) and torch.equal(l, again[1])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_qk_i8", "exp2_attention"])
def test_forward_gate_refuses_a_dropped_key_tile(cuda, name):
    """One 64-key tile of 64 left out of the plain version's P V product at
    N = 4096 (l kept): the gate that K1, K2 and K4 are held to refuses that
    output, and passes the kernel's."""
    shape, tile = (2, 4, 4096, 64), slice(1024, 1088)
    q, k, v = _qkv(shape, torch.bfloat16, cuda, seed=40)
    kernel, plain = {"flash_attention": (A.flash_attention, A.flash_attention_plain),
                     "flash_attention_qk_i8": (A.flash_attention_qk_i8, A.flash_attention_qk_i8_plain),
                     "exp2_attention": (K4.exp2_attention, K4.exp2_attention_plain)}[name]
    ref = plain(q, k, v)
    assert _within_forward_gate(kernel(q, k, v), ref)
    v_dropped = v.clone()
    v_dropped[:, :, tile] = 0  # p of those keys still counts in l: their share of O is gone
    dropped = plain(q, k, v_dropped)
    assert not _within_forward_gate(dropped, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernels_at_n_16384(cuda, dtype):
    """256 tiles of 64 keys, the length of a 128 x 128 map: K1 with l, then K3
    on its output, each against its plain version."""
    shape = (1, 1, 16384, 64)
    q, k, v = _qkv(shape, dtype, cuda, seed=41)
    o, l = A.flash_attention(q, k, v, return_l=True)
    ref_o, ref_l = A.flash_attention_plain(q, k, v, return_l=True)
    assert _within_forward_gate(o, ref_o)
    torch.testing.assert_close(l, ref_l, rtol=1e-4, atol=0)
    do = _qkv(shape, dtype, cuda, seed=141)[0]
    got = A.flash_attention_bwd(q, k, v, ref_o, do, ref_l)
    ref = A.flash_attention_bwd_plain(q, k, v, ref_o, do, ref_l)
    for name, g, r, again in zip(("dq", "dk", "dv"), got, ref, A.flash_attention_bwd(q, k, v, ref_o, do, ref_l)):
        assert torch.isfinite(g.float()).all() and _rel_err(g, r) <= BWD_REL_TOL, (name, _rel_err(g, r))
        assert torch.equal(g, again), name


@pytest.mark.gpu
def test_flash_kernel_clamp_fires(cuda):
    """Scores far past +-60 take the clamp on both sides, as the plain version does."""
    q, k, v = _qkv((1, 2, 128, 64), torch.bfloat16, cuda, scale=6.0)
    o = A.flash_attention(q, k, v)
    ref = A.flash_attention_plain(q, k, v)
    assert torch.isfinite(o.float()).all()
    assert (o.float() - ref.float()).abs().max().item() <= 4 * BF16_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("d", K1_HEAD_DIMS)
@pytest.mark.parametrize("n", [192, 256])
def test_flash_kernel_at_both_clamp_rails(cuda, d, n):
    """q and k scaled so that scores pass +60 and -60 at every head dim, at
    an odd and an even count of 64-key tiles (N = 192 fills the three-deep
    tile ring once, N = 256 wraps it): O and l as the plain version's (bf16,
    whose range holds e^60)."""
    q, k, v = _qkv((2, 2, n, d), torch.bfloat16, cuda, seed=d + n)
    gain = 2.0 * (60.0 / d**0.5) ** 0.5
    q, k = (q.float() * gain).to(torch.bfloat16), (k.float() * gain).to(torch.bfloat16)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / d**0.5
    assert (s > 60).any() and (s < -60).any()
    o, l = A.flash_attention(q, k, v, return_l=True)
    ref_o, ref_l = A.flash_attention_plain(q, k, v, return_l=True)
    assert torch.isfinite(o.float()).all() and torch.isfinite(l).all()
    assert (o.float() - ref_o.float()).abs().max().item() <= 4 * BF16_ATOL
    # l sums exp2(s * log2 e) in the kernel and exp(s) in the plain version:
    # at |s| near 60 the f32 argument's rounding moves p by up to ~60 * 2^-23
    torch.testing.assert_close(l, ref_l, rtol=1e-4, atol=0)


@pytest.mark.gpu
def test_flash_kernel_takes_strided_inputs(cuda):
    """Head-split views of a (B, N, 3C) projection, as the UNet passes them."""
    b, n, h, d = 2, 1024, 4, 32
    qkv = _qkv((b, n, 3 * h * d), torch.bfloat16, cuda)[0]
    q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    torch.testing.assert_close(A.flash_attention(q, k, v), A.flash_attention_plain(q, k, v),
                               rtol=0, atol=BF16_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ALL_SHAPES + D24_SHAPES + D192_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_qk_i8_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = _qkv(shape, dtype, cuda, seed=1)
    before = (A.flash_attention_qk_i8.launches, A.quantize_qk_i8.launches)
    o = A.flash_attention_qk_i8(q, k, v)
    torch.cuda.synchronize()
    assert (A.flash_attention_qk_i8.launches, A.quantize_qk_i8.launches) == (before[0] + 1, before[1] + 1)
    ref = A.flash_attention_qk_i8_plain(q, k, v)
    assert o.dtype == dtype and o.shape == q.shape
    # the int32 scores are exact in both, so the tolerance is K1's
    assert _within_forward_gate(o, ref)
    # no atomics on the forward's path and a maximum is order-free: the same bits again
    assert torch.equal(o, A.flash_attention_qk_i8(q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("n", [192, 256])
def test_flash_qk_i8_kernel_at_both_clamp_rails(cuda, d, n):
    """q and k scaled so that the quantized scores pass +60 and -60 at every
    head dim, at an odd and an even count of 64-key tiles (bf16, whose range
    holds e^60; f16 cannot hold p there, in the kernel or the plain version)."""
    q, k, v = _qkv((2, 2, n, d), torch.bfloat16, cuda, seed=d + n)
    gain = 2.0 * (60.0 / d**0.5) ** 0.5
    q, k = (q.float() * gain).to(torch.bfloat16), (k.float() * gain).to(torch.bfloat16)
    q8, k8, qk_scale = A.quantize_qk_i8_plain(q, k)
    s = torch.matmul(q8.float(), k8.float().transpose(-1, -2)) * qk_scale
    assert (s > 60).any() and (s < -60).any()
    o = A.flash_attention_qk_i8(q, k, v)
    assert torch.isfinite(o.float()).all()
    assert (o.float() - A.flash_attention_qk_i8_plain(q, k, v).float()).abs().max().item() <= 4 * BF16_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_qk_i8_kernel_takes_strided_inputs(cuda, d):
    """Head-split views of a (B, N, 3C) projection, as the UNet passes them:
    the quantizer reads q and k in place."""
    b, n, h = 2, 1024, 4
    qkv = _qkv((b, n, 3 * h * d), torch.bfloat16, cuda)[0]
    q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous() and A._row_strides(q) is not None
    for got, want in zip(A.quantize_qk_i8(q, k), A.quantize_qk_i8_plain(q, k)):
        assert got.is_contiguous() and torch.equal(got, want)
    torch.testing.assert_close(A.flash_attention_qk_i8(q, k, v), A.flash_attention_qk_i8_plain(q, k, v),
                               rtol=0, atol=BF16_ATOL)


def _quantizer_inputs(case, shape, dtype, device):
    q, k = _qkv(shape, dtype, device, seed=30)[:2]
    if case == "zero":  # the 1e-6 floor of the scale
        q = torch.zeros_like(q)
    elif case == "ties":  # max|x| = 127 makes the scale 1: every multiple of 0.5 is a tie
        g = np.random.default_rng(31)
        q = torch.from_numpy(g.integers(-254, 255, shape) * 0.5).to(device, dtype)
        q.view(-1)[0] = 127.0
    elif case == "outlier":  # one huge value: everything else quantizes to 0 or +-1
        q.view(-1)[7] = 3.0e4
    elif case == "misaligned":  # rows 16 bytes apart but the base 2 bytes off: copied, then quantized
        q = torch.cat([q.reshape(-1), q.new_zeros(8)])[1:1 + q.numel()].view(shape)
    return q, k


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "zero", "ties", "outlier", "misaligned"])
@pytest.mark.parametrize("shape", [(1, 1, 64, 16), (2, 3, 128, 32), (1, 2, 192, 64), (8, 4, 1024, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_quantize_qk_i8_kernel_equals_plain_bit_for_bit(cuda, case, shape, dtype):
    """Tolerance: none, for the int8 tensors and for the f32 scale."""
    q, k = _quantizer_inputs(case, shape, dtype, cuda)
    before = A.quantize_qk_i8.launches
    got = A.quantize_qk_i8(q, k)
    torch.cuda.synchronize()
    assert A.quantize_qk_i8.launches == before + 1
    want = A.quantize_qk_i8_plain(q, k)
    assert got[0].dtype == got[1].dtype == torch.int8 and got[2].dtype == torch.float32 and got[2].shape == (1,)
    for name, g, w in zip(("q8", "k8", "qk_scale"), got, want):
        assert torch.equal(g, w), name
    # the plain version gives the same bits on the CPU (its divisors are tensors)
    for name, g, w in zip(("q8", "k8", "qk_scale"), got, A.quantize_qk_i8_plain(q.cpu(), k.cpu())):
        assert torch.equal(g.cpu(), w), name
    for g, again in zip(got, A.quantize_qk_i8(q, k)):
        assert torch.equal(g, again)


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
@pytest.mark.parametrize("which", ["q", "k"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_quantize_qk_i8_kernel_surfaces_non_finite_input(cuda, bad, which, dtype):
    """One inf or NaN element reaches the scale, as in the plain version (inf
    for an infinity, NaN for a NaN), instead of being quantized silently; with
    an infinity the int8 tensors are the plain version's too (zero in that
    tensor), but for the element itself: it divides to NaN, whose cast to int8
    is not defined. Tolerance: none."""
    q, k = _qkv((2, 2, 128, 32), dtype, cuda, seed=33)[:2]
    (q if which == "q" else k).view(-1)[1234] = bad
    got, want = A.quantize_qk_i8(q, k), A.quantize_qk_i8_plain(q, k)
    assert not torch.isfinite(want[2]).any()
    assert torch.equal(got[2], want[2]) or (torch.isnan(got[2]).all() and torch.isnan(want[2]).all())
    if bad == bad:  # with a NaN every element divides to NaN
        for g, w in zip(got[:2], want[:2]):
            g, w = g.clone(), w.clone()
            g.view(-1)[1234] = w.view(-1)[1234] = 0
            assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "zero", "ties", "outlier", "misaligned", "views", "row_x100"])
@pytest.mark.parametrize("shape", [(2, 3, 128, 32), (3, 2, 192, 64), (8, 4, 1024, 128), (8, 4, 4096, 16),
                                   (2, 3, 192, 24), (2, 4, 1024, 192)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_quantize_qk_i8_kernel_per_item_equals_plain_bit_for_bit(cuda, case, shape, dtype):
    """One scale a batch row (`per_item`, the server's): the int8 tensors and
    the B scales equal the plain version's (tolerance: none), and each row's
    equal those of the row quantized alone, also where one row's maximum is
    100x the others' or the rows are head-split views of one projection."""
    b, h, n, d = shape
    if case == "views":
        qkv = _qkv((b, n, 3 * h * d), dtype, cuda, seed=34)[0]
        q, k = (t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1)[:2])
    else:
        q, k = _quantizer_inputs("random" if case == "row_x100" else case, shape, dtype, cuda)
        if case == "row_x100":
            q[1], k[1] = q[1] * 100, k[1] * 100
    got = A.quantize_qk_i8(q, k, per_item=True)
    assert got[2].shape == (b,) and got[0].is_contiguous() and got[1].is_contiguous()
    for name, g, w in zip(("q8", "k8", "qk_scale"), got, A.quantize_qk_i8_plain(q, k, per_item=True)):
        assert torch.equal(g, w), name
    for row in (0, b - 1):
        alone = A.quantize_qk_i8(q[row:row + 1], k[row:row + 1], per_item=True)
        for g, a in zip(got, alone):
            assert torch.equal(g[row:row + 1], a)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PATH_SHAPES + [(2, 3, 128, 32), (3, 1, 192, 64), (2, 2, 320, 192),
                                   (2, 4, 1024, 192)])
def test_flash_qk_i8_kernel_per_item_matches_plain_and_keeps_rows_apart(cuda, shape):
    """K2 with one scale a batch row reads scale b for the heads of row b:
    within the forward gate of its plain version, bit-equal over two calls,
    and row 0's output is that of row 0 alone when row 1 is scaled 100x
    (bf16: row 1's scores pass the clamp, and f16 cannot hold p = e^60, in
    the kernel or the plain version)."""
    q, k, v = _qkv(shape, torch.bfloat16, cuda, seed=35)
    q[1], k[1] = q[1] * 100, k[1] * 100
    before = (A.flash_attention_qk_i8.launches, A.quantize_qk_i8.launches)
    o = A.flash_attention_qk_i8(q, k, v, per_item=True)
    torch.cuda.synchronize()
    assert (A.flash_attention_qk_i8.launches, A.quantize_qk_i8.launches) == (before[0] + 1, before[1] + 1)
    assert _within_forward_gate(o, A.flash_attention_qk_i8_plain(q, k, v, per_item=True))
    assert torch.equal(o, A.flash_attention_qk_i8(q, k, v, per_item=True))
    assert torch.equal(o[:1], A.flash_attention_qk_i8(q[:1], k[:1], v[:1], per_item=True))
    assert not torch.equal(o[:1], A.flash_attention_qk_i8(q, k, v)[:1])  # one scale for the batch: row 1's


@pytest.mark.gpu
@pytest.mark.parametrize("d", [24, 32, 128, 192])
@pytest.mark.parametrize("per_item", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_quantize_qk_i8_kernel_on_head_split_views_at_every_width(cuda, d, per_item, dtype):
    """q and k as head-split views of one (B, N, 3C) projection, read in
    place, at the UNets' head dims D = 24 to 192: equal to the plain version
    (tolerance: none), two calls equal."""
    b, h, n = 2, 4, 1024
    qkv = _qkv((b, n, 3 * h * d), dtype, cuda, seed=37 + d)[0]
    q, k = (t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1)[:2])
    assert not q.is_contiguous() and A._row_strides(q) is not None
    got = A.quantize_qk_i8(q, k, per_item=per_item)
    for name, g, w, again in zip(("q8", "k8", "qk_scale"), got, A.quantize_qk_i8_plain(q, k, per_item=per_item),
                                 A.quantize_qk_i8(q, k, per_item=per_item)):
        assert torch.equal(g, w) and torch.equal(g, again), name


@pytest.mark.gpu
@pytest.mark.parametrize("per_item", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_quantize_qk_i8_kernel_after_a_larger_call(cuda, per_item, dtype):
    """The quantizer's scratch slots are written in full by every call and
    never filled: a small call right after a large one (whose maxima are
    100x larger) and a large one right after a small one each equal the
    plain version (tolerance: none)."""
    big = [t * 100 for t in _qkv((8, 4, 4096, 64), dtype, cuda, seed=38)[:2]]
    small = _qkv((2, 1, 64, 16), dtype, cuda, seed=39)[:2]
    for q, k in (big, small, big):
        got = A.quantize_qk_i8(q, k, per_item=per_item)
        for name, g, w in zip(("q8", "k8", "qk_scale"), got, A.quantize_qk_i8_plain(q, k, per_item=per_item)):
            assert torch.equal(g, w), name


@pytest.mark.gpu
@pytest.mark.parametrize("per_item", [False, True])
def test_quantize_qk_i8_is_one_launch(cuda, per_item):
    """A quantizer call runs one kernel on the card: no fill of the maxima
    before it, no second pass after it (torch.profiler's device events)."""
    q, k = _qkv((8, 4, 1024, 128), torch.bfloat16, cuda, seed=40)[:2]
    A.quantize_qk_i8(q, k, per_item=per_item)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        A.quantize_qk_i8(q, k, per_item=per_item)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "quantize_qk_kernel" in kernels[0], kernels


@pytest.mark.gpu
def test_flash_qk_i8_forward_takes_one_scale_or_one_a_row(cuda):
    q, k, v = _qkv((3, 2, 128, 64), torch.bfloat16, cuda, seed=36)
    q8, k8, scales = A.quantize_qk_i8(q, k, per_item=True)
    with pytest.raises(ValueError, match="scales"):
        A.flash_qk_i8_forward(q8, k8, scales[:2].contiguous(), v)
    torch.testing.assert_close(A.flash_qk_i8_forward(q8, k8, scales, v),
                               A.flash_attention_qk_i8_plain(q, k, v, per_item=True), rtol=0, atol=BF16_ATOL)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v = _qkv((1, 1, 128, 64), torch.float64, cuda)  # f32 takes K1-f32; no kernel takes f64
    with pytest.raises(ValueError, match="dtype"):
        A.flash_attention(q, k, v)
    q, k, v = _qkv((1, 1, 96, 64), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="multiple"):
        A.flash_attention_qk_i8(q, k, v)
    q, k, v = _qkv((1, 1, 128, 48), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention(q, k, v)
    # K2 takes K1's head dims, 192 included, and refuses another by name, never falling back; K4 stops at 128
    with pytest.raises(ValueError, match="head dim 48"):
        A.flash_attention_qk_i8(q, k, v)
    q, k, v = _qkv((1, 1, 128, 192), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim 192"):
        K4.exp2_attention(q, k, v)
    q, k, v = _qkv((1, 1, 128, 64), torch.bfloat16, cuda)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        A.flash_attention_qk_i8(q, k, v)
    q, k, v = _qkv((1, 1, 128, 64), torch.float32, cuda)
    l = torch.ones((1, 1, 128, 1), device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        A.flash_attention_bwd(q, k, v, q, q, l)
    # K2 takes q, k and v of one dtype; its quantizer q and k of one dtype (bf16, f16 or f32) and one shape
    with pytest.raises(ValueError, match="dtype"):
        A.flash_attention_qk_i8(q, k, v.to(torch.bfloat16))
    with pytest.raises(ValueError, match="dtype"):
        A.quantize_qk_i8(q.to(torch.bfloat16), k.to(torch.float16))
    with pytest.raises(ValueError, match="shape"):
        A.quantize_qk_i8(q.to(torch.bfloat16), k.to(torch.bfloat16)[:, :, :64])
    with pytest.raises(ValueError, match="multiple of 8"):
        A.quantize_qk_i8(q.to(torch.bfloat16)[..., :12], k.to(torch.bfloat16)[..., :12])
    with pytest.raises(ValueError, match="one CUDA device"):
        A.quantize_qk_i8(q.to(torch.bfloat16), k.to(torch.bfloat16).cpu())
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        A.quantize_qk_i8(q.to(torch.bfloat16), k.to(torch.bfloat16))
    # K2's kernel alone takes contiguous int8 tensors of v's shape
    q, k, v = _qkv((1, 2, 128, 64), torch.bfloat16, cuda)
    q8, k8, qk_scale = A.quantize_qk_i8(q, k)
    with pytest.raises(ValueError, match="int8"):
        A.flash_qk_i8_forward(q8.float(), k8, qk_scale, v)
    with pytest.raises(ValueError, match="int8"):  # v's shape, but not contiguous
        A.flash_qk_i8_forward(q8.transpose(1, 2).contiguous().transpose(1, 2), k8, qk_scale, v)


@pytest.mark.gpu
def test_flash_kernel_d24_takes_head_split_views_and_keeps_heads_apart(cuda):
    """K1 at D = 24 reads rows of 48 bytes: on head-split views of a (B, N,
    3C) projection, as the legacy UNet's attn_up2 passes them, it matches
    its plain version, and one batch row's result does not move when
    another's values do."""
    b, n, h, d = 2, 1024, 4, 24
    qkv = _qkv((b, n, 3 * h * d), torch.bfloat16, cuda)[0]
    views = [t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]
    assert _within_forward_gate(A.flash_attention(*views), A.flash_attention_plain(*views))
    q, k, v = _qkv((2, 2, 128, 24), torch.bfloat16, cuda, seed=24)
    o = A.flash_attention(q, k, v)
    q2, k2, v2 = (t.clone() for t in (q, k, v))
    for t in (q2, k2, v2):
        t[1] = 1e4  # another batch row: far outside the clamp if it leaked in
    o2 = A.flash_attention(q2, k2, v2)
    assert torch.equal(o[0], o2[0])
    assert _within_forward_gate(o, A.flash_attention_plain(q, k, v))


@pytest.mark.gpu
def test_flash_bwd_refuses_head_dim_24_by_name(cuda):
    """K3 has no D = 24 instantiation (the legacy UNet only samples): the
    backward and a differentiable K1 call refuse it by name, before any
    forward runs; K1 without grad takes it."""
    q, k, v = _qkv((1, 2, 128, 24), torch.bfloat16, cuda)
    o, l = A.flash_attention(q, k, v, return_l=True)
    with pytest.raises(ValueError, match="flash_attention_bwd: head dim 24"):
        A.flash_attention_bwd(q, k, v, o, q, l)
    before = A.flash_attention.launches
    with pytest.raises(ValueError, match="flash_attention_bwd: head dim 24"):
        A.flash_attention(q.requires_grad_(True), k, v)
    assert A.flash_attention.launches == before


@pytest.mark.gpu
def test_256px_unet_with_qk_int8_takes_k2_where_it_has_the_head_dim(cuda):
    """The default ladder at im_size 256 with qk_int8 (what the CLI builds on
    the card): all twelve flash-length layers take K2 and its quantizer, the
    four at D = 192 included."""
    from weatherconverter_tpu_torch.core.config import UnetModelConfig
    from weatherconverter_tpu_torch.models.unet import Unet

    torch.manual_seed(0)
    model = Unet(UnetModelConfig(im_size=256), qk_int8=True).to(cuda).eval()
    kernels = [kind for _, _, kind in model.attention_kernels(256)]
    x = torch.randn(1, 3, 256, 256, device=cuda)
    before = (A.flash_attention.launches, A.flash_attention_qk_i8.launches, A.quantize_qk_i8.launches)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        out = model(x, 5)
    torch.cuda.synchronize()
    after = (A.flash_attention.launches, A.flash_attention_qk_i8.launches, A.quantize_qk_i8.launches)
    assert [a - b for a, b in zip(after, before)] == [kernels.count("K1"), kernels.count("K2"), kernels.count("K2")]
    assert (kernels.count("K1"), kernels.count("K2")) == (0, 12)
    assert A.flash_attention_qk_i8.launches_by_head_dim.get(192, 0) >= 4
    assert out.shape == x.shape and torch.isfinite(out).all()


# K1-f32 against its plain version in f32: the same products in another
# order, exp2 by ex2.approx (2 ulp): 1e-5 of max |ref|, l to 1e-5 relative.
# The legacy UNet's shapes (D = 16, 24), then one to three tiles and the
# default UNet's path shapes at batch 8 at every other head dim (the 256 px
# ladder's D = 192 included)
F32_SHAPES = [(1, 1, 64, 16), (2, 3, 192, 24), (8, 4, 1024, 16), (8, 4, 1024, 24),
              (1, 1, 64, 32), (2, 3, 192, 64), (1, 2, 128, 128), (1, 1, 192, 192),
              (8, 4, 4096, 64), (8, 4, 1024, 128), (8, 4, 1024, 32), (8, 4, 4096, 16), (8, 4, 1024, 192)]
F32_REL_TOL = 1e-5
# K3-f32 against its plain version in f32: max |err| / max |ref| of each
# gradient (3xTF32 products, f32 sums in another order)
F32_BWD_REL_TOL = 1e-4
F32_BWD_SHAPES = [(1, 1, 64, 16), (2, 3, 192, 32), (1, 2, 128, 64), (1, 1, 192, 128), (1, 2, 64, 192),
                  (8, 4, 4096, 64), (8, 4, 1024, 128), (8, 4, 1024, 32), (8, 4, 4096, 16), (8, 4, 1024, 192)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", F32_SHAPES)
def test_flash_f32_kernel_matches_plain(cuda, shape):
    q, k, v = _qkv(shape, torch.float32, cuda, seed=32)
    before = (A.flash_attention.launches, A.flash_attention_f32.launches)
    o, l = A.flash_attention(q, k, v, return_l=True)  # f32 CUDA inputs go to K1-f32
    torch.cuda.synchronize()
    assert (A.flash_attention.launches, A.flash_attention_f32.launches) == (before[0], before[1] + 1)
    ref_o, ref_l = A.flash_attention_plain(q, k, v, return_l=True)
    assert o.dtype == torch.float32 and o.shape == q.shape and torch.isfinite(o).all()
    assert _rel_err(o, ref_o) <= F32_REL_TOL
    torch.testing.assert_close(l, ref_l, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 24, 32, 64, 128, 192])
def test_flash_f32_kernel_at_both_clamp_rails(cuda, d):
    q, k, v = _qkv((2, 2, 192, d), torch.float32, cuda, seed=d)
    gain = 2.0 * (60.0 / d**0.5) ** 0.5
    q, k = q * gain, k * gain
    s = torch.matmul(q, k.transpose(-1, -2)) / d**0.5
    assert (s > 60).any() and (s < -60).any()
    o = A.flash_attention_f32(q, k, v)
    assert torch.isfinite(o).all() and _rel_err(o, A.flash_attention_plain(q, k, v)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("shape", F32_SHAPES)
@pytest.mark.parametrize("per_item", [False, True])
def test_flash_qk_i8_f32_kernel_matches_plain(cuda, shape, per_item):
    """K2-f32: an f32 V takes K1-f32's kernels with int8 scores, within
    F32_REL_TOL of the f32 plain version (the int32 scores are exact in
    both; P V in 3xTF32), the same bits twice, counted under "float32";
    per row, row 0 of a batch whose row 1 is x100 is row 0 alone."""
    q, k, v = _qkv(shape, torch.float32, cuda, seed=37)
    before = (A.flash_attention_qk_i8.launches_by_dtype.get("float32", 0),
              A.quantize_qk_i8.launches_by_dtype.get("float32", 0))
    o = A.flash_attention_qk_i8(q, k, v, per_item=per_item)
    torch.cuda.synchronize()
    assert (A.flash_attention_qk_i8.launches_by_dtype["float32"],
            A.quantize_qk_i8.launches_by_dtype["float32"]) == (before[0] + 1, before[1] + 1)
    ref = A.flash_attention_qk_i8_plain(q, k, v, per_item=per_item)
    assert o.dtype == torch.float32 and o.shape == q.shape and torch.isfinite(o).all()
    assert _rel_err(o, ref) <= F32_REL_TOL
    assert torch.equal(o, A.flash_attention_qk_i8(q, k, v, per_item=per_item))
    if per_item and shape[0] > 1:
        q[1], k[1] = q[1] * 100, k[1] * 100
        o = A.flash_attention_qk_i8(q, k, v, per_item=True)
        assert torch.equal(o[:1], A.flash_attention_qk_i8(q[:1], k[:1], v[:1], per_item=True))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 24, 32, 64, 128, 192])
def test_flash_qk_i8_f32_kernel_at_both_clamp_rails(cuda, d):
    """K2-f32 where the quantized scores pass +60 and -60, at every head
    dim (f32 holds p = e^60)."""
    q, k, v = _qkv((2, 2, 192, d), torch.float32, cuda, seed=d + 7)
    gain = 2.0 * (60.0 / d**0.5) ** 0.5
    q, k = q * gain, k * gain
    q8, k8, qk_scale = A.quantize_qk_i8_plain(q, k)
    s = torch.matmul(q8.float(), k8.float().transpose(-1, -2)) * qk_scale
    assert (s > 60).any() and (s < -60).any()
    o = A.flash_attention_qk_i8(q, k, v)
    assert torch.isfinite(o).all() and _rel_err(o, A.flash_attention_qk_i8_plain(q, k, v)) <= F32_REL_TOL


@pytest.mark.gpu
def test_flash_qk_i8_f32_kernel_takes_head_split_views(cuda):
    """f32 head-split views of one projection (row strides a multiple of 4
    elements): the quantizer reads them in place, K2-f32 matches its plain
    version."""
    b, n, h, d = 2, 1024, 4, 24
    qkv = _qkv((b, n, 3 * h * d), torch.float32, cuda, seed=38)[0]
    q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous() and A._row_strides(q) is not None
    for got, want in zip(A.quantize_qk_i8(q, k), A.quantize_qk_i8_plain(q, k)):
        assert got.is_contiguous() and torch.equal(got, want)
    assert _rel_err(A.flash_attention_qk_i8(q, k, v), A.flash_attention_qk_i8_plain(q, k, v)) <= F32_REL_TOL


# One tile and an odd multiple of 64 at every head dim of the f32 wgmma
# kernels: their staged tiles are 64 keys (32 at D = 192) for K1-f32 and
# K2-f32, 64 rows (32 from D = 64) for K3-f32. K3-f32's pair passes at D =
# 192 (a block of 64 rows shared by two consumers, 32-row walked tiles, dK
# and dV in one launch) also at an odd B*H over several blocks.
F32_WGMMA_EDGE_SHAPES = [(1, 2, n, d) for n in (64, 1088) for d in (32, 64, 128, 192)]
F32_BWD_EDGE_SHAPES = [(1, 2, n, d) for n in (64, 1088) for d in (16, 32, 64, 128, 192)] + [(3, 5, 256, 192)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", F32_WGMMA_EDGE_SHAPES)
def test_flash_f32_kernels_at_one_tile_and_an_odd_tile_count(cuda, shape):
    """K1-f32 (O and l) and K2-f32 within F32_REL_TOL of their plain
    versions, the same bits twice."""
    q, k, v = _qkv(shape, torch.float32, cuda, seed=shape[2] + shape[3])
    o, l = A.flash_attention(q, k, v, return_l=True)
    torch.cuda.synchronize()
    ref_o, ref_l = A.flash_attention_plain(q, k, v, return_l=True)
    assert torch.isfinite(o).all() and _rel_err(o, ref_o) <= F32_REL_TOL
    torch.testing.assert_close(l, ref_l, rtol=1e-5, atol=0)
    assert torch.equal(o, A.flash_attention_f32(q, k, v))
    o8 = A.flash_attention_qk_i8(q, k, v)
    assert torch.isfinite(o8).all() and _rel_err(o8, A.flash_attention_qk_i8_plain(q, k, v)) <= F32_REL_TOL
    assert torch.equal(o8, A.flash_attention_qk_i8(q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", F32_BWD_EDGE_SHAPES)
def test_flash_bwd_f32_kernel_at_one_tile_and_an_odd_tile_count(cuda, shape):
    args = _f32_bwd_args(shape, cuda, seed=shape[2] + shape[3] + 1)
    got = A.flash_attention_bwd_f32(*args)
    torch.cuda.synchronize()
    for name, g, r, again in zip(("dq", "dk", "dv"), got, A.flash_attention_bwd_plain(*args),
                                 A.flash_attention_bwd_f32(*args)):
        assert torch.isfinite(g).all() and _rel_err(g, r) <= F32_BWD_REL_TOL, (name, _rel_err(g, r))
        assert torch.equal(g, again), name


@pytest.mark.gpu
def test_flash_bwd_f32_limit_refuses_one_tf32_pass_at_d192(cuda):
    """The planted fault of chip_smoke.py's K3-f32 gate at D = 192: the plain
    backward with f32 matmuls in one TF32 pass breaks F32_BWD_REL_TOL, which
    the kernel (three TF32 passes a product) keeps."""
    args = _f32_bwd_args((2, 4, 1024, 192), cuda, seed=19)
    with _no_tf32():
        ref = A.flash_attention_bwd_plain(*args)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        fault = A.flash_attention_bwd_plain(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    got = A.flash_attention_bwd_f32(*args)
    assert max(_rel_err(f, r) for f, r in zip(fault, ref)) > F32_BWD_REL_TOL
    assert max(_rel_err(g, r) for g, r in zip(got, ref)) <= F32_BWD_REL_TOL


@pytest.mark.gpu
def test_flash_f32_kernels_at_both_clamp_rails_at_d192(cuda):
    """Scores past +60 and -60 at D = 192 over 17 tiles: K1-f32 and K2-f32
    (their wgmma kernel's 32-key tiles) and K3-f32."""
    shape = (1, 2, 1088, 192)
    args = _f32_bwd_args(shape, cuda, seed=192, gain=2.0 * (60.0 / 192**0.5) ** 0.5)
    q, k, v = args[:3]
    s = torch.matmul(q, k.transpose(-1, -2)) / 192**0.5
    assert (s > 60).any() and (s < -60).any()
    o = A.flash_attention_f32(q, k, v)
    assert torch.isfinite(o).all() and _rel_err(o, A.flash_attention_plain(q, k, v)) <= 1e-4
    o8 = A.flash_attention_qk_i8(q, k, v)
    assert torch.isfinite(o8).all() and _rel_err(o8, A.flash_attention_qk_i8_plain(q, k, v)) <= F32_REL_TOL
    for name, g, r in zip(("dq", "dk", "dv"), A.flash_attention_bwd_f32(*args), A.flash_attention_bwd_plain(*args)):
        assert torch.isfinite(g).all() and _rel_err(g, r) <= 1e-3, (name, _rel_err(g, r))


@pytest.mark.gpu
def test_flash_f32_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 1, 128, 48), torch.float32, cuda)
    with pytest.raises(ValueError, match="flash_attention_f32: head dim 48"):
        A.flash_attention(q, k, v)
    q, k, v = _qkv((1, 1, 96, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple"):
        A.flash_attention_f32(q, k, v)
    q, k, v = _qkv((1, 1, 128, 16), torch.float32, cuda)
    with pytest.raises(NotImplementedError, match="K3-f32"):  # the forward alone: the gradient is flash_attention's
        A.flash_attention_f32(q.requires_grad_(True), k, v)
    with pytest.raises(ValueError, match="float32"):
        A.flash_attention_f32(q.detach().to(torch.bfloat16), k, v)


@contextlib.contextmanager
def _no_tf32():
    """f32 matmuls and convolutions in full f32 inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _f32_bwd_args(shape, device, seed=0, gain=1.0):
    q, k, v = _qkv(shape, torch.float32, device, seed=seed)
    q, k = q * gain, k * gain
    do = _qkv(shape, torch.float32, device, seed=seed + 100)[0]
    o, l = A.flash_attention_plain(q, k, v, return_l=True)
    return q, k, v, o, do, l


@pytest.mark.gpu
@pytest.mark.parametrize("shape", F32_BWD_SHAPES)
def test_flash_bwd_f32_kernel_matches_plain(cuda, shape):
    args = _f32_bwd_args(shape, cuda, seed=shape[2] + shape[3])
    before = (A.flash_attention_bwd.launches, A.flash_attention_bwd_f32.launches)
    got = A.flash_attention_bwd_f32(*args)
    torch.cuda.synchronize()
    assert (A.flash_attention_bwd.launches, A.flash_attention_bwd_f32.launches) == (before[0], before[1] + 1)
    ref = A.flash_attention_bwd_plain(*args)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.float32 and g.shape == shape and torch.isfinite(g).all(), name
        assert _rel_err(g, r) <= F32_BWD_REL_TOL, (name, _rel_err(g, r))
    # no atomics: a second call gives the same bits
    for name, g, again in zip(("dq", "dk", "dv"), got, A.flash_attention_bwd_f32(*args)):
        assert torch.equal(g, again), name


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128, 192])
def test_flash_bwd_f32_kernel_at_both_clamp_rails(cuda, d):
    """Scores past +60 and -60: p at its e^60 ceiling, the gradient mask
    firing on both sides."""
    shape = (1, 2, 256, d)
    args = _f32_bwd_args(shape, cuda, seed=20 + d, gain=2.0 * (60.0 / d**0.5) ** 0.5)
    s = torch.matmul(args[0], args[1].transpose(-1, -2)) / d**0.5
    assert (s > 60).any() and (s < -60).any()
    for name, g, r in zip(("dq", "dk", "dv"), A.flash_attention_bwd_f32(*args), A.flash_attention_bwd_plain(*args)):
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, r) <= 1e-3, (name, _rel_err(g, r))


@pytest.mark.gpu
def test_flash_bwd_f32_kernel_refuses_head_dim_24(cuda):
    """The legacy UNet, the one model at D = 24, only samples: K3-f32 has no
    D = 24, and `flash_attention` refuses f32 inputs at D = 24 that require
    grad before its forward runs, by name."""
    args = _f32_bwd_args((1, 1, 128, 24), cuda)
    with pytest.raises(ValueError, match="flash_attention_bwd_f32: head dim 24"):
        A.flash_attention_bwd_f32(*args)
    before = A.flash_attention_f32.launches
    with pytest.raises(ValueError, match="flash_attention_bwd_f32: head dim 24"):
        A.flash_attention(*(t.clone().requires_grad_(True) for t in args[:3]))
    assert A.flash_attention_f32.launches == before
    args = _f32_bwd_args((1, 1, 128, 16), cuda)
    with pytest.raises(ValueError, match="float32"):
        A.flash_attention_bwd_f32(*(t.to(torch.bfloat16) for t in args[:5]), args[5])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 2, 1024, 64), (1, 4, 1024, 128), (2, 2, 4096, 16), (1, 4, 1024, 192)])
def test_flash_attention_f32_autograd_matches_autograd_through_plain(cuda, shape):
    """The autograd Function on f32 CUDA inputs (K1-f32 forward, K3-f32
    backward; K1 and K3 not launched) against torch's autograd through
    `flash_attention_plain`, in f32 with TF32 off."""
    grads = []
    with _no_tf32():
        for fn in (A.flash_attention, A.flash_attention_plain):
            q, k, v = (t.requires_grad_(True) for t in _qkv(shape, torch.float32, cuda, seed=9))
            g = _qkv(shape, torch.float32, cuda, seed=10)[0]
            counters = (A.flash_attention, A.flash_attention_bwd, A.flash_attention_f32, A.flash_attention_bwd_f32)
            before = [c.launches for c in counters]
            (fn(q, k, v) * g).sum().backward()
            if fn is A.flash_attention:
                assert [c.launches - b for c, b in zip(counters, before)] == [0, 0, 1, 1]
            grads.append((q.grad, k.grad, v.grad))
    for name, g, r in zip(("dq", "dk", "dv"), *grads):
        assert g.dtype == torch.float32 and _rel_err(g, r) <= F32_BWD_REL_TOL, (name, _rel_err(g, r))


@pytest.mark.gpu
def test_legacy_unet_on_the_card_in_bf16_and_f32(cuda):
    """The legacy UNet at 128 px, batch 2: under bf16 autocast with qk_int8
    a forward launches K2 and its quantizer twice (attn_down3, D = 16, and
    attn_up2, D = 24); in f32 (core/precision.f32_arithmetic) with qk_int8
    K2-f32 twice; in f32 without it K1-f32 twice, and its output is the
    CPU's f32 forward's to 1e-4 of max |ref|."""
    from weatherconverter_tpu_torch.core.precision import f32_arithmetic
    from weatherconverter_tpu_torch.models.unet_legacy import LegacyUNet

    torch.manual_seed(0)
    cpu = LegacyUNet(128)
    x, t = torch.randn(2, 3, 128, 128), torch.tensor([0.3, 0.9])
    counters = (A.flash_attention, A.flash_attention_qk_i8, A.quantize_qk_i8, A.flash_attention_f32)
    for qk_int8, dtype, expected in ((True, torch.bfloat16, [0, 2, 2, 0]), (True, None, [0, 2, 2, 0]),
                                     (False, None, [0, 0, 0, 2])):
        model = LegacyUNet(128, qk_int8=qk_int8)
        model.load_state_dict(cpu.state_dict())
        model = model.to(cuda)
        before = [fn.launches for fn in counters]
        ctx = torch.autocast("cuda", dtype=dtype) if dtype else f32_arithmetic(cuda)
        with torch.no_grad(), ctx:
            out = model(x.to(cuda), t.to(cuda))
        torch.cuda.synchronize()
        assert [fn.launches - b for fn, b in zip(counters, before)] == expected
        assert out.dtype == torch.float32 and out.shape == x.shape and torch.isfinite(out).all()
    with torch.no_grad():
        ref = cpu(x, t)
    assert _rel_err(out.cpu(), ref) <= 1e-4


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
@pytest.mark.parametrize("shape", FLASH_SHAPES)
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
    # no atomics: a second call gives the same bits
    for name, g, again in zip(("dq", "dk", "dv"), got, A.flash_attention_bwd(*args)):
        assert torch.equal(g, again), name


@pytest.mark.gpu
@pytest.mark.parametrize("d", FLASH_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bwd_kernel_at_both_clamp_rails_every_head_dim(cuda, d, dtype):
    """Scores past +60 and -60 at every head dim: p at its e^60 ceiling, the
    gradient mask firing on both sides. bf16 against the plain version in
    bf16. f16 against the plain version on f32 copies of the same values:
    the kernel folds 1/l into p before the cast, so p / l <= 1 stays in
    f16's range, where the plain version's own f16 cast of p would overflow."""
    shape = (1, 2, 256, d)
    q, k, v = _qkv(shape, dtype, cuda, seed=20 + d, scale=1.0)
    gain = 2.0 * (60.0 / d**0.5) ** 0.5
    q, k = (q.float() * gain).to(dtype), (k.float() * gain).to(dtype)
    do = _qkv(shape, dtype, cuda, seed=120 + d)[0]
    ref_dtype = dtype if dtype == torch.bfloat16 else torch.float32
    o, l = A.flash_attention_plain(q.to(ref_dtype), k.to(ref_dtype), v.to(ref_dtype), return_l=True)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / d**0.5
    assert (s > 60).any() and (s < -60).any()
    got = A.flash_attention_bwd(q, k, v, o.to(dtype), do, l)
    ref = A.flash_attention_bwd_plain(*(t.to(ref_dtype) for t in (q, k, v, o.to(dtype), do)), l)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == dtype and torch.isfinite(g.float()).all(), name
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


@pytest.fixture(scope="module")
def one_warpgroup_k3(tmp_path_factory):
    """The backward at D = 192 as the one-warpgroup design built it (pass 1 on
    64 query rows a block, pass 2 as a dV launch and a dK launch), a library of
    its own (probes/bwd_wide_ablations.py's `one_warpgroup`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return bwd_wide_ablations.build(["one_warpgroup"], str(tmp_path_factory.mktemp("k3")))["one_warpgroup"][0]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [64, 192, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bwd_d192_two_consumers_equal_the_one_warpgroup_design(cuda, one_warpgroup_k3, n, dtype):
    """K3 at D = 192 on a producer and two consumer warpgroups a pass (one
    tile; three, where pass 1's last block has one consumer's rows; sixteen):
    within BWD_REL_TOL of the plain version, two calls bit-equal, and dQ, dK
    and dV bit-equal to the one-warpgroup design's, whose sums it keeps in
    their order."""
    args = _bwd_inputs((2, 4, n, 192), dtype, cuda, seed=n)
    before = A.flash_attention_bwd.launches
    got = A.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    assert A.flash_attention_bwd.launches == before + 1
    for name, g, r in zip(("dq", "dk", "dv"), got, A.flash_attention_bwd_plain(*args)):
        assert torch.isfinite(g.float()).all() and _rel_err(g, r) <= BWD_REL_TOL, (name, _rel_err(g, r))
    for name, g, again, old in zip(("dq", "dk", "dv"), got, A.flash_attention_bwd(*args),
                                   bwd_wide_ablations.k3_call(one_warpgroup_k3, args)):
        assert torch.equal(g, again), name
        assert torch.equal(g, old), name


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 2, 1024, 64), (1, 4, 1024, 128), (2, 2, 4096, 16), (1, 4, 1024, 192)])
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


@pytest.mark.gpu
def test_256px_default_unet_runs_forward_and_backward_on_the_card(cuda):
    """The default ladder at im_size 256 attends at (N, D) = (4096, 128),
    (1024, 192), (1024, 128), (1024, 64) and (4096, 32): under bf16 autocast
    every flash-length layer goes through K1 and, backwards, K3; in f32
    through K1-f32 and K3-f32; in f32 with qk_int8 a forward takes K2-f32
    at all twelve, and a forward that would need a gradient raises
    (K2 is forward-only, as JAX's int8 path)."""
    from weatherconverter_tpu_torch.core.config import UnetModelConfig
    from weatherconverter_tpu_torch.models.unet import Unet

    torch.manual_seed(0)
    model = Unet(UnetModelConfig(im_size=256)).to(cuda)
    flash_layers = sum(A.is_flash_length(n) for n, _ in model.attention_shapes(256))
    assert flash_layers == 12
    x = torch.randn(1, 3, 256, 256, device=cuda)
    int8 = Unet(UnetModelConfig(im_size=256), qk_int8=True).to(cuda)
    with pytest.raises(NotImplementedError, match="forward-only"):
        int8(x, 5)
    before = A.flash_attention_qk_i8.launches_by_dtype.get("float32", 0)
    with torch.no_grad(), _no_tf32():
        assert torch.isfinite(int8(x, 5)).all()
    assert A.flash_attention_qk_i8.launches_by_dtype["float32"] - before == 12
    counters = (A.flash_attention, A.flash_attention_bwd, A.flash_attention_f32, A.flash_attention_bwd_f32)
    for ctx, expected in ((torch.autocast("cuda", dtype=torch.bfloat16), [12, 12, 0, 0]),
                          (_no_tf32(), [0, 0, 12, 12])):
        model.zero_grad(set_to_none=True)
        before = [c.launches for c in counters]
        with ctx:
            out = model(x, 5)
            out.square().mean().backward()
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == expected
        assert out.shape == x.shape and torch.isfinite(out).all()
        grads = [p.grad for p in model.parameters()]
        assert all(g is not None and torch.isfinite(g).all() for g in grads) and any(g.abs().sum() > 0 for g in grads)


@pytest.mark.gpu
def test_unet_f32_train_step_on_the_card_matches_the_cpu(cuda):
    """One f32 DDPM train step of a small UNet that attends at flash length
    at D = 32 and 64 (N = 1024), card (K1-f32, K3-f32, TF32 off) against the
    CPU (plain versions) from the same weights and draws: the loss to 1e-4
    and the gradient to 1e-3 relative L2 (f32 sums in other orders)."""
    import copy

    from weatherconverter_tpu_torch.core.config import UnetModelConfig
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.models.unet import Unet
    from weatherconverter_tpu_torch.training.diffusion import create_ddpm_state, train_step

    cfg = UnetModelConfig(im_size=32, down_channels=[32, 64, 64], mid_channels=[64, 64, 64], down_sample=[False, False],
                          time_emb_dim=16, num_down_layers=1, num_mid_layers=1, num_up_layers=1, num_heads=1,
                          attn_resolutions=[32])
    shapes = Unet(cfg).attention_shapes(32)
    assert {d for n, d in shapes if A.is_flash_length(n)} == {32, 64}
    flash = sum(A.is_flash_length(n) for n, _ in shapes)
    torch.manual_seed(0)
    ref_model = Unet(cfg)
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
    t, noise = torch.tensor([17, 640]), torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    results = []
    for dev in (cuda, torch.device("cpu")):
        model = copy.deepcopy(ref_model).to(dev)
        state = create_ddpm_state(model, lr=1e-4)
        before = [c.launches for c in (A.flash_attention_f32, A.flash_attention_bwd_f32)]
        with _no_tf32():
            _, loss = train_step(state, images.to(dev), linear_schedule(1000, device=dev), t=t.to(dev),
                                 noise=noise.to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert [c.launches - b for c, b in zip((A.flash_attention_f32, A.flash_attention_bwd_f32), before)] \
                == [flash, flash]
        results.append((loss.item(), torch.cat([p.grad.flatten() for p in model.parameters()]).cpu()))
    (l_card, g_card), (l_cpu, g_cpu) = results
    assert abs(l_card - l_cpu) / abs(l_cpu) <= 1e-4
    assert ((g_card - g_cpu).norm() / g_cpu.norm()).item() <= 1e-3
    assert torch.isfinite(g_card).all() and g_card.abs().sum() > 0


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


# --- the micro-probes' kernels (K4-K7, weatherconverter_tpu_torch/probes) ---

from weatherconverter_tpu_torch.probes import micro_attn as K4  # noqa: E402
from weatherconverter_tpu_torch.probes import probe_dw3x3 as K6  # noqa: E402
from weatherconverter_tpu_torch.probes import probe_dw9x9_floor as K5  # noqa: E402
from weatherconverter_tpu_torch.probes import probe_int8_dot as K7  # noqa: E402
from weatherconverter_tpu_torch.probes import common as probe_common, dispatch_cost, time_flash  # noqa: E402
from weatherconverter_tpu_torch.probes import bwd_wide_ablations, fwd_wide_ablations  # noqa: E402

PROBE_MODULES = [K4, K7, K6, K5]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ALL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_exp2_attention_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = _qkv(shape, dtype, cuda, seed=2)
    before = K4.exp2_attention.launches
    o = K4.exp2_attention(q, k, v)
    torch.cuda.synchronize()
    assert K4.exp2_attention.launches == before + 1
    assert o.dtype == dtype and o.shape == q.shape
    assert _within_forward_gate(o, K4.exp2_attention_plain(q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_exp2_attention_kernel_upper_clamp_fires(cuda, d):
    """q and k scaled so that many scores pass 60 log2 e and share exp2's
    ceiling, as in the plain version, at every head dim and over three key
    tiles (bf16, whose range holds 2^86.6; f16 holds no p past 2^16, in the
    kernel or the plain version, so there the clamp cannot be reached)."""
    q, k, v = _qkv((1, 2, 192, d), torch.bfloat16, cuda, seed=3)
    gain = 2.0 * (60.0 / d**0.5) ** 0.5
    q, k = (q.float() * gain).to(torch.bfloat16), (k.float() * gain).to(torch.bfloat16)
    assert (torch.matmul(q.float(), k.float().transpose(-1, -2)) / d**0.5 > 60).any()
    o = K4.exp2_attention(q, k, v)
    assert torch.isfinite(o.float()).all()
    assert (o.float() - K4.exp2_attention_plain(q, k, v).float()).abs().max().item() <= 4 * BF16_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 64, 32), (2, 128, 64), (1, 192, 128), (K7.B, K7.N, K7.D)])
def test_qk_dot_kernels_match_plain(cuda, shape):
    """int8 exactly equal; bf16 within 1e-5 of max |S| (the tensor cores and
    cuBLAS add the exact products in other orders)."""
    qf, kf = _qkv(shape, torch.bfloat16, cuda, seed=4)[:2]
    q8, k8 = K7.to_int8(qf), K7.to_int8(kf)
    before = (K7.qk_dot_i8.launches, K7.qk_dot_bf16.launches)
    s8, sb = K7.qk_dot_i8(q8, k8), K7.qk_dot_bf16(qf, kf)
    torch.cuda.synchronize()
    assert (K7.qk_dot_i8.launches, K7.qk_dot_bf16.launches) == (before[0] + 1, before[1] + 1)
    assert s8.dtype == torch.int32 and s8.shape == (shape[0], shape[1], shape[1])
    assert torch.equal(s8, K7.qk_dot_i8_plain(q8, k8))
    ref = K7.qk_dot_bf16_plain(qf, kf)
    assert sb.dtype == torch.float32
    torch.testing.assert_close(sb, ref, rtol=1e-5, atol=K7.BF16_RTOL * ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 4160])
@pytest.mark.parametrize("d", K7.HEAD_DIMS)
def test_qk_dot_kernels_at_path_widths_batch_2(cuda, d, n):
    """The persistent kernel at B = 2 (tile runs that cross from one batch
    row to the next), every head dim, N = 4096 and 4160 (64 * 65: each row of
    tiles ends in one 64 columns wide): int8 exactly equal, bf16 within
    BF16_RTOL * max |S| (the same exact products added in other orders)."""
    qf, kf = _qkv((2, n, d), torch.bfloat16, cuda, seed=11)[:2]
    q8, k8 = K7.to_int8(qf), K7.to_int8(kf)
    s8, sb = K7.qk_dot_i8(q8, k8), K7.qk_dot_bf16(qf, kf)
    torch.cuda.synchronize()
    assert torch.equal(s8, K7.qk_dot_i8_plain(q8, k8))
    ref = K7.qk_dot_bf16_plain(qf, kf)
    assert (sb - ref).abs().max().item() <= K7.BF16_RTOL * ref.abs().max().item()


# one pixel; odd H and W; a row of 130 pixels (five column tiles, the last
# ragged) of 3 vectors and two row tiles; 9 vectors a pixel (two channel
# groups, the second of one vector) over ragged tiles; one whole tile; the
# probe's shape
DW3X3_SHAPES = [(1, 1, 1, 8), (2, 5, 7, 16), (1, 19, 130, 24), (2, 33, 70, 72), (1, 16, 32, 64),
                (K6.B, K6.H, K6.W, K6.C)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", DW3X3_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_dw3x3_kernel_matches_plain(cuda, shape, dtype):
    x = _qkv(shape, dtype, cuda, seed=5)[0]
    k = _qkv((3, 3, 1, shape[-1]), dtype, cuda, seed=6, scale=K6.TAP_SCALE)[0]
    before = K6.dw3x3.launches
    out = K6.dw3x3(x, k)
    torch.cuda.synchronize()
    assert K6.dw3x3.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    assert (out.float() - K6.dw3x3_plain(x, k).float()).abs().max().item() <= K6.TOL


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8,), (3, 5, 8), (1, 7, 9, 64), (K5.B, K5.HW, K5.HW, K5.C)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_dw_fma81_kernel_within_one_ulp_of_plain(cuda, shape, dtype):
    """The kernel fuses each multiply-add and the plain version rounds twice,
    so after the cast they differ by at most one ulp of the output type."""
    x = _qkv(shape, dtype, cuda, seed=7)[0]
    before = K5.dw_fma81.launches
    out = K5.dw_fma81(x, K5.taps())
    torch.cuda.synchronize()
    assert K5.dw_fma81.launches == before + 1
    ref = K5.dw_fma81_plain(x, K5.taps())
    assert out.dtype == dtype and out.shape == x.shape
    assert ((out.float() - ref.float()).abs() <= K5.ulp(ref, dtype)).all()


@pytest.mark.gpu
def test_probe_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v = _qkv((1, 1, 128, 64), torch.float32, cuda)
    with pytest.raises(ValueError, match="dtype"):
        K4.exp2_attention(q, k, v)
    q, k, v = _qkv((1, 1, 128, 48), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim"):
        K4.exp2_attention(q, k, v)
    q, k = _qkv((1, 128, 48), torch.bfloat16, cuda)[:2]
    with pytest.raises(ValueError, match="head dim"):
        K7.qk_dot_bf16(q, k)
    q, k = _qkv((1, 96, 64), torch.bfloat16, cuda)[:2]
    with pytest.raises(ValueError, match="multiple"):
        K7.qk_dot_bf16(q, k)
    with pytest.raises(ValueError, match="dtype"):
        K7.qk_dot_i8(q[:, :64], k[:, :64])
    x = _qkv((1, 4, 4, 12), torch.bfloat16, cuda)[0]
    with pytest.raises(ValueError, match="multiple of 8"):
        K6.dw3x3(x, _qkv((3, 3, 1, 12), torch.bfloat16, cuda)[0])
    x = _qkv((1, 4, 4, 16), torch.float32, cuda)[0]
    with pytest.raises(ValueError, match="dtype"):
        K6.dw3x3(x, _qkv((3, 3, 1, 16), torch.float32, cuda)[0])
    with pytest.raises(ValueError, match="dtype"):
        K5.dw_fma81(x, K5.taps())
    with pytest.raises(ValueError, match="multiple of 8"):
        K5.dw_fma81(_qkv((12,), torch.bfloat16, cuda)[0], K5.taps())
    with pytest.raises(ValueError, match="81"):
        K5.dw_fma81(_qkv((16,), torch.bfloat16, cuda)[0], K5.taps()[:80])


@pytest.mark.parametrize("probe", PROBE_MODULES + [time_flash, dispatch_cost, fwd_wide_ablations,
                                                   bwd_wide_ablations],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_probe_main_exits_2_without_cuda(probe, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main() == 2
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


@pytest.mark.parametrize("shape, kw, ms, binds", [
    ((8, 4, 4096, 64), {}, 0.138968, "bf16"),
    ((8, 4, 4096, 16), {}, 0.138907, "ex2"),
    ((8, 4, 1024, 128), dict(qk_int8=True), 0.013026, "int8+bf16"),
    ((8, 4, 4096, 64), dict(qk_int8=True), 0.138907, "ex2"),
    ((8, 4, 4096, 64), dict(backward=True), 0.347419, "bf16"),
    ((8, 4, 1024, 32), dict(backward=True), 0.0108568, "bf16"),
    ((8, 4, 4096, 16), dict(backward=True), 0.138907, "ex2"),
    ((8, 4, 1024, 16), dict(f32=True), 0.0130229, "tf32x3"),
    ((8, 4, 1024, 24), dict(f32=True), 0.0195344, "tf32x3"),
])
def test_attention_roofline_counts_what_the_function_needs(shape, kw, ms, binds):
    """By hand, B*H = 32: the forward's two products at 989 TFLOP/s (Q K^T at
    1,979 TOP/s in int8; in f32 three TF32 products each at 494.7 TFLOP/s,
    K1-f32's 3xTF32), the backward's five, and one exponential a score at
    16 * 132 * 1.83e9 a second in both directions."""
    bound = probe_common.attention_roofline(probe_common.peaks("NVIDIA H100 80GB HBM3, 700.00 W"), shape, **kw)
    assert bound["binds"] == binds and bound["bound_by"] == "operations"
    assert bound["bound_ms"] == pytest.approx(ms, rel=1e-5)
    assert probe_common.attention_roofline(None, shape, **kw)["bound_ms"] is None


def test_kernel_lines_give_the_share_of_the_bound():
    """chip_smoke.py's phase 2 and probes/time_flash.py print each kernel's
    time beside its bound and the share of it the kernel reaches."""
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    bound = probe_common.attention_roofline(probe_common.peaks(card), (8, 4, 4096, 64), backward=True, f32=True)
    assert probe_common.bound_text(bound, 4 * bound["bound_ms"]) == (
        f"bound {bound['bound_ms']:.4f} ms (tf32x3 binds; the kernel at 25% of it)")
    assert probe_common.bound_text(probe_common.attention_roofline(None, (8, 4, 4096, 64)), 1.0) == (
        "bound not known for this card")
    line = time_flash._bound_line(card, (8, 4, 1024, 128), 2 * 0.1042 / 0.9)
    assert line.startswith("bound 0.1042 ms (tf32x3 binds;") and line.endswith("at 45% of it)")


@pytest.mark.parametrize("shape, ms", [((8, 4, 4096, 64), 0.015024374), ((8, 4, 1024, 32), 0.001878048)])
def test_quantizer_roofline_counts_three_bytes_an_element(shape, ms):
    """By hand: q and k, B*H*N*D 16-bit elements each, read once (2 bytes) and
    written once as int8 (1 byte), plus the f32 scale, over 3.35 TB/s."""
    bound = probe_common.quantizer_roofline(probe_common.peaks("NVIDIA H100 80GB HBM3, 700.00 W"), shape)
    assert bound["bound_by"] == "bytes" and bound["binds"] == "hbm"
    assert bound["bound_ms"] == pytest.approx(ms, rel=1e-5)
    assert probe_common.quantizer_roofline(None, shape)["bound_ms"] is None


def test_quantizer_reads_head_split_views_in_place():
    """The layout rule around the quantizer kernel: rows of D contiguous and
    16-byte aligned pass their (B, H, N) strides; anything else is copied."""
    b, n, h, d = 2, 64, 4, 16
    qkv = torch.zeros((b, n, 3 * h * d), dtype=torch.bfloat16)
    q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    assert list(A._row_strides(k)) == [n * 3 * h * d, d, 3 * h * d]
    assert list(A._row_strides(q.contiguous())) == [h * n * d, n * d, d]
    assert A._row_strides(q.transpose(2, 3)) is None  # d is not contiguous
    assert A._row_strides(torch.zeros(b * h * n * d + 8, dtype=torch.bfloat16)[1:-7].view(b, h, n, d)) is None
    odd = torch.zeros((b, h, n, d + 4), dtype=torch.bfloat16)[..., :d]  # rows 40 bytes apart
    assert A._row_strides(odd) is None


def test_time_flash_loads_another_checkouts_k2_and_k4_wrappers():
    import os
    import sys

    before = {k: m for k, m in sys.modules.items() if k.startswith("weatherconverter_tpu_torch")}
    other = time_flash.load_checkout(os.path.abspath(os.path.join(os.path.dirname(A.__file__), "..", "..")))
    assert other.attention is not A and other.micro_attn is not K4
    # the other checkout's K4 wrapper launches through that checkout's library
    assert other.micro_attn.cuda_build is other.attention.cuda_build is not A.cuda_build
    assert other.attention.flash_attention_qk_i8 is not A.flash_attention_qk_i8
    assert time_flash.THIS.attention is A and time_flash.THIS.micro_attn is K4
    assert {k: m for k, m in sys.modules.items() if k.startswith("weatherconverter_tpu_torch")} == before


def test_time_flash_loads_another_checkout_beside_this_one():
    import os
    import sys

    before = {k: m for k, m in sys.modules.items() if k.startswith("weatherconverter_tpu_torch")}
    path = list(sys.path)
    other = time_flash.load_checkout(os.path.abspath(os.path.join(os.path.dirname(A.__file__), "..", ".."))).attention
    assert other is not A and other.cuda_build is not A.cuda_build
    assert os.path.samefile(other.__file__, A.__file__)
    assert {k: m for k, m in sys.modules.items() if k.startswith("weatherconverter_tpu_torch")} == before
    assert sys.path == path


def test_probe_cpu_tensors_take_the_plain_versions_and_count_nothing():
    counters = (K4.exp2_attention, K7.qk_dot_i8, K7.qk_dot_bf16, K6.dw3x3, K5.dw_fma81)
    before = [f.launches for f in counters]
    q, k, v = _qkv((1, 2, 128, 16), torch.float32, "cpu")
    torch.testing.assert_close(K4.exp2_attention(q, k, v), K4.exp2_attention_plain(q, k, v), rtol=0, atol=0)
    q8, k8 = K7.to_int8(q[0]), K7.to_int8(k[0])
    assert torch.equal(K7.qk_dot_i8(q8, k8), K7.qk_dot_i8_plain(q8, k8))
    qb, kb = q[0].to(torch.bfloat16), k[0].to(torch.bfloat16)
    torch.testing.assert_close(K7.qk_dot_bf16(qb, kb), K7.qk_dot_bf16_plain(qb, kb), rtol=0, atol=0)
    x, taps = _qkv((2, 6, 5, 8), torch.float32, "cpu")[0], _qkv((3, 3, 1, 8), torch.float32, "cpu")[0]
    torch.testing.assert_close(K6.dw3x3(x, taps), K6.dw3x3_plain(x, taps), rtol=0, atol=0)
    torch.testing.assert_close(K5.dw_fma81(x, K5.taps()), K5.dw_fma81_plain(x, K5.taps()), rtol=0, atol=0)
    assert [f.launches for f in counters] == before


def test_dw3x3_plain_is_the_depthwise_conv_of_the_srgan_block():
    """The plain version against the SRGAN residual block's depthwise
    nn.Conv2d with the same taps (f32 on the CPU, 1e-5)."""
    x = _qkv((2, 9, 7, 16), torch.float32, "cpu", seed=8)[0]
    k = _qkv((3, 3, 1, 16), torch.float32, "cpu", seed=9, scale=K6.TAP_SCALE)[0]
    conv = K6.SeparableConv(16, 16, 3, 1, 1, bias=False).depthwise
    with torch.no_grad():
        conv.weight.copy_(k.permute(3, 2, 0, 1))
        want = conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(K6.dw3x3_plain(x, k), want, rtol=0, atol=1e-5)


def test_probe_kernels_are_forward_only():
    q = _qkv((1, 1, 64, 16), torch.float32, "cpu")[0].requires_grad_(True)
    for call in (lambda: K4.exp2_attention(q, q, q), lambda: K7.qk_dot_bf16(q[0], q[0]),
                 lambda: K6.dw3x3(q.reshape(1, 8, 8, 16), q.reshape(64, 16)[:9].reshape(3, 3, 1, 16)),
                 lambda: K5.dw_fma81(q, K5.taps())):
        with pytest.raises(NotImplementedError, match="forward-only"):
            call()


def test_ulp_is_one_step_of_the_type():
    x = torch.tensor([1.0, 1.5, -3.0, 256.0, 0.01])
    for dtype in (torch.bfloat16, torch.float16):
        step = K5.ulp(x, dtype)
        assert torch.equal(step[:4], torch.tensor([1.0, 1.0, 2.0, 256.0]) * torch.finfo(dtype).eps)
        assert ((x + step).to(dtype).float() != x.to(dtype).float())[:4].all()


def test_to_int8_clamps_and_truncates_toward_zero():
    x = torch.tensor([-200.0, -127.9, -3.9, -0.5, 0.0, 0.5, 3.9, 126.99, 500.0])
    assert K7.to_int8(x, scale=1.0).tolist() == [-127, -127, -3, 0, 0, 0, 3, 126, 127]

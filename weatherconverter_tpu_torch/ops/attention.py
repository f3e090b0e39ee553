"""Multi-head self-attention over flattened image tokens, (B, H, N, D).

Port of weatherconverter_tpu/ops/attention.py. The Pallas kernels become
three hand-written CUDA kernels for Hopper (csrc/, built by ops/cuda_build.py):

  K1 `flash_attention`       <- `_flash_kernel` and `_flash_kernel_stream_fwd`
  K2 `flash_attention_qk_i8` <- `_flash_kernel_qk_i8` (pv_int8=False)
  K3 `flash_attention_bwd`   <- `_flash_bwd_kernel`, `_flash_bwd_kernel_v2`,
                                `_flash_bwd_dq_kernel_stream` and
                                `_flash_bwd_dkv_kernel_stream`

They compute the JAX kernels' clamped softmax, exp(clip(s, -60, 60)) with no
row max, and its gradient, masked where the clamp fires, which a stock flash
kernel or SDPA does not. Beside each kernel is its plain PyTorch version
(`*_plain`): the wrapper takes it for a CPU tensor only, and on a CUDA
tensor launches the kernel or raises. Each wrapper counts its launches in
`.launches`.

`flash_attention` is differentiable: inputs that require grad go through
`FlashAttentionFunction`, whose forward is K1 with l and whose backward is
K3, as `jax.custom_vjp` wires `_fa_fwd`/`_fa_bwd`. K2 is forward-only, as
in JAX, which has no VJP for the int8 path: it raises for inputs that
require grad, on every device.
"""

from __future__ import annotations

import ctypes

import torch

from weatherconverter_tpu_torch.ops import cuda_build

# Both sides of the exp clamp; the kernels' kClamp (csrc/flash_common.cuh).
_CLAMP = 60.0

# Below this length, or when N % 128 != 0, plain softmax attention runs
# (the JAX dispatch, attention.py:784-809).
FLASH_MIN_SEQ = 1024

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_BLOCK = 64  # N must be a multiple of the kernels' query/key tile
KERNEL_DTYPES = (torch.bfloat16, torch.float16)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain softmax(Q K^T / sqrt(D)) V with a row max, the short-sequence
    path. Scores and softmax in f32, probabilities cast to V's dtype."""
    scale = 1.0 / q.shape[-1] ** 0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, return_l: bool = False
):
    """K1's plain version: the clamped softmax, f32 scores and row sums, p cast
    to V's dtype before PV, O normalised after PV and cast to q's dtype.
    With `return_l` also returns l, (B, H, N, 1) f32."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s.clamp(-_CLAMP, _CLAMP))
    l = p.sum(dim=-1, keepdim=True)
    o = (torch.matmul(p.to(v.dtype).float(), v.float()) / l).to(q.dtype)
    return (o, l) if return_l else o


def quantize_per_tensor(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: scale = max(max|x|, 1e-6) / 127, round half
    to even (attention.py:173-179). Returns (int8 tensor, f32 scale)."""
    xf = x.float()
    scale = xf.abs().amax().clamp_min(1e-6) / 127.0
    return torch.round(xf / scale).to(torch.int8), scale


def _quantize_qk(q: torch.Tensor, k: torch.Tensor):
    q8, qs = quantize_per_tensor(q)
    k8, ks = quantize_per_tensor(k)
    return q8, k8, (qs * ks / q.shape[-1] ** 0.5).reshape(1)


def flash_attention_qk_i8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K2's plain version: the same quantization, then int32-exact scores
    (an f32 product of int8 values: every partial sum is an integer below
    127*127*128 < 2^24) times qs*ks*D^-1/2, then K1's softmax and bf16 PV."""
    q8, k8, qk_scale = _quantize_qk(q, k)
    s = torch.matmul(q8.float(), k8.float().transpose(-1, -2)) * qk_scale
    p = torch.exp(s.clamp(-_CLAMP, _CLAMP))
    l = p.sum(dim=-1, keepdim=True)
    return (torch.matmul(p.to(v.dtype).float(), v.float()) / l).to(v.dtype)


def _check_kernel_inputs(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got {q.device}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q, k, v must share one (B, H, N, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v must be on one device")
    b, h, n, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {KERNEL_HEAD_DIMS}")
    if n % KERNEL_BLOCK != 0:
        raise ValueError(f"{name}: N={n} is not a multiple of {KERNEL_BLOCK}")
    if b * h > 65535:
        raise ValueError(f"{name}: B*H={b * h} exceeds the grid's 65535")
    if v.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: dtype {v.dtype} not in {KERNEL_DTYPES}")


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _launch_error(name: str, err: int) -> RuntimeError:
    msg = cuda_build.library().wc_error_string(err).decode()
    return RuntimeError(f"{name}: kernel launch failed, cudaError {err}: {msg}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, return_l: bool = False):
    """K1, (B, H, N, D) -> O in q's dtype (and l, (B, H, N, 1) f32, with
    `return_l`). A CPU tensor takes `flash_attention_plain`; a CUDA tensor
    launches the kernel (bf16/f16, D in {16, 32, 64, 128}, N % 64 == 0) or
    raises. Inputs that require grad (under grad mode) go through
    `FlashAttentionFunction`, so the backward is K3."""
    if _wants_grad(q, k, v):
        o, l = FlashAttentionFunction.apply(q, k, v)
        return (o, l) if return_l else o
    return _flash_forward(q, k, v, return_l=return_l)


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, return_l: bool):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, return_l=return_l)
    _check_kernel_inputs("flash_attention", q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share one dtype")
    b, h, n, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    l = torch.empty((b, h, n, 1), device=q.device, dtype=torch.float32) if return_l else None
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = lib.wc_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if l is None else l.data_ptr(),
            b * h, n, d, int(q.dtype == torch.float16), 1.0 / d**0.5, _stream(q.device),
        )
    if err != 0:
        raise _launch_error("flash_attention", err)
    flash_attention.launches += 1
    return (o, l) if return_l else o


flash_attention.launches = 0


def flash_attention_bwd_plain(q, k, v, o, do, l):
    """K3's plain version, in the v2 form of the JAX kernels (attention.py:305-369,
    515-582): s = Q K^T * scale, p = exp(clip(s, +-60)), dpn = dO V^T,
    Dv = rowsum(dO o O) in f32, m = p o (dpn - Dv) zeroed where |s| > 60, then
    dQ = (m K) * scale / l, dK = m^T (Q * scale / l), dV = p^T (dO / l), with m
    and p cast to the input dtype before the products, as JAX does. Products
    of low-precision values are taken in f32. l is the forward's row sums,
    (B, H, N, 1) f32. Returns (dq, dk, dv) in the dtypes of q, k and v."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s.clamp(-_CLAMP, _CLAMP))
    dpn = torch.matmul(do.to(v.dtype).float(), v.float().transpose(-1, -2))
    dv_row = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    m = torch.where(s.abs() <= _CLAMP, p * (dpn - dv_row), torch.zeros((), device=s.device))
    m_lp = m.to(q.dtype).float()
    linv = 1.0 / l.float()
    dq = torch.matmul(m_lp, k.float()) * (scale * linv)
    qh = (q.float() * (scale * linv)).to(q.dtype).float()
    dk = torch.matmul(m_lp.transpose(-1, -2), qh)
    doh = (do.float() * linv).to(do.dtype).float()
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), doh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, o, do, l):
    """K3, the flash backward: (q, k, v, o, dO) (B, H, N, D) and l (B, H, N, 1)
    f32 from the forward -> (dq, dk, dv) in the input dtype. A CPU tensor
    takes `flash_attention_bwd_plain`; a CUDA tensor launches the kernel's
    two passes (dQ, then dK/dV) or raises. It takes what K1 takes, with all
    five tensors in one dtype."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, l)
    _check_kernel_inputs("flash_attention_bwd", q, k, v)
    b, h, n, d = q.shape
    for name, t in (("k", k), ("v", v), ("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must match q's shape, dtype and device, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
    if l.shape != (b, h, n, 1) or l.dtype != torch.float32 or l.device != q.device:
        raise ValueError(f"flash_attention_bwd: l must be (B, H, N, 1) f32 on q's device, got "
                         f"{tuple(l.shape)} {l.dtype} {l.device}")
    q, k, v, o, do, l = (t.contiguous() for t in (q, k, v, o, do, l))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dvec = torch.empty((b * h, n), device=q.device, dtype=torch.float32)  # Dv, pass 1 -> pass 2
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = lib.wc_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), l.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dvec.data_ptr(),
            b * h, n, d, int(q.dtype == torch.float16), 1.0 / d**0.5, _stream(q.device),
        )
    if err != 0:
        raise _launch_error("flash_attention_bwd", err)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """O = flash_attention(q, k, v) with the flash backward: the forward is K1
    with l (its plain version on the CPU) and saves (q, k, v, o, l); the
    backward is `flash_attention_bwd`. Under autocast the backward runs in
    the forward's autocast state and sees the dtypes the forward saw; dO is
    cast to q's dtype, as `_fa_bwd` does. Returns (o, l); l takes no
    gradient."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, l = _flash_forward(q, k, v, return_l=True)
        ctx.save_for_backward(q, k, v, o, l)
        ctx.mark_non_differentiable(l)
        return o, l

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, do, _dl):
        q, k, v, o, l = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, do.to(q.dtype).contiguous(), l)


def flash_attention_qk_i8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K2, forward only, (B, H, N, D) -> O in v's dtype. Q and K are
    quantized per tensor here, in PyTorch; the kernel takes the int8 tensors,
    V and the f32 score scale. A CPU tensor takes
    `flash_attention_qk_i8_plain`; a CUDA tensor launches the kernel or
    raises. Inputs that require grad (under grad mode) raise on every
    device: JAX has no VJP for this path, and autograd through the plain
    version's rounding would give a meaningless gradient."""
    if _wants_grad(q, k, v):
        raise NotImplementedError(
            "flash_attention_qk_i8 is forward-only, as in JAX (no VJP through the int8 quantization); "
            "train with qk_int8=False")
    if q.device.type == "cpu":
        return flash_attention_qk_i8_plain(q, k, v)
    _check_kernel_inputs("flash_attention_qk_i8", q, k, v)
    b, h, n, d = q.shape
    # contiguous first, so q8/k8 come out contiguous; every buffer the kernel
    # reads stays referenced here until the launch has been queued
    q8, k8, qk_scale = _quantize_qk(q.contiguous(), k.contiguous())
    v = v.contiguous()
    o = torch.empty_like(v)
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = lib.wc_flash_fwd_qk_i8(
            q8.data_ptr(), k8.data_ptr(), v.data_ptr(),
            qk_scale.data_ptr(), o.data_ptr(), b * h, n, d, int(v.dtype == torch.float16),
            _stream(q.device),
        )
    if err != 0:
        raise _launch_error("flash_attention_qk_i8", err)
    flash_attention_qk_i8.launches += 1
    return o


flash_attention_qk_i8.launches = 0


def multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, qk_int8: bool = False
) -> torch.Tensor:
    """(B, H, N, D) attention dispatch, as attention.py:784-809: plain softmax
    for N < FLASH_MIN_SEQ or N % 128 != 0, else the clamped-softmax flash
    forward, with the int8-QK^T variant when `qk_int8` (forward only: it
    raises for inputs that require grad)."""
    n = q.shape[2]
    if n % 128 != 0 or n < FLASH_MIN_SEQ:
        return attention_reference(q, k, v)
    if qk_int8:
        return flash_attention_qk_i8(q, k, v)
    return flash_attention(q, k, v)

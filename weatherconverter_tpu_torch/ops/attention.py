"""Multi-head self-attention over flattened image tokens, (B, H, N, D).

Port of weatherconverter_tpu/ops/attention.py. The Pallas kernels become
hand-written CUDA kernels for Hopper (csrc/, built by ops/cuda_build.py):

  K1 `flash_attention`       <- `_flash_kernel` and `_flash_kernel_stream_fwd`
                                (D = 24 on zero-filled D = 32 tiles)
  K1-f32 `flash_attention_f32` <- `_flash_kernel` and `_flash_kernel_stream_fwd`
                                in f32 (csrc/flash_fwd_f32.cu)
  K2 `flash_attention_qk_i8` <- `_flash_kernel_qk_i8` (pv_int8=False; D = 24
                                on zero-filled D = 32 tiles as K1)
  K3 `flash_attention_bwd`   <- `_flash_bwd_kernel`, `_flash_bwd_kernel_v2`,
                                `_flash_bwd_dq_kernel_stream` and
                                `_flash_bwd_dkv_kernel_stream`
  K3-f32 `flash_attention_bwd_f32` <- the same four in f32 (csrc/flash_bwd_f32.cu)

and the quantization of Q and K in front of K2, which XLA fused on the TPU,
another: `quantize_qk_i8` (csrc/quantize_i8.cu). K2 and its quantizer take
one scale per tensor (JAX's function called once on a batch, the CLI's
one-request commands) or, with `per_item`, one a batch row (JAX's function
under jax.vmap over requests, as the JAX server runs it).

Each kernel is a custom op of the namespace `OPS` ("wc"): a fake
implementation for tracing, the plain version on the CPU, the ctypes launch
on CUDA. An exported program (`cli export-hlo --attn int8`) holds them as
ops and runs them wherever this module is imported.

They compute the JAX kernels' clamped softmax, exp(clip(s, -60, 60)) with no
row max, and its gradient, masked where the clamp fires, which a stock flash
kernel or SDPA does not. Beside each kernel is its plain PyTorch version
(`*_plain`): the wrapper takes it for a CPU tensor only, and on a CUDA
tensor launches the kernel or raises. Each wrapper counts its launches in
`.launches`.

`flash_attention` is differentiable: inputs that require grad go through
`FlashAttentionFunction`, whose forward is K1 with l and whose backward is
K3 (K1-f32 and K3-f32 for f32 CUDA inputs), as `jax.custom_vjp` wires
`_fa_fwd`/`_fa_bwd`. K2 is forward-only, as
in JAX, which has no VJP for the int8 path: it raises for inputs that
require grad, on every device.

The kernels take fixed head dims: K1 `KERNEL_HEAD_DIMS`, K1-f32
`F32_HEAD_DIMS`, K3 `BWD_HEAD_DIMS` and K3-f32 `F32_BWD_HEAD_DIMS` (no 24:
the one model at D = 24, the legacy UNet, only samples), K2
`QK_I8_HEAD_DIMS`, every head dim a model of the repo has, as JAX's int8
kernel takes any. Each refuses another by name.
A model with `qk_int8` set takes K2 in every flash-length layer
(`qk_int8_takes`, read by the attention layers).
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

KERNEL_HEAD_DIMS = (16, 24, 32, 64, 128, 192)  # K1
BWD_HEAD_DIMS = (16, 32, 64, 128, 192)  # K3
QK_I8_HEAD_DIMS = (16, 24, 32, 64, 128, 192)  # K2
F32_HEAD_DIMS = (16, 24, 32, 64, 128, 192)  # K1-f32
F32_BWD_HEAD_DIMS = (16, 32, 64, 128, 192)  # K3-f32
KERNEL_BLOCK = 64  # N must be a multiple of the kernels' query/key tile
KERNEL_DTYPES = (torch.bfloat16, torch.float16)


def is_flash_length(n: int) -> bool:
    """Whether `multi_head_attention` sends N tokens to the flash kernels."""
    return n >= FLASH_MIN_SEQ and n % 128 == 0


def qk_int8_takes(head_dim: int, qk_int8: bool) -> bool:
    """Whether an attention layer of `head_dim` built with `qk_int8` takes K2:
    where K2 has the instantiation (every head dim of the repo's models)."""
    return qk_int8 and head_dim in QK_I8_HEAD_DIMS


def layer_kernel(n: int, head_dim: int, qk_int8: bool, fused: bool = True) -> str:
    """What `multi_head_attention` runs for a layer of N tokens and `head_dim`
    whose int8 choice is `qk_int8` (after `qk_int8_takes`): "K2", "K1" or
    "softmax" (the plain short-sequence path, and every layer when not
    `fused`)."""
    if not fused or not is_flash_length(n):
        return "softmax"
    return "K2" if qk_int8 else "K1"


def check_flash_precision(device_type: str, dtype: torch.dtype, layers, where: str,
                          forward_only: bool = False) -> None:
    """Refuse, where the user chose the dtype, a CUDA model that would reach a
    flash-length attention layer in a dtype or at a head dim the kernels do
    not take. `layers` is the model's `attention_kernels` list, (N, D, "K1",
    "K2" or "softmax"), or its (N, D) list where no layer takes K2; `dtype`
    is what its attention layers compute in (the autocast dtype, else the
    parameters'). bf16/f16 run K1 and K3, or K2. f32 runs
    K1-f32 (F32_HEAD_DIMS) and, unless the model is `forward_only` (the
    legacy UNet, which only samples), K3-f32 (F32_BWD_HEAD_DIMS), but not K2,
    whose V is 16-bit. Nothing is cast silently: the caller picks the dtype.
    The CPU runs any dtype (plain versions), and so does a CUDA model with no
    flash-length layer (plain softmax attention)."""
    if device_type != "cuda" or dtype in KERNEL_DTYPES:
        return
    flash = sorted({(n, d) for n, d, *kind in layers if is_flash_length(n) and kind != ["softmax"]})
    if not flash:
        return
    qk_int8 = any(kind == ["K2"] for _, _, *kind in layers)
    remedy = (f'Run it under autocast: make_translate_fn(..., dtype=torch.bfloat16), training.dtype="bfloat16", or '
              f'torch.autocast("cuda", dtype=torch.bfloat16) around the call; {dtype} runs on the CPU')
    if dtype != torch.float32:
        raise ValueError(f"{where}: this model attends at flash length, (N, D) = {flash}, and on CUDA the "
                         f"flash-attention kernels take bfloat16/float16 or float32, not {dtype}. {remedy}")
    if qk_int8:
        raise ValueError(f"{where}: this model attends at flash length, (N, D) = {flash}, with qk_int8, and on CUDA "
                         f"the int8 forward (K2, flash_attention_qk_i8) takes bfloat16/float16 V, not {dtype}. Build "
                         f"it with qk_int8=False to run it in {dtype} (K1-f32), or: {remedy}")
    dims = F32_HEAD_DIMS if forward_only else set(F32_HEAD_DIMS) & set(F32_BWD_HEAD_DIMS)
    if all(d in dims for _, d in flash):
        return
    kernels = (f"the f32 forward (K1-f32, flash_attention_f32) takes head dims {F32_HEAD_DIMS}"
               + ("" if forward_only else f" and the f32 backward (K3-f32, flash_attention_bwd_f32) "
                                          f"{F32_BWD_HEAD_DIMS}"))
    raise ValueError(f"{where}: this model attends at flash length, (N, D) = {flash}, and on CUDA in {dtype} "
                     f"{kernels}. {remedy}")


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


def quantize_per_tensor(x: torch.Tensor, per_item: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8: scale = max(max|x|, 1e-6) / 127, round half to even
    (attention.py:173-179), over the whole tensor, or with `per_item` over
    each batch row (dim 0), as JAX computes it under jax.vmap over requests.
    Returns (int8 tensor, contiguous; f32 scale, 0-dim or (B, 1, ...)). Every
    divisor is a tensor on x's device: PyTorch's CUDA division by a Python
    number multiplies by its reciprocal, which is not always the correctly
    rounded quotient that the CPU, JAX and the quantizer kernel compute."""
    xf = x.float()
    amax = xf.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True) if per_item else xf.abs().amax()
    scale = amax.clamp_min(1e-6) / xf.new_full((), 127.0)
    return torch.round(xf / scale).to(torch.int8).contiguous(), scale


def quantize_qk_i8_plain(q: torch.Tensor, k: torch.Tensor, per_item: bool = False):
    """The quantizer's plain version (attention.py:173-189): q and k quantized
    per tensor, or with `per_item` per batch row, and the f32 score scale
    qs * ks / sqrt(D), shape (1,) or (B,)."""
    q8, qs = quantize_per_tensor(q, per_item)
    k8, ks = quantize_per_tensor(k, per_item)
    return q8, k8, (qs * ks / qs.new_full((), q.shape[-1] ** 0.5)).reshape(-1)


def qk_i8_attention_plain(q8: torch.Tensor, k8: torch.Tensor, qk_scale: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K2's forward on quantized inputs, plain: int32-exact scores (an f32
    product of int8 values: every partial sum is an integer below
    127*127*128 < 2^24) times the score scale of each batch row (one for all
    when qk_scale has one entry), then K1's softmax and bf16 PV."""
    s = torch.matmul(q8.float(), k8.float().transpose(-1, -2)) * qk_scale.reshape(-1, 1, 1, 1)
    p = torch.exp(s.clamp(-_CLAMP, _CLAMP))
    l = p.sum(dim=-1, keepdim=True)
    return (torch.matmul(p.to(v.dtype).float(), v.float()) / l).to(v.dtype)


def flash_attention_qk_i8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                per_item: bool = False) -> torch.Tensor:
    """K2's plain version: the quantization (per tensor, or per batch row
    with `per_item`), then `qk_i8_attention_plain`."""
    return qk_i8_attention_plain(*quantize_qk_i8_plain(q, k, per_item), v)


def check_kernel_inputs(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        head_dims: tuple[int, ...] = KERNEL_HEAD_DIMS) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got {q.device}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q, k, v must share one (B, H, N, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v must be on one device")
    check_kernel_shape(name, *q.shape, head_dims=head_dims)
    if v.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: dtype {v.dtype} not in {KERNEL_DTYPES}")


def check_kernel_shape(name: str, b: int, h: int, n: int, d: int,
                       head_dims: tuple[int, ...] = KERNEL_HEAD_DIMS) -> None:
    """The (B, H, N, D) a flash kernel takes (K1's head dims unless
    `head_dims` names another's); raises on another."""
    if d not in head_dims:
        raise ValueError(f"{name}: head dim {d} not in {head_dims}")
    if n % KERNEL_BLOCK != 0:
        raise ValueError(f"{name}: N={n} is not a multiple of {KERNEL_BLOCK}")
    if b * h > 65535:
        raise ValueError(f"{name}: B*H={b * h} exceeds the grid's 65535")


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# The kernels as custom ops (torch.library): each has a fake implementation
# (shapes and dtypes only, for tracing), a CPU implementation, its plain
# version, and a CUDA implementation, the ctypes launch, which checks what the
# kernel takes and raises, never falls back. So a traced program
# (torch.export, `cli export-hlo --attn int8`) holds them as ops of the
# namespace `OPS`, and runs them wherever this module has been imported. The
# public functions below call them; their refusals, launch counts and numbers
# are those of the kernels. The probe kernels K4-K7 stay plain ctypes calls:
# no program that can be exported reaches them.


def _op_namespace() -> str:
    """"wc", or "wc<i>" for a later copy of this module in one process (an op
    name is registered once a process; probes/time_flash.load_checkout loads
    another checkout's copy beside this one, with its own kernel library)."""
    i = 0
    while True:
        ns = "wc" if i == 0 else f"wc{i}"
        try:
            getattr(getattr(torch.ops, ns), "flash_fwd")
        except AttributeError:
            return ns
        i += 1


OPS = _op_namespace()


def _no_l(q: torch.Tensor) -> torch.Tensor:
    """The (0,) f32 tensor a forward op returns in l's place without `return_l`."""
    return q.new_empty((0,), dtype=torch.float32)


def _l_like(q: torch.Tensor, return_l: bool) -> torch.Tensor:
    b, h, n, _ = q.shape
    return q.new_empty((b, h, n, 1), dtype=torch.float32) if return_l else _no_l(q)


def _forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   return_l: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's and K1-f32's CPU implementation: the plain version, (o, l or an empty l)."""
    o, l = flash_attention_plain(q, k, v, return_l=True)
    return o, l if return_l else _no_l(q)


_k1_op = torch.library.custom_op(f"{OPS}::flash_fwd", _forward_plain, mutates_args=(), device_types="cpu")
_k1_f32_op = torch.library.custom_op(f"{OPS}::flash_fwd_f32", _forward_plain, mutates_args=(), device_types="cpu")
for _op in (_k1_op, _k1_f32_op):
    _op.register_fake(lambda q, k, v, return_l: (q.new_empty(q.shape), _l_like(q, return_l)))


@_k1_op.register_kernel("cuda")
def _(q, k, v, return_l):
    check_kernel_inputs("flash_attention", q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share one dtype")
    b, h, n, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    l = _l_like(q, return_l)
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = lib.wc_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr() if return_l else None,
            b * h, n, d, int(q.dtype == torch.float16), 1.0 / d**0.5, cuda_build.stream(q.device),
        )
    cuda_build.check_launch("flash_attention", err)
    flash_attention.launches += 1
    return o, l


@_k1_f32_op.register_kernel("cuda")
def _(q, k, v, return_l):
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_f32: q, k, v must lie on one CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention_f32: q, k, v must share one (B, H, N, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype == torch.float32:
        raise ValueError(f"flash_attention_f32: dtype must be float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, n, d = q.shape
    if d not in F32_HEAD_DIMS:
        raise ValueError(f"flash_attention_f32: head dim {d} not in {F32_HEAD_DIMS}: in dtype float32 the forward "
                         f"takes those only; dtypes {KERNEL_DTYPES} take {KERNEL_HEAD_DIMS}")
    check_kernel_shape("flash_attention_f32", b, h, n, d, head_dims=F32_HEAD_DIMS)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    l = _l_like(q, return_l)
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = lib.wc_flash_fwd_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                   l.data_ptr() if return_l else None, b * h, n, d, 1.0 / d**0.5,
                                   cuda_build.stream(q.device))
    cuda_build.check_launch("flash_attention_f32", err)
    flash_attention_f32.launches += 1
    return o, l


@torch.library.custom_op(f"{OPS}::flash_bwd", mutates_args=(), device_types="cpu")
def _k3_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
           l: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_attention_bwd_plain(q, k, v, o, do, l)


@_k3_op.register_fake
def _(q, k, v, o, do, l):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _check_bwd_inputs(name: str, q, k, v, o, do, l) -> None:
    """What K3 and K3-f32 take beside their dtype and head dims: five (B, H,
    N, D) tensors of q's shape, dtype and device, and l (B, H, N, 1) f32."""
    b, h, n, d = q.shape
    for what, t in (("k", k), ("v", v), ("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {what} must match q's shape, dtype and device, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
    if l.shape != (b, h, n, 1) or l.dtype != torch.float32 or l.device != q.device:
        raise ValueError(f"{name}: l must be (B, H, N, 1) f32 on q's device, got "
                         f"{tuple(l.shape)} {l.dtype} {l.device}")


@_k3_op.register_kernel("cuda")
def _(q, k, v, o, do, l):
    _check_bwd_head_dim(q.shape[-1])
    check_kernel_inputs("flash_attention_bwd", q, k, v, BWD_HEAD_DIMS)
    _check_bwd_inputs("flash_attention_bwd", q, k, v, o, do, l)
    b, h, n, d = q.shape
    q, k, v, o, do, l = (t.contiguous() for t in (q, k, v, o, do, l))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dvec = torch.empty((2, b * h, n), device=q.device, dtype=torch.float32)  # Dv and 1/l, pass 1 -> pass 2
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = lib.wc_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), l.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dvec.data_ptr(),
            b * h, n, d, int(q.dtype == torch.float16), 1.0 / d**0.5, cuda_build.stream(q.device),
        )
    cuda_build.check_launch("flash_attention_bwd", err)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


@torch.library.custom_op(f"{OPS}::flash_bwd_f32", mutates_args=(), device_types="cpu")
def _k3_f32_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
               l: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_attention_bwd_plain(q, k, v, o, do, l)


@_k3_f32_op.register_fake
def _(q, k, v, o, do, l):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@_k3_f32_op.register_kernel("cuda")
def _(q, k, v, o, do, l):
    _check_bwd_f32_head_dim(q.shape[-1])
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_f32: the kernel runs on CUDA tensors, got {q.device}")
    if q.dim() != 4 or q.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd_f32: q must be (B, H, N, D) float32, got {tuple(q.shape)} {q.dtype}")
    _check_bwd_inputs("flash_attention_bwd_f32", q, k, v, o, do, l)
    b, h, n, d = q.shape
    check_kernel_shape("flash_attention_bwd_f32", b, h, n, d, head_dims=F32_BWD_HEAD_DIMS)
    q, k, v, o, do, l = (t.contiguous() for t in (q, k, v, o, do, l))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dvec = torch.empty((2, b * h, n), device=q.device, dtype=torch.float32)  # Dv and 1/l, pass 1 -> pass 2
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = lib.wc_flash_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), l.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dvec.data_ptr(), b * h, n, d, 1.0 / d**0.5,
            cuda_build.stream(q.device),
        )
    cuda_build.check_launch("flash_attention_bwd_f32", err)
    flash_attention_bwd_f32.launches += 1
    return dq, dk, dv


_QUANTIZE_GROUP = 8  # D must be a multiple: the smaller of the quantizer's groups (csrc/quantize_i8.cu G)


def _row_strides(t: torch.Tensor):
    """The (B, H, N) element strides of `t` if the quantizer can read it in
    place (rows of D contiguous, every row 16-byte aligned), else None."""
    if t.stride(3) != 1 or t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        return None
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def _readable_rows(t: torch.Tensor):
    """`t` as the quantizer can read it, with its strides: `t` itself, or a
    fresh contiguous copy (a new allocation is aligned)."""
    strides = _row_strides(t)
    if strides is None:
        t = t.clone(memory_format=torch.contiguous_format)
        strides = _row_strides(t)
    return t, strides


@torch.library.custom_op(f"{OPS}::quantize_qk_i8", mutates_args=(), device_types="cpu")
def _quantize_op(q: torch.Tensor, k: torch.Tensor,
                 per_item: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return quantize_qk_i8_plain(q, k, per_item)


@_quantize_op.register_fake
def _(q, k, per_item):
    scales = q.shape[0] if per_item else 1
    return (q.new_empty(q.shape, dtype=torch.int8), k.new_empty(q.shape, dtype=torch.int8),
            q.new_empty((scales,), dtype=torch.float32))


@_quantize_op.register_kernel("cuda")
def _(q, k, per_item):
    if q.device.type != "cuda" or k.device != q.device:
        raise ValueError(f"quantize_qk_i8: q and k must lie on one CUDA device, got {q.device} and {k.device}")
    if q.dim() != 4 or q.shape != k.shape:
        raise ValueError(f"quantize_qk_i8: q and k must share one (B, H, N, D) shape, got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype:
        raise ValueError(f"quantize_qk_i8: q and k must share one dtype of {KERNEL_DTYPES}, got {q.dtype} "
                         f"and {k.dtype}")
    b, h, n, d = q.shape
    if d % _QUANTIZE_GROUP != 0:
        raise ValueError(f"quantize_qk_i8: head dim {d} is not a multiple of {_QUANTIZE_GROUP}")
    scales = b if per_item else 1
    (q, q_strides), (k, k_strides) = _readable_rows(q), _readable_rows(k)
    amax = torch.zeros(2 * scales, device=q.device, dtype=torch.float32)  # the maxima: pass 1 -> pass 2
    q8 = torch.empty(q.shape, device=q.device, dtype=torch.int8)
    k8 = torch.empty(q.shape, device=q.device, dtype=torch.int8)
    qk_scale = torch.empty(scales, device=q.device, dtype=torch.float32)
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = lib.wc_quantize_qk_i8(
            q.data_ptr(), k.data_ptr(), q_strides, k_strides, b, h, n, d, int(q.dtype == torch.float16), scales,
            amax.data_ptr(), q8.data_ptr(), k8.data_ptr(), qk_scale.data_ptr(), d**0.5,
            cuda_build.stream(q.device),
        )
    cuda_build.check_launch("quantize_qk_i8", err)
    quantize_qk_i8.launches += 1
    return q8, k8, qk_scale


@torch.library.custom_op(f"{OPS}::flash_fwd_qk_i8", mutates_args=(), device_types="cpu")
def _k2_op(q8: torch.Tensor, k8: torch.Tensor, qk_scale: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return qk_i8_attention_plain(q8, k8, qk_scale, v)


@_k2_op.register_fake
def _(q8, k8, qk_scale, v):
    return v.new_empty(v.shape)


@_k2_op.register_kernel("cuda")
def _(q8, k8, qk_scale, v):
    check_kernel_inputs("flash_qk_i8_forward", v, v, v)
    b, h, n, d = v.shape
    _check_qk_i8_head_dim(d)
    if not (q8.is_contiguous() and k8.is_contiguous() and q8.dtype == k8.dtype == torch.int8
            and q8.shape == k8.shape == v.shape and qk_scale.dtype == torch.float32
            and q8.device == k8.device == qk_scale.device == v.device):
        raise ValueError("flash_qk_i8_forward: q8 and k8 must be contiguous int8 of v's shape and qk_scale f32, "
                         "all on v's device")
    if qk_scale.numel() not in (1, b):
        raise ValueError(f"flash_qk_i8_forward: qk_scale holds {qk_scale.numel()} scales; one (per tensor) or B = "
                         f"{b} (per batch row)")
    v = v.contiguous()  # q8, k8, qk_scale and v stay referenced here until the launch has been queued
    o = torch.empty_like(v)
    lib = cuda_build.library()
    with torch.cuda.device(v.device):
        err = lib.wc_flash_fwd_qk_i8(
            q8.data_ptr(), k8.data_ptr(), v.data_ptr(), qk_scale.data_ptr(), o.data_ptr(), b * h, n, d,
            int(v.dtype == torch.float16), b * h // qk_scale.numel(), cuda_build.stream(v.device),
        )
    cuda_build.check_launch("flash_attention_qk_i8", err)
    flash_attention_qk_i8.launches += 1
    flash_attention_qk_i8.launches_by_head_dim[d] = flash_attention_qk_i8.launches_by_head_dim.get(d, 0) + 1
    return o


# --- the public functions ---


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, return_l: bool = False):
    """K1, (B, H, N, D) -> O in q's dtype (and l, (B, H, N, 1) f32, with
    `return_l`). A CPU tensor takes `flash_attention_plain`; a CUDA tensor
    launches the kernel (bf16/f16, D in KERNEL_HEAD_DIMS, N % 64 == 0; f32
    goes to K1-f32) or raises. Inputs that require grad (under grad mode) go
    through `FlashAttentionFunction`, so the backward is K3 (K3-f32 for f32);
    on CUDA a head dim the backward lacks (24) is refused before the forward
    runs."""
    if _wants_grad(q, k, v):
        if q.device.type != "cpu":  # before the forward, not in the backward
            if q.dtype == torch.float32:
                _check_bwd_f32_head_dim(q.shape[-1])
            else:
                _check_bwd_head_dim(q.shape[-1])
        o, l = FlashAttentionFunction.apply(q, k, v)
        return (o, l) if return_l else o
    return _flash_forward(q, k, v, return_l=return_l)


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, return_l: bool):
    if q.device.type != "cpu" and q.dtype == torch.float32:
        return flash_attention_f32(q, k, v, return_l=return_l)
    o, l = _k1_op(q, k, v, return_l)
    return (o, l) if return_l else o


flash_attention.launches = 0


def flash_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, return_l: bool = False):
    """K1-f32: (B, H, N, D) f32 -> O f32 (and l with `return_l`), every sum
    in f32 and every product in 3xTF32 on the tensor cores (each operand
    split into TF32 high and low parts, the lo*lo term dropped: about 21
    bits of the product). A CPU tensor takes `flash_attention_plain`; a CUDA
    tensor (f32, D in F32_HEAD_DIMS, N % 64 == 0) launches the kernel or
    raises. `flash_attention` sends f32 CUDA inputs here, and its autograd
    Function takes this forward's l to K3-f32; this function alone is the
    forward, and raises for inputs that require grad."""
    if _wants_grad(q, k, v):
        raise NotImplementedError("flash_attention_f32 is the forward alone: call flash_attention, whose f32 "
                                  "backward is K3-f32")
    o, l = _k1_f32_op(q, k, v, return_l)
    return (o, l) if return_l else o


flash_attention_f32.launches = 0


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
    five tensors in one dtype, at the head dims of BWD_HEAD_DIMS."""
    return _k3_op(q, k, v, o, do, l)


flash_attention_bwd.launches = 0


def flash_attention_bwd_f32(q, k, v, o, do, l):
    """K3-f32, the flash backward in f32: (q, k, v, o, dO) (B, H, N, D) f32
    and l (B, H, N, 1) f32 from the forward -> (dq, dk, dv) f32, every sum in
    f32 and every product in 3xTF32, as K1-f32. A CPU tensor takes
    `flash_attention_bwd_plain`; a CUDA tensor launches the kernel's passes
    (dQ, then dK/dV, dV and dK apart at D >= 128) or raises. Head dims
    F32_BWD_HEAD_DIMS."""
    return _k3_f32_op(q, k, v, o, do, l)


flash_attention_bwd_f32.launches = 0


def _check_bwd_head_dim(d: int) -> None:
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {d} not in {BWD_HEAD_DIMS}: the flash backward has no such "
                         f"instantiation (K1 takes it forward only; the legacy UNet, at D = 24, only samples)")


def _check_bwd_f32_head_dim(d: int) -> None:
    if d not in F32_BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd_f32: head dim {d} not in {F32_BWD_HEAD_DIMS}: the f32 flash backward "
                         f"has no such instantiation (K1-f32 takes {F32_HEAD_DIMS} forward only; the legacy UNet, at "
                         f"D = 24, only samples)")


class FlashAttentionFunction(torch.autograd.Function):
    """O = flash_attention(q, k, v) with the flash backward: the forward is K1
    with l (K1-f32 for f32 CUDA inputs; its plain version on the CPU) and
    saves (q, k, v, o, l); the backward is `flash_attention_bwd`
    (`flash_attention_bwd_f32` for f32 CUDA inputs). Under autocast the backward runs in
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
        bwd = flash_attention_bwd_f32 if q.device.type != "cpu" and q.dtype == torch.float32 else flash_attention_bwd
        return bwd(q, k, v, o, do.to(q.dtype).contiguous(), l)


def quantize_qk_i8(q: torch.Tensor, k: torch.Tensor, *, per_item: bool = False):
    """The quantizer in front of K2, forward only: (B, H, N, D) q and k ->
    (q8, k8, qk_scale), contiguous int8 tensors and the f32 score scale
    qs * ks / sqrt(D), one for the tensors, shape (1,), or with `per_item`
    one a batch row, shape (B,), as JAX's function computes them under
    jax.vmap over requests. A CPU tensor takes `quantize_qk_i8_plain`; a
    CUDA tensor (bf16/f16, D a multiple of 8) launches the kernel's two
    passes (the maxima, then the division) or raises, and the result equals
    the plain version's bit for bit. Head-split views of one projection are
    read in place. One count in `.launches` for the two passes. Nothing here
    synchronises with the host."""
    if _wants_grad(q, k):
        raise NotImplementedError("quantize_qk_i8 is forward-only: rounding has no useful gradient")
    return _quantize_op(q, k, per_item)


quantize_qk_i8.launches = 0


def flash_attention_qk_i8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          per_item: bool = False) -> torch.Tensor:
    """K2, forward only, (B, H, N, D) -> O in v's dtype. Q and K go through
    `quantize_qk_i8` (one scale per tensor, or with `per_item` one a batch
    row, so that a row's output does not depend on the others'); the kernel
    takes the int8 tensors, V and the f32 score scales on the device. A CPU
    tensor takes `flash_attention_qk_i8_plain`; a CUDA tensor launches the
    kernels or raises. A call queues a fill of the maxima, the quantizer's
    two passes and the forward (and a copy of V if it is a view), and never
    synchronises with the host. Inputs that require grad (under grad mode)
    raise on every device: JAX has no VJP for this path, and autograd through
    the plain version's rounding would give a meaningless gradient."""
    if _wants_grad(q, k, v):
        raise NotImplementedError(
            "flash_attention_qk_i8 is forward-only, as in JAX (no VJP through the int8 quantization); "
            "train with qk_int8=False")
    if q.device.type != "cpu":
        check_kernel_inputs("flash_attention_qk_i8", q, k, v)
        _check_qk_i8_head_dim(q.shape[-1])
    return flash_qk_i8_forward(*quantize_qk_i8(q, k, per_item=per_item), v)


def _check_qk_i8_head_dim(d: int) -> None:
    if d not in QK_I8_HEAD_DIMS:
        raise ValueError(f"flash_attention_qk_i8: head dim {d} not in {QK_I8_HEAD_DIMS}: the int8 forward has no "
                         f"such instantiation; use flash_attention (qk_int8=False), which takes {KERNEL_HEAD_DIMS}")


def flash_qk_i8_forward(q8: torch.Tensor, k8: torch.Tensor, qk_scale: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K2's kernel alone, on what `quantize_qk_i8` returns: contiguous int8
    (B, H, N, D) q8 and k8, the f32 score scales on the device (1 or B), and
    V; on the CPU its plain version. It counts as one launch of
    `flash_attention_qk_i8`."""
    return _k2_op(q8, k8, qk_scale, v)


flash_attention_qk_i8.launches = 0
flash_attention_qk_i8.launches_by_head_dim = {}  # the same launches by head dim


def multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, qk_int8: bool = False, per_item: bool = False,
    fused: bool = True,
) -> torch.Tensor:
    """(B, H, N, D) attention dispatch, as attention.py:784-809: plain softmax
    for N < FLASH_MIN_SEQ or N % 128 != 0, or at every length when not
    `fused` (JAX's use_pallas=False: the model's portable form), else the
    clamped-softmax flash forward, with the int8-QK^T variant when `qk_int8`
    (forward only: it raises for inputs that require grad; `per_item` gives
    it one scale a batch row)."""
    if not fused or not is_flash_length(q.shape[2]):
        return attention_reference(q, k, v)
    if qk_int8:
        return flash_attention_qk_i8(q, k, v, per_item=per_item)
    return flash_attention(q, k, v)

"""K1-K4 of this checkout beside those of another checkout of the package,
in one process on one card and timed by one method.

    python -m weatherconverter_tpu_torch.probes.time_flash OTHER_ROOT [--parts k3_wide,quantizer]

OTHER_ROOT is the root of another checkout (say `git archive` of an earlier
commit, unpacked): its `ops.attention` and `probes.micro_attn` are loaded
beside this one's and build their own kernels. At the production UNet's four
attention shapes, bf16, each kernel (K1 `flash_attention`, K3
`flash_attention_bwd`, K2 `flash_attention_qk_i8` with its quantization, K4
`exp2_attention`) is timed in turns (other, this, this, other) with
`common.time_ms`, and the two checkouts' outputs are compared; the same for
K1, K3 and K2 at the 256 px UNet's (1024, 192) (K4 has no D = 192). Then K2
apart in the same turns: the quantizer, the forward on quantized inputs
alone (this checkout's quantization feeds both), and, for this checkout, the
eager quantization the quantizer replaces; with each shape's bounds (K1, K2
whole, the quantizer's bytes) and scaled_dot_product_attention's forward.
Then K1-f32 `flash_attention_f32` at F32_SHAPES (the default UNet's (4096, 16) and the legacy UNet's two, f32,
TF32 off) and at the f32 training path's wide head dims F32_WIDE_SHAPES
(K1-f32's wgmma kernel) in the same turns, each checkout's max|err|/max|ref|
against the plain version printed beside its time, with the shape's bound
and scaled_dot_product_attention's f32 forward. Then K3-f32
`flash_attention_bwd_f32` at F32_BWD_SHAPES (the path shapes and the 256 px
UNet's (1024, 192)) in the same turns, each checkout's largest
max|err|/max|ref| of dQ, dK and dV, the bound and sdpa's f32 backward alone
beside it. Last, K2-f32's forward
(`flash_qk_i8_forward` on an f32 V: K1-f32's kernels with int8 scores) at
QK_I8_F32_SHAPES in the same turns (the other checkout must have K2-f32),
each with its max|err|/max|ref| against the f32 plain version, and this
checkout's K2-f32 whole, its quantizer on f32 q and k, and K1-f32 beside.
Each f32 line also says whether the two checkouts' outputs are bit-equal.
Then K3 at (8, 4, 1024, 192) in bf16 with its passes apart (each kernel's
device time from torch.profiler over 20 calls: pass 1, pass 2, and the
parent's pass 2 as its dV and dK launches), beside its bound and sdpa's
backward alone, bit-equality to the other checkout printed; and the
quantizer at QUANT_SHAPES in bf16 and f32, one scale and one a batch row,
in the same turns beside its bytes bound, bit-equal to the other
checkout's, and K2 whole (quantizer included) at QUANT_SHAPES and the
legacy UNet's (1024, 24), bf16, beside sdpa's forward.
Without OTHER_ROOT only this checkout is timed.
"""

from __future__ import annotations

import importlib
import sys
import types

import torch

from weatherconverter_tpu_torch.ops import attention as A
from weatherconverter_tpu_torch.probes import common, micro_attn

PACKAGE = A.__name__.split(".")[0]
SHAPES = [(8, 4, 4096, 64), (8, 4, 1024, 128), (8, 4, 1024, 32), (8, 4, 4096, 16)]
WIDE_SHAPES = [(8, 4, 1024, 192)]  # the 256 px UNet's 768-channel layers: K1, K2, K3 (not K4)
F32_SHAPES = [(8, 4, 4096, 16), (8, 4, 1024, 16), (8, 4, 1024, 24)]
F32_WIDE_SHAPES = [(8, 4, 4096, 64), (8, 4, 1024, 128), (8, 4, 1024, 32), (8, 4, 1024, 192)]
F32_BWD_SHAPES = SHAPES + [(8, 4, 1024, 192)]
QK_I8_F32_SHAPES = SHAPES + [(8, 4, 1024, 16), (8, 4, 1024, 24), (8, 4, 1024, 192)]
QUANT_SHAPES = SHAPES + WIDE_SHAPES  # the quantizer at the UNets' flash-length layers in front of K2 and K2-f32
THIS = types.SimpleNamespace(attention=A, micro_attn=micro_attn)


def load_checkout(root: str, modules=("ops.attention", "probes.micro_attn")):
    """`modules` of the checkout at `root` (by default `ops.attention`, K1-K3's
    wrappers, and `probes.micro_attn`, K4's), imported together beside this
    one's, so that they share that checkout's kernel library: this package's
    modules are set aside during the import and put back. Returns a namespace
    keyed by each module's last name."""
    mine = {k: sys.modules.pop(k) for k in list(sys.modules) if k == PACKAGE or k.startswith(PACKAGE + ".")}
    sys.path.insert(0, root)
    try:
        return types.SimpleNamespace(**{m.rsplit(".", 1)[-1]: importlib.import_module(f"{PACKAGE}.{m}")
                                        for m in modules})
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules if k == PACKAGE or k.startswith(PACKAGE + ".")]:
            del sys.modules[k]
        sys.modules.update(mine)


def _runs(ms) -> str:
    return ", ".join(f"{t:.4f}" for t in ms)


def run(device, card: str, other=None) -> None:
    gen = torch.Generator(device=device).manual_seed(0)
    turns = _turns(other)
    for shape in SHAPES + WIDE_SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(4))
        o, l = A.flash_attention_plain(q, k, v, return_l=True)
        calls = {"K1 flash_attention": lambda m: m.attention.flash_attention(q, k, v),
                 "K3 flash_attention_bwd": lambda m: m.attention.flash_attention_bwd(q, k, v, o, do, l),
                 "K2 flash_attention_qk_i8": lambda m: m.attention.flash_attention_qk_i8(q, k, v)}
        if shape[-1] in micro_attn.HEAD_DIMS:
            calls["K4 exp2_attention"] = lambda m: m.micro_attn.exp2_attention(q, k, v)
        for name, call in calls.items():
            ms = {"this": [], "other": []}
            for who, checkout in turns:
                ms[who].append(common.time_ms(lambda: call(checkout), reps=20))
            line = f"{name} {shape}: this {sum(ms['this']) / len(ms['this']):.4f} ms (runs {_runs(ms['this'])})"
            if other is not None:
                mine, theirs = call(THIS), call(other)
                pairs = zip(mine, theirs) if isinstance(mine, tuple) else [(mine, theirs)]
                diff = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
                line += (f", other {sum(ms['other']) / 2:.4f} ms (runs {_runs(ms['other'])}), other/this "
                         f"{sum(ms['other']) / sum(ms['this']):.3f}x, max |this - other| {diff:.3e}")
            common.log(f"{line} [{card}]")
        # K2 apart: the quantizer and the forward alone, in the same turns, on this checkout's quantization
        q8, k8, qk_scale = A.quantize_qk_i8(q, k)
        parts = {"quantize_qk_i8": lambda m: m.attention.quantize_qk_i8(q, k),
                 "the forward alone": lambda m: m.attention.flash_qk_i8_forward(q8, k8, qk_scale, v)}
        texts = []
        for name, call in parts.items():
            ms = {"this": [], "other": []}
            for who, checkout in turns:
                ms[who].append(common.time_ms(lambda: call(checkout), reps=20))
            text = f"{name} {sum(ms['this']) / len(ms['this']):.4f} ms (runs {_runs(ms['this'])})"
            if other is not None:
                text += (f", other {sum(ms['other']) / 2:.4f} ms (runs {_runs(ms['other'])}), other/this "
                         f"{sum(ms['other']) / sum(ms['this']):.3f}x")
            texts.append(text)
        eager = common.time_ms(lambda: A.quantize_qk_i8_plain(q, k), reps=20)
        peak = common.peaks(card)
        bounds = {"quantizer": common.quantizer_roofline(peak, shape), "K2 whole":
                  common.attention_roofline(peak, shape, qk_int8=True), "K1": common.attention_roofline(peak, shape)}
        bounds = ", ".join(f"{name} not known" if b["bound_ms"] is None else
                           f"{name} {b['bound_ms']:.4f} ms ({b['binds']})" for name, b in bounds.items())
        common.log(f"K2 apart {shape}: {'; '.join(texts)}; this checkout's eager quantization {eager:.4f} ms; "
                   f"bounds: {bounds}; sdpa forward {common.sdpa_ms(q, k, v):.4f} ms [{card}]")


def _turns(other):
    return [("this", THIS)] if other is None else [("other", other), ("this", THIS), ("this", THIS), ("other", other)]


def _bound_line(card: str, shape, ms: float, **kind) -> str:
    return common.bound_text(common.attention_roofline(common.peaks(card), shape, f32=True, **kind), ms)


def _outputs(call, turns) -> dict:
    """Each checkout's output of `call` (a tensor or a tuple of them), keyed "this" / "other"."""
    return {who: call(checkout) for who, checkout in dict(turns).items()}


def _compare(name, shape, ms, errs, other, card, tail="", outs=None) -> None:
    line = (f"{name} {shape}: this {sum(ms['this']) / len(ms['this']):.4f} ms (runs {_runs(ms['this'])}), "
            f"max|err|/max|ref| {errs['this']:.2e}")
    if other is not None:
        line += (f", other {sum(ms['other']) / 2:.4f} ms (runs {_runs(ms['other'])}), other/this "
                 f"{sum(ms['other']) / sum(ms['this']):.3f}x, max|err|/max|ref| {errs['other']:.2e}")
        if outs is not None:
            pairs = zip(outs["this"], outs["other"]) if isinstance(outs["this"], tuple) else [tuple(outs.values())]
            line += f", bit-equal to other {all(torch.equal(a, b) for a, b in pairs)}"
    common.log(f"{line}{tail} [{card}]")


def run_f32(device, card: str, other=None) -> None:
    gen = torch.Generator(device=device).manual_seed(1)
    turns = _turns(other)
    for shape in F32_SHAPES + F32_WIDE_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=device) for _ in range(3))
        ref = A.flash_attention_plain(q, k, v)
        ms = {"this": [], "other": []}
        for who, checkout in turns:
            ms[who].append(common.time_ms(lambda: checkout.attention.flash_attention_f32(q, k, v), reps=20))
        outs = _outputs(lambda m: m.attention.flash_attention_f32(q, k, v), turns)
        errs = {who: ((out - ref).abs().max() / ref.abs().max()).item() for who, out in outs.items()}
        mine = sum(ms["this"]) / len(ms["this"])
        _compare("K1-f32 flash_attention_f32", shape, ms, errs, other, card,
                 f"; {_bound_line(card, shape, mine)}, sdpa forward in f32 {common.sdpa_ms(q, k, v):.4f} ms", outs)


def run_bwd_f32(device, card: str, other=None) -> None:
    gen = torch.Generator(device=device).manual_seed(3)
    turns = _turns(other)
    for shape in F32_BWD_SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=device) for _ in range(4))
        o, l = A.flash_attention_plain(q, k, v, return_l=True)
        args = (q, k, v, o, do, l)
        ref = A.flash_attention_bwd_plain(*args)
        ms = {"this": [], "other": []}
        for who, checkout in turns:
            ms[who].append(common.time_ms(lambda: checkout.attention.flash_attention_bwd_f32(*args), reps=20))
        outs = _outputs(lambda m: tuple(m.attention.flash_attention_bwd_f32(*args)), turns)
        errs = {who: max(((g - r).abs().max() / r.abs().max()).item() for g, r in zip(out, ref))
                for who, out in outs.items()}
        mine = sum(ms["this"]) / len(ms["this"])
        _compare("K3-f32 flash_attention_bwd_f32", shape, ms, errs, other, card,
                 f"; {_bound_line(card, shape, mine, backward=True)}, sdpa backward alone in f32 "
                 f"{common.sdpa_ms(q, k, v, do):.4f} ms", outs)
        del outs
        del q, k, v, do, o, l, args, ref
        torch.cuda.empty_cache()


def run_qk_i8_f32(device, card: str, other=None) -> None:
    gen = torch.Generator(device=device).manual_seed(2)
    turns = _turns(other)
    for shape in QK_I8_F32_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=device) for _ in range(3))
        q8, k8, qk_scale = A.quantize_qk_i8(q, k)
        ref = A.qk_i8_attention_plain(q8, k8, qk_scale, v)
        ms = {"this": [], "other": []}
        for who, checkout in turns:  # the forward alone, on this checkout's quantized inputs
            ms[who].append(common.time_ms(lambda: checkout.attention.flash_qk_i8_forward(q8, k8, qk_scale, v),
                                          reps=20))
        outs = _outputs(lambda m: m.attention.flash_qk_i8_forward(q8, k8, qk_scale, v), turns)
        errs = {who: ((out - ref).abs().max() / ref.abs().max()).item() for who, out in outs.items()}
        whole = common.time_ms(lambda: A.flash_attention_qk_i8(q, k, v), reps=20)
        quant = common.time_ms(lambda: A.quantize_qk_i8(q, k), reps=20)
        k1 = common.time_ms(lambda: A.flash_attention_f32(q, k, v), reps=20)
        _compare("K2-f32 flash_qk_i8_forward f32", shape, ms, errs, other, card,
                 f"; this checkout's K2-f32 whole {whole:.4f} ms ({_bound_line(card, shape, whole, qk_int8=True)}), "
                 f"quantize_qk_i8 on f32 {quant:.4f} ms, K1-f32 {k1:.4f} ms", outs)


def device_ms_by_kernel(fn, calls: int = 20) -> dict:
    """{kernel name: device ms a call of `fn`}, from torch.profiler's device
    events over `calls` calls after one untimed call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    sums = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_async():
            name = torch._C._demangle(e.name())
            sums[name] = sums.get(name, 0.0) + e.duration_ns() / 1e6 / calls
    return sums


def k3_pass_text(times: dict) -> str:
    """K3's kernels by pass: pass 1 (dq), pass 2 (dkv, each launch)."""
    passes = {"pass 1": [t for k, t in times.items() if "flash_bwd_dq" in k],
              "pass 2": [t for k, t in times.items() if "flash_bwd_dkv" in k]}
    return ", ".join(f"{name} {sum(ts):.4f} ms" + (f" ({' + '.join(f'{t:.4f}' for t in ts)})" if len(ts) > 1 else "")
                     for name, ts in passes.items())


def run_k3_wide(device, card: str, other=None) -> None:
    shape = WIDE_SHAPES[0]
    gen = torch.Generator(device=device).manual_seed(4)
    turns = _turns(other)
    q, k, v, do = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(4))
    o, l = A.flash_attention_plain(q, k, v, return_l=True)
    args = (q, k, v, o, do, l)
    ref = A.flash_attention_bwd_plain(*args)
    ms = {"this": [], "other": []}
    for who, checkout in turns:
        ms[who].append(common.time_ms(lambda: checkout.attention.flash_attention_bwd(*args), reps=20))
    outs = _outputs(lambda m: tuple(m.attention.flash_attention_bwd(*args)), turns)
    errs = {who: max(((g.float() - r.float()).abs().max() / r.float().abs().max()).item() for g, r in zip(out, ref))
            for who, out in outs.items()}
    passes = {who: k3_pass_text(device_ms_by_kernel(lambda: checkout.attention.flash_attention_bwd(*args)))
              for who, checkout in dict(turns).items()}
    mine = sum(ms["this"]) / len(ms["this"])
    bound = common.attention_roofline(common.peaks(card), shape, backward=True)
    _compare("K3 flash_attention_bwd", shape, ms, errs, other, card,
             f"; this checkout's {passes['this']}" + (f"; the other's {passes['other']}" if other is not None else "")
             + f"; {common.bound_text(bound, mine)}, sdpa backward alone {common.sdpa_ms(q, k, v, do):.4f} ms", outs)


def run_quantizer(device, card: str, other=None) -> None:
    gen = torch.Generator(device=device).manual_seed(5)
    turns = _turns(other)
    for shape in QUANT_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k = (torch.randn(shape, generator=gen, device=device).to(dtype) for _ in range(2))
            for per_item in (False, True):
                ms = {"this": [], "other": []}
                for who, checkout in turns:
                    ms[who].append(common.time_ms(lambda: checkout.attention.quantize_qk_i8(q, k, per_item=per_item),
                                                  reps=20))
                outs = _outputs(lambda m: tuple(m.attention.quantize_qk_i8(q, k, per_item=per_item)), turns)
                plain = A.quantize_qk_i8_plain(q, k, per_item=per_item)
                errs = {who: float(not all(torch.equal(g, w) for g, w in zip(out, plain))) for who, out in outs.items()}
                bound = common.quantizer_roofline(common.peaks(card), shape, scales=shape[0] if per_item else 1,
                                                  elem_bytes=q.element_size())
                _compare(f"quantize_qk_i8 {str(dtype).removeprefix('torch.')} {'per row' if per_item else 'one scale'}",
                         shape, ms, errs, other, card,
                         f" (err: 1.0 where it differs from the plain version); "
                         f"{common.bound_text(bound, sum(ms['this']) / len(ms['this']))}", outs)
            del q, k
    for shape in QUANT_SHAPES + [(8, 4, 1024, 24)]:
        q, k, v = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
        ref = A.flash_attention_qk_i8_plain(q, k, v).float()
        ms = {"this": [], "other": []}
        for who, checkout in turns:
            ms[who].append(common.time_ms(lambda: checkout.attention.flash_attention_qk_i8(q, k, v), reps=20))
        outs = _outputs(lambda m: m.attention.flash_attention_qk_i8(q, k, v), turns)
        errs = {who: ((out.float() - ref).abs().max() / ref.abs().max()).item() for who, out in outs.items()}
        mine, sdpa = sum(ms["this"]) / len(ms["this"]), common.sdpa_ms(q, k, v)
        bound = common.attention_roofline(common.peaks(card), shape, qk_int8=True)
        _compare("K2 flash_attention_qk_i8 whole", shape, ms, errs, other, card,
                 f"; {common.bound_text(bound, mine)}, sdpa forward {sdpa:.4f} ms (this/sdpa {mine / sdpa:.2f}x)", outs)
        del q, k, v, ref, outs


PARTS = {"bf16": run, "f32": run_f32, "bwd_f32": run_bwd_f32, "qk_i8_f32": run_qk_i8_f32, "k3_wide": run_k3_wide,
         "quantizer": run_quantizer}


def main(argv=None) -> int:
    """[OTHER_ROOT] [--parts NAME,...]: the parts of PARTS to run, all by default."""
    argv = sys.argv[1:] if argv is None else list(argv)
    parts = list(PARTS)
    if "--parts" in argv:
        i = argv.index("--parts")
        parts = argv[i + 1].split(",")
        del argv[i:i + 2]
    if not common.require_cuda("time_flash"):
        return 2
    card = common.card_line()
    common.log(card)
    common.log(common.setup())
    other = load_checkout(argv[0]) if argv else None
    for name in parts:
        PARTS[name](torch.device("cuda"), card, other)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K1-K4 of this checkout beside those of another checkout of the package,
in one process on one card and timed by one method.

    python -m weatherconverter_tpu_torch.probes.time_flash OTHER_ROOT

OTHER_ROOT is the root of another checkout (say `git archive` of an earlier
commit, unpacked): its `ops.attention` and `probes.micro_attn` are loaded
beside this one's and build their own kernels. At the production UNet's four
attention shapes, bf16, each kernel (K1 `flash_attention`, K3
`flash_attention_bwd`, K2 `flash_attention_qk_i8` with its quantization, K4
`exp2_attention`) is timed in turns (other, this, this, other) with
`common.time_ms`, and the two checkouts' outputs are compared. Then, for this
checkout alone: K2 apart (the quantizer, the eager quantization it replaces,
the forward on quantized inputs). Last, K1-f32 `flash_attention_f32` at
F32_SHAPES (the default UNet's (4096, 16) and the legacy UNet's two, f32,
TF32 off) in the same turns, each checkout's max|err|/max|ref| against the
plain version printed beside its time. Last, K2-f32's forward
(`flash_qk_i8_forward` on an f32 V: K1-f32's kernels with int8 scores) at
QK_I8_F32_SHAPES in the same turns (the other checkout must have K2-f32),
each with its max|err|/max|ref| against the f32 plain version, and this
checkout's K2-f32 whole, its quantizer on f32 q and k, and K1-f32 beside.
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
F32_SHAPES = [(8, 4, 4096, 16), (8, 4, 1024, 16), (8, 4, 1024, 24)]
QK_I8_F32_SHAPES = SHAPES + [(8, 4, 1024, 16), (8, 4, 1024, 24), (8, 4, 1024, 192)]
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
    turns = [("this", THIS)] if other is None else [("other", other), ("this", THIS), ("this", THIS), ("other", other)]
    for shape in SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(4))
        o, l = A.flash_attention_plain(q, k, v, return_l=True)
        calls = {"K1 flash_attention": lambda m: m.attention.flash_attention(q, k, v),
                 "K3 flash_attention_bwd": lambda m: m.attention.flash_attention_bwd(q, k, v, o, do, l),
                 "K2 flash_attention_qk_i8": lambda m: m.attention.flash_attention_qk_i8(q, k, v),
                 "K4 exp2_attention": lambda m: m.micro_attn.exp2_attention(q, k, v)}
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
                         f"{sum(ms['other']) / sum(ms['this']):.2f}x, max |this - other| {diff:.3e}")
            common.log(f"{line} [{card}]")
        # K2 apart, this checkout alone
        q8, k8, qk_scale = A.quantize_qk_i8(q, k)
        quant = common.time_ms(lambda: A.quantize_qk_i8(q, k), reps=20)
        eager = common.time_ms(lambda: A.quantize_qk_i8_plain(q, k), reps=20)
        fwd = [common.time_ms(lambda: A.flash_qk_i8_forward(q8, k8, qk_scale, v), reps=20) for _ in range(2)]
        common.log(f"K2 apart {shape}: quantize_qk_i8 {quant:.4f} ms, its eager version {eager:.4f} ms "
                   f"({eager / quant:.1f}x), the forward alone {sum(fwd) / 2:.4f} ms (runs {_runs(fwd)}) [{card}]")


def run_f32(device, card: str, other=None) -> None:
    gen = torch.Generator(device=device).manual_seed(1)
    turns = [("this", THIS)] if other is None else [("other", other), ("this", THIS), ("this", THIS), ("other", other)]
    for shape in F32_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=device) for _ in range(3))
        ref = A.flash_attention_plain(q, k, v)
        ms = {"this": [], "other": []}
        for who, checkout in turns:
            ms[who].append(common.time_ms(lambda: checkout.attention.flash_attention_f32(q, k, v), reps=20))
        errs = {who: ((checkout.attention.flash_attention_f32(q, k, v) - ref).abs().max() / ref.abs().max()).item()
                for who, checkout in dict(turns).items()}
        line = (f"K1-f32 flash_attention_f32 {shape}: this {sum(ms['this']) / len(ms['this']):.4f} ms "
                f"(runs {_runs(ms['this'])}), max|err|/max|ref| {errs['this']:.2e}")
        if other is not None:
            line += (f", other {sum(ms['other']) / 2:.4f} ms (runs {_runs(ms['other'])}), other/this "
                     f"{sum(ms['other']) / sum(ms['this']):.2f}x, max|err|/max|ref| {errs['other']:.2e}")
        common.log(f"{line} [{card}]")


def run_qk_i8_f32(device, card: str, other=None) -> None:
    gen = torch.Generator(device=device).manual_seed(2)
    turns = [("this", THIS)] if other is None else [("other", other), ("this", THIS), ("this", THIS), ("other", other)]
    for shape in QK_I8_F32_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=device) for _ in range(3))
        q8, k8, qk_scale = A.quantize_qk_i8(q, k)
        ref = A.qk_i8_attention_plain(q8, k8, qk_scale, v)
        ms = {"this": [], "other": []}
        for who, checkout in turns:  # the forward alone, on this checkout's quantized inputs
            ms[who].append(common.time_ms(lambda: checkout.attention.flash_qk_i8_forward(q8, k8, qk_scale, v),
                                          reps=20))
        errs = {who: ((checkout.attention.flash_qk_i8_forward(q8, k8, qk_scale, v) - ref).abs().max()
                      / ref.abs().max()).item() for who, checkout in dict(turns).items()}
        whole = common.time_ms(lambda: A.flash_attention_qk_i8(q, k, v), reps=20)
        quant = common.time_ms(lambda: A.quantize_qk_i8(q, k), reps=20)
        k1 = common.time_ms(lambda: A.flash_attention_f32(q, k, v), reps=20)
        line = (f"K2-f32 flash_qk_i8_forward f32 {shape}: this {sum(ms['this']) / len(ms['this']):.4f} ms "
                f"(runs {_runs(ms['this'])}), max|err|/max|ref| {errs['this']:.2e}")
        if other is not None:
            line += (f", other {sum(ms['other']) / 2:.4f} ms (runs {_runs(ms['other'])}), other/this "
                     f"{sum(ms['other']) / sum(ms['this']):.3f}x, max|err|/max|ref| {errs['other']:.2e}")
        common.log(f"{line}; this checkout's K2-f32 whole {whole:.4f} ms, quantize_qk_i8 on f32 {quant:.4f} ms, "
                   f"K1-f32 {k1:.4f} ms [{card}]")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not common.require_cuda("time_flash"):
        return 2
    card = common.card_line()
    common.log(card)
    common.log(common.setup())
    other = load_checkout(argv[0]) if argv else None
    run(torch.device("cuda"), card, other)
    run_f32(torch.device("cuda"), card, other)
    run_qk_i8_f32(torch.device("cuda"), card, other)
    return 0


if __name__ == "__main__":
    sys.exit(main())

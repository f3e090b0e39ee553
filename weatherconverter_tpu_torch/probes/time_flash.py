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
the forward on quantized inputs). Without OTHER_ROOT only this checkout is timed.
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
THIS = types.SimpleNamespace(attention=A, micro_attn=micro_attn)


def load_checkout(root: str):
    """`ops.attention` (K1-K3's wrappers) and `probes.micro_attn` (K4's) of
    the checkout at `root`, imported together beside this one's, so that they
    share that checkout's kernel library: this package's modules are set aside
    during the import and put back."""
    mine = {k: sys.modules.pop(k) for k in list(sys.modules) if k == PACKAGE or k.startswith(PACKAGE + ".")}
    sys.path.insert(0, root)
    try:
        return types.SimpleNamespace(attention=importlib.import_module(PACKAGE + ".ops.attention"),
                                     micro_attn=importlib.import_module(PACKAGE + ".probes.micro_attn"))
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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not common.require_cuda("time_flash"):
        return 2
    card = common.card_line()
    common.log(card)
    common.log(common.setup())
    run(torch.device("cuda"), card, load_checkout(argv[0]) if argv else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K1 and K3 of this checkout beside those of another checkout of the
package, in one process on one card and timed by one method.

    python -m weatherconverter_tpu_torch.probes.time_flash OTHER_ROOT

OTHER_ROOT is the root of another checkout (say `git archive` of an earlier
commit, unpacked): its `ops.attention` is loaded beside this one's and builds
its own kernels. At the production UNet's four attention shapes, bf16, each
kernel is timed in turns (other, this, this, other) with `common.time_ms`,
and the forward's outputs and the backward's gradients of the two checkouts
are compared. Without OTHER_ROOT only this checkout is timed.
"""

from __future__ import annotations

import importlib
import sys

import torch

from weatherconverter_tpu_torch.ops import attention as A
from weatherconverter_tpu_torch.probes import common

PACKAGE = A.__name__.split(".")[0]
SHAPES = [(8, 4, 4096, 64), (8, 4, 1024, 128), (8, 4, 1024, 32), (8, 4, 4096, 16)]


def load_attention(root: str):
    """`ops.attention` of the checkout at `root`, imported beside this one's:
    this package's modules are set aside during the import and put back."""
    mine = {k: sys.modules.pop(k) for k in list(sys.modules) if k == PACKAGE or k.startswith(PACKAGE + ".")}
    sys.path.insert(0, root)
    try:
        return importlib.import_module(PACKAGE + ".ops.attention")
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules if k == PACKAGE or k.startswith(PACKAGE + ".")]:
            del sys.modules[k]
        sys.modules.update(mine)


def run(device, card: str, other=None) -> None:
    gen = torch.Generator(device=device).manual_seed(0)
    turns = [("this", A)] if other is None else [("other", other), ("this", A), ("this", A), ("other", other)]
    for shape in SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(4))
        o, l = A.flash_attention_plain(q, k, v, return_l=True)
        calls = {"K1 flash_attention": lambda m: m.flash_attention(q, k, v),
                 "K3 flash_attention_bwd": lambda m: m.flash_attention_bwd(q, k, v, o, do, l)}
        for name, call in calls.items():
            ms = {"this": [], "other": []}
            for who, module in turns:
                ms[who].append(common.time_ms(lambda: call(module), reps=20))
            line = f"{name} {shape}: this {sum(ms['this']) / len(ms['this']):.4f} ms (runs {ms['this']})"
            if other is not None:
                mine, theirs = call(A), call(other)
                pairs = zip(mine, theirs) if isinstance(mine, tuple) else [(mine, theirs)]
                diff = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
                line += (f", other {sum(ms['other']) / 2:.4f} ms (runs {ms['other']}), other/this "
                         f"{sum(ms['other']) / sum(ms['this']):.2f}x, max |this - other| {diff:.3e}")
            common.log(f"{line} [{card}]")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not common.require_cuda("time_flash"):
        return 2
    card = common.card_line()
    common.log(card)
    common.log(common.setup())
    run(torch.device("cuda"), card, load_attention(argv[0]) if argv else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())

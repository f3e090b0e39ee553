"""The host cost of the kernels' wrappers and whether the card repeats a
guided chain, for this checkout beside another one:

    python -m weatherconverter_tpu_torch.probes.dispatch_cost [OTHER_ROOT] [--phases]

OTHER_ROOT is the root of another checkout (say `git archive` of an earlier
commit, unpacked). Each measurement runs in a fresh process of each checkout,
in turns (other, this, other, this), so that each uses its own package:
  * the host time of one call of K1's and K2's public wrappers
    (`flash_attention`, `flash_attention_qk_i8` with its quantizer), 2,000
    calls queued back to back at two shapes, bf16: what a layer of dispatch
    in front of the launches costs;
  * the CLI's `translate` (DDPM, 20 steps, seed 5, configs/translation.yaml,
    chip_smoke.py's synthetic pair) four times in one process, the second
    with `--debug-dir`: the PNGs' digests, equal if the card repeats the
    chain under cuDNN's autotuning;
  * with `--phases`, chip_smoke.py's phases 3 and 14 of that checkout, timed
    (other, then this; minutes each).
Without OTHER_ROOT only this checkout runs. Needs a card (exit 2 without).
"""

from __future__ import annotations

import os
import subprocess
import sys

from weatherconverter_tpu_torch.probes import common

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_CHILD = r'''
import hashlib, os, sys, tempfile, time
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as C
from weatherconverter_tpu_torch.cli.main import main as cli
from weatherconverter_tpu_torch.ops import attention as A, cuda_build
from weatherconverter_tpu_torch.probes.common import card_line
label, phases = sys.argv[1], sys.argv[2] == "1"
card = card_line()
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.benchmark = True
cuda_build.library()
dev = torch.device("cuda")
for shape in [(8, 4, 1024, 32), (2, 4, 1024, 16)]:
    q, k, v = (torch.randn(shape, device=dev).to(torch.bfloat16) for _ in range(3))
    for name, fn in (("K1 flash_attention", lambda: A.flash_attention(q, k, v)),
                     ("K2 flash_attention_qk_i8", lambda: A.flash_attention_qk_i8(q, k, v))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        host = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
        print(f"[{label}] {name} {shape}: host {host:.1f} us a call [{card}]", flush=True)
with tempfile.TemporaryDirectory() as tmp:
    img, lbl = os.path.join(tmp, "i.png"), os.path.join(tmp, "l.png")
    C._synthetic_pair(img, lbl, seed=53)
    argv = ["translate", "--config", os.path.join("configs", "translation.yaml"), "--image", img, "--label", lbl,
            "--seed", "5", "--steps", "20"]
    digests = []
    for i in range(4):
        out = os.path.join(tmp, f"o{i}.png")
        extra = ["--debug-dir", os.path.join(tmp, f"d{i}"), "--debug-every", "5"] if i == 1 else []
        assert cli(argv + ["--out", out] + extra) == 0
        digests.append(hashlib.sha256(open(out, "rb").read()).hexdigest()[:12])
    print(f"[{label}] translate x4 in one process (the second with --debug-dir): PNG digests {digests}, "
          f"{len(set(digests))} distinct [{card}]", flush=True)
    if phases:
        t0 = time.perf_counter()
        C.phase_slice(torch, A, dev, C.build_models(torch), card)
        torch.cuda.synchronize()
        p3 = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        C.phase_server(torch, A, dev, card, tmp)
        print(f"[{label}] chip_smoke phase 3 {p3:.1f} s, phase 14 {time.perf_counter() - t0:.1f} s (each at its "
              f"checkout's own settings) [{card}]", flush=True)
'''


def run_child(root: str, label: str, phases: bool) -> int:
    """The measurements in a fresh process of the checkout at `root`; its lines go to standard output."""
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _CHILD, label, "1" if phases else "0"], cwd=root, env=env,
                          capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith(f"[{label}]"):
            common.log(line)
    if proc.returncode != 0:
        common.log(f"[{label}] failed ({proc.returncode}): {proc.stderr[-2000:]}")
    return proc.returncode


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not common.require_cuda("dispatch_cost"):
        return 2
    phases = "--phases" in argv
    other = next((os.path.abspath(a) for a in argv if not a.startswith("--")), None)
    common.log(common.card_line())
    turns = [("this", THIS_ROOT)] * 2 if other is None else [("other", other), ("this", THIS_ROOT)] * 2
    failed = 0
    for i, (label, root) in enumerate(turns):
        failed |= run_child(root, label, phases and i < 2)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m wcbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs one CUDA card (more if the cell asks
for them) and exits non-zero, printing no result, without. The last line of
standard output is the result, one JSON object; the numbers compared with
the reference are also the last lines of standard error, each beside its
limit. With --trace 0 the metrics are the cell's end-to-end ones, with
--trace 1 its per-layer ones, read from a torch.profiler trace of the first
steps of the window. Build and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(_ROOT, ".wcbench_cache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(_CACHE, _sub)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    from wcbench.harness import Bench, forbidden_modules, run_cell

    bench = Bench()
    chips = bench.workload(args.workload).get("chips", 1)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"wcbench: the cell needs {chips} CUDA card(s), found {found}; nothing runs on the CPU",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"wcbench: the run loaded {', '.join(bad)}: the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that set the limits of `correct`: for each seed, one short window
of the cell (set-up, `--seconds` of timed work, the program freed), then the
program's numbers against the reference and, with `--control`, the
control's: the reference in TF32 (one precision below the f32 the
configurations state) put in the program's place. `--fault` plants one of
faults.FAULTS in the program first. One JSON line a seed on standard output.

    python3 -m wcbench.control --workload <cell> --seeds 1,2,3 --seconds 5 [--control] [--fault half_batch]

It needs the card, as a run does; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    import torch

    from wcbench import faults
    from wcbench.harness import Bench, Context

    if not torch.cuda.is_available():
        print("wcbench.control: no CUDA card", file=sys.stderr)
        return 2
    bench = Bench()
    cell = bench.workload(args.workload)
    tr = bench.traffic(cell["traffic"])
    driver = bench.driver(tr["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = Context(config=bench.config(cell["config"]), traffic=tr, seed=seed, device=torch.device("cuda:0"))
        plant = faults.plant(driver.Cell.kind, args.fault) if args.fault else contextlib.nullcontext()
        with plant:
            runner = driver.Cell(ctx)
            t1 = time.perf_counter()
            calls = 0
            while time.perf_counter() - t1 < args.seconds or calls == 0:
                runner.step()
                calls += 1
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        runner.free_program()
        line = {"seed": seed, "fault": args.fault, "calls": calls, "peak_bytes": peak,
                "program": {n: v for n, v, _ in runner.check()}}
        if args.control:
            line["control"] = {n: v for n, v, _ in runner.check(control=True)}
        line["diag"] = getattr(runner, "diag", None)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del runner
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())

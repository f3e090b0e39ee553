"""Where a Python script's wall time goes, by sampling its main thread's stack:

    python -m weatherconverter_tpu_torch.probes.stack_sample [--every 0.25] [--out FILE.json]
        [--top 400] SCRIPT [ARG ...]

Runs SCRIPT as `__main__` (runpy) in this process and, every `--every`
seconds, reads its main thread's stack from a second thread. Each sample
is counted under three keys, all in seconds (samples times `--every`):
  * `by_phase`: the outermost frame of SCRIPT whose function is `main` or
    starts with `phase_` (chip_smoke.py's phases), else "main";
  * `by_phase_line`: that frame's line, and the innermost frame of SCRIPT
    with its line (which statement of a phase the time is in);
  * `by_phase_inner`: that phase, the innermost frame in the port's package
    and the innermost frame of all (a library call, a wait on a child
    process, the profiler's parse).
Time spent in child processes shows as the parent's wait. The counts are
written when SCRIPT ends, also on an error or a non-zero exit, to `--out`
(default `chiprun_out/stack_samples.json` under the working directory).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import runpy
import sys
import threading
import time

PACKAGE = "weatherconverter_tpu_torch"


def _key_frames(stack, script):
    """(phase, phase frame, innermost script frame, innermost package frame, leaf) of one stack, outermost first."""
    phase, phase_frame = "main", None
    own = [f for f in stack if f[0] == script]
    for f in own:
        if f[1] == "main" or f[1].startswith("phase_"):
            phase, phase_frame = f[1], f
    inner_pkg = next((f for f in reversed(stack) if f"{PACKAGE}/" in f[0] and f[0] != __file__), None)
    return phase, phase_frame, own[-1] if own else None, inner_pkg, stack[-1] if stack else None


def _name(frame):
    """path:function:line, the path relative to the package or the file's name alone."""
    if frame is None:
        return "-"
    path = frame[0].split(f"{PACKAGE}/")[-1] if f"{PACKAGE}/" in frame[0] else os.path.basename(frame[0])
    return f"{path}:{frame[1]}:{frame[2]}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--every", type=float, default=0.25, help="seconds between samples")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "stack_samples.json"))
    ap.add_argument("--top", type=int, default=400, help="entries kept of each key")
    ap.add_argument("script")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    a = ap.parse_args(argv)
    script = os.path.abspath(a.script)
    counts = {k: collections.Counter() for k in ("by_phase", "by_phase_line", "by_phase_inner")}
    target, done = threading.get_ident(), threading.Event()

    def sample():
        while not done.wait(a.every):
            f = sys._current_frames().get(target)
            stack = []
            while f is not None:
                stack.append((f.f_code.co_filename, f.f_code.co_name, f.f_lineno))
                f = f.f_back
            phase, pf, own, pkg, leaf = _key_frames(stack[::-1], script)
            counts["by_phase"][phase] += 1
            counts["by_phase_line"][f"{phase}:{pf[2] if pf else '-'} | {_name(own)}"] += 1
            counts["by_phase_inner"][f"{phase} | {_name(pkg)} | {_name(leaf)}"] += 1

    threading.Thread(target=sample, daemon=True).start()
    sys.argv = [script] + a.args
    sys.path.insert(0, os.path.dirname(script))
    t0, code = time.perf_counter(), 0
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    finally:
        done.set()
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump({"every_s": a.every, "wall_s": time.perf_counter() - t0,
                       **{k: {n: c * a.every for n, c in v.most_common(a.top)} for k, v in counts.items()}}, fh,
                      indent=1)
    return code


if __name__ == "__main__":
    sys.exit(main())

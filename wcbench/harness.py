"""One run of one cell: find its files by name, set up, measure a window,
check the outputs against the plain reference, and build the result line.

Everything that belongs to one configuration, traffic mix, metric or kind
of timed entry sits in a file of its own, found by name:

    <BENCHMARK.json's config file>     the configuration's sizes
    traffic/<traffic>.json             the traffic mix; its "driver" names the entry
    drivers/<driver>.py                `Cell(ctx)`: set-up, `step()`, `check()`
    metrics/<metric>.py                `read(ctx)` -> a number or None
                                       (or metrics/<name before the first dot>.py)

A driver's Cell builds the program and its inputs from the seed and warms
up in its constructor, enqueues one unit of timed work per `step()` and
returns what it did ({"translations": ..., "images": ..., ...}), frees the
program in `free_program()`, and in `check(control=False)` compares what
the window produced with the reference: a list of (name, value, limit),
each passing where value <= limit.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from types import ModuleType
from typing import Any

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "weatherconverter_tpu")


class Bench:
    """BENCHMARK.json at `root` and the benchmark's files under `bench_dir`."""

    def __init__(self, root: str = ROOT, bench_dir: str = BENCH_DIR):
        self.root, self.bench_dir = root, bench_dir
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.manifest = json.load(fh)

    def workload(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.manifest["configs"] if c["name"] == name)
        with open(os.path.join(self.root, entry["file"])) as fh:
            return json.load(fh)

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.bench_dir, "traffic", f"{name}.json")) as fh:
            return json.load(fh)

    def driver(self, name: str) -> ModuleType:
        return _load(os.path.join(self.bench_dir, "drivers", f"{name}.py"), f"wcbench_driver_{name}")

    def reader(self, metric: str) -> ModuleType:
        for base in (metric, metric.split(".")[0]):
            path = os.path.join(self.bench_dir, "metrics", f"{base}.py")
            if os.path.isfile(path):
                return _load(path, "wcbench_metric_" + base.replace(".", "_"))
        raise FileNotFoundError(f"no reader for metric {metric!r} under metrics/")

    def metrics(self, section: str, cell: str) -> list[dict]:
        """The metrics of `section` ("end_to_end" or "per_layer") that `cell` reports."""
        e2e = {m["name"] for m in self.manifest["end_to_end"] if cell in m.get("workloads", [cell])}
        out = []
        for m in self.manifest[section]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif section == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out


def _load(path: str, name: str) -> ModuleType:
    """The module at `path`, loaded once a process (named by its path, so two
    benchmark folders do not share their drivers)."""
    name = f"{name}_{hashlib.sha256(os.path.abspath(path).encode()).hexdigest()[:8]}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclass
class Context:
    """What a driver is given, and what the readers read after the window."""

    config: dict
    traffic: dict
    seed: int
    device: Any
    setup_s: float = 0.0
    window_s: float = 0.0
    work: dict = field(default_factory=dict)
    calls: int = 0
    trace: Any = None  # wcbench.trace.Trace of the traced part
    traced_steps: int = 0
    step_s: float | None = None  # window seconds a step, outside the traced part
    spans: dict = field(default_factory=dict)  # kind -> [ms]
    flops_per_step: float | None = None
    flash_bound_s: float | None = None  # the traced part's flash kernels' least time
    peak: dict | None = None


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench: Bench, workload: str, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run: returns the result object (without printing it)."""
    import torch

    from wcbench import yardstick

    cell = bench.workload(workload)
    tr = bench.traffic(cell["traffic"])
    ctx = Context(config=bench.config(cell["config"]), traffic=tr, seed=int(seed), device=torch.device(device))
    runner = bench.driver(tr["driver"]).Cell(ctx)
    _sync(device)
    ctx.setup_s = time.perf_counter() - t_start
    is_cuda = ctx.device.type == "cuda"
    card = torch.cuda.get_device_name(ctx.device) if is_cuda else "cpu"
    ctx.peak = yardstick.peaks(card)

    def add(work):
        for k, v in work.items():
            ctx.work[k] = ctx.work.get(k, 0) + v
        ctx.calls += 1

    t0 = time.perf_counter()
    if trace:
        from wcbench import trace as trace_lib

        activities = [torch.profiler.ProfilerActivity.CPU]
        if is_cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function("wcbench.window"):
                for _ in range(int(tr.get("trace_calls", 1))):
                    add(runner.step(spans=True))
                _sync(device)
        ctx.traced_steps = ctx.calls * runner.steps_per_call
        t1, n1 = time.perf_counter(), ctx.calls
        while time.perf_counter() - t0 < seconds or ctx.calls == n1:
            add(runner.step())
        _sync(device)
        ctx.step_s = (time.perf_counter() - t1) / ((ctx.calls - n1) * runner.steps_per_call)
        ctx.trace = trace_lib.from_profiler(prof)
        ctx.spans = runner.spans()
        ctx.flops_per_step = runner.flops_per_step()
        if ctx.peak is not None:
            ctx.flash_bound_s = runner.flash_bound_per_step(ctx.peak) * ctx.traced_steps
    else:
        while time.perf_counter() - t0 < seconds or ctx.calls == 0:
            add(runner.step())
        _sync(device)
    ctx.window_s = time.perf_counter() - t0
    peak_bytes = int(torch.cuda.max_memory_allocated(ctx.device)) if is_cuda else 0

    runner.free_program()
    checks = runner.check()
    failed = sum(1 for _, v, limit in checks if not (v <= limit))

    metrics = {}
    for m in bench.metrics("per_layer" if trace else "end_to_end", workload):
        value = bench.reader(m["name"]).read(ctx)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if is_cuda else "cpu", "kind": card, "count": 1, "memory_peak_bytes": peak_bytes,
           "power_limit_w": yardstick.power_limit_w() if is_cuda else None}
    if trace:
        dev["busy_s"], dev["window_s"] = ctx.trace.busy_s, ctx.trace.window_s
    result = {"correct": failed == 0, "attempted": ctx.calls, "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = ctx.trace.breakdown()
    result["check"] = {name: {"value": float(v), "limit": float(limit)} for name, v, limit in checks}
    return result

"""Tracing, timing and memory instrumentation (port of
weatherconverter_tpu/core/profiling.py), on PyTorch's own tools:

  - `trace(dir)`: torch.profiler over the host and, where a card is present,
    the device, written as a Chrome trace (`dir`/trace.json; Perfetto or
    chrome://tracing opens it).
  - `annotate(name)`: a named range in that trace (record_function).
  - `StepTimer`: wall-clock time a step, the first steps skipped, with the
    JAX summary's keys; on the card it synchronizes before each clock read.
  - `enable_nan_debugging()`: autograd's anomaly mode.
  - `device_memory_stats()` / `format_memory()`: the caching allocator's
    counters, {} on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

TRACE_FILE = "trace.json"


def _default_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body with torch.profiler (host activity, and the
    device's where a card is present) and write its Chrome trace to
    `log_dir`/trace.json when the body ends, also on an error. Yields the
    profiler, whose `key_averages()` sum the time by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named range inside a trace: `with annotate("step"): ...`."""
    return torch.profiler.record_function(name)


def enable_nan_debugging(enable: bool = True) -> None:
    """Turn autograd's anomaly mode on (or off). It differs from JAX's
    `jax_debug_nans`, which re-runs a computation op by op when a NaN
    appears and raises at the op that made it, forward included: anomaly
    mode checks what each backward function returns and raises there,
    naming (by the traceback it records during the forward) the forward op
    whose backward produced the NaN. A NaN made in a forward with no
    backward is not caught. Slow: debugging only."""
    torch.autograd.set_detect_anomaly(enable)


def device_memory_stats(device=None) -> dict:
    """The caching allocator's counters (torch.cuda.memory_stats) of a CUDA
    device, the default one unless `device` names another, with JAX's
    bytes_in_use, peak_bytes_in_use and bytes_limit beside them; {} on the
    CPU, as the JAX function returns there."""
    dev = _default_device(device)
    if dev.type != "cuda":
        return {}
    stats = dict(torch.cuda.memory_stats(dev))
    stats.update(bytes_in_use=stats.get("allocated_bytes.all.current", 0),
                 peak_bytes_in_use=stats.get("allocated_bytes.all.peak", 0),
                 bytes_limit=torch.cuda.get_device_properties(dev).total_memory)
    return stats


def format_memory(device=None) -> str:
    s = device_memory_stats(device)
    if not s:
        return "memory stats unavailable"
    used = s.get("bytes_in_use", 0) / 2**30
    peak = s.get("peak_bytes_in_use", 0) / 2**30
    limit = s.get("bytes_limit", 0) / 2**30
    return f"HBM used {used:.2f} GiB (peak {peak:.2f} / limit {limit:.2f})"


class StepTimer:
    """Wall-clock time a step (`with timer: step()`), skipping the first
    `warmup` steps (first-shape work: kernel builds, cuDNN's algorithm
    trials). On a CUDA device (the default one when a card is present, or
    `device`) it synchronizes the device before it reads the clock at both
    ends: PyTorch returns before the device has finished, so without it the
    timer would time the launches, not the steps."""

    def __init__(self, warmup: int = 2, device=None):
        self.warmup = warmup
        self.device = _default_device(device)
        self.times: list[float] = []
        self._count = 0
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return False

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[min(n - 1, int(n * 0.9))],
            "min_s": ts[0],
            "max_s": ts[-1],
        }
